"""On the card (skips on the CPU): a run at the configurations' full
widths on a smaller mix comes out correct; of ``bench/controls.py``'s
readings, the program comes out correct, and the control (the plain
reference in TF32 put in the program's place) and every planted fault
not correct, against each cell's limits."""
import time

import pytest

from bench import controls, harness
from bench.tests import _tiny

pytestmark = pytest.mark.card
FAULTS = list(controls.FAULTS)


def _spec(cell):
    s = _tiny.full_spec(cell)
    s["traffic"].update(n_train=2000, n_test=1000, clients=10, k=4)
    return s


@pytest.mark.parametrize("cell", _tiny.cells())
def test_run_and_control_on_the_card(card, cell):
    spec = _spec(cell)
    out = harness.run_cell(spec, 2 ** 31 + 5, 2.0, False, card,
                           time.perf_counter())
    assert out["correct"], out["numbers"]
    lines = {r["kind"]: r for r in controls.readings_for(
        spec, 2 ** 31 + 6, card, FAULTS)}
    assert lines["sound"]["correct"], lines["sound"]
    for kind in ["tf32"] + FAULTS:
        assert not lines[kind]["correct"], lines[kind]
