"""The port's quickstart and paper simulation against the reference's, on
the CPU (``examples/torch_quickstart.py``, ``examples/torch_safl_paper_sim
.py``).

  * ``prng.randint`` bitwise ``jax.random.randint`` over several keys and
    shapes, spans that are powers of two and spans that are not, minval >
    0, span 1, empty and full int32 ranges, and the quickstart's (4, 32)
    draw in [0, 512);
  * the engine's accuracy bitwise the reference's ``jnp.mean`` of the
    hits (XLA's count times f32(1 / n)) for every count at five test-set
    sizes, images and ``char``;
  * the quickstart, run once (``main(["--device", "cpu"])``) beside one
    run of the reference script: its printed lines the reference's; part
    1's batch bitwise, and at each of its 5 AdamW steps the loss within
    1e-5 (relative) and the gradients within ``_train_common``'s bound of
    the reference's at the port's params, the reference's update then
    taking the port's gradients: params and optimizer state bitwise the
    port's after every step (free-running, AdamW parts the two at
    small-gradient coordinates: 3.2e-5 relative in the fifth loss);
    part 2's two engines: bytes, staleness, participation and simulated
    times exact, accuracy within 2 test samples, params within
    ``rtol=1e-5, atol=1e-6`` of the reference engine's; part 3's last ids
    the reference's;
  * ``sparkline`` the reference's for the same values;
  * the paper simulation at ``--rounds 3 --clients 8`` against the
    reference script's ``main`` at the same flags: each mode's summary
    with its accuracy-free fields exact (and the accuracy-derived ones
    equal where the curves are), its bytes, staleness, participation and
    simulated times exact, its curve within 2 test samples.

Threads: torch runs on one thread in this module, except the
quickstart's part 2, whose engines run on torch's pool, where their
params hold the f32 bound (on one thread a ReLU unit within rounding of
0 lands on the other side, and fedavg's params read 1.5e-4 from the
reference's: a branch point, ``tools/branch_points.py case``).  Beside
other test processes a pool on the small ops slowed this module tenfold.
"""
import contextlib
import importlib.util
import io
import pathlib
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _train_common as tc  # noqa: E402
import _zoo_common as zc  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
#: the paper simulation's flags in these tests
SIM_ROUNDS, SIM_CLIENTS = 3, 8
#: accuracy: within 2 test samples, as the engine tests hold it
ACC_SAMPLES = 2


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


qs = _load("torch_quickstart")
sim = _load("torch_safl_paper_sim")

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)
#: torch's pool as the process starts: the quickstart's part 2 runs on it
POOL = torch.get_num_threads()


@contextlib.contextmanager
def _reference_engines():
    """Every reference engine that runs in the block, with its result."""
    runs = []
    real = JEngine.run

    def run(self, *args, **kwargs):
        res = real(self, *args, **kwargs)
        runs.append((self, res))
        return res
    JEngine.run = run
    try:
        yield runs
    finally:
        JEngine.run = real


def _lines(text):
    return [line for line in text.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# prng.randint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [
    (0, 512), (0, 500), (3, 10), (5, 6), (9, 2), (4, 4), (-7, 1000),
    (100, 2 ** 20 + 3), (0, 3 * 2 ** 16 + 1), (0, 2 ** 31 - 1),
    (-2 ** 31, 0), (-2 ** 31, 2 ** 31 - 1)])
def test_randint_bitwise_jax(lo, hi):
    for seed in (0, 1, 7, 2 ** 31 - 1):
        for shape in ((4, 32), (1,), (7, 9), (1000,)):
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                                 shape, lo, hi))
            got = prng.randint(prng.prng_key(seed), shape, lo, hi)
            assert got.dtype == torch.int32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want)


def test_randint_folded_keys_bitwise_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    pkey = prng.fold_in(prng.prng_key(3), 11)
    np.testing.assert_array_equal(
        prng.randint(pkey, (33, 5), 17, 92).numpy(),
        np.asarray(jax.random.randint(key, (33, 5), 17, 92)))


# ---------------------------------------------------------------------------
# the engine's accuracy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["image", "char"])
def test_accuracy_is_the_reference_f32_mean(kind):
    """Every hit count at five test-set sizes: the port's accuracy bitwise
    the reference's jitted ``evaluate`` (its ``jnp.mean``, which XLA
    computes as the count times f32(1 / n)).  A correctly rounded count /
    n differs in the last bit for about a third of the counts, which moved
    a target accuracy of 0.45 (180 of 400) a round."""
    def apply_fn(params, state, x, train):
        return x, state
    jeval = jclient.make_eval_fn(apply_fn, kind)
    rng = np.random.default_rng(0)
    for n in (37, 100, 150, 200, 400):
        # a (B, 2) char batch scores position 0's logits against y[:, 1]
        y = rng.integers(0, 10, (n,) if kind == "image" else (n, 2))
        onehot = np.eye(10, dtype=np.float32)[y]
        if kind == "char":
            onehot[:, 0] = onehot[:, 1]
        for c in range(n + 1):
            # c hits: the rest rolled to the next class
            logits = onehot.copy()
            logits[c:] = np.roll(logits[c:], 1, axis=-1)
            want, _ = jeval({}, {}, jnp.asarray(logits), jnp.asarray(y))
            got, _ = tclient.evaluate(apply_fn, kind, {}, {},
                                      torch.from_numpy(logits),
                                      torch.from_numpy(y))
            assert np.float32(got).view(np.uint32) == \
                np.float32(want).view(np.uint32), (n, c, float(got),
                                                   float(want))


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart():
    """One run of the reference script (its globals, engines and printed
    lines) and one of the port's ``main`` on the CPU (its result, printed
    lines and every ``value_and_grad`` of part 1)."""
    out = io.StringIO()
    with _reference_engines() as engines, contextlib.redirect_stdout(out):
        ref = runpy.run_path(str(EXAMPLES / "quickstart.py"))
    ref_lines = _lines(out.getvalue())
    out = io.StringIO()
    federate = qs.federate

    def pooled(*args, **kwargs):
        torch.set_num_threads(POOL)
        try:
            return federate(*args, **kwargs)
        finally:
            torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        seen = tc.record_value_and_grad(mp)
        mp.setattr(qs, "federate", pooled)
        got = qs.main(["--device", "cpu"])
    return dict(ref=ref, engines=engines, ref_lines=ref_lines, got=got,
                lines=_lines(out.getvalue()), seen=seen)


def test_quickstart_prints_the_reference_lines(quickstart):
    assert quickstart["lines"] == quickstart["ref_lines"]
    assert quickstart["lines"][-1] == "quickstart OK"


def test_quickstart_batch_is_the_reference_draw(quickstart):
    got = quickstart["got"]["train"]["batch"]["tokens"]
    want = np.asarray(quickstart["ref"]["batch"]["tokens"])
    assert tuple(got.shape) == (qs.B, qs.S) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_quickstart_training_matches_reference(quickstart):
    """Part 1, step by step at the port's params: the reference script's
    jitted step gives the loss, the reference's ``value_and_grad`` the
    gradients, and its AdamW, fed the port's gradients, the next params
    and state, bitwise the port's."""
    ref = quickstart["ref"]
    seen = quickstart["seen"]
    assert len(seen) == qs.STEPS
    jcfg, tcfg, _, jp, jvg = tc.ref("qwen3-1.7b")
    assert qs.lm_config() == tcfg and ref["cfg"] == jcfg
    jstep = ref["jstep"]
    jupd = jax.jit(ref["opt"].update)
    fed, fed_s = jp, ref["opt"].init(jp)
    tc.assert_bitwise(tc.to_numpy(seen[0][0]), tc.np_tree(jp), "init")
    batch = ref["batch"]
    for step, (params, tbatch, ((loss, _), grads)) in enumerate(seen):
        tc.assert_bitwise(tc.to_numpy(params), tc.np_tree(fed),
                          ("params", step))
        np.testing.assert_array_equal(tbatch["tokens"].numpy(),
                                      np.asarray(batch["tokens"]))
        _, _, m = jstep(fed, fed_s, batch, jnp.int32(step))
        want = float(m["loss"])
        assert abs(float(loss) - want) <= 1e-5 * abs(want), (step,
                                                             float(loss),
                                                             want)
        (_, _), jg = jvg(fed, batch)
        tc.assert_grads_close(tc.to_numpy(grads), tc.np_tree(jg),
                              ("step", step))
        fed, fed_s = jupd(fed, jax.tree_util.tree_map(
            jnp.asarray, tc.to_numpy(grads)), fed_s, jnp.int32(step))
    lm = quickstart["got"]["train"]
    tc.assert_bitwise(tc.to_numpy(lm["params"]), tc.np_tree(fed), "params")
    tc.assert_bitwise(tc.to_numpy(lm["ostate"]), tc.np_tree(fed_s), "state")
    assert len(lm["losses"]) == qs.STEPS


@pytest.mark.parametrize("agg", ["fedsgd", "fedavg"])
def test_quickstart_federate_matches_reference(quickstart, agg):
    """Part 2: the port's engine against the reference script's."""
    jeng, jres = {e.cfg.aggregation: (e, r)
                  for e, r in quickstart["engines"]}[agg]
    teng, tres = quickstart["got"]["federate"][agg]
    _assert_same_run(jeng, jres, teng, tres, qs.ROUNDS, qs.N_TEST)
    want = np.asarray(jflatbuf.PytreeCodec(jres.final_params).ravel(
        jres.final_params))
    np.testing.assert_allclose(teng._flat_params.numpy(), want, rtol=1e-5,
                               atol=1e-6)


def test_quickstart_decode_matches_reference(quickstart):
    """Part 3: the last greedy ids of the reference script's decode."""
    got = quickstart["got"]["decode"]
    assert got["last"] == np.asarray(quickstart["ref"]["tok"]).tolist()
    assert len(got["ids"]) == qs.DECODE + 1
    assert all(torch.isfinite(x).all() for x in got["logits"])


def _assert_same_run(jeng, jres, teng, tres, rounds, n_test):
    """Bytes, staleness, participation and simulated times exact; the
    summaries' accuracy-free fields exact and the curves within
    ``ACC_SAMPLES`` test samples (the accuracy-derived fields equal where
    the curves are)."""
    assert (teng.tx_bytes, teng.rx_bytes) == (jeng.tx_bytes, jeng.rx_bytes)
    assert tres.staleness_hist == jres.staleness_hist
    np.testing.assert_array_equal(tres.participation, jres.participation)
    recs = tres.metrics.records
    jrecs = jres.metrics.records
    assert len(recs) == len(jrecs) == rounds
    for rt, rj in zip(recs, jrecs):
        assert (rt.round, rt.sim_time, rt.mean_staleness, rt.max_staleness,
                rt.tx_bytes, rt.rx_bytes) == \
            (rj.round, rj.sim_time, rj.mean_staleness, rj.max_staleness,
             rj.tx_bytes, rj.rx_bytes)
        assert abs(rt.accuracy - rj.accuracy) * n_test <= ACC_SAMPLES + 1e-6
    s, js = tres.metrics.summary(), jres.metrics.summary()
    assert s.keys() == js.keys()
    derived = ("best_accuracy", "final_accuracy", "T_f", "T_s",
               "stability", "oscillations")
    for k in s:
        if k not in derived:
            assert s[k] == js[k], k
    if [r.accuracy for r in recs] == [r.accuracy for r in jrecs]:
        assert all(s[k] == js[k] for k in derived)


# ---------------------------------------------------------------------------
# the paper simulation
# ---------------------------------------------------------------------------


def test_sparkline_is_the_reference():
    ref = runpy.run_path(str(EXAMPLES / "safl_paper_sim.py"))
    rng = np.random.default_rng(0)
    cases = [[], [0.0], [1.0], [1.2], [0.9999], [-0.0], [0.1, 0.5, 0.95],
             [i / 9 for i in range(10)]]
    cases += [rng.uniform(0, 1.05, n).tolist() for n in (1, 7, 39, 40, 41,
                                                         80, 81, 123)]
    for vals in cases:
        for width in (40, 8):
            assert sim.sparkline(vals, width) == ref["sparkline"](vals, width)


@pytest.fixture(scope="module")
def paper_sim():
    """The reference script's ``main`` and the port's :func:`simulate` at
    ``--rounds 3 --clients 8``."""
    ref = runpy.run_path(str(EXAMPLES / "safl_paper_sim.py"))
    argv = ["safl_paper_sim", "--rounds", str(SIM_ROUNDS), "--clients",
            str(SIM_CLIENTS)]
    out = io.StringIO()
    with _reference_engines() as engines, contextlib.redirect_stdout(out), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", argv)
        ref["main"]()
    got = sim.simulate(SIM_ROUNDS, SIM_CLIENTS, "cpu")
    return dict(engines=engines, got=got)


@pytest.mark.parametrize("tag", ["SS", "SA", "AS", "AA"])
def test_paper_sim_matches_reference(paper_sim, tag):
    order = [t for _, _, t in sim.SETTINGS]
    assert list(paper_sim["got"]) == order
    jeng, jres = paper_sim["engines"][order.index(tag)]
    run = paper_sim["got"][tag]
    mode, agg, _ = sim.SETTINGS[order.index(tag)]
    assert (jeng.cfg.mode, jeng.cfg.aggregation) == (mode, agg)
    _assert_same_run(jeng, jres, run["engine"], run["result"], SIM_ROUNDS,
                     sim.N_TEST)
    assert run["summary"] == run["result"].metrics.summary()
    assert run["curve"] == [r.accuracy for r in run["result"].metrics.records]
    if tag in ("AS", "AA"):
        assert max(run["result"].staleness_hist) > 0


def test_paper_sim_main_prints_each_mode(capsys):
    """``main`` at one round and four clients: the header, a row a mode in
    the paper's order, the closing line."""
    out = sim.main(["--rounds", "1", "--clients", "4", "--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert lines[0].split() == ["mode", "best", "T_f", "T_s-T_f", "osc@.05",
                                "tx", "MB", "stale", "curve"]
    assert [line.split()[0] for line in lines[1:5]] == list(out)
    assert lines[-1].startswith("paper claims at this scale")
