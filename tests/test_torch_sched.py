"""repro_torch.sched (static timing, full policy) against repro.sched:
the event trace must be identical, float for float.  The other timings
and policies are held in ``test_torch_sched_policies.py``."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import sched as jsched  # noqa: E402
from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core.client import ClientState as JClient  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.core.client import ClientState as TClient  # noqa: E402


def _clients(cls, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for cid in range(n):
        speed = float(np.exp(rng.normal(0.0, 0.8)))
        comm = float(np.exp(rng.normal(0.0, 0.3)))
        out.append(cls(cid=cid, params=None, model_state=None, version=0,
                       n_samples=int(rng.integers(4, 90)), speed=speed,
                       comm_time=comm,
                       rng=np.random.default_rng(seed * 7919 + cid)))
    return out


def _base(c):
    return c.n_samples / (500.0 * c.speed)


def _trace(mod, cfg, clients, n_events, k):
    s = mod.build_scheduler(cfg, clients, _base)
    s.resume()
    rnd, out = 0, []
    for i in range(n_events):
        ev = s.pop(rnd)
        # the full policy admits every upload
        assert ev.admitted and ev.verdict == "admit"
        out.append((ev.time, ev.cid, ev.staleness, ev.compute_s))
        if (i + 1) % k == 0:  # the k horizon closes: next round
            rnd += 1
    return out, s.stats()


@pytest.mark.parametrize("n,k", [(8, 3), (16, 4)])
def test_static_full_trace_equal(n, k):
    tj, sj = _trace(jsched, JConfig(n_clients=n, k=k),
                    _clients(JClient, n), 60, k)
    tt, st = _trace(tsched, TConfig(n_clients=n, k=k),
                    _clients(TClient, n), 60, k)
    assert tt == tj
    assert st == sj


def test_sync_duration_equal():
    for cj, ct in zip(_clients(JClient, 6), _clients(TClient, 6)):
        tj = jsched.timing.StaticTiming(_base)
        tt = tsched.timing.StaticTiming(_base)
        assert tt.sync_duration(ct) == tj.sync_duration(cj)
