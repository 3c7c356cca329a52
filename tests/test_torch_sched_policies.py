"""repro_torch.sched's timing models, policies and scheduler against
repro.sched, host to host.

Bitwise: the uniform lanes of the timing stream's blocks; Markov's drop
decisions and off times; the ``uniform`` policy's sets; FedQS's
``score_one`` against its ``score`` and against the reference's;
``RateControl``'s verdict stream; every scheduler pop's ``(cid, verdict,
staleness, compute_s)`` and the counters, under each timing x policy,
with and without faults; ``Scheduler.state()`` key by key.  The normal
lanes are bitwise too (the port's ``prng.normal`` takes XLA's f32
``log1p``), so every timing model's event times are held bitwise.
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import sched as jsched  # noqa: E402
from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core.client import ClientState as JClient  # noqa: E402
from repro.sched import timing as jtiming  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch.configs.base import FLConfig as TConfig  # noqa: E402
from repro_torch.core.client import ClientState as TClient  # noqa: E402
from repro_torch.sched import policy as tpolicy  # noqa: E402
from repro_torch.sched import timing as ttiming  # noqa: E402

TIMINGS = ("static", "lognormal", "markov")
POLICY_KW = {"full": {}, "uniform": {"sched_c": 3},
             "seafl": {"sched_stale_cap": 1}, "fedqs": {},
             "ratelimit": {"horizon": "timeout", "horizon_timeout_s": 0.5,
                           "sched_rate_limit": 2}}
CHAOS = dict(fault_crash_p=0.15, fault_straggler_p=0.15, fault_seed=3)


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


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# ----------------------------- the stream -----------------------------


def test_stream_blocks_match_reference():
    """The reference's blocks (fold_in twice, split, normal (64, 1),
    uniform (64, 2)) for 3 seeds x 16 clients x 3 blocks: uniform and
    normal lanes bitwise (0 of the 9,216 normal lanes differ)."""
    draw = jtiming._block_fn()
    n_diff = n_lanes = 0
    worst = 0
    for seed in (0, 1_000_003, 7):
        for cid in range(16):
            for b in range(3):
                want = np.asarray(draw(seed, cid, b))
                got = ttiming._block(seed, cid, b)
                assert got.dtype == np.float32 and got.shape == (64, 3)
                np.testing.assert_array_equal(
                    got[:, 1:].view(np.uint32), want[:, 1:].view(np.uint32))
                u = _ulps(got[:, 0], want[:, 0])
                n_diff += int((u > 0).sum())
                n_lanes += u.size
                worst = max(worst, int(u.max()))
    print(f"normal lanes differing: {n_diff} of {n_lanes}, worst {worst} "
          "ulp")
    assert n_lanes == 9216
    assert n_diff == 0 and worst == 0


def test_stream_is_counter_keyed():
    """Draw n of client c depends on (seed, c, n) only, not on how the
    clients' draws interleave; blocks turn over at 64."""
    a, b = ttiming.PRNGStream(11), ttiming.PRNGStream(11)
    seq_a = [(cid, a.draw(cid).copy()) for cid in [0, 1] * 70]
    seq_b = {0: [b.draw(0).copy() for _ in range(70)],
             1: [b.draw(1).copy() for _ in range(70)]}
    got = {0: [v for c, v in seq_a if c == 0],
           1: [v for c, v in seq_a if c == 1]}
    for cid in (0, 1):
        np.testing.assert_array_equal(np.stack(got[cid]),
                                      np.stack(seq_b[cid]))
    np.testing.assert_array_equal(got[0][64], ttiming._block(11, 0, 1)[0])


def test_markov_transitions_match_reference():
    """300 post-upload transitions of 6 clients: the drop decision (WAKE
    or UPLOAD), a WAKE's off time and an UPLOAD's time (its jitter a
    normal lane) bitwise."""
    cfg_kw = dict(n_clients=6, k=2, sched_timing="markov", sched_drop_p=0.3,
                  sched_jitter_sigma=0.5, sched_seed=2, seed=5)
    jt = jtiming.make_timing(JConfig(**cfg_kw), _base)
    tt = ttiming.make_timing(TConfig(**cfg_kw), _base)
    cj, ct = _clients(JClient, 6), _clients(TClient, 6)
    n_wake = 0
    for i in range(300):
        cid = i % 6
        now = 0.25 * i
        want = jt.after_upload(cj[cid], now)
        got = tt.after_upload(ct[cid], now)
        assert got == want
        n_wake += got[1] == jsched.WAKE
    assert 30 < n_wake < 150
    for a, b in zip(cj, ct):
        assert tt.sync_duration(b) == jt.sync_duration(a)


# ----------------------------- policies -----------------------------


@pytest.mark.parametrize("c", [1, 3, 5, 8])
def test_uniform_sets_match_reference(c):
    kw = dict(n_clients=8, k=2, sched_policy="uniform", sched_c=c,
              sched_seed=4, seed=9)
    jp = jsched.make_policy(JConfig(**kw), 8)
    tp = tpolicy.make_policy(TConfig(**kw), 8)
    for rnd in range(40):
        if c < 8:
            assert tp._round_set(rnd) == jp._round_set(rnd)
        for cid in range(8):
            assert tp.verdict(cid, 0, 10, rnd) == jp.verdict(cid, 0, 10, rnd)


@pytest.mark.parametrize("beta", [0.5, 1.0, 2.0])
def test_fedqs_scores_bitwise(beta):
    """score_one equals score lane by lane, and both the reference's."""
    kw = dict(n_clients=7, k=2, sched_policy="fedqs", sched_qs_beta=beta)
    jp = jsched.make_policy(JConfig(**kw), 7)
    tp = tpolicy.make_policy(TConfig(**kw), 7)
    jp.bind(_clients(JClient, 7))
    tp.bind(_clients(TClient, 7))
    assert tp.n_mean == jp.n_mean
    rng = np.random.default_rng(1)
    stal = rng.integers(0, 12, 64).tolist()
    sizes = rng.integers(1, 200, 64).tolist()
    vec = tp.score(stal, sizes)
    assert vec.dtype == np.float32
    np.testing.assert_array_equal(vec.view(np.uint32),
                                  jp.score(stal, sizes).view(np.uint32))
    for i, (t, n) in enumerate(zip(stal, sizes)):
        one = tp.score_one(t, n)
        assert one.dtype == np.float32
        assert one.view(np.uint32) == vec[i].view(np.uint32)
        assert one.view(np.uint32) == jp.score_one(t, n).view(np.uint32)
    assert tp.reweights and not tpolicy.Policy.reweights


@pytest.mark.parametrize("limit", [0, 1, 3])
def test_ratelimit_verdict_stream(limit):
    kw = dict(n_clients=5, k=3, sched_policy="ratelimit",
              sched_rate_limit=limit, horizon="timeout",
              horizon_timeout_s=1.0)
    jp = jsched.make_policy(JConfig(**kw), 5)
    tp = tpolicy.make_policy(TConfig(**kw), 5)
    rng = np.random.default_rng(limit)
    rnds = np.cumsum(rng.random(200) < 0.2).tolist()
    got = [tp.verdict(i % 5, 0, 10, r) for i, r in enumerate(rnds)]
    want = [jp.verdict(i % 5, 0, 10, r) for i, r in enumerate(rnds)]
    assert got == want
    assert "idle" in got and "admit" in got


def test_seafl_verdicts():
    kw = dict(n_clients=4, k=2, sched_policy="seafl", sched_stale_cap=2)
    jp = jsched.make_policy(JConfig(**kw), 4)
    tp = tpolicy.make_policy(TConfig(**kw), 4)
    for stal in range(6):
        assert tp.verdict(0, stal, 5, 7) == jp.verdict(0, stal, 5, 7)
    assert [tp.verdict(0, s, 5, 7) for s in (2, 3)] == ["admit", "reject"]


# ----------------------------- the scheduler -----------------------------


def _trace(mod, cfg, clients, n_events, k):
    """Pop ``n_events`` decisions, closing a round every ``k`` admitted
    uploads; -> the pops, the stats and the final state."""
    s = mod.build_scheduler(cfg, clients, _base)
    s.resume()
    rnd = adm = 0
    out = []
    for _ in range(n_events):
        ev = s.pop(rnd)
        out.append((ev.time, ev.cid, ev.verdict, ev.staleness,
                    ev.compute_s, None if ev.fault is None
                    else ev.fault.kind))
        if ev.admitted:
            adm += 1
            if adm % k == 0:
                rnd += 1
    return out, s.stats(), s.state()


def _assert_traces(got, want, timing):
    assert [e[1:4] + e[5:] for e in got] == [e[1:4] + e[5:] for e in want]
    t_got = np.asarray([(e[0], e[4]) for e in got])
    t_want = np.asarray([(e[0], e[4]) for e in want])
    np.testing.assert_array_equal(t_got, t_want)


@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("policy", list(POLICY_KW))
@pytest.mark.parametrize("timing", TIMINGS)
def test_scheduler_trace_matches_reference(timing, policy, faults):
    kw = dict(n_clients=8, k=3, sched_timing=timing, sched_policy=policy,
              sched_jitter_sigma=0.5, sched_drop_p=0.25, sched_seed=1,
              **POLICY_KW[policy])
    if faults:
        kw.update(CHAOS)
    tj, sj, stj = _trace(jsched, JConfig(**kw), _clients(JClient, 8), 150, 3)
    tt, st, stt = _trace(tsched, TConfig(**kw), _clients(TClient, 8), 150, 3)
    _assert_traces(tt, tj, timing)
    assert st == sj
    assert set(stt) == set(stj)
    for key in stt:
        assert stt[key] == stj[key], key
    verdicts = {e[2] for e in tt}
    if policy in ("uniform", "seafl"):
        assert "reject" in verdicts
    if policy == "ratelimit":
        assert "idle" in verdicts
    if timing == "markov":
        assert st["no_shows"] > 0
    if faults:
        assert "crash" in verdicts


@pytest.mark.parametrize("timing", TIMINGS)
def test_scheduler_state_roundtrip(timing):
    """A scheduler restored from ``state()`` mid-stream pops the rest of
    the uninterrupted stream bit for bit."""
    kw = dict(n_clients=6, k=2, sched_timing=timing,
              sched_policy="ratelimit", sched_rate_limit=2,
              horizon="timeout", horizon_timeout_s=0.5,
              sched_drop_p=0.3, **CHAOS)
    cfg = TConfig(**kw)
    full = tsched.build_scheduler(cfg, _clients(TClient, 6), _base)
    full.resume()
    want = [full.pop(i // 7) for i in range(120)]
    a = tsched.build_scheduler(cfg, _clients(TClient, 6), _base)
    a.resume()
    head = [a.pop(i // 7) for i in range(50)]
    b = tsched.build_scheduler(cfg, _clients(TClient, 6), _base)
    b.load_state(a.state())
    b.resume()
    tail = [b.pop(i // 7) for i in range(50, 120)]
    assert head + tail == want
    assert b.stats() == full.stats()


def test_static_full_is_the_oracle():
    """uniform with C = N and seafl with a cap no staleness reaches
    admit every upload: the full policy's stream."""
    runs = []
    for kw in ({}, {"sched_policy": "uniform", "sched_c": 8},
               {"sched_policy": "seafl", "sched_stale_cap": 10 ** 6}):
        cfg = TConfig(n_clients=8, k=3, **kw)
        runs.append(_trace(tsched, cfg, _clients(TClient, 8), 80, 3)[0])
    assert runs[0] == runs[1] == runs[2]
