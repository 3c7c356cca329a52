"""The plain versions of the ported kernels against the reference's Pallas
kernels (interpret mode) and its jnp oracles, on the CPU: ``safl_fold``,
``safl_aggregate``, ``sdga_aggregate``, the q8 wire's
``safl_fold_q8``, ``safl_aggregate_q8``, ``sdga_aggregate_q8``, the q4
wire's ``safl_fold_q4``, ``safl_aggregate_q4``, ``sdga_aggregate_q4``,
and the defense's ``screen_rows``, ``screen_rows_q8`` and
``screen_rows_q4`` (on clean, corrupted, Byzantine and all-zero rows:
sums within ``rtol=1e-5``, since ``torch.sum`` and XLA sum in other
orders; the isfinite verdicts exact; ``screen_rows_q4_plain`` bitwise
equal to the port's oracle ``ref.screen_sumsq_q4_ref``).

Tolerance against the reference: ``rtol=1e-5, atol=1e-5``.  The plain
versions reduce over K one row at a time; the reference's einsum may sum
in another order and the poly discount's ``pow`` may differ in the last
ulp, so they agree to a few ulp of the summed terms (magnitude up to ~10
here, hence the absolute term where the sum cancels).  Properties of the port itself (a fold
chain equals one aggregate, a CPU call is the plain version) are exact.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import safl_agg as jk  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D_RAGGED = 2500  # not a multiple of the reference's 2048-lane block


def _rows(k, d, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(k, d)).astype(np.float32)
    p = rng.normal(size=(d,)).astype(np.float32)
    return u, p, rng


def _weights(rng, k, mode, discount):
    if discount == "poly":  # staleness values
        return rng.integers(0, 6, k).astype(np.float32)
    if mode == "mix":  # fedasync mix coefficients sum below 1
        return (rng.uniform(0.05, 0.9, k) / k).astype(np.float32)
    return rng.uniform(0.5, 4.0, k).astype(np.float32)


@pytest.mark.parametrize("beta", [1.0, 0.625])
def test_fold_plain_matches_reference(beta):
    u, p, _ = _rows(1, D_RAGGED)
    acc, vec, w = p, u[0], np.float32(0.37)
    want = np.asarray(jk.safl_fold(acc, vec, w, beta, interpret=True))
    oracle = np.asarray(jref.fold_ref(acc, vec, w, beta))
    got = tk.safl_fold_plain(torch.from_numpy(acc), torch.from_numpy(vec),
                             w, beta).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("discount", ["none", "poly"])
@pytest.mark.parametrize("mode", ["fedsgd", "avg", "mix", "sum"])
def test_aggregate_plain_matches_reference(mode, discount, k):
    u, p, rng = _rows(k, D_RAGGED, seed=k)
    w = _weights(rng, k, mode, discount)
    needs_p = mode in ("fedsgd", "mix")
    kw = dict(server_lr=0.3, mode=mode, alpha=0.5, discount=discount)
    want = np.asarray(jk.safl_aggregate(u, w, p if needs_p else None,
                                        interpret=True, **kw))
    got = tk.safl_aggregate_plain(
        torch.from_numpy(u), torch.from_numpy(w),
        torch.from_numpy(p) if needs_p else None, **kw).numpy()
    assert got.shape == (D_RAGGED,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # and the jnp oracles of the modes that have one
    wd = np.power(1.0 + w, np.float32(-0.5)) if discount == "poly" \
        else w
    oracle = {"fedsgd": lambda: jref.safl_agg_ref(u, wd, p, 0.3),
              "avg": lambda: jref.weighted_avg_ref(u, wd),
              "mix": lambda: jref.fedasync_flat_ref(u, wd, p),
              "sum": lambda: jref.weighted_sum_ref(u, wd)}[mode]()
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


def test_fold_chain_equals_aggregate_bitwise():
    """The port's streaming channel (K folds) equals its buffered channel
    (one sum-mode aggregate) bit for bit."""
    u, _, rng = _rows(5, D_RAGGED, seed=9)
    w = rng.uniform(0.5, 40.0, 5).astype(np.float32)
    acc = torch.zeros(D_RAGGED)
    for k in range(5):
        tk.safl_fold(acc, torch.from_numpy(u[k]), w[k], out=acc)
    agg = tk.safl_aggregate(torch.from_numpy(u), torch.from_numpy(w),
                            mode="sum")
    assert torch.equal(acc, agg)


def test_cpu_calls_are_plain_and_not_counted():
    u, p, rng = _rows(3, 777, seed=4)
    ut, pt = torch.from_numpy(u), torch.from_numpy(p)
    w = torch.from_numpy(rng.uniform(0.5, 4.0, 3).astype(np.float32))
    f0, a0 = tk.safl_fold.launches, tk.safl_aggregate.launches
    assert torch.equal(tk.safl_fold(pt, ut[0], 0.5),
                       tk.safl_fold_plain(pt, ut[0], 0.5))
    out = pt.clone()
    assert tk.safl_fold(out, ut[1], 0.25, out=out) is out
    assert torch.equal(out, tk.safl_fold_plain(pt, ut[1], 0.25))
    for mode in tk.MODES:
        assert torch.equal(
            tk.safl_aggregate(ut, w, pt, server_lr=0.3, mode=mode),
            tk.safl_aggregate_plain(ut, w, pt, server_lr=0.3, mode=mode))
    assert (tk.safl_fold.launches, tk.safl_aggregate.launches) == (f0, a0)
    assert (f0, a0) == (0, 0)


def test_aggregate_rejects_bad_arguments():
    u = torch.zeros(2, 8)
    w = torch.ones(2)
    with pytest.raises(ValueError):
        tk.safl_aggregate(u, w, mode="median")
    with pytest.raises(ValueError):
        tk.safl_aggregate(u, w, discount="hinge")
    with pytest.raises(ValueError):
        tk.safl_aggregate(u, w, None, mode="fedsgd")


# ---------------------------------------------------------------------------
# sdga_aggregate and the q8 kernels
# ---------------------------------------------------------------------------

QB = 512
DQ_RAGGED = -(-D_RAGGED // QB) * QB  # 2560: the quantized row length
SDGA_KW = dict(server_lr=0.3, alpha=0.5, momentum=0.8, ema_anchor=0.05,
               ema_decay=0.95)


def _q8_rows(k, seed=0):
    """k rows quantized on the q8 grid: (q int8 (k, Dq), scales (k, Dq/QB))
    with the padding lanes of each row at zero."""
    u, _, _ = _rows(k, D_RAGGED, seed)
    x = np.zeros((k, DQ_RAGGED), np.float32)
    x[:, :D_RAGGED] = u
    q, s = jref.quantize_ref(x.reshape(-1, QB))
    return (np.asarray(q).reshape(k, DQ_RAGGED),
            np.asarray(s).reshape(k, DQ_RAGGED // QB))


def _slow_state(seed):
    rng = np.random.default_rng(seed + 100)
    return tuple(rng.normal(size=(D_RAGGED,)).astype(np.float32)
                 for _ in range(3))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("discount", ["none", "poly"])
def test_sdga_plain_matches_reference(discount, k):
    u, _, rng = _rows(k, D_RAGGED, seed=20 + k)
    w = _weights(rng, k, "avg", discount)
    p, m, e = _slow_state(k)
    want = jk.sdga_aggregate(u, w, p, m, e, interpret=True,
                             discount=discount, **SDGA_KW)
    got = tk.sdga_aggregate_plain(*_t(u, w, p, m, e), discount=discount,
                                  **SDGA_KW)
    wd = np.power(1.0 + w, np.float32(-0.5)) if discount == "poly" else w
    oracle = jref.sdga_step_from_mean(
        jref.weighted_avg_ref(u, wd), p, m, e, server_lr=0.3, momentum=0.8,
        ema_anchor=0.05, ema_decay=0.95)
    for g, wnt, orc in zip(got, want, oracle):
        assert g.shape == (D_RAGGED,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(orc), **TOL)


@pytest.mark.parametrize("beta", [1.0, 0.625])
def test_fold_q8_plain_matches_reference(beta):
    q, s = _q8_rows(1, seed=3)
    acc = np.random.default_rng(4).normal(size=DQ_RAGGED).astype(np.float32)
    w = np.float32(0.37)
    want = np.asarray(jk.safl_fold_q8(acc, q[0], s[0], w, beta, qblock=QB,
                                      interpret=True))
    oracle = np.asarray(jref.fold_q8_ref(acc, q[0], s[0], w, QB, beta))
    got = tk.safl_fold_q8_plain(*_t(acc, q[0], s[0]), w, beta,
                                qblock=QB).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("discount", ["none", "poly"])
@pytest.mark.parametrize("mode", ["fedsgd", "avg", "mix", "sum"])
def test_aggregate_q8_plain_matches_reference(mode, discount, k):
    q, s = _q8_rows(k, seed=30 + k)
    _, p, rng = _rows(1, D_RAGGED, seed=40 + k)
    w = _weights(rng, k, mode, discount)
    needs_p = mode in ("fedsgd", "mix")
    kw = dict(server_lr=0.3, mode=mode, alpha=0.5, discount=discount)
    want = np.asarray(jk.safl_aggregate_q8(
        q, s, w, p if needs_p else None, qblock=QB, interpret=True, **kw))
    got = tk.safl_aggregate_q8_plain(
        *_t(q, s, w), torch.from_numpy(p) if needs_p else None, qblock=QB,
        **kw).numpy()
    assert got.shape == ((D_RAGGED,) if needs_p else (DQ_RAGGED,))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("discount", ["none", "poly"])
def test_sdga_q8_plain_matches_reference(discount, k):
    q, s = _q8_rows(k, seed=50 + k)
    rng = np.random.default_rng(k)
    w = _weights(rng, k, "avg", discount)
    p, m, e = _slow_state(k + 7)
    want = jk.sdga_aggregate_q8(q, s, w, p, m, e, qblock=QB, interpret=True,
                                discount=discount, **SDGA_KW)
    got = tk.sdga_aggregate_q8_plain(*_t(q, s, w, p, m, e), qblock=QB,
                                     discount=discount, **SDGA_KW)
    for g, wnt in zip(got, want):
        assert g.shape == (D_RAGGED,)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


@pytest.mark.parametrize("wire", ["f32", "q8"])
def test_folds_then_sdga_step_equal_sdga_aggregate_bitwise(wire):
    """The port's streaming sdga (folds, then the step in PyTorch ops)
    equals its buffered sdga (one aggregate) bit for bit."""
    from repro_torch.kernels import ref as tref
    k = 4
    rng = np.random.default_rng(5)
    w = rng.uniform(0.2, 1.0, k).astype(np.float32)
    p, m, e = _t(*_slow_state(5))
    if wire == "q8":
        q, s = _t(*_q8_rows(k, seed=6))
        acc = torch.zeros(DQ_RAGGED)
        for i in range(k):
            tk.safl_fold_q8(acc, q[i], s[i], w[i], qblock=QB, out=acc)
        want = tk.sdga_aggregate_q8(q, s, torch.from_numpy(w), p, m, e,
                                    qblock=QB, discount="none", **SDGA_KW)
    else:
        u = torch.from_numpy(_rows(k, D_RAGGED, seed=6)[0])
        acc = torch.zeros(D_RAGGED)
        for i in range(k):
            tk.safl_fold(acc, u[i], w[i], out=acc)
        want = tk.sdga_aggregate(u, torch.from_numpy(w), p, m, e,
                                 discount="none", **SDGA_KW)
    wsum = np.float32(0.0)
    for x in w:
        wsum = np.float32(wsum + x)
    g = acc[:D_RAGGED] / torch.tensor(wsum)
    got = tref.sdga_step_from_mean(g, p, m, e, server_lr=0.3, momentum=0.8,
                                   ema_anchor=0.05, ema_decay=0.95)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_q8_fold_chain_equals_aggregate_bitwise():
    q, s = _t(*_q8_rows(5, seed=8))
    w = np.random.default_rng(8).uniform(0.5, 40.0, 5).astype(np.float32)
    acc = torch.zeros(DQ_RAGGED)
    for k in range(5):
        tk.safl_fold_q8(acc, q[k], s[k], w[k], qblock=QB, out=acc)
    agg = tk.safl_aggregate_q8(q, s, torch.from_numpy(w), mode="sum",
                               qblock=QB)
    assert torch.equal(acc, agg)


def test_new_kernels_cpu_calls_are_plain_and_not_counted():
    k = 3
    q, s = _t(*_q8_rows(k, seed=9))
    u = torch.from_numpy(_rows(k, D_RAGGED, seed=9)[0])
    w = torch.from_numpy(np.float32([0.5, 1.5, 2.0]))
    p, m, e = _t(*_slow_state(9))
    before = {n: f.launches for n, f in tk.KERNELS.items()}
    out = torch.zeros(DQ_RAGGED)
    assert tk.safl_fold_q8(out, q[0], s[0], 0.5, 0.75, out=out) is out
    assert torch.equal(out, tk.safl_fold_q8_plain(
        torch.zeros(DQ_RAGGED), q[0], s[0], 0.5, 0.75))
    for mode in tk.MODES:
        assert torch.equal(
            tk.safl_aggregate_q8(q, s, w, p, mode=mode, server_lr=0.3),
            tk.safl_aggregate_q8_plain(q, s, w, p, mode=mode,
                                       server_lr=0.3))
    for a, b in zip(tk.sdga_aggregate(u, w, p, m, e, **SDGA_KW),
                    tk.sdga_aggregate_plain(u, w, p, m, e, **SDGA_KW)):
        assert torch.equal(a, b)
    for a, b in zip(tk.sdga_aggregate_q8(q, s, w, p, m, e, **SDGA_KW),
                    tk.sdga_aggregate_q8_plain(q, s, w, p, m, e,
                                               **SDGA_KW)):
        assert torch.equal(a, b)
    assert {n: f.launches for n, f in tk.KERNELS.items()} == before
    assert set(before.values()) == {0}


# ---------------------------------------------------------------------------
# screen_rows and screen_rows_q8 (the defense's sums of squares)
# ---------------------------------------------------------------------------

POISONS = ("clean", "corrupt", "byzantine", "zero")


def _poison_masks(k, poison):
    corrupt = [poison == "corrupt" and i % 2 == 0 for i in range(k)]
    byz = [poison == "byzantine" and i % 2 == 1 for i in range(k)]
    locs = np.linspace(0.05, 0.95, k).astype(np.float32)
    return corrupt, byz, locs


def _screen_inputs(k, poison, seed):
    """K f32 rows and their q8 (q, scales), poisoned by the reference's
    appliers (corrupt: NaN/Inf lanes, or flipped bytes and an Inf scale;
    byzantine: x -10), or all zero."""
    u, _, _ = _rows(k, D_RAGGED, seed)
    q, s = _q8_rows(k, seed)
    if poison == "zero":
        return np.zeros_like(u), np.zeros_like(q), np.zeros_like(s)
    corrupt, byz, locs = _poison_masks(k, poison)
    u = np.asarray(jfaults.apply_faults_flat(u, corrupt, byz, locs, 10.0))
    q, s = jfaults.apply_faults_q(q, s, corrupt, byz, locs, 10.0)
    return u, np.asarray(q), np.asarray(s)


def _assert_sums(got, *wants):
    for want in wants:
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


@pytest.mark.parametrize("poison", POISONS)
@pytest.mark.parametrize("k", [1, 3, 4])
def test_screen_plain_matches_reference(k, poison):
    """Against the reference's oracles and its Pallas kernels (interpret
    mode): sums within rtol=1e-5, isfinite verdicts exact; each row alone
    equals the same row in the stack bitwise."""
    u, q, s = _screen_inputs(k, poison, seed=30 + k)
    got = tk.screen_rows_plain(*_t(u)).numpy()
    _assert_sums(got, jref.screen_sumsq_ref(u),
                 jk.screen_rows(u, interpret=True))
    got_q = tk.screen_rows_q8_plain(*_t(q, s), qblock=QB).numpy()
    _assert_sums(got_q, jref.screen_sumsq_q8_ref(q, s, QB),
                 jk.screen_rows_q8(q, s, qblock=QB, interpret=True))
    assert got.dtype == got_q.dtype == np.float32 and got.shape == (k,)
    if poison == "corrupt":
        assert not np.isfinite(got[0]) and not np.isfinite(got_q[0])
    if poison == "zero":
        assert not got.any() and not got_q.any()
    for i in range(k):
        alone = tk.screen_rows(*_t(u[i:i + 1])).numpy()
        alone_q = tk.screen_rows_q8(*_t(q[i:i + 1], s[i:i + 1]),
                                    qblock=QB).numpy()
        np.testing.assert_array_equal(alone.view(np.int32),
                                      got[i:i + 1].view(np.int32))
        np.testing.assert_array_equal(alone_q.view(np.int32),
                                      got_q[i:i + 1].view(np.int32))


def test_screen_q8_block_sums_are_exact():
    """sum q^2 over a 512-lane block is exact in int32 and in f32: the
    largest, 512 * 128^2 (flipped bytes reach -128), is below 2^24."""
    q = np.full((1, QB), -128, np.int8)
    s = np.ones((1, 1), np.float32)
    assert float(tk.screen_rows_q8(*_t(q, s), qblock=QB)[0]) == \
        float(QB * 128 ** 2)


def test_screen_cpu_calls_are_plain_and_not_counted():
    u, q, s = _screen_inputs(3, "corrupt", seed=40)
    before = {n: f.launches for n, f in tk.KERNELS.items()}
    # bit patterns: the corrupt rows' sums are NaN
    a, b = tk.screen_rows(*_t(u)), tk.screen_rows_plain(*_t(u))
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  b.numpy().view(np.int32))
    a = tk.screen_rows_q8(*_t(q, s), qblock=QB)
    b = tk.screen_rows_q8_plain(*_t(q, s), qblock=QB)
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  b.numpy().view(np.int32))
    assert {n: f.launches for n, f in tk.KERNELS.items()} == before
    assert before["screen_rows"] == before["screen_rows_q8"] == 0
    assert {"screen_rows", "screen_rows_q8"} <= set(tk.KERNELS)


def test_screen_q8_plain_rejects_a_ragged_row():
    q = torch.zeros((2, 700), dtype=torch.int8)
    with pytest.raises(ValueError):
        tk.screen_rows_q8_plain(q, torch.ones(2, 1), qblock=QB)


# ---------------------------------------------------------------------------
# the q4 wire: packed int4 rows
# ---------------------------------------------------------------------------


def _q4_rows(k, seed=0):
    """k rows quantized on the q4 grid by the reference (jitted, draws from
    the port's threefry): (packed int8 (k, Dq/2), scales (k, Dq/QB))."""
    from repro_torch import prng
    import jax
    u, _, _ = _rows(k, D_RAGGED, seed)
    x = np.zeros((k, DQ_RAGGED), np.float32)
    x[:, :D_RAGGED] = u
    draws = prng.uniform(prng.fold_in(prng.prng_key(seed), k),
                         (k * DQ_RAGGED // QB, QB))
    q, s = jax.jit(jref.quantize_q4_ref)(x.reshape(-1, QB), draws)
    return (np.asarray(jref.pack_q4_ref(q.reshape(k, DQ_RAGGED))),
            np.asarray(s).reshape(k, DQ_RAGGED // QB))


@pytest.mark.parametrize("beta", [1.0, 0.625])
def test_fold_q4_plain_matches_reference(beta):
    q, s = _q4_rows(1, seed=3)
    acc = np.random.default_rng(4).normal(size=DQ_RAGGED).astype(np.float32)
    w = np.float32(0.37)
    want = np.asarray(jk.safl_fold_q4(acc, q[0], s[0], w, beta, qblock=QB,
                                      interpret=True))
    oracle = np.asarray(jref.fold_q4_ref(acc, q[0], s[0], w, QB, beta))
    got = tk.safl_fold_q4_plain(*_t(acc, q[0], s[0]), w, beta,
                                qblock=QB).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("discount", ["none", "poly"])
@pytest.mark.parametrize("mode", ["fedsgd", "avg", "mix", "sum"])
def test_aggregate_q4_plain_matches_reference(mode, discount, k):
    q, s = _q4_rows(k, seed=60 + k)
    _, p, rng = _rows(1, D_RAGGED, seed=70 + k)
    w = _weights(rng, k, mode, discount)
    needs_p = mode in ("fedsgd", "mix")
    kw = dict(server_lr=0.3, mode=mode, alpha=0.5, discount=discount)
    want = np.asarray(jk.safl_aggregate_q4(
        q, s, w, p if needs_p else None, qblock=QB, interpret=True, **kw))
    got = tk.safl_aggregate_q4_plain(
        *_t(q, s, w), torch.from_numpy(p) if needs_p else None, qblock=QB,
        **kw).numpy()
    assert got.shape == ((D_RAGGED,) if needs_p else (DQ_RAGGED,))
    np.testing.assert_allclose(got, want, **TOL)
    if mode == "fedsgd":
        wd = np.power(1.0 + w, np.float32(-0.5)) if discount == "poly" \
            else w
        np.testing.assert_allclose(
            got, np.asarray(jref.safl_agg_q4_ref(q, s, wd, p, 0.3, QB)),
            **TOL)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("discount", ["none", "poly"])
def test_sdga_q4_plain_matches_reference(discount, k):
    q, s = _q4_rows(k, seed=80 + k)
    rng = np.random.default_rng(k + 2)
    w = _weights(rng, k, "avg", discount)
    p, m, e = _slow_state(k + 11)
    want = jk.sdga_aggregate_q4(q, s, w, p, m, e, qblock=QB, interpret=True,
                                discount=discount, **SDGA_KW)
    got = tk.sdga_aggregate_q4_plain(*_t(q, s, w, p, m, e), qblock=QB,
                                     discount=discount, **SDGA_KW)
    for g, wnt in zip(got, want):
        assert g.shape == (D_RAGGED,)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    if discount == "poly":
        oracle = jref.sdga_flat_q4_ref(q, s, w, p, m, e, qblock=QB,
                                       **SDGA_KW)
        for g, orc in zip(got, oracle):
            np.testing.assert_allclose(g.numpy(), np.asarray(orc), **TOL)


def test_q4_fold_chain_equals_aggregate_and_sdga_bitwise():
    """The port's streaming q4 channel (folds, then the step in PyTorch
    ops) equals its buffered one (one aggregate) bit for bit."""
    from repro_torch.kernels import ref as tref
    k = 4
    q, s = _t(*_q4_rows(k, seed=8))
    w = np.random.default_rng(8).uniform(0.2, 1.0, k).astype(np.float32)
    acc = torch.zeros(DQ_RAGGED)
    for i in range(k):
        tk.safl_fold_q4(acc, q[i], s[i], w[i], qblock=QB, out=acc)
    assert torch.equal(acc, tk.safl_aggregate_q4(
        q, s, torch.from_numpy(w), mode="sum", qblock=QB))
    p, m, e = _t(*_slow_state(8))
    want = tk.sdga_aggregate_q4(q, s, torch.from_numpy(w), p, m, e,
                                qblock=QB, discount="none", **SDGA_KW)
    wsum = np.float32(0.0)
    for x in w:
        wsum = np.float32(wsum + x)
    g = acc[:D_RAGGED] / torch.tensor(wsum)
    got = tref.sdga_step_from_mean(g, p, m, e, server_lr=0.3, momentum=0.8,
                                   ema_anchor=0.05, ema_decay=0.95)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _screen_q4_inputs(k, poison, seed):
    """K packed q4 rows poisoned by the reference's appliers (corrupt:
    64 flipped bytes, 128 lanes, and an Inf scale; byzantine: scales
    x -10), or all zero."""
    q, s = _q4_rows(k, seed)
    if poison == "zero":
        return np.zeros_like(q), np.zeros_like(s)
    corrupt, byz, locs = _poison_masks(k, poison)
    q, s = jfaults.apply_faults_q(q, s, corrupt, byz, locs, 10.0)
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("poison", POISONS)
@pytest.mark.parametrize("k", [1, 3, 4])
def test_screen_q4_plain_matches_reference(k, poison):
    """Bitwise equal to the port's oracle ``ref.screen_sumsq_q4_ref``;
    against the reference's oracle and its Pallas kernel: sums within
    rtol=1e-5, isfinite verdicts exact; each row alone equals the same
    row in the stack bitwise."""
    from repro_torch.kernels import ref as tref
    q, s = _screen_q4_inputs(k, poison, seed=90 + k)
    got = tk.screen_rows_q4_plain(*_t(q, s), qblock=QB).numpy()
    np.testing.assert_array_equal(
        got.view(np.int32),
        tref.screen_sumsq_q4_ref(*_t(q, s), QB).numpy().view(np.int32))
    _assert_sums(got, jref.screen_sumsq_q4_ref(q, s, QB),
                 jk.screen_rows_q4(q, s, qblock=QB, interpret=True))
    assert got.dtype == np.float32 and got.shape == (k,)
    if poison == "corrupt":
        assert not np.isfinite(got[0])
    if poison == "zero":
        assert not got.any()
    for i in range(k):
        alone = tk.screen_rows_q4(*_t(q[i:i + 1], s[i:i + 1]),
                                  qblock=QB).numpy()
        np.testing.assert_array_equal(alone.view(np.int32),
                                      got[i:i + 1].view(np.int32))


def test_screen_q4_counts_minus_eight():
    """A byte 0x88 holds two -8 nibbles: 64 each, 512 * 64 per block."""
    q = np.full((1, QB // 2), -120, np.int8)  # 0x88
    s = np.ones((1, 1), np.float32)
    assert float(tk.screen_rows_q4(*_t(q, s), qblock=QB)[0]) == \
        float(QB * 64)


def test_q4_kernels_cpu_calls_are_plain_and_not_counted():
    k = 3
    q, s = _t(*_q4_rows(k, seed=9))
    w = torch.from_numpy(np.float32([0.5, 1.5, 2.0]))
    p, m, e = _t(*_slow_state(9))
    before = {n: f.launches for n, f in tk.KERNELS.items()}
    out = torch.zeros(DQ_RAGGED)
    assert tk.safl_fold_q4(out, q[0], s[0], 0.5, 0.75, out=out) is out
    assert torch.equal(out, tk.safl_fold_q4_plain(
        torch.zeros(DQ_RAGGED), q[0], s[0], 0.5, 0.75))
    for mode in tk.MODES:
        assert torch.equal(
            tk.safl_aggregate_q4(q, s, w, p, mode=mode, server_lr=0.3),
            tk.safl_aggregate_q4_plain(q, s, w, p, mode=mode,
                                       server_lr=0.3))
    for a, b in zip(tk.sdga_aggregate_q4(q, s, w, p, m, e, **SDGA_KW),
                    tk.sdga_aggregate_q4_plain(q, s, w, p, m, e,
                                               **SDGA_KW)):
        assert torch.equal(a, b)
    a = tk.screen_rows_q4(q, s, qblock=QB)
    b = tk.screen_rows_q4_plain(q, s, qblock=QB)
    np.testing.assert_array_equal(a.numpy().view(np.int32),
                                  b.numpy().view(np.int32))
    assert {n: f.launches for n, f in tk.KERNELS.items()} == before
    assert {"safl_fold_q4", "safl_aggregate_q4", "sdga_aggregate_q4",
            "screen_rows_q4"} <= set(tk.KERNELS)
    assert len(tk.KERNELS) == 14 and set(before.values()) == {0}
