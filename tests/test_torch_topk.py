"""The sparse top-k wire, the int8 quantize pair and the pytree compression
helpers in the port against the reference, on the CPU:

  * the codec's top-k emit programs against the reference's jitted ones
    (bitwise: indices, int8 values, scales and error-feedback residual),
    on rows with planted ties (equal magnitudes of both signs, runs of
    zeros), and the sparse buffer's layout; the ranking's sort a branch
    point that ``models.kinks`` records and replays;
  * the plain versions of ``safl_fold_topk`` / ``safl_aggregate_topk``
    against the reference's oracles and its Pallas kernels in interpret
    mode (bitwise: every version adds the rows' terms in row order, and
    within a row each coordinate is hit once);
  * ``FlatServer(wire="topk")`` against the reference's in fedsgd,
    fedbuff, fedopt and sdga through both channels, the port's two
    channels bitwise;
  * the engine and ``fl_sim`` on ``wire="topk"`` against the reference's
    sequential engine, clean, under chaos + screen and under clip;
  * ``quantize_int8`` / ``dequantize_int8``'s plain versions against the
    reference's Pallas kernels in interpret mode (bitwise), and the
    pytree and top-k sparsification helpers.

Tolerances.  Server against the reference: ``rtol=1e-5, atol=1e-5`` (as
on the other wires; the sums agree bitwise, the Adam and SDGA steps'
PyTorch ops round like XLA's to an ulp).  Engine: bytes, staleness,
participation, simulated time and fault counts exact; params within the
q8 bounds, 1e-3 of the run's own movement with error feedback and 2e-2
without (a weight an ulp off can move a lane across the top-k cut or an
int8 rounding boundary).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import FLConfig as JConfig  # noqa: E402
from repro.core import FLEngine as JEngine  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.kernels import quantize as jquant  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import safl_agg as jk  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import FLEngine as TEngine  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import flatbuf as tflatbuf  # noqa: E402
from repro_torch.kernels import quantize as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import safl_agg as tk  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from test_torch_faults import (BYZ, CHAOS, COUNTS, _assert_engine_close,  # noqa: E402
                               _kw, _pair, _port, _record_norms)
from test_torch_modes import (KW, N_TEST, SLR, assert_host_exact,  # noqa: E402
                              assert_same_summary, fl_sim_pair,
                              flat_reference, run_pair, setup)  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
D, K, QB = 3001, 4, 512
GRAD_MODES = ["fedsgd", "fedbuff", "fedopt", "sdga"]


def _bits(x):
    x = np.asarray(x)
    return x.view({1: np.uint8, 4: np.uint32}[x.dtype.itemsize])


def _same(got, want):
    """Bitwise equal, dtype included."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _t(x):
    return torch.from_numpy(np.array(x))


def _tied_trees(seed=0):
    """A start/end pair whose delta (end - start) / 0.05 has planted ties:
    values on a coarse grid (equal magnitudes of both signs, many
    repeats) and a run of exact zeros."""
    rng = np.random.default_rng(seed)
    shapes = {"c1": (3, 3, 3, 4), "b1": (700,), "f1": (33, 41)}
    start = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
    delta = {k: np.round(rng.normal(size=s) * 4) / 4
             for k, s in shapes.items()}
    delta["b1"][:120] = 0.0
    delta["b1"][120:170] = -delta["b1"][170:220]
    end = {k: (start[k] - 0.05 * delta[k]).astype(np.float32)
           for k in start}
    return start, end


def _codecs(tree, qblock, frac):
    j = jflatbuf.PytreeCodec({k: jnp.asarray(v) for k, v in tree.items()},
                             qblock=qblock, topk_frac=frac)
    t = tflatbuf.PytreeCodec({k: _t(v) for k, v in tree.items()},
                             qblock=qblock, topk_frac=frac)
    return j, t


def _jt(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _tt(tree):
    return {k: _t(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qblock,frac", [(64, 0.1), (64, 0.5), (64, 1.0),
                                         (512, 0.1)])
def test_codec_topk_matches_jitted_reference_bitwise(qblock, frac):
    start, end = _tied_trees()
    jc, tc = _codecs(start, qblock, frac)
    assert (tc.d, tc.dq, tc.nk, tc.nk_qblocks) == \
        (jc.d, jc.dq, jc.nk, jc.nk_qblocks)
    res = (np.random.default_rng(1).normal(size=jc.dq) * 1e-3).astype(
        np.float32)
    cases = [
        (jc.ravel_delta_topk(_jt(start), _jt(end), 0.05, jnp.asarray(res)),
         tc.ravel_delta_topk(_tt(start), _tt(end), 0.05, _t(res))),
        (jc.ravel_delta_topk_nores(_jt(start), _jt(end), 0.05),
         tc.ravel_delta_topk_nores(_tt(start), _tt(end), 0.05)),
        (jc.ravel_topk(_jt(end), jnp.asarray(res)),
         tc.ravel_topk(_tt(end), _t(res))),
    ]
    for want, got in cases:
        assert len(got) == len(want)
        assert tuple(got[0].shape) == (tc.nk,)
        for a, b in zip(want, got):
            _same(b, a)
    # the planted ties reach the cut: the ranking decides which of equal
    # magnitudes are kept and in which compacted block each value lands
    idx = cases[1][1][0].numpy()
    x = np.abs(tc.ravel_delta(_tt(start), _tt(end), 0.05).numpy())
    x = np.pad(x, (0, tc.dq - tc.d))
    assert len(np.unique(x[idx])) < len(idx) / 4
    # what the wire dropped is carried: dequant + residual = input
    q_idx, qv, s, new_res = cases[0][1]
    full = np.pad(tc.ravel_delta(_tt(start), _tt(end), 0.05).numpy(),
                  (0, tc.dq - tc.d)) + res
    back = new_res.numpy().copy()
    back[q_idx.numpy()] += tref.dequant_topk_ref(qv, s, qblock).numpy()
    np.testing.assert_allclose(back, full, rtol=1e-6, atol=1e-7)


def test_torch_topk_breaks_ties_otherwise():
    """Why the codec ranks with a stable sort: on tied magnitudes
    ``torch.topk`` keeps other indices, or orders them otherwise, than
    ``jax.lax.top_k``, which the stable descending sort reproduces."""
    start, end = _tied_trees()
    _, tc = _codecs(start, 64, 0.5)
    x = np.pad(tc.ravel_delta(_tt(start), _tt(end), 0.05).numpy(),
               (0, tc.dq - tc.d))
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(x)), tc.nk)
    got = torch.topk(_t(np.abs(x)), tc.nk).indices.numpy()
    assert not np.array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(tc._rank(_t(x)).numpy(), np.asarray(want))


def test_topk_ranking_replays_recorded_branch_points():
    """The ranking's sort is a branch point (``models.kinks``): two keys
    within rounding of each other swap between two f32 runs.  A run
    replaying a recorded run takes its permutation (the codec's kept
    lanes and their order), counts the lanes it ranked otherwise and
    their keys' distance; a run without a swap replays bitwise."""
    from repro_torch.models import kinks
    codec = tflatbuf.PytreeCodec({"w": torch.zeros(3001)}, qblock=64,
                                 topk_frac=0.1)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=codec.dq).astype(np.float32))
    rank = codec._rank(x)
    order = torch.sort(x.abs(), descending=True, stable=True).indices
    k = int(order[codec.nk - 1])  # the last lane kept
    j = int(order[codec.nk])  # the first lane dropped
    y = x.clone()
    y[j] = np.nextafter(np.float32(abs(x[k])), np.float32(np.inf)) \
        * np.sign(float(x[j]))
    rec = kinks.Record()
    with rec:
        want = codec._rank(x)
    assert torch.equal(want, rank) and len(rec.choices) == 1
    replay = kinks.Replay(rec.choices)
    with replay:
        got = codec._rank(y)
    assert torch.equal(got, rank) and replay.done
    assert not torch.equal(codec._rank(y), rank)  # y alone swaps k and j
    assert replay.flips == 2 and replay.margin < 1e-6
    replay = kinks.Replay(rec.choices)
    with replay:
        assert torch.equal(codec._rank(x), rank)
    assert replay.flips == 0


@pytest.mark.parametrize("d,frac,qblock", [(1, 0.1, 8), (3001, 0.1, 512),
                                           (3001, 1.0, 512), (4099, 0.37, 64),
                                           (2_154_730, 0.1, 512)])
def test_topk_sizing_matches_reference(d, frac, qblock):
    jc = jflatbuf.PytreeCodec({"w": jnp.zeros((d,))}, qblock=qblock,
                              topk_frac=frac)
    tc = tflatbuf.PytreeCodec({"w": torch.zeros(d)}, qblock=qblock,
                              topk_frac=frac)
    assert (tc.nk, tc.nk_qblocks) == (jc.nk, jc.nk_qblocks)
    assert tc.nk % qblock == 0 and tc.nk <= tc.dq


def test_topk_buffer_layout_matches_reference():
    jb = jflatbuf.TopkBuffer(3, 1100, 512, 256)
    tb = tflatbuf.TopkBuffer(3, 1100, 512, 256, device="cpu")
    for a, b in zip(tb.views, jb.views):
        _same(a, b)
    assert (tb.d, tb.nk, tb.nk_qblocks) == (1100, 512, 2)
    idx = torch.arange(512, dtype=torch.int32)
    qv = torch.arange(512).remainder(256).sub(128).to(torch.int8)
    s = torch.tensor([0.5, 0.25])
    tb.write(idx, qv, s, 1)
    assert torch.equal(tb.idx[1], idx) and torch.equal(tb.qv[1], qv)
    assert torch.equal(tb.scales[1], s)
    assert (tb.idx[[0, 2]] == 1100).all() and not tb.qv[[0, 2]].any()
    with pytest.raises(ValueError):
        tflatbuf.TopkBuffer(2, 100, 300, 256, device="cpu")


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------


def _sparse_rows(rng, k, d, nk, qblock, empty=()):
    """k sparse rows of the reference's codec math: the top-|x| nk lanes
    of random padded (dq,) rows (coordinate 5 the largest of every row
    and 6 of all but the last, so rows collide there; at nk near dq the
    ranking picks pad lanes >= d), int8-quantized by the jitted
    reference; rows in ``empty`` are the buffer's empty rows (idx == d,
    values and scales 0)."""
    dq = -(-d // qblock) * qblock
    x = np.zeros((k, dq), np.float32)
    x[:, :d] = rng.normal(size=(k, d))
    x[:, 5] = 50.0 + np.arange(k)
    x[:-1, 6] = -40.0
    _, idx = jax.lax.top_k(jnp.abs(jnp.asarray(x)), nk)
    vals = jnp.take_along_axis(jnp.asarray(x), idx, axis=1)
    q, s = jax.jit(jref.quantize_ref)(vals.reshape(-1, qblock))
    idx = np.array(idx, np.int32)
    q = np.array(q).reshape(k, nk)
    s = np.array(s).reshape(k, nk // qblock)
    for r in empty:
        idx[r], q[r], s[r] = d, 0, 0.0
    return idx, q, s


@pytest.mark.parametrize("beta", [1.0, 0.7])
@pytest.mark.parametrize("d,nk", [(D, 512), (4099, 4608)])
def test_fold_topk_plain_matches_reference_bitwise(d, nk, beta):
    rng = np.random.default_rng(d + nk)
    idx, q, s = _sparse_rows(rng, 1, d, nk, QB)
    acc = rng.normal(size=d).astype(np.float32)
    w = np.float32(0.37)
    want = jk.safl_fold_topk(jnp.asarray(acc), jnp.asarray(idx[0]),
                             jnp.asarray(q[0]), jnp.asarray(s[0]), w, beta,
                             qblock=QB, interpret=True)
    oracle = jref.fold_topk_ref(jnp.asarray(acc), jnp.asarray(idx[0]),
                                jnp.asarray(q[0]), jnp.asarray(s[0]), w, QB,
                                beta)
    got = tk.safl_fold_topk_plain(_t(acc), _t(idx[0]), _t(q[0]), _t(s[0]),
                                  w, beta, qblock=QB)
    _same(got, want)
    _same(got, oracle)
    if nk > d:  # pad lanes were ranked and dropped
        assert (idx[0] >= d).any()


@pytest.mark.parametrize("k", [1, 3, 4])
def test_aggregate_topk_plain_matches_reference_bitwise(k):
    rng = np.random.default_rng(k)
    idx, q, s = _sparse_rows(rng, k, 4099, 1024, QB,
                             empty=(1,) if k == 3 else ())
    if k > 1:  # coordinate 5 in every row
        assert (idx == 5).any(axis=1).sum() == k - (k == 3)
    w = rng.uniform(0.2, 2.0, k).astype(np.float32)
    want = jk.safl_aggregate_topk(jnp.asarray(idx), jnp.asarray(q),
                                  jnp.asarray(s), jnp.asarray(w), 4099,
                                  qblock=QB, interpret=True)
    oracle = jref.topk_weighted_sum_ref(jnp.asarray(idx), jnp.asarray(q),
                                        jnp.asarray(s), jnp.asarray(w), 4099,
                                        QB)
    got = tk.safl_aggregate_topk_plain(_t(idx), _t(q), _t(s), _t(w), 4099,
                                       qblock=QB)
    _same(got, want)
    _same(got, oracle)
    # and the port's own oracle copies
    _same(tref.topk_weighted_sum_ref(_t(idx), _t(q), _t(s), w, 4099, QB),
          oracle)
    p = rng.normal(size=4099).astype(np.float32)
    np.testing.assert_allclose(
        tref.safl_agg_topk_ref(_t(idx), _t(q), _t(s), w, _t(p), 0.05,
                               QB).numpy(),
        np.asarray(jref.safl_agg_topk_ref(
            jnp.asarray(idx), jnp.asarray(q), jnp.asarray(s),
            jnp.asarray(w), jnp.asarray(p), 0.05, QB)), rtol=1e-6, atol=1e-7)


def test_topk_fold_chain_equals_aggregate_bitwise():
    """The streaming channel (K in-place folds from zeros) equals the
    buffered one (one K-row sum), with rows colliding on coordinates."""
    rng = np.random.default_rng(9)
    idx, q, s = _sparse_rows(rng, 5, D, 1024, QB, empty=(2,))
    w = rng.uniform(0.5, 40.0, 5).astype(np.float32)
    acc = torch.zeros(D)
    for r in range(5):
        tk.safl_fold_topk(acc, _t(idx[r]), _t(q[r]), _t(s[r]), w[r],
                          out=acc)
    agg = tk.safl_aggregate_topk(_t(idx), _t(q), _t(s), _t(w), D)
    assert torch.equal(acc, agg)


def test_topk_kernels_cpu_calls_are_plain_and_not_counted():
    rng = np.random.default_rng(4)
    idx, q, s = _sparse_rows(rng, 3, 777, 512, QB)
    acc = _t(rng.normal(size=777).astype(np.float32))
    w = _t(rng.uniform(0.5, 2.0, 3).astype(np.float32))
    before = {n: f.launches for n, f in tk.KERNELS.items()}
    for beta in (1.0, 0.5):
        assert torch.equal(
            tk.safl_fold_topk(acc, _t(idx[0]), _t(q[0]), _t(s[0]), 0.3, beta),
            tk.safl_fold_topk_plain(acc, _t(idx[0]), _t(q[0]), _t(s[0]), 0.3,
                                    beta))
    out = acc.clone()
    assert tk.safl_fold_topk(out, _t(idx[1]), _t(q[1]), _t(s[1]), 0.3,
                             out=out) is out
    assert torch.equal(out, tk.safl_fold_topk_plain(
        acc, _t(idx[1]), _t(q[1]), _t(s[1]), 0.3))
    assert torch.equal(tk.safl_aggregate_topk(_t(idx), _t(q), _t(s), w, 777),
                       tk.safl_aggregate_topk_plain(_t(idx), _t(q), _t(s), w,
                                                    777))
    assert {n: f.launches for n, f in tk.KERNELS.items()} == before
    assert {"safl_fold_topk", "safl_aggregate_topk"} <= set(tk.KERNELS)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _servers(mode):
    kw = dict(server_lr=SLR.get(mode, 1.0), momentum=0.8, ema_anchor=0.05)
    j = jagg.FlatServer(mode, D, backend="xla", external_discount=True,
                        fedasync_rates=True, wire="topk", qblock=QB, **kw)
    t = tagg.FlatServer(mode, D, wire="topk", qblock=QB, device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("mode", GRAD_MODES)
def test_server_topk_matches_reference_both_channels(mode):
    """Two rounds through each channel of both servers (K = 4 rows, one of
    them empty in the second round): the port against the reference to
    tolerance, the port's two channels bitwise."""
    rng = np.random.default_rng(GRAD_MODES.index(mode))
    js, ts = _servers(mode)
    assert ts.bank_width == D
    params = rng.normal(size=D).astype(np.float32)
    jp = {c: jnp.asarray(params) for c in ("buf", "str")}
    tp = {c: _t(params) for c in ("buf", "str")}
    jo = {c: js.init_opt(jp[c]) for c in jp}
    to = {c: ts.init_opt(tp[c]) for c in tp}
    for rnd in range(2):
        idx, q, s = _sparse_rows(rng, K, D, 512, QB,
                                 empty=(2,) if rnd else ())
        tau = rng.integers(0, 5, K).astype(np.float32)
        w = (np.ones(K, np.float32) if mode == "fedsgd" else np.asarray(
            np.power(tau + 1.0, -np.float32(0.5)), np.float32))
        # the reference: one step, and K folds + finalize
        jp["buf"], jo["buf"], jm = js.step(
            jp["buf"], (jnp.asarray(idx), jnp.asarray(q), jnp.asarray(s)),
            jnp.asarray(w), jo["buf"])
        bank = jnp.zeros((1, D), jnp.float32)
        for r in range(K):
            bank = js.fold_program(bank, jnp.asarray(idx[r]),
                                   jnp.asarray(q[r]), jnp.asarray(s[r]),
                                   jnp.int32(0), jnp.float32(w[r]),
                                   jnp.float32(1.0))
        jp["str"], jo["str"], _, _ = js.finalize(jp["str"], bank, w,
                                                 jo["str"])
        # the port: TopkBuffer rows + step, and AccumBuffer folds
        buf = tflatbuf.TopkBuffer(K, D, 512, QB, device="cpu")
        acc = tflatbuf.AccumBuffer(ts.bank_width, ts.fold_program, "cpu")
        for r in range(K):
            buf.write(_t(idx[r]), _t(q[r]), _t(s[r]), r)
            acc.fold((_t(idx[r]), _t(q[r]), _t(s[r])), w=w[r])
        tp["buf"], to["buf"], tm = ts.step(tp["buf"], buf.views, w,
                                           to["buf"])
        b, wvec, stats = acc.seal()
        tp["str"], to["str"], _, zeroed = ts.finalize(tp["str"], b, wvec,
                                                      to["str"])
        assert not zeroed.any()
        assert torch.equal(tp["buf"], tp["str"])
        for key in to["buf"]:
            if key == "step":
                assert to["buf"][key] == to["str"][key] == rnd + 1
            else:
                assert torch.equal(to["buf"][key], to["str"][key])
        for c in ("buf", "str"):
            np.testing.assert_allclose(tp[c].numpy(), np.asarray(jp[c]),
                                       **TOL)
        np.testing.assert_allclose(float(tm["weight_sum"]),
                                   float(jm["weight_sum"]), rtol=1e-6)


def test_server_topk_screen_traffic_and_empty_rows():
    """The screen reads the values and scales (a row with an Inf scale is
    non-finite), the traffic unit is the (d,) partial, and a zeroed
    scale row adds nothing."""
    _, ts = _servers("fedbuff")
    js, _ = _servers("fedbuff")
    assert ts.traffic == {k: (tuple(v) if isinstance(v, tuple) else v)
                          for k, v in js.traffic.items()}
    assert ts.traffic["cross_edge_bytes"] == 4 * D + 4
    rng = np.random.default_rng(3)
    idx, q, s = _sparse_rows(rng, 3, D, 512, QB)
    s[1, 0] = np.inf
    want = np.asarray(js.screen((jnp.asarray(idx), jnp.asarray(q),
                                 jnp.asarray(s))))
    got = ts.screen((_t(idx), _t(q), _t(s))).numpy()
    np.testing.assert_array_equal(np.isfinite(got), [True, False, True])
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-5)
    zero = tk.safl_aggregate_topk(_t(idx), _t(q), _t(np.zeros_like(s)),
                                  torch.ones(3), D)
    assert not zero.any()


# ---------------------------------------------------------------------------
# the engine, against the reference's sequential engine
# ---------------------------------------------------------------------------


def _assert_topk_params_close(teng, jres, p_j, ef=True):
    ref = flat_reference(jres)
    p0 = np.concatenate([np.asarray(p_j[k]).ravel() for k in sorted(p_j)])
    rel = np.linalg.norm(teng._flat_params.numpy() - ref) / \
        np.linalg.norm(ref - p0)
    assert rel <= (1e-3 if ef else 2e-2), rel


@pytest.mark.parametrize("setting,agg", [("SS", "fedsgd"), ("AS", "fedsgd"),
                                         ("AS", "fedbuff"), ("SS", "sdga"),
                                         ("AS", "sdga"), ("AS", "fedopt")])
def test_engine_topk_matches_reference(setup, setting, agg):
    jeng, jres, teng, tres = run_pair(setup, setting, wire="topk",
                                      aggregation=agg)
    assert_host_exact(jeng, jres, teng, tres)
    assert teng._server.wire == "topk" and teng.codec.nk == jeng.codec.nk
    assert set(teng._residuals) == set(jeng._residuals)
    for cid, res in teng._residuals.items():
        assert res.shape == (teng.codec.dq,)
    _assert_topk_params_close(teng, jres, setup[2])


def test_engine_topk_without_error_feedback_matches_reference(setup):
    jeng, jres, teng, tres = run_pair(setup, "AS", wire="topk",
                                      error_feedback=False, topk_frac=0.3)
    assert_host_exact(jeng, jres, teng, tres)
    assert not teng._residuals
    _assert_topk_params_close(teng, jres, setup[2], ef=False)


def _engine(setup, **kw):
    shards, te, p_j, _ = setup
    cfg = dataclasses.replace(tpaper.MODES["AS"], batch_clients=False,
                              **KW, **kw)
    cfg = dataclasses.replace(cfg, server_lr=SLR.get(cfg.aggregation, 1.0))
    return TEngine(cfg, tcnn.cnn_apply, "image",
                   params_from_jax(jax.tree_util.tree_map(np.asarray, p_j),
                                   "cpu"), {}, shards, te.x[:N_TEST],
                   te.y[:N_TEST], device="cpu")


@pytest.mark.parametrize("agg", ["fedsgd", "sdga"])
def test_engine_topk_channels_bitwise(setup, agg):
    """AS on topk: the streaming channel equals the buffered one bit for
    bit."""
    flats = []
    for channel in ("streaming", "buffered"):
        eng = _engine(setup, wire="topk", aggregation=agg,
                      server_channel=channel)
        eng.run(3)
        flats.append(eng._flat_params)
    assert torch.equal(flats[0], flats[1])


def test_engine_topk_upload_bytes_and_refusals(setup):
    e32, etk = _engine(setup), _engine(setup, wire="topk")
    assert etk._upload_nbytes() == int(
        (etk.codec.nk * 5 + etk.codec.nk_qblocks * 4) * 1.002)
    assert e32._upload_nbytes() / etk._upload_nbytes() > 1.5
    for agg in ("fedavg", "fedasync"):
        with pytest.raises(AssertionError, match="gradient-only"):
            _engine(setup, wire="topk", aggregation=agg)


@pytest.fixture(scope="module")
def fsetup():
    """The fault tests' setup (``test_torch_faults.py``): width-4 CNN on
    16x16 images, 6 iid clients."""
    ds = make_dataset("cifar10", n=240, seed=0, hw=16)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "iid", n_clients=6, batch_size=16)
    p_j, s_j = jcnn.cnn_init(jax.random.PRNGKey(0), width=4, image_size=16)
    return shards, te, p_j, s_j


@pytest.mark.parametrize("agg", ["fedsgd", "sdga"])
def test_engine_topk_chaos_screen_matches_reference(fsetup, agg):
    """Corrupt uploads flip value bytes and set an Inf scale (never an
    index): the screen drops exactly them."""
    jeng, jres, teng, tres = _pair(fsetup, agg, wire="topk",
                                   defense="screen", **CHAOS)
    _assert_engine_close(jeng, jres, teng, tres, agg, "topk", fsetup[2])
    st = tres.sched_stats
    assert st["crashed_uploads"] > 0 and st["corrupted_uploads"] > 0
    assert st["screened_uploads"] == st["corrupted_uploads"]


def test_engine_topk_byzantine_clip_matches_reference(fsetup):
    eng = _port(fsetup, "fedbuff", wire="topk", defense="screen")
    norms = _record_norms(eng)
    eng.run(1)
    cap = float(3.0 * np.median(norms))
    kw = dict(wire="topk", defense="clip", defense_norm_cap=cap, **BYZ)
    shards, te, p_j, s_j = fsetup
    jeng = JEngine(JConfig(batch_clients=False, **_kw("fedbuff", **kw)),
                   jcnn.cnn_apply, "image", p_j, s_j, shards,
                   te.x[:N_TEST], te.y[:N_TEST])
    jres = jeng.run(4)
    teng = _port(fsetup, "fedbuff", **kw)
    tres = teng.run(4)
    _assert_engine_close(jeng, jres, teng, tres, "fedbuff", "topk", p_j)
    st = tres.sched_stats
    assert st["byzantine_uploads"] > 0
    assert st["clipped_uploads"] >= st["byzantine_uploads"]
    assert {k: st[k] for k in COUNTS} == \
        {k: jres.sched_stats[k] for k in COUNTS}


@pytest.mark.parametrize("mode,agg,frac", [("sync", "sdga", "0.1"),
                                           ("semi_async", "fedsgd", "0.25")])
def test_fl_sim_topk_summary_matches_reference(tmp_path, monkeypatch, capsys,
                                               mode, agg, frac):
    j, t = fl_sim_pair(tmp_path, monkeypatch, capsys,
                       ["--rounds", "2", "--samples", "240", "--clients",
                        "5", "--k", "2", "--mode", mode, "--aggregation",
                        agg, "--wire", "topk", "--topk-frac", frac])
    assert_same_summary(j, t)


# ---------------------------------------------------------------------------
# int8 quantize / dequantize and the compression helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1.0, 300.0])
def test_quantize_int8_plain_matches_pallas_bitwise(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 1000)
    x = (rng.normal(size=(37, 512)) * scale).astype(np.float32)
    x[3] = 0.0  # an all-zero row takes the 1e-12 floor
    x[5, ::7] = np.float32(127.5) * np.float32(scale)  # exact .5 ties
    x[6, 1:] = np.float32(0.5) * np.float32(scale)
    x[6, 0] = np.float32(127.0) * np.float32(scale)
    qj, sj = jquant.quantize_int8(jnp.asarray(x), interpret=True)
    qt, st = tquant.quantize_int8(_t(x))
    _same(qt, qj)
    _same(st, sj)
    assert float(st[3]) == float(np.float32(1e-12))
    back = jquant.dequantize_int8(qj, sj, interpret=True)
    _same(tquant.dequantize_int8(qt, st), back)


def test_quantize_int8_scale_is_the_kernels_not_the_eager_oracles():
    """The Pallas kernel's scale is absmax * f32(1/127); the eager ``xla``
    fallback divides and differs on some rows."""
    x = np.random.default_rng(2).normal(size=(2000, 64)).astype(np.float32)
    _, sp = jquant.quantize_int8(jnp.asarray(x), interpret=True)
    _, se = jref.quantize_ref(jnp.asarray(x))
    _, st = tquant.quantize_int8(_t(x))
    _same(st, sp)
    assert (np.asarray(se) != np.asarray(sp)).sum() > 10


def test_quantize_pytree_bytes_and_roundtrip_match_reference():
    rng = np.random.default_rng(5)
    tree = {"c1": rng.normal(size=(3, 3, 3, 4)), "f1": rng.normal(
        size=(33, 41)), "b": {"x": rng.normal(size=(700,))}}
    tree = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()}
                if isinstance(v, dict) else v.astype(np.float32))
            for k, v in tree.items()}
    ttree = {"c1": _t(tree["c1"]), "f1": _t(tree["f1"]),
             "b": {"x": _t(tree["b"]["x"])}}
    jq, jbytes = jquant.quantize_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                               tree))
    tq, tbytes = tquant.quantize_pytree(ttree)
    assert tbytes == jbytes
    for k in ("c1", "f1"):
        _same(tq[k][0], jq[k][0])
        _same(tq[k][1], jq[k][1])
        assert tq[k][2] == tuple(jq[k][2])
    back_j = jquant.dequantize_pytree(jq)
    back_t = tquant.dequantize_pytree(tq)
    for k in ("c1", "f1"):
        _same(back_t[k], back_j[k])
    _same(back_t["b"]["x"], back_j["b"]["x"])


def test_topk_sparsify_restore_and_bytes_match_reference():
    start, end = _tied_trees(3)
    x = (end["f1"] - start["f1"]) / np.float32(0.05)
    for frac in (0.05, 0.3):
        jv, ji, jshape = jquant.topk_sparsify(jnp.asarray(x), frac)
        tv, ti, tshape = tquant.topk_sparsify(_t(x), frac)
        _same(ti, ji)
        _same(tv, jv)
        assert tshape == tuple(jshape)
        _same(tquant.topk_restore(tv, ti, tshape),
              jquant.topk_restore(jv, ji, jshape))
        assert tquant.topk_bytes(tv, ti) == jquant.topk_bytes(jv, ji)


def test_int8_kernels_cpu_calls_are_plain_and_not_counted():
    x = _t(np.random.default_rng(6).normal(size=(9, 64)).astype(np.float32))
    before = {n: f.launches for n, f in tquant.KERNELS.items()}
    q, s = tquant.quantize_int8(x)
    pq, ps = tquant.quantize_int8_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert torch.equal(tquant.dequantize_int8(q, s),
                       tquant.dequantize_int8_plain(q, s))
    assert {n: f.launches for n, f in tquant.KERNELS.items()} == before
    assert set(tquant.KERNELS) == {"quantize_int8", "dequantize_int8"}
