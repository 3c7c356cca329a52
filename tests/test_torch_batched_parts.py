"""The horizon-batched engine's parts in the port against the
reference's, on the CPU:

  * ``write_rows`` (f32 buffer), ``QuantBuffer.write_rows`` (q8 and packed
    q4 rows) and ``TopkBuffer.write_rows``: a wave scattered into its
    slots, rows sent to slot K dropped, the untouched rows kept; equal
    to the reference's ``mode="drop"`` scatters bitwise;
    ``set_rows`` adopting a whole round and refusing a misfit;
  * the codec's row forms ``quantize_rows(_nores)``,
    ``quantize_rows_q4(_nores)`` (per-lane residual, client and counter,
    one seed) and ``quantize_rows_topk(_nores)``: bitwise the reference's
    jitted row programs and, row by row, the port's per-upload codec;
  * ``DeviceMetricsRing``: growth past its capacity, and the flush equal
    to the rows appended and to the reference's ring fed the same values;
  * ``resolve_wave_impl`` / ``model_has_conv``, the codec's row ravel /
    unravel, and the wave training calls: a ``map`` wave bitwise K
    sequential local epochs, the sync round bitwise its wave from the
    broadcast global row, and a ``vmap`` wave within ``rtol=1e-5,
    atol=1e-6`` of the reference's batched programs on the same rows
    (``atol=2e-5`` on the grad target: the params' over lr = 0.05).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import client as jclient  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.data import build_client_shards, make_dataset  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core import flatbuf as tflatbuf  # noqa: E402
from repro_torch.core import metrics as tmetrics  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402

QB = 64
K = 3


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    t = {"c1": rng.normal(size=(3, 3, 2, 4)), "b1": rng.normal(size=(37,)),
         "f1": rng.normal(size=(29, 5))}
    return {k: v.astype(np.float32) for k, v in t.items()}



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch ops on one thread.  Its wave calls run a width-4
    CNN whose ops a thread pool only slows, and far more so when other
    test processes share the cores (each pool takes all of them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def codecs():
    tree = _tree()
    j = jflatbuf.PytreeCodec({k: jnp.asarray(v) for k, v in tree.items()},
                             qblock=QB, topk_frac=0.2)
    t = tflatbuf.PytreeCodec({k: torch.from_numpy(v)
                              for k, v in tree.items()}, qblock=QB,
                             topk_frac=0.2)
    assert (j.d, j.dq, j.nk) == (t.d, t.dq, t.nk)
    return j, t


def _rows(codec, k, seed):
    rng = np.random.default_rng(seed)
    vecs = (rng.normal(size=(k, codec.d)) * 0.1).astype(np.float32)
    vecs[1, :5] = 0.0  # ties at zero for the top-k ranking
    res = (rng.normal(size=(k, codec.dq)) * 1e-3).astype(np.float32)
    return vecs, res


def _same(got, want):
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("form", ["q8", "q8_nores", "q4", "q4_nores",
                                  "topk", "topk_nores"])
def test_codec_row_forms_bitwise_reference_and_per_row(codecs, form):
    j, t = codecs
    vecs, res = _rows(t, 5, seed=len(form))
    tv, tr = torch.from_numpy(vecs), torch.from_numpy(res)
    cids, ctrs, seed = [4, 1, 4, 0, 2], [0, 3, 1, 7, 2], 11
    if form.startswith("q4"):
        jc, jn = jnp.asarray(cids, jnp.int32), jnp.asarray(ctrs, jnp.int32)
        if form == "q4":
            want = j.quantize_rows_q4(jnp.asarray(vecs), jnp.asarray(res),
                                      seed, jc, jn)
            got = t.quantize_rows_q4(tv, tr, seed, cids, ctrs)
            rows = [t._quantize_q4(tv[i], tr[i], seed, cids[i], ctrs[i])
                    for i in range(5)]
        else:
            want = j.quantize_rows_q4_nores(jnp.asarray(vecs), seed, jc, jn)
            got = t.quantize_rows_q4_nores(tv, seed, cids, ctrs)
            rows = [t._quantize_q4_nores(tv[i], seed, cids[i], ctrs[i])
                    for i in range(5)]
    else:
        kind = "" if form.startswith("q8") else "_topk"
        nores = form.endswith("nores")
        jfn = getattr(j, f"quantize_rows{kind}{'_nores' if nores else ''}")
        tfn = getattr(t, f"quantize_rows{kind}{'_nores' if nores else ''}")
        per = {"": (t._quantize_nores if nores else t._quantize),
               "_topk": (t._topk_nores if nores else t._topk)}[kind]
        if nores:
            want, got = jfn(jnp.asarray(vecs)), tfn(tv)
            rows = [per(tv[i]) for i in range(5)]
        else:
            want = jfn(jnp.asarray(vecs), jnp.asarray(res))
            got = tfn(tv, tr)
            rows = [per(tv[i], tr[i]) for i in range(5)]
    _same([g.numpy() for g in got], want)
    for i, row in enumerate(rows):
        _same([g[i].numpy() for g in got], [r.numpy() for r in row])


def _slots():
    # a wave of 4 lanes: two slots out of order, two rows to slot K
    # (dropped, as the reference's padding lanes are)
    return np.asarray([2, 0, K, K], np.int32)


def test_write_rows_f32_drop_mode(codecs):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(K, 50)).astype(np.float32)
    rows = rng.normal(size=(4, 50)).astype(np.float32)
    want = jflatbuf.write_rows(jnp.asarray(base), jnp.asarray(rows),
                               jnp.asarray(_slots()))
    buf = torch.from_numpy(base.copy())
    tflatbuf.write_rows(buf, torch.from_numpy(rows), _slots())
    _same([buf.numpy()], [want])
    np.testing.assert_array_equal(buf[1].numpy(), base[1])
    # every slot dropped: nothing written
    tflatbuf.write_rows(buf, torch.from_numpy(rows), [K, K + 1, K, K])
    _same([buf.numpy()], [want])


@pytest.mark.parametrize("packed", [False, True])
def test_quant_buffer_write_rows_drop_mode(packed):
    d = 300
    jb = jflatbuf.QuantBuffer(K, d, QB, packed=packed)
    tb = tflatbuf.QuantBuffer(K, d, QB, device="cpu", packed=packed)
    rng = np.random.default_rng(4)
    q = rng.integers(-128, 128, (4,) + tuple(tb.q.shape[1:])).astype(
        np.int8)
    s = rng.uniform(0.1, 2.0, (4, tb.n_qblocks)).astype(np.float32)
    jb.write_rows(jnp.asarray(q), jnp.asarray(s), _slots())
    tb.write_rows(torch.from_numpy(q), torch.from_numpy(s), _slots())
    _same([tb.q.numpy(), tb.scales.numpy()], [jb.q, jb.scales])
    assert not tb.q[1].any() and not tb.scales[1].any()
    tb.set_rows(torch.from_numpy(q[:K].copy()), torch.from_numpy(s[:K]))
    assert torch.equal(tb.q, torch.from_numpy(q[:K]))
    with pytest.raises(ValueError):
        tb.set_rows(torch.from_numpy(q), torch.from_numpy(s))


def test_topk_buffer_write_rows_drop_mode():
    d, nk = 500, 128
    jb = jflatbuf.TopkBuffer(K, d, nk, QB)
    tb = tflatbuf.TopkBuffer(K, d, nk, QB, device="cpu")
    rng = np.random.default_rng(5)
    idx = rng.integers(0, d, (4, nk)).astype(np.int32)
    qv = rng.integers(-127, 128, (4, nk)).astype(np.int8)
    s = rng.uniform(0.1, 2.0, (4, nk // QB)).astype(np.float32)
    jb.write_rows(jnp.asarray(idx), jnp.asarray(qv), jnp.asarray(s),
                  _slots())
    tb.write_rows(torch.from_numpy(idx), torch.from_numpy(qv),
                  torch.from_numpy(s), _slots())
    _same([tb.idx.numpy(), tb.qv.numpy(), tb.scales.numpy()],
          [jb.idx, jb.qv, jb.scales])
    # the untouched row stays empty: index d everywhere
    assert (tb.idx[1] == d).all()
    with pytest.raises(ValueError):
        tb.set_rows(torch.from_numpy(idx), torch.from_numpy(qv),
                    torch.from_numpy(s))


def test_metrics_ring_grows_and_flushes_per_round_records():
    rng = np.random.default_rng(6)
    rounds = rng.normal(size=(11, 5)).astype(np.float32)
    ring = tmetrics.DeviceMetricsRing(4, channels=5, device="cpu")
    jring = jmetrics.DeviceMetricsRing(4, channels=5)
    for row in rounds:
        # device scalars and host numbers alike
        ring.append(torch.tensor(row[0]), torch.tensor(row[1]),
                    torch.tensor(row[2]), np.float32(row[3]), float(row[4]))
        jring.append(*[jnp.float32(v) for v in row])
    assert len(ring) == 11 and ring.capacity >= 11
    np.testing.assert_array_equal(ring.flush(), rounds)
    np.testing.assert_array_equal(ring.flush(), np.asarray(jring.flush()))
    with pytest.raises(ValueError):
        ring.append(1.0)


# ---------------------------------------------------------------------------
# the wave training calls
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    ds = make_dataset("cifar10", n=160, seed=0, hw=8)
    shards = build_client_shards(ds, "hetero_dirichlet", 4, 16, seed=0,
                                 alpha=0.3)
    p_j, _ = jcnn.cnn_init(jax.random.PRNGKey(0), width=4, image_size=8)
    p_t = params_from_jax(jax.tree_util.tree_map(np.asarray, p_j), "cpu")
    codec = tflatbuf.PytreeCodec(p_t)
    bank = {f: torch.as_tensor(np.stack([s[f] for s in shards]))
            for f in ("xs", "ys", "mask")}
    bank["xs"] = bank["xs"].float()
    bank["ys"] = bank["ys"].long()
    bank["mask"] = bank["mask"].float()
    bank["valid"] = np.stack([s["mask"].max(axis=1) > 0 for s in shards])
    rng = np.random.default_rng(7)
    flat = codec.ravel(p_t)
    starts = torch.stack([flat + 0.01 * torch.from_numpy(
        rng.normal(size=codec.d).astype(np.float32)) for _ in range(3)])
    return shards, p_j, p_t, codec, bank, starts


@pytest.mark.parametrize("stride,padding,dilation", [
    (1, 1, 1), (2, 1, 1), (1, (0, 2), 2), ((2, 1), 0, (1, 2))])
def test_gemm_conv_matches_conv2d(stride, padding, dilation):
    """The vmapped wave's convolution (unfold + matmul) against
    ``F.conv2d``: output and input / weight / bias gradients."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 9, 8, generator=g, requires_grad=True)
    w = torch.randn(5, 3, 3, 3, generator=g, requires_grad=True)
    b = torch.randn(5, generator=g, requires_grad=True)
    kw = dict(stride=stride, padding=padding, dilation=dilation)
    got = tclient._conv2d_gemm(x, w, b, **kw)
    want = torch.nn.functional.conv2d(x, w, b, **kw)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(got.square().sum(), (x, w, b))
    wgrads = torch.autograd.grad(want.square().sum(), (x, w, b))
    for a, e in zip(grads, wgrads):
        torch.testing.assert_close(a, e, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError):
        tclient._conv2d_gemm(x, w.reshape(5, 3, 3, 3)[:, :1], groups=3)


def test_resolve_wave_impl(model):
    _, _, p_t, _, bank, _ = model
    x = bank["xs"][0, 0, :1]
    assert tclient.model_has_conv(tcnn.cnn_apply, p_t, {}, x)
    assert tclient.resolve_wave_impl("auto", tcnn.cnn_apply, p_t, {},
                                     x) == "map"
    for impl in ("map", "vmap"):
        assert tclient.resolve_wave_impl(impl, tcnn.cnn_apply, p_t, {},
                                         x) == impl

    def dense(params, state, xb, train):
        return xb.reshape(xb.shape[0], -1)[:, :10], state

    assert not tclient.model_has_conv(dense, p_t, {}, x)
    assert tclient.resolve_wave_impl("auto", dense, p_t, {}, x) == "vmap"
    with pytest.raises(ValueError):
        tclient.resolve_wave_impl("scan", tcnn.cnn_apply, p_t, {}, x)


def test_codec_row_ravel_unravel(model):
    _, _, p_t, codec, _, starts = model
    trees = codec.unravel_rows(starts)
    assert {k: tuple(v.shape) for k, v in trees.items()} == \
        {k: (3,) + tuple(v.shape) for k, v in p_t.items()}
    assert torch.equal(codec.ravel_rows(trees), starts)
    for i in range(3):
        one = codec.unravel(starts[i])
        assert all(torch.equal(trees[k][i], one[k]) for k in one)


@pytest.mark.parametrize("target", ["grad", "params"])
def test_map_wave_bitwise_sequential_epochs(model, target):
    _, _, _, codec, bank, starts = model
    fn = tclient.make_batched_hetero_train(tcnn.cnn_apply, "image", target,
                                           2, codec, impl="map")
    idx = [2, 0, 2]  # a client twice: each lane gathers its own shard
    vecs, new_flat, _, losses = fn(starts, {}, bank, idx, 0.05)
    loss_fn = tclient.make_loss_fn(tcnn.cnn_apply, "image")
    for i, cid in enumerate(idx):
        p = codec.unravel(starts[i])
        for _ in range(2):
            p, _, loss = tclient.local_epoch(
                loss_fn, p, {}, bank["xs"][cid], bank["ys"][cid],
                bank["mask"][cid], bank["valid"][cid], 0.05)
        assert torch.equal(new_flat[i], codec.ravel(p))
        want = (codec.ravel_delta(codec.unravel(starts[i]), p, 0.05)
                if target == "grad" else codec.ravel(p))
        assert torch.equal(vecs[i], want)
        assert torch.equal(losses[i], loss)
    # the sync round: the same wave from the broadcast global row
    sync = tclient.make_batched_local_train(tcnn.cnn_apply, "image", target,
                                            2, codec, impl="map")
    svecs, _, _ = sync(starts[0], {}, bank, idx, 0.05)
    wvecs, _, _, _ = fn(starts[0].expand(3, codec.d), {}, bank, idx, 0.05)
    assert torch.equal(svecs, wvecs)


@pytest.mark.parametrize("target", ["grad", "params"])
def test_vmap_wave_close_to_reference(model, target):
    """The vmapped wave against the reference's ``make_batched_hetero_
    train`` (vmap) on the same rows and shards, and the sync round
    against its ``make_batched_local_train``."""
    shards, p_j, _, codec, bank, starts = model
    jcodec = jflatbuf.PytreeCodec(p_j)
    jbank = tuple(jnp.asarray(np.stack([s[f] for s in shards]))
                  for f in ("xs", "ys", "mask"))
    idx = [1, 3, 0]
    jfn = jclient.make_batched_hetero_train(jcnn.cnn_apply, "image", target,
                                            1, jcodec, impl="vmap")
    jv, jn, _, _ = jfn(jnp.asarray(starts.numpy()), {}, *jbank,
                       jnp.asarray(idx), 0.05)
    fn = tclient.make_batched_hetero_train(tcnn.cnn_apply, "image", target,
                                           1, codec, impl="vmap")
    tv, tn, _, _ = fn(starts, {}, bank, idx, 0.05)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-6)
    # the grad target is (start - end) / lr: the params' atol over lr 0.05
    # (the largest difference seen: 1.2e-6 on the grad, 6e-8 on params)
    tol = dict(rtol=1e-5, atol=2e-5 if target == "grad" else 1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    jsync = jclient.make_batched_local_train(jcnn.cnn_apply, "image",
                                             target, 1)
    sv, _, _ = jsync(p_j, {}, *(b[jnp.asarray(idx)] for b in jbank), 0.05)
    tsync = tclient.make_batched_local_train(tcnn.cnn_apply, "image",
                                             target, 1, codec, impl="vmap")
    tsv, _, _ = tsync(codec.ravel(params_from_jax(jax.tree_util.tree_map(
        np.asarray, p_j), "cpu")), {}, bank, idx, 0.05)
    np.testing.assert_allclose(tsv.numpy(), np.asarray(sv), **tol)


def test_flat_eval_equals_eval(model):
    _, _, p_t, codec, bank, _ = model
    ev = tclient.make_flat_eval_fn(tcnn.cnn_apply, "image", codec)
    x, y = bank["xs"][0, 0], bank["ys"][0, 0]
    got = ev(codec.ravel(p_t), {}, x, y)
    want = tclient.evaluate(tcnn.cnn_apply, "image", p_t, {}, x, y)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
