"""repro_torch's ResNet-18, VGG-16 and LSTM (both task heads), its pytree
helpers and the nested codec, against repro on the same inputs (numpy
from a seed) and on parameters carried across from JAX.

Tolerances: ``rtol=1e-5, atol=1e-6`` for the forward pass, the new
BatchNorm state and one SGD step.  ResNet-18's logits in *training* mode
are held to ``rtol=1e-5, atol=1e-5 * max|logits|``: each train-mode
BatchNorm normalizes by its batch's statistics, whose f32 sums XLA takes
one element after another and PyTorch pairwise, so every one of the 20
BatchNorms adds a few ulp relative to its output's spread (at batch 8 the
logits differ by up to 9.2e-6 on a largest logit of 3.0; eval mode, on
the running statistics, stays within the forward tolerance).  Inits from
``prng_key(0)`` are held bitwise (0 ulp; the normal draws take XLA's
f32 log1p).  The flat rows and the q8 state
roundtrip are held bitwise.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import client as jclient  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch import prng, tree  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.flatbuf import PytreeCodec  # noqa: E402
from repro_torch.models import lstm as tlstm  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)

#: name -> (reference builder, port builder, kwargs, input maker)
MODELS = {
    "resnet18": (functools.partial(jcnn.build_paper_model, "resnet18"),
                 functools.partial(tcnn.build_paper_model, "resnet18"),
                 dict(width=4), "image16"),
    "vgg16": (functools.partial(jcnn.build_paper_model, "vgg16"),
              functools.partial(tcnn.build_paper_model, "vgg16"),
              dict(width_mult=0.125, image_size=32), "image32"),
    "lstm-char": (functools.partial(jlstm.build_lstm, task="char"),
                  functools.partial(tlstm.build_lstm, task="char"),
                  dict(embed=16, hidden=32), "char"),
    "lstm-sentiment": (functools.partial(jlstm.build_lstm, task="sentiment"),
                       functools.partial(tlstm.build_lstm,
                                         task="sentiment"),
                       dict(embed=16, hidden=32), "sentiment"),
}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _inputs(kind, n=8, seed=0):
    """(x, y) from numpy: images NHWC f32, or int32 tokens."""
    rng = np.random.default_rng(seed)
    if kind.startswith("image"):
        hw = int(kind[5:])
        return (rng.normal(size=(n, hw, hw, 3)).astype(np.float32),
                rng.integers(0, 10, n).astype(np.int32))
    vocab, n_out = (80, 80) if kind == "char" else (1000, 2)
    x = rng.integers(0, vocab, (n, 12)).astype(np.int32)
    y = x.copy() if kind == "char" else rng.integers(0, n_out, n).astype(
        np.int32)
    return x, y


def _t(x):
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind in "iu"
                           else x)


#: the port's apply function of each model at the sizes of ``MODELS``
APPLY = {"resnet18": functools.partial(tcnn.resnet18_apply, width=4),
         "vgg16": tcnn.vgg16_apply,
         "lstm-char": functools.partial(tlstm.lstm_apply, task="char"),
         "lstm-sentiment": functools.partial(tlstm.lstm_apply,
                                             task="sentiment")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch ops on one thread: its models are small,
    and a thread pool beside other test processes only slows them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(name):
    jbuild, _, kw, _ = MODELS[name]
    return jbuild(KEY, **dict(kw))


def _build(name):
    """The reference's model (built once) and the port's apply function
    over the reference's params and state carried across."""
    p_j, s_j, f_j = _reference(name)
    return (p_j, s_j, f_j, params_from_jax(_np(p_j), CPU),
            params_from_jax(_np(s_j), CPU), APPLY[name], MODELS[name][3])


def _flat(leaves):
    return np.concatenate([np.asarray(leaf, np.float32).ravel()
                           for leaf in leaves])


# ---------------------------------------------------------------------------
# tree.py and the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n_params,n_state", [("resnet18", 62, 40),
                                                   ("vgg16", 19, 0)])
def test_leaf_order_is_jax_tree_util(name, n_params, n_state):
    """Leaves and key paths in ``jax.tree_util.tree_flatten``'s order (keys
    sorted at every level; VGG-16's c0..c12 as strings)."""
    p_j, s_j, _, p_t, s_t, _, _ = _build(name)
    for jt, tt, n in ((p_j, p_t, n_params), (s_j, s_t, n_state)):
        leaves_j, _ = jax.tree_util.tree_flatten(jt)
        leaves_t, treedef = tree.tree_flatten(tt)
        assert len(leaves_t) == len(leaves_j) == n
        for a, b in zip(leaves_j, leaves_t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        paths_j = ["/".join(str(k.key) for k in path) for path, _ in
                   jax.tree_util.tree_flatten_with_path(jt)[0]]
        assert tree.tree_paths(tt) == paths_j
        back = tree.tree_unflatten(treedef, leaves_t)
        assert tree.tree_paths(back) == paths_j
    if name == "vgg16":
        assert [p for p in tree.tree_paths(p_t) if p.startswith("c")][:5] \
            == ["c0", "c1", "c10", "c11", "c12"]


@pytest.mark.parametrize("name", ["resnet18", "vgg16", "lstm-char"])
def test_nested_codec_rows_are_the_references(name):
    """ravel / unravel / ravel_rows of the nested trees: the reference
    codec's flat row element for element, and back bitwise."""
    p_j, s_j, _, p_t, s_t, _, _ = _build(name)
    for jt, tt in ((p_j, p_t), (s_j, s_t)):
        if not tree.tree_leaves(tt):
            continue
        jcodec, codec = jflatbuf.PytreeCodec(jt), PytreeCodec(tt)
        assert (codec.d, codec.dq, codec.n_qblocks) == \
            (jcodec.d, jcodec.dq, jcodec.n_qblocks)
        flat = codec.ravel(tt)
        np.testing.assert_array_equal(flat.numpy(),
                                      np.asarray(jcodec.ravel(jt)))
        for a, b in zip(tree.tree_leaves(codec.unravel(flat)),
                        tree.tree_leaves(tt)):
            assert torch.equal(a, b)
        stacked = tree.tree_stack([tt, tree.tree_map(lambda v: v * 2, tt)])
        rows = codec.ravel_rows(stacked)
        np.testing.assert_array_equal(rows[1].numpy(), 2 * flat.numpy())
        for a, b in zip(tree.tree_leaves(codec.unravel_rows(rows)),
                        tree.tree_leaves(stacked)):
            assert torch.equal(a, b)


def test_state_roundtrip_q8_is_the_references():
    """roundtrip_q8 (quantize -> dequantize -> unravel of the state on the
    q8 wire) bitwise the reference's jitted program, and each row of
    roundtrip_q8_rows bitwise roundtrip_q8 of that row."""
    p_j, s_j, f_j, p_t, s_t, f_t, _ = _build("resnet18")
    x, _ = _inputs("image16")
    _, s1_j = f_j(p_j, s_j, x, True)
    s1_t = params_from_jax(_np(s1_j), CPU)
    jcodec, codec = jflatbuf.PytreeCodec(s_j), PytreeCodec(s_t)
    want = jcodec.roundtrip_q8(s1_j)
    got = codec.roundtrip_q8(s1_t)
    for a, b in zip(tree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows = codec.roundtrip_q8_rows(tree.tree_stack([s1_t, s_t]))
    for k, st in enumerate((s1_t, s_t)):
        for a, b in zip(tree.tree_leaves(rows),
                        tree.tree_leaves(codec.roundtrip_q8(st))):
            assert torch.equal(a[k], b)


def test_weighted_mean_matches_reference():
    """fedavg's state mean: sum_k w_k leaf[k] / sum w in f32 per leaf."""
    rng = np.random.default_rng(3)
    stacked = {"a": {"mean": rng.normal(size=(3, 5)).astype(np.float32),
                     "var": rng.random((3, 5)).astype(np.float32)},
               "b": rng.normal(size=(3, 2, 2)).astype(np.float32)}
    w = np.asarray([17, 5, 30], np.float32)
    want = jagg.weighted_mean(jax.tree_util.tree_map(jnp.asarray, stacked),
                              jnp.asarray(w))
    got = tagg.weighted_mean(params_from_jax(stacked, CPU), w)
    for a, b in zip(tree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_convert_carries_the_state():
    """params_from_jax carries the nested BatchNorm state as it carries
    the params: same keys, leaves bitwise."""
    _, s_j, _, _, s_t, _, _ = _build("resnet18")
    assert tree.tree_paths(s_t) == tree.tree_paths(_np(s_j))
    for a, b in zip(tree.tree_leaves(s_t), jax.tree_util.tree_leaves(s_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# inits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("resnet18", dict(width=4)), ("resnet18", dict(width=8)),
    ("vgg16", dict(width_mult=0.125, image_size=32)),
    ("lstm-char", {}), ("lstm-sentiment", {}),
    ("lstm-char", dict(embed=32, hidden=64, vocab=80, n_out=80)),
    ("lstm-sentiment", dict(embed=32, hidden=64))])
def test_init_matches_reference_key(name, kw):
    """Each model from prng_key(0) is the reference's from PRNGKey(0)
    bitwise in every lane (the tests' and the launcher's sizes, the
    LSTM's defaults)."""
    jbuild, tbuild = MODELS[name][:2]
    p_j, s_j, _ = jbuild(KEY, **dict(kw))
    p_t, s_t, _ = tbuild(prng.prng_key(0), device="cpu", **dict(kw))
    for want, got in ((p_j, p_t), (s_j, s_t)):
        lj = jax.tree_util.tree_leaves(want)
        lt = tree.tree_leaves(got)
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            a = np.asarray(a, np.float32)
            assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
            np.testing.assert_array_max_ulp(b.numpy(), a, maxulp=0)


@pytest.mark.parametrize("name,kw,d,n_state", [
    ("resnet18", dict(width=64), 11_173_962, 9_600),
    ("vgg16", dict(width_mult=1.0, image_size=32), 15_240_906, 0),
    ("lstm-char", {}, 114_256, 0), ("lstm-sentiment", {}, 163_074, 0)])
def test_full_width_sizes(name, kw, d, n_state):
    """The full widths chip_smoke.py drives: the reference's D and state
    size (from its shapes), and the port's layout at the same widths."""
    jbuild = MODELS[name][0]
    p_s, s_s = jax.eval_shape(lambda k: jbuild(k, **dict(kw))[:2], KEY)
    size = lambda t: sum(int(np.prod(x.shape))
                         for x in jax.tree_util.tree_leaves(t))
    assert (size(p_s), size(s_s)) == (d, n_state)
    if name.startswith("lstm"):
        p_t, s_t, _ = MODELS[name][1](prng.prng_key(0), device="cpu", **kw)
        assert PytreeCodec(p_t).d == d
        assert [tuple(v.shape) for v in tree.tree_leaves(p_t)] == \
            [tuple(v.shape) for v in jax.tree_util.tree_leaves(p_s)]


def test_paper_models_build():
    """build_paper_model builds the paper's three image models and
    build_lstm both heads, on the CPU, with the reference's leaf shapes."""
    for name, kw in (("cnn", dict(width=4, image_size=8)),
                     ("resnet18", dict(width=4)),
                     ("vgg16", dict(width_mult=0.125))):
        p, s, fn = tcnn.build_paper_model(name, prng.prng_key(0),
                                          device="cpu", **dict(kw))
        pj, sj = jax.eval_shape(
            lambda k: jcnn.build_paper_model(name, k, **dict(kw))[:2], KEY)
        assert [tuple(v.shape) for v in tree.tree_leaves({"p": p, "s": s})] \
            == [tuple(np.shape(v))
                for v in jax.tree_util.tree_leaves({"p": pj, "s": sj})]
        assert callable(fn)
    for task in ("char", "sentiment"):
        p, s, fn = tlstm.build_lstm(prng.prng_key(0), task, device="cpu")
        assert s == {} and callable(fn)
    with pytest.raises(ValueError):
        tcnn.build_paper_model("lstm", prng.prng_key(0), device="cpu")


# ---------------------------------------------------------------------------
# layers: SAME padding and BatchNorm
# ---------------------------------------------------------------------------


def test_same_padding_stride2_is_asymmetric():
    """XLA's SAME at stride 2 pads (0, 1) on an even map: a 3x3 stride-2
    convolution of a 4x4 map of ones is [[9, 6], [6, 4]] in both."""
    x = np.ones((1, 4, 4, 1), np.float32)
    w = np.ones((3, 3, 1, 1), np.float32)
    want = np.asarray(jcnn.conv2d(x, w, stride=2))[0, :, :, 0]
    got = tcnn._conv_same(torch.as_tensor(x).permute(0, 3, 1, 2),
                          torch.as_tensor(w), 2)[0, 0].numpy()
    np.testing.assert_array_equal(want, [[9, 6], [6, 4]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,k,stride", [(16, 3, 2), (7, 3, 2), (8, 1, 2),
                                         (5, 1, 2), (9, 3, 1), (6, 1, 1)])
def test_conv_same_matches_reference(hw, k, stride):
    rng = np.random.default_rng(hw * 10 + k)
    x = rng.normal(size=(3, hw, hw, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jcnn.conv2d(x, w, stride=stride))
    got = tcnn._conv_same(torch.as_tensor(x).permute(0, 3, 1, 2),
                          torch.as_tensor(w), stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_partial_batch(train):
    """BatchNorm over a batch whose last 5 of 8 samples are zero padding:
    the statistics include the padding (the mask weights the loss only),
    the variance is biased, the state is 0.9 old + 0.1 batch, returned
    new; eval uses the running statistics."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, 4, 4, 3)).astype(np.float32) * 2 + 0.5
    x[3:] = 0.0
    p = {"scale": rng.random(3).astype(np.float32) + 0.5,
         "bias": rng.normal(size=3).astype(np.float32)}
    s = {"mean": rng.normal(size=3).astype(np.float32),
         "var": rng.random(3).astype(np.float32) + 0.5}
    yj, sj = jcnn.bn_apply(p, s, x, train)
    s_t = params_from_jax(s, CPU)
    yt, st = tcnn.bn_apply(params_from_jax(p, CPU), s_t,
                           torch.as_tensor(x).permute(0, 3, 1, 2), train)
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(),
                               np.asarray(yj), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), **TOL)
    if train:
        var = x.reshape(-1, 3).var(axis=0)  # biased
        np.testing.assert_allclose(
            st["var"].numpy(), 0.9 * s["var"] + 0.1 * var, rtol=1e-5)
        assert st is not s_t and not torch.equal(st["mean"], s_t["mean"])
    else:
        assert st is s_t


# ---------------------------------------------------------------------------
# forward, eval and one SGD step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_reference(name, train):
    p_j, s_j, f_j, p_t, s_t, f_t, kind = _build(name)
    x, _ = _inputs(kind)
    lj, nsj = f_j(p_j, s_j, x, train)
    lt, nst = f_t(p_t, s_t, _t(x), train)
    want = np.asarray(lj)
    tol = TOL
    if name == "resnet18" and train:
        tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    assert tuple(lt.shape) == want.shape
    np.testing.assert_allclose(lt.numpy(), want, **tol)
    assert tree.tree_paths(nst) == tree.tree_paths(_np(nsj))
    for a, b in zip(tree.tree_leaves(nst), jax.tree_util.tree_leaves(nsj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_one_sgd_step_matches_reference(name):
    """One local SGD step (the client's epoch over one batch, its last 3
    samples padding) from the same params: params, state and loss."""
    p_j, s_j, f_j, p_t, s_t, f_t, kind = _build(name)
    x, y = _inputs(kind)
    mask = np.ones((1, 8), np.float32)
    mask[0, 5:] = 0.0
    task = "image" if kind.startswith("image") else kind
    epoch = jclient.make_local_train(f_j, task)
    pj, sj, lj = epoch(p_j, s_j, x[None], y[None], mask, 0.05)
    pt, st, lt = tclient.local_epoch(
        tclient.make_loss_fn(f_t, task), p_t, s_t, _t(x[None]), _t(y[None]),
        torch.as_tensor(mask), np.array([True]), 0.05)
    np.testing.assert_allclose(_flat(tree.tree_leaves(pt)),
                               _flat(jax.tree_util.tree_leaves(pj)), **TOL)
    for a, b in zip(tree.tree_leaves(st), jax.tree_util.tree_leaves(sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


@pytest.mark.parametrize("name", ["lstm-char", "lstm-sentiment", "resnet18"])
def test_evaluate_matches_reference(name):
    """Eval: the char head's next-character accuracy and loss over the
    positions, the other heads' over the samples; BatchNorm on its
    running statistics."""
    p_j, s_j, f_j, p_t, s_t, f_t, kind = _build(name)
    x, y = _inputs(kind, n=16, seed=5)
    task = "image" if kind.startswith("image") else kind
    aj, lj = jclient.make_eval_fn(f_j, task)(p_j, s_j, x, y)
    at, lt = tclient.evaluate(f_t, task, p_t, s_t, _t(x), _t(y))
    n = y[:, 1:].size if task == "char" else len(y)
    assert abs(float(at) - float(aj)) * n <= 1  # at most one flip
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_char_loss_scores_the_shifted_targets():
    """The char loss is the mean NLL of logits[:, :-1] against y[:, 1:]
    over the valid samples' positions (the (B,) mask broadcast)."""
    p_j, s_j, f_j, p_t, s_t, f_t, _ = _build("lstm-char")
    x, y = _inputs("char")
    mask = np.array([1, 1, 0, 1, 0, 0, 1, 1], np.float32)
    lj, _ = jclient.make_loss_fn(f_j, "char")(p_j, s_j, x, y, mask)
    lt, _ = tclient.make_loss_fn(f_t, "char")(p_t, s_t, _t(x), _t(y),
                                              torch.as_tensor(mask))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)


def test_vgg16_under_32x32_fails_in_both():
    """Five 2x2 pools take a 16x16 input to 0x0: the reference's f1
    matmul raises; the port raises a ValueError that names the cause."""
    p_j, s_j, f_j, p_t, s_t, f_t, _ = _build("vgg16")
    x = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(TypeError):
        f_j(p_j, s_j, x, True)
    with pytest.raises(ValueError, match="leaves no pixel"):
        f_t(p_t, s_t, torch.as_tensor(x), True)


def test_launcher_vgg16_fails_on_its_16x16_images():
    """fl_sim --model vgg16 on the launcher's 16x16 CIFAR-10 exits
    non-zero, as the reference's does."""
    from repro_torch.launch import fl_sim as tfl_sim
    with pytest.raises(ValueError, match="leaves no pixel"):
        tfl_sim.main(["--model", "vgg16", "--device", "cpu", "--rounds",
                      "1", "--samples", "120", "--clients", "3", "--k",
                      "2"])


def test_vmap_lanes_carry_the_state():
    """The vmapped wave returns each lane's new BatchNorm state (one
    grad_and_value with has_aux a step), within the forward tolerance of
    the lanes run one after another."""
    ds = make_dataset("cifar10", n=120, seed=0, hw=16)
    tr, _ = train_test_split(ds)
    shards = build_client_shards(tr, "iid", 3, 8, seed=0)
    p, s, fn = tcnn.build_paper_model("resnet18", prng.prng_key(0),
                                      device="cpu", width=4)
    codec = PytreeCodec(p)
    # each client's first batch (a wave of 3 lanes, one step each)
    bank = {f: torch.stack([_t(sh[f][:1]) if f != "mask" else
                            torch.as_tensor(sh[f][:1]) for sh in shards])
            for f in ("xs", "ys", "mask")}
    bank["valid"] = np.stack([sh["mask"][:1].max(axis=1) > 0
                              for sh in shards])
    rows = codec.ravel(p).expand(3, codec.d)
    states = tree.tree_map(lambda v: v.expand((3,) + tuple(v.shape)), s)
    out = {}
    for impl in ("map", "vmap"):
        wave = tclient.make_batched_hetero_train(fn, "image", "params", 1,
                                                 codec, impl)
        out[impl] = wave(rows, states, bank, [0, 1, 2], 0.05)
    for a, b in zip(tree.tree_leaves(out["vmap"][2]),
                    tree.tree_leaves(out["map"][2])):
        assert tuple(a.shape) == tuple(b.shape) and a.shape[0] == 3
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert not torch.equal(out["map"][2]["bn0"]["mean"][0],
                           s["bn0"]["mean"])


# ---------------------------------------------------------------------------
# a client's whole epoch: many batches, the BatchNorm state carried
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _epoch_shards(name):
    """Six hetero-Dirichlet shards of synthetic CIFAR-10 at the model's
    size, batch 8: every shard has several batches and a padded last
    one, some with one or two real samples."""
    hw = 16 if name == "resnet18" else 32
    ds = make_dataset("cifar10", n=240, seed=0, hw=hw)
    tr, _ = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", 6, 8, seed=0,
                                 alpha=0.3)
    # one batch count for all (a batch without a real sample changes
    # nothing in either package), so the reference's epoch compiles once
    n = max(np.asarray(sh["mask"]).shape[0] for sh in shards)
    return [{f: np.concatenate([v, np.zeros((n - len(v),) + v.shape[1:],
                                            v.dtype)])
             for f, v in ((f, np.asarray(sh[f]))
                          for f in ("xs", "ys", "mask"))}
            for sh in shards]


@functools.lru_cache(maxsize=None)
def _reference_epoch_f64(name):
    with jax.enable_x64(True):
        return jax.jit(jclient._make_epoch_body(_reference(name)[2],
                                                "image"))


def _port_epoch(name, shard, dtype, mode):
    """The port's local epoch of ``shard`` in ``dtype`` from the
    reference's init, under the torch function mode ``mode``."""
    _, _, _, p_t, s_t, f_t, _ = _build(name)
    cast = functools.partial(tree.tree_map, lambda v: v.to(dtype))
    mask = np.asarray(shard["mask"])
    with mode:
        p, s, _ = tclient.local_epoch(
            tclient.make_loss_fn(f_t, "image"), cast(p_t), cast(s_t),
            torch.as_tensor(np.asarray(shard["xs"])).to(dtype),
            _t(shard["ys"]), torch.as_tensor(mask).to(dtype),
            mask.max(axis=1) > 0, 0.05)
    return (np.concatenate([v.numpy().ravel() for v in tree.tree_leaves(t)])
            if tree.tree_leaves(t) else np.zeros(0) for t in (p, s))


@pytest.mark.parametrize("name", ["resnet18", "vgg16"])
def test_epoch_matches_reference_in_f64(name):
    """Each of six clients' whole local epoch (several batches, a padded
    last one, ResNet-18's BatchNorm state carried from batch to batch),
    the port's and the reference's both in f64: params and state within
    ``rtol=1e-10, atol=1e-12``.  In f64 no unit lies within rounding of
    its ReLU or max-pool branch point, so the two epochs take the same
    branches and what is left is f64 rounding."""
    from repro_torch.models.kinks import Record
    p_j, s_j, _ = _reference(name)
    c64 = functools.partial(jax.tree_util.tree_map,
                            lambda v: jnp.asarray(np.asarray(v, np.float64)))
    for shard in _epoch_shards(name):
        with jax.enable_x64(True):
            pj, sj, _ = _reference_epoch_f64(name)(
                c64(p_j), c64(s_j),
                jnp.asarray(np.asarray(shard["xs"], np.float64)),
                jnp.asarray(shard["ys"]),
                jnp.asarray(np.asarray(shard["mask"], np.float64)), 0.05)
            want = [np.concatenate([np.asarray(v).ravel() for v in
                                    jax.tree_util.tree_leaves(t)])
                    if jax.tree_util.tree_leaves(t) else np.zeros(0)
                    for t in (pj, sj)]
        got = _port_epoch(name, shard, torch.float64, Record())
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["resnet18", "vgg16"])
def test_f32_epoch_is_f64_on_its_branches(name):
    """Each of six clients' f32 epoch against the f64 epoch (held to the
    reference above) made to take the f32 run's ReLU and max-pool
    branches (:mod:`repro_torch.models.kinks`): every recorded branch
    taken, each unit where f64 would have gone the other way within
    1e-3 of its branch point (relative to its call's largest input),
    params within 1e-4 of the epoch's movement and the state within
    ``rtol=1e-4, atol=1e-5``.  Free, the f64 epoch parts from the f32
    one by a flipped unit's whole gradient term; a padded last batch
    with one or two real samples makes BatchNorm divide by a small
    spread and is the largest term of what is left."""
    from repro_torch.models.kinks import Record, Replay
    _, _, _, p_t, _, _, _ = _build(name)
    p0 = np.concatenate([v.numpy().ravel().astype(np.float64)
                         for v in tree.tree_leaves(p_t)])
    for shard in _epoch_shards(name):
        record = Record()
        p32, s32 = _port_epoch(name, shard, torch.float32, record)
        replay = Replay(record.choices)
        p64, s64 = _port_epoch(name, shard, torch.float64, replay)
        assert replay.done and replay.margin <= 1e-3, replay.margin
        rel = np.linalg.norm(p32 - p64) / np.linalg.norm(p64 - p0)
        assert rel <= 1e-4, rel
        np.testing.assert_allclose(s32, s64, rtol=1e-4, atol=1e-5)


def test_replay_takes_the_recorded_branches():
    """``Replay`` gives the recorded relu masks, pool argmaxes and
    rounded integers to a run whose inputs sit across them by rounding
    (one flip each, a margin of that rounding), raises on a call of
    another shape, and reads a margin of order 1 from a run whose inputs
    are other values."""
    import torch.nn.functional as F

    from repro_torch.models.kinks import Record, Replay
    x = torch.tensor([[[[1e-7, 0.5], [-0.3, 0.2]]]])
    r = torch.tensor([2.5000002, -1.2, 7.0])

    def run(x, r):
        return F.relu(x), F.max_pool2d(x, 2), torch.round(r)

    rec = Record()
    with rec:
        want = run(x, r)
    assert [k for k, _ in rec.choices] == ["relu", "pool", "round"]
    near = x.clone()
    near[0, 0, 0, 0] = -1e-7
    near[0, 0, 1, 1] = 0.5 + 1e-7  # the pool's argmax moves
    replay = Replay(rec.choices)
    with replay:
        got = run(near, torch.tensor([2.4999998, -1.2, 7.0]))
    assert replay.done and replay.flips == 3, replay.flips
    assert replay.margin <= 1e-6, replay.margin
    assert torch.equal(got[2], want[2])
    assert float(got[0][0, 0, 0, 0]) == float(near[0, 0, 0, 0])
    assert float(got[1].flatten()[0]) == 0.5
    far = Replay(rec.choices)
    with far:
        run(-x, r)
    assert far.margin > 0.5
    with pytest.raises(RuntimeError, match="the recorded one a relu"):
        with Replay(rec.choices):
            F.relu(torch.zeros(3))
