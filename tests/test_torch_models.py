"""repro_torch's paper CNN, codec and client epoch against repro on
parameters carried across from JAX.

Tolerance: ``rtol=1e-5, atol=1e-5`` on logits, trained weights and the
loss.  Both sides compute in float32 on the CPU, but the convolutions and
matrix products sum in different orders, so they agree to a few ulp, not
bitwise.  The flat codec is held exactly: it only copies.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import client as jclient  # noqa: E402
from repro.core import flatbuf as jflatbuf  # noqa: E402
from repro.data import build_client_shards, make_dataset, train_test_split  # noqa: E402
from repro.models import vision_cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import client as tclient  # noqa: E402
from repro_torch.core.flatbuf import PytreeCodec  # noqa: E402
from repro_torch.models import vision_cnn as tcnn  # noqa: E402
from repro_torch import prng, tree  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    p_j, s_j = jcnn.cnn_init(jax.random.PRNGKey(0), width=4, image_size=8)
    p_np = jax.tree_util.tree_map(np.asarray, p_j)
    ds = make_dataset("cifar10", n=200, seed=0, hw=8)
    tr, te = train_test_split(ds)
    shards = build_client_shards(tr, "hetero_dirichlet", 4, 16, seed=0,
                                 alpha=0.3)
    return p_j, s_j, p_np, shards, te


def _torch_shard(s):
    return (torch.as_tensor(s["xs"]), torch.as_tensor(s["ys"], dtype=torch.int64),
            torch.as_tensor(s["mask"]), s["mask"].max(axis=1) > 0)


def test_logits_match(setup):
    p_j, s_j, p_np, _, te = setup
    x = te.x[:16]
    lj, _ = jcnn.cnn_apply(p_j, s_j, x, False)
    lt, _ = tcnn.cnn_apply(params_from_jax(p_np, CPU), {},
                           torch.as_tensor(x), False)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_codec_ravel_exact(setup):
    p_j, _, p_np, _, _ = setup
    jcodec = jflatbuf.PytreeCodec(p_j)
    pt = params_from_jax(p_np, CPU)
    codec = PytreeCodec(pt)
    assert codec.d == jcodec.d
    flat = codec.ravel(pt)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jcodec.ravel(p_j)))
    back = codec.unravel(flat)
    for k in p_np:
        np.testing.assert_array_equal(back[k].numpy(), p_np[k])
    # ravel_delta is (start - end) / scale, leaf by leaf
    p_end = {k: v * 0.5 for k, v in pt.items()}
    jend = jax.tree_util.tree_map(lambda v: v * 0.5, p_j)
    np.testing.assert_array_equal(
        codec.ravel_delta(pt, p_end, 0.05).numpy(),
        np.asarray(jcodec.ravel_delta(p_j, jend, 0.05)))


def test_full_width_layout():
    """The flat row of the full-width CNN: sorted-key leaf order and
    D = 2,154,730, as the reference's codec gives it."""
    p, _ = tcnn.cnn_init(prng.prng_key(0), device="cpu")
    codec = PytreeCodec(p)
    assert codec.keys == [
        "b1", "b2", "c1", "c2", "c3", "f1", "f2"]
    assert codec.d == 2_154_730
    shapes = jax.eval_shape(lambda k: jcnn.cnn_init(k)[0],
                            jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in shapes.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}


def test_init_is_seeded_he_normal():
    a, _ = tcnn.cnn_init(prng.prng_key(5), width=4, image_size=8,
                         device="cpu")
    b, _ = tcnn.cnn_init(prng.prng_key(5), width=4, image_size=8,
                         device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert float(a["b1"].abs().sum()) == 0.0
    # He-normal std sqrt(2 / fan_in) for the dense layer
    f1 = a["f1"]
    assert abs(float(f1.std()) - np.sqrt(2.0 / f1.shape[0])) < 0.1 * np.sqrt(
        2.0 / f1.shape[0])


@pytest.mark.parametrize("kw", [dict(width=8, image_size=16),
                                dict(width=4, image_size=8), {}])
def test_init_matches_reference_key(kw):
    """cnn_init(prng_key(0)) is the reference's cnn_init(PRNGKey(0)) within
    0 ulp in every lane (the launcher's width-8 CNN, the tests' width 4
    and the full width): the normal draws take XLA's f32 log1p."""
    got, _ = tcnn.cnn_init(prng.prng_key(0), device="cpu", **kw)
    want, _ = jcnn.cnn_init(jax.random.PRNGKey(0), **kw)
    same = total = 0
    for k, v in want.items():
        w = np.asarray(v, np.float32)
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_max_ulp(g, w, maxulp=0)
        same += int((g.view(np.int32) == w.view(np.int32)).sum())
        total += w.size
    print(f"cnn_init {kw}: {same / total:.2%} of {total} lanes bitwise")
    assert same / total > 0.95


def test_unported_models_raise():
    """The models this test once saw refused, ResNet-18 and VGG-16, now
    build from the reference key (params and state on the CPU); a name
    that is not a paper image model raises."""
    for name, kw in (("resnet18", dict(width=4)),
                     ("vgg16", dict(width_mult=0.125))):
        p, s, fn = tcnn.build_paper_model(name, prng.prng_key(0),
                                          device="cpu", **kw)
        assert callable(fn) and p
        assert all(v.device == CPU for v in tree.tree_leaves(p))
        assert bool(tree.tree_leaves(s)) == (name == "resnet18")
    with pytest.raises(ValueError):
        tcnn.build_paper_model("lstm", prng.prng_key(0), device="cpu")


@pytest.mark.parametrize("cid", [0, 3])
def test_local_epoch_matches(setup, cid):
    p_j, s_j, p_np, shards, _ = setup
    s = shards[cid]
    epoch = jclient.make_local_train(jcnn.cnn_apply, "image")
    pj, _, lj = epoch(p_j, s_j, s["xs"], s["ys"], s["mask"], 0.05)
    loss_fn = tclient.make_loss_fn(tcnn.cnn_apply, "image")
    xs, ys, mask, valid = _torch_shard(s)
    pt, _, lt = tclient.local_epoch(loss_fn, params_from_jax(p_np, CPU), {},
                                    xs, ys, mask, valid, 0.05)
    for k in p_np:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), **TOL)
    np.testing.assert_allclose(float(lt), float(lj), **TOL)


def test_padding_batch_is_a_noop(setup):
    """A batch whose mask is all zero changes nothing (the reference's
    ``where(any_valid, ...)``)."""
    _, _, p_np, shards, _ = setup
    xs, ys, mask, _ = _torch_shard(shards[0])
    loss_fn = tclient.make_loss_fn(tcnn.cnn_apply, "image")
    p0 = params_from_jax(p_np, CPU)
    none_valid = np.zeros(xs.shape[0], bool)
    p1, _, loss = tclient.local_epoch(loss_fn, p0, {}, xs, ys, mask * 0,
                                      none_valid, 0.05)
    for k in p0:
        assert torch.equal(p1[k], p0[k])
    assert float(loss) == 0.0


def test_evaluate_matches(setup):
    p_j, s_j, p_np, _, te = setup
    ev = jclient.make_eval_fn(jcnn.cnn_apply, "image")
    aj, lj = ev(p_j, s_j, te.x, te.y)
    at, lt = tclient.evaluate(tcnn.cnn_apply, "image",
                              params_from_jax(p_np, CPU), {},
                              torch.as_tensor(te.x),
                              torch.as_tensor(te.y, dtype=torch.int64))
    assert abs(float(at) - float(aj)) * len(te.y) <= 1  # at most one flip
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
