"""The zoo's configs, shapes, draws and weight transfer against the
reference on the CPU:

  * all ten ``ARCHS``, full and reduced, field for field the reference's
    (and the properties ``hd``, ``padded_vocab``, ``d_inner``,
    ``ssm_heads``, ``is_encoder_decoder``, ``supports_long_decode``);
    ``validate()`` refusing what the reference's asserts refuse;
  * every full-width model built on the meta device with the reference's
    ``jax.eval_shape`` parameter count and leaf shapes;
  * the draws the zoo adds: ``gumbel_torch`` bitwise
    ``jax.random.gumbel``, ``categorical_torch`` the reference's tokens,
    ``uniform_range_torch`` bitwise ``jax.random.uniform(minval=,
    maxval=)``, and the threefry counter past 2**32 lanes (the high word
    first, as ``iota_2x32_shape``);
  * ``params_from_jax`` keeping a bf16 leaf bf16, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

PROPS = ("hd", "padded_vocab", "d_inner", "ssm_heads", "is_encoder_decoder",
         "supports_long_decode")


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list(JARCHS))
def test_config_field_for_field(arch, reduced):
    jc, tc = JARCHS[arch], get_config(arch)
    if reduced:
        jc, tc = jreduced(jc), reduced_config(tc)
    jf = [f.name for f in dataclasses.fields(jc)]
    assert [f.name for f in dataclasses.fields(tc)] == jf
    for name in jf + list(PROPS):
        assert getattr(tc, name) == getattr(jc, name), name


@pytest.mark.parametrize("bad", [
    dict(family="rnn"), dict(n_heads=3), dict(n_kv_heads=3),
    dict(family="moe", n_experts=0), dict(family="ssm"),
    dict(family="hybrid", hybrid_attn_every=5),
])
def test_validate_refuses(bad):
    base = dict(name="x", family="dense", n_layers=4, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=100)
    cfg = ModelConfig(**{**base, **bad})
    with pytest.raises(ValueError):
        cfg.validate()
    from repro.configs.base import ModelConfig as JModelConfig
    with pytest.raises(AssertionError):
        JModelConfig(**{**base, **bad}).validate()


def _paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield pre + (k,), v


@pytest.mark.parametrize("arch", list(JARCHS))
def test_full_width_param_count(arch):
    """The full config built on the meta device (no memory): the
    reference's parameter count and leaf shapes."""
    import _zoo_common as zc
    cfg = get_config(arch)
    m = build_model(cfg).init(prng.prng_key(0), "meta")
    shapes = jax.eval_shape(jbuild(JARCHS[arch]).init, jax.random.PRNGKey(0))
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _paths(shapes)}
    assert m.param_count() == sum(int(np.prod(s)) for s, _ in want.values())
    got = {}
    for path, leaf in zc.leaves(_meta_tree(m)):
        got[path] = (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
    assert got == want


def _meta_tree(m):
    """The model's leaves in the reference's stacked layout, as meta
    tensors."""
    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.empty((len(trees), *v.shape), dtype=v.dtype,
                                 device="meta")
                for k, v in trees[0].items()}
    out = dict(m.top.tree)
    fam = m.cfg.family
    if fam in ("dense", "moe", "vlm"):
        n = m.n_dense(m.cfg)
        trees = [layer.tree for layer in m.layers]
        if n:
            out["layers_dense"] = stack(trees[:n])
        if len(trees) > n:
            out["layers_moe"] = stack(trees[n:])
    elif fam == "hybrid":
        L = m.per_group
        groups = [stack([t.tree for t in m.mamba[g * L:(g + 1) * L]])
                  for g in range(m.n_groups)]
        out["mamba"] = jax.tree_util.tree_map(
            lambda *a: torch.empty((len(a), *a[0].shape), dtype=a[0].dtype,
                                   device="meta"), *groups)
        out["shared_attn"] = m.shared.tree
    elif fam == "ssm":
        out["mblocks"] = stack([b.tree for b in m.mblocks])
        out["sblocks"] = stack([b.tree for b in m.sblocks])
    else:
        out["enc"] = stack([b.tree for b in m.enc])
        out["dec"] = stack([b.tree for b in m.dec])
    return out


def test_gumbel_and_categorical_bitwise():
    key = jax.random.PRNGKey(1)
    logits = np.random.default_rng(0).standard_normal((4, 640)).astype(
        np.float32) * 3
    for _ in range(4):
        key, sub = jax.random.split(key)
        ks = np.asarray(sub, np.uint32)
        want = np.asarray(jax.random.gumbel(sub, (4, 640)))
        got = prng.gumbel_torch(ks, (4, 640), "cpu").numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        t = np.float32(0.8)
        tok = np.asarray(jax.random.categorical(sub, jnp.asarray(logits) / t,
                                                axis=-1))
        got = prng.categorical_torch(ks, torch.from_numpy(logits)
                                     / torch.tensor(t))
        np.testing.assert_array_equal(got.numpy(), tok)


@pytest.mark.parametrize("lo,hi", [(-2.5, 3.0), (0.1, 0.7),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_range_bitwise(lo, hi):
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.uniform(key, (4096,), minval=lo,
                                         maxval=hi))
    got = prng.uniform_range_torch(np.asarray(key, np.uint32), (4096,),
                                   "cpu", lo, hi).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_counter_past_two_to_the_32():
    """Lanes past 2**32 (kimi-k2's expert draws hold 5.6 G): the counter
    pair is (lane >> 32, lane & 0xFFFFFFFF), as ``jax.random`` counts."""
    from jax._src import prng as jprng
    key = np.array([7, 11], np.uint32)
    start = 2 ** 32 * 3 + 2 ** 32 - 5
    lanes = np.arange(start, start + 10, dtype=np.uint64)
    hi = (lanes >> np.uint64(32)).astype(np.uint32)
    lo = (lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = jprng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                       jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(b1) ^ np.asarray(b2)
    got = prng._bits_torch(key, start, 10, "cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    # and the first lanes are the numpy twin's
    np.testing.assert_array_equal(
        prng._bits_torch(key, 0, 64, "cpu").numpy().astype(np.uint32),
        prng._random_bits(key, 64))


def test_params_from_jax_keeps_bf16():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"w": np.asarray(a), "n": {"s": np.ones(4, np.float32)}}
    t = params_from_jax(tree, "cpu")
    assert t["w"].dtype == torch.bfloat16 and t["n"]["s"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        t["w"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(a).view(np.uint16))
    np.testing.assert_array_equal(t["w"].float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))
