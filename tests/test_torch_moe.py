"""The MoE layer and the MoE decoders (``repro_torch.models.moe``; the
reduced granite-moe-1b-a400m and kimi-k2-1t-a32b, f32 compute) against
the reference on the CPU:

  * ``init(prng_key(0))`` bitwise ``init(PRNGKey(0))`` (the experts'
    normal draws divided by the f32 ``jnp.sqrt(D)``; drawn in slices of
    experts, the lanes of one draw);
  * prefill and 8 decode steps within ``atol=rtol=1e-4`` (kimi: a dense
    layer, then a MoE layer with a shared expert);
  * ``moe_apply`` within ``atol=rtol=1e-5`` of the reference's, and its
    routing (expert indices, kept choices, gates) exact, under a
    capacity that drops tokens (``capacity_factor`` 0.5), a roomy one
    (8.0), both dispatch impls, the bf16 dispatch dtype, and a forced
    router tie (two experts' router columns equal: the lower index
    first, as ``lax.top_k``; the layer within ``atol=rtol=1e-4``: the
    shifted router's logits reach 1e2, seen 1.3e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _zoo_common as zc  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

ARCHS_HERE = ["kimi-k2-1t-a32b", "granite-moe-1b-a400m"]


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_init_matches_reference_key(arch):
    zc.check_init(arch)


@pytest.mark.parametrize("S", [32, 200])
@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_prefill_and_decode(arch, S):
    zc.check_prefill_decode(arch, S)


def _layer(arch="kimi-k2-1t-a32b", **kw):
    jcfg, tcfg, _, jp, tm = zc.cached_setup(arch)
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers_moe"])["moe"]
    pt = {k: (dict(v) if isinstance(v, dict) else v)
          for k, v in tm.layers[tcfg.first_k_dense].tree["moe"].items()}
    return jcfg, tcfg, pj, pt


def _routing_jax(pj, cfg, x):
    """The reference's routing of x (its moe_apply's first lines)."""
    B, S, D = x.shape
    gs = min(cfg.moe_group_size, B * S)
    xt = jnp.asarray(x).reshape(-1, gs, D)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ pj["router"], axis=-1)
    gv, gi = jax.lax.top_k(probs, cfg.top_k)
    return np.asarray(gi)


CASES = {
    "drops": dict(capacity_factor=0.5),
    "roomy": dict(capacity_factor=8.0),
    "scatter": dict(moe_dispatch_impl="scatter", capacity_factor=0.5),
    "bf16-dispatch": dict(moe_dispatch_dtype="bfloat16"),
    "granite": dict(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case):
    arch = "granite-moe-1b-a400m" if case == "granite" else "kimi-k2-1t-a32b"
    jcfg, tcfg, pj, pt = _layer(arch, **CASES[case])
    x = np.random.default_rng(7).standard_normal(
        (4, 32, tcfg.d_model)).astype(np.float32)
    yj, auxj = jmoe.moe_apply(pj, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        yt, auxt = tmoe.moe_apply(pt, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    # routing exact: the same experts, the same kept choices
    xt = torch.from_numpy(x).reshape(-1, min(tcfg.moe_group_size, 128),
                                     tcfg.d_model)
    _, gates, idx, _, keep, _ = tmoe.route(pt, tcfg, xt)
    np.testing.assert_array_equal(idx.numpy(), _routing_jax(pj, jcfg, x))
    C = tmoe._capacity(tcfg, xt.shape[1])
    dropped = int((~keep).sum())
    if case in ("drops", "scatter"):
        assert dropped > 0, "the tight capacity drops no choice"
    if case == "roomy":
        assert dropped == 0 and C == int(8.0 * 64 * 2 / 4)
    assert bool((gates[~keep] == 0).all())


def test_router_tie_lower_index_first():
    """Experts 1 and 3 with equal router columns tie on every token: the
    lower index is ranked first (``lax.top_k``), and the layer's output
    is the reference's.  Expert 0's column shifted far makes some tokens'
    other probabilities subnormal, which XLA flushes to 0 (a tie at 0,
    ranked by index) and the port too."""
    jcfg, tcfg, pj, pt = _layer()
    router = np.array(pj["router"])
    router[:, 3] = router[:, 1]
    router[:, 0] -= 10.0  # experts 1 and 3 are every token's top two
    pj = dict(pj, router=jnp.asarray(router))
    pt = dict(pt, router=torch.from_numpy(router))
    x = np.random.default_rng(8).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    gi = _routing_jax(pj, jcfg, x)
    xt = torch.from_numpy(x).reshape(1, 64, tcfg.d_model)
    _, _, idx, _, _, _ = tmoe.route(pt, tcfg, xt)
    np.testing.assert_array_equal(idx.numpy(), gi)
    tied = (np.sort(gi, -1) == [1, 3]).all(-1)
    assert tied.any() and (gi[tied] == [1, 3]).all()
    yj, _ = jmoe.moe_apply(pj, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        yt, _ = tmoe.moe_apply(pt, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **zc.TOL)


def test_capacity_truncates():
    _, tcfg, _, _ = _layer()
    for cf, gs, want in ((1.25, 64, 40), (0.5, 64, 16), (0.01, 64, 4),
                         (1.25, 7, 4), (1.3, 100, 65)):
        c = dataclasses.replace(tcfg, capacity_factor=cf)
        assert tmoe._capacity(c, gs) == want == jmoe._capacity(c, gs)


def test_sliced_expert_draw_is_the_one_draw(monkeypatch):
    """The experts drawn a slice at a time (here 1 expert a slice) equal
    the one (E, D, F) draw."""
    from repro_torch import prng
    from repro_torch.models import layers
    key = prng.split(prng.prng_key(3), 5)[1]
    shape, fan = (4, 32, 24), 32
    monkeypatch.setattr(tmoe, "INIT_EXPERTS", 1)
    got = tmoe._expert_weights(key, shape, fan, torch.float32, "cpu")
    want = layers.div_f32(prng.normal_torch(key, shape, "cpu"),
                          layers.sqrt_f32(fan))
    assert torch.equal(got, want)
    ref = np.asarray(jax.random.normal(jnp.asarray(key), shape)
                     / jnp.sqrt(fan))
    np.testing.assert_array_equal(got.numpy(), ref)
