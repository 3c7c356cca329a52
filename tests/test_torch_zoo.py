"""The zoo's dense, VLM and enc-dec architectures (``repro_torch.models``;
the reduced configs, f32 compute) against the reference on the CPU:

  * ``init(prng_key(0))`` against ``init(PRNGKey(0))`` leaf by leaf, every
    lane bitwise;
  * with the reference's weights carried across: the prefill's
    last-position logits and KV cache (the enc-dec's cross K / V too)
    within ``atol=rtol=1e-4`` at prompts 32 and 200, then 8
    teacher-forced decode steps' logits and the final cache within the
    same bound (the VLM's 8 projected patch embeddings before the
    prompt, decode at S + 8 + i);
  * the window: starcoder2's prefill past its window (the window mask in
    ``_sdpa``, q-chunked by ``attn_chunk``) and the ring-buffer decode
    (a cache of the window's capacity, slot pos % C) against the
    reference's and against the full cache decoded under the window;
  * the enc-dec's encoder non-causal, its cross-attention and its decode
    against the reference's functions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _zoo_common as zc  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

one_torch_thread = pytest.fixture(scope="module", autouse=True)(
    zc.one_torch_thread)

ARCHS_HERE = ["starcoder2-3b", "qwen3-1.7b", "internlm2-20b", "minitron-4b",
              "internvl2-76b", "seamless-m4t-medium"]


def test_zoo_is_the_references():
    assert list(ARCHS) == list(JARCHS)
    fams = {a: c.family for a, c in ARCHS.items()}
    assert set(fams.values()) == {"dense", "moe", "vlm", "hybrid", "ssm",
                                  "audio"}


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_init_matches_reference_key(arch):
    zc.check_init(arch)


@pytest.mark.parametrize("S", [32, 200])
@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_prefill_and_decode(arch, S):
    zc.check_prefill_decode(arch, S)


def _attn(arch, **kw):
    jcfg, tcfg, _, jp, tm = zc.cached_setup(arch)
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    name = "layers_dense" if "layers_dense" in jp else "dec"
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp[name])["attn"]
    lp_t = (tm.layers[0] if hasattr(tm, "layers") else tm.dec[0]).tree[
        "attn"]
    return jcfg, tcfg, lp_j, lp_t


@pytest.mark.parametrize("S,window,chunk", [
    (160, 64, 0),    # past the window: the window mask
    (192, 64, 64),   # and q-chunked
    (48, 64, 0),     # within it: the flash kernel's causal mask
])
def test_windowed_prefill_attention(S, window, chunk):
    jcfg, tcfg, lp_j, lp_t = _attn("starcoder2-3b", attn_chunk=chunk)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = jlayers.full_attention(lp_j, jcfg, jnp.asarray(x),
                                  jnp.asarray(pos), window=window)
    got = tlayers.full_attention(lp_t, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_ring_decode_matches_full_cache_decode():
    """Decode under a window W: on a ring of capacity W (slot i holding
    the latest position = i mod W) as on the full cache, and as the
    reference's."""
    jcfg, tcfg, lp_j, lp_t = _attn("starcoder2-3b")
    W, S, B = 16, 40, 2
    hkv, hd = tcfg.n_kv_heads, tcfg.hd
    rng = np.random.default_rng(3)
    full_k = rng.standard_normal((B, S + 6, hkv, hd)).astype(np.float32)
    full_v = rng.standard_normal((B, S + 6, hkv, hd)).astype(np.float32)
    for pos in range(S, S + 6):
        x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        ring_k = np.empty((B, W, hkv, hd), np.float32)
        ring_v = np.empty((B, W, hkv, hd), np.float32)
        for p in range(pos - W, pos):
            ring_k[:, p % W], ring_v[:, p % W] = full_k[:, p], full_v[:, p]
        outs = []
        for ck, cv in ((ring_k, ring_v), (full_k, full_v)):
            o, _, _ = tlayers.decode_attention(
                lp_t, tcfg, torch.from_numpy(x), torch.from_numpy(ck.copy()),
                torch.from_numpy(cv.copy()), pos, window=W)
            outs.append(o.numpy())
        want, _, _ = jlayers.decode_attention(
            lp_j, jcfg, jnp.asarray(x), jnp.asarray(ring_k),
            jnp.asarray(ring_v), jnp.int32(pos), window=W)
        np.testing.assert_allclose(outs[0], np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(outs[0], outs[1], atol=2e-5, rtol=2e-5)


def test_cross_attention_matches_reference():
    jcfg, tcfg, _, jp, tm = zc.cached_setup("seamless-m4t-medium")
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["dec"])["xattn"]
    lp_t = tm.dec[0].tree["xattn"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    want = jlayers.full_attention(lp_j, jcfg, jnp.asarray(x),
                                  jnp.asarray(pos), memory=jnp.asarray(mem))
    got = tlayers.full_attention(lp_t, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos),
                                 memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    hd, hkv = tcfg.hd, tcfg.n_kv_heads
    mk = (mem @ np.asarray(lp_j["wk"])).reshape(2, 40, hkv, hd)
    mv = (mem @ np.asarray(lp_j["wv"])).reshape(2, 40, hkv, hd)
    want = jlayers.cross_attention_decode(lp_j, jcfg, jnp.asarray(x[:, :1]),
                                          jnp.asarray(mk), jnp.asarray(mv))
    got = tlayers.cross_attention_decode(lp_t, tcfg, torch.from_numpy(
        x[:, :1]), torch.from_numpy(mk), torch.from_numpy(mv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_encoder_is_non_causal():
    """The enc-dec's memory at frame 0 moves when a later frame does."""
    _, tcfg, _, _, tm = zc.cached_setup("seamless-m4t-medium")
    f = torch.from_numpy(np.random.default_rng(5).normal(
        0, 0.1, (1, 16, tcfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        a = tm.encode(f)
        f[:, -1] += 1.0
        b = tm.encode(f)
    assert not torch.allclose(a[:, 0], b[:, 0])
