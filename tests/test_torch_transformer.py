"""The port's dense decoder LM and serving launcher (``repro_torch.models``,
``repro_torch.launch.serve``) against the reference on the CPU, on the
reduced qwen3-1.7b (2 layers, d_model 256, 4 / 2 heads, hd 64, vocab 512,
f32 compute).

  * ``init(prng_key(0))`` is the reference's ``init(PRNGKey(0))`` within
    0 ulp in every lane (the normal draws take XLA's f32 log1p);
  * with the reference's weights carried across (``params_from_jax``):
    ``rmsnorm``, ``apply_rope`` and ``_qkv`` within ``rtol=1e-5``; prefill
    logits of the last position and the KV cache within ``atol=rtol=
    1e-4`` in f32 at prompts 32 and 200 (the port's attention is the flash
    kernel's plain version, the reference's ``_sdpa``: the same f32
    softmax summed in another order; seen: 4e-6); 8 teacher-forced
    decode steps' logits within the same bound;
  * in bf16 compute, prefill logits within ``atol=rtol=5e-2``: the
    kernel keeps p and v in f32 where ``_sdpa`` rounds p to bf16 before
    its PV product, and the two frameworks round other bf16 products at
    other places (seen: 4.0e-2 at logits up to 3.7);
  * ``serve --device cpu`` prints the reference's sample token ids on
    the same flags; an arch outside the zoo is refused; the window and
    cross-attention paths equal the reference's (the rest of the zoo in
    ``test_torch_zoo*.py``).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced_config as jreduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.prng import prng_key  # noqa: E402

ARCH = "qwen3-1.7b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(**kw):
    return (dataclasses.replace(jreduced(jget_config(ARCH)), **kw),
            dataclasses.replace(reduced_config(get_config(ARCH)), **kw))


@pytest.fixture(scope="module")
def f32():
    """(jax cfg, port cfg, jax model, jax params, port model on the
    reference's weights)."""
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = DecoderLM.from_tree(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return jcfg, tcfg, jm, jp, tm


def _paths(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, pre + (k,))
        else:
            yield pre + (k,), v


def test_config_matches_reference():
    for full in (True, False):
        jc = jget_config(ARCH)
        tc = get_config(ARCH)
        if not full:
            jc, tc = jreduced(jc), reduced_config(tc)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert (tc.hd, tc.padded_vocab) == (jc.hd, jc.padded_vocab)


def test_full_width_param_count():
    """The full config's tree, built on the meta device (no memory):
    2,038,555,648 parameters, the reference's shapes."""
    cfg = get_config(ARCH)
    m = DecoderLM.init(cfg, prng_key(0), "meta")
    assert m.param_count() == 2_038_555_648
    shapes = jax.eval_shape(jbuild(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    want = {p: tuple(v.shape) for p, v in _paths(
        jax.tree_util.tree_map(lambda a: a, shapes))}
    assert want[("embed",)] == tuple(m.top.tree["embed"].shape)
    assert want[("head",)] == tuple(m.top.tree["head"].shape)
    for path, shape in want.items():
        if path[0] == "layers_dense":
            leaf = m.layers[0].tree
            for p in path[1:]:
                leaf = leaf[p]
            assert (cfg.n_layers, *leaf.shape) == shape, path


def test_init_matches_reference_key(f32):
    """Every leaf of init(prng_key(0)) within 0 ulp of the reference's
    init(PRNGKey(0)): every lane bitwise."""
    _, tcfg, _, jp, _ = f32
    tm = build_model(tcfg).init(prng_key(0), "cpu")
    same = total = 0
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, jp)):
        if path[0] == "layers_dense":
            for i in range(tcfg.n_layers):
                leaf = tm.layers[i].tree
                for p in path[1:]:
                    leaf = leaf[p]
                got, w = leaf.numpy(), want[i]
                np.testing.assert_array_max_ulp(got, w, maxulp=0)
                same += int((got.view(np.int32) == w.view(np.int32)).sum())
                total += w.size
        else:
            got = tm.top.tree[path[0]]
            for p in path[1:]:
                got = got[p]
            np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=0)
            same += int((got.numpy().view(np.int32)
                         == want.view(np.int32)).sum())
            total += want.size
    print(f"reduced qwen3 init: {same / total:.2%} of {total} lanes bitwise")
    assert same / total > 0.95


def test_rmsnorm_rope_qkv(f32):
    jcfg, tcfg, _, jp, tm = f32
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers_dense"])
    lp_t = tm.layers[0].tree
    np.testing.assert_allclose(
        tlayers.rmsnorm(lp_t["ln1"], torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.rmsnorm(lp_j["ln1"], jnp.asarray(x))), rtol=1e-5)
    # RoPE at long positions (theta = 1e6): the frequencies and angles are
    # f32 on both sides, cos / sin from two libraries
    xr = rng.standard_normal((2, 40, 4, 64)).astype(np.float32)
    pos = np.arange(1000, 1040, dtype=np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                           tcfg.rope_theta).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                                      jcfg.rope_theta)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlayers.rope_freqs(64, 1e6).numpy(),
        np.asarray(jlayers.rope_freqs(64, 1e6)), rtol=1e-6)
    positions = np.arange(40, dtype=np.int32)
    got = tlayers._qkv(lp_t["attn"], tcfg, torch.from_numpy(x),
                       torch.from_numpy(positions))
    want = jlayers._qkv(lp_j["attn"], jcfg, jnp.asarray(x),
                        jnp.asarray(positions))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("S", [32, 200])
def test_prefill_and_decode(f32, S):
    """Prefill logits and KV cache, then 8 teacher-forced decode steps."""
    _, _, jm, jp, tm = f32
    rng = np.random.default_rng(S)
    toks = rng.integers(0, 512, (2, S))
    forced = rng.integers(0, 512, (8, 2))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                        capacity=S + 8)
    with torch.inference_mode():
        tl, tc = tm.prefill(torch.from_numpy(toks), capacity=S + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(),
                                   np.asarray(jc["layers_dense"][k]), **TOL)
    decode = jax.jit(jm.decode_step)
    for i, tok in enumerate(forced):
        jl, jc = decode(jp, jc, jnp.asarray(tok, jnp.int32),
                        jnp.int32(S + i))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tc, torch.from_numpy(tok), S + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(),
                               np.asarray(jc["layers_dense"]["k"]), **TOL)


def test_prefill_bf16_compute():
    """bf16 compute (f32 params), the full config's numerics: prefill
    logits within atol=rtol=5e-2 (the observed maximum is printed)."""
    jcfg, tcfg = _cfgs(compute_dtype="bfloat16")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = DecoderLM.from_tree(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    toks = np.random.default_rng(5).integers(0, 512, (2, 200))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        tl, tc = tm.prefill(torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tc["k"].dtype == torch.bfloat16
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    print(f"bf16 prefill logits: max |port - reference| = {err:.3e}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("flags,shape", [
    ([], (8, 32, 64)),  # the CLI's defaults
    (["--batch", "4", "--prompt-len", "24", "--max-new", "20"], (4, 24, 20)),
], ids=["defaults", "small"])
def test_serve_prints_reference_tokens(monkeypatch, capsys, flags, shape):
    """The CLIs on the same flags print the same sample token ids (both
    default to xlstm-125m, so qwen3 is named on both)."""
    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, *flags])
    jserve.main()
    j_out = capsys.readouterr().out
    res = tserve.main(["--arch", ARCH, *flags, "--device", "cpu"])
    t_out = capsys.readouterr().out

    def ids(out):
        line, = [ln for ln in out.splitlines()
                 if ln.startswith("sample token ids[0]:")]
        return line

    B, S, n = shape
    assert ids(t_out) == ids(j_out)
    assert t_out.splitlines()[0].startswith(f"arch={ARCH} prefill({B}x{S}) ")
    assert res.gen.shape == (B, n)


@pytest.mark.parametrize("flags", [["--arch", "gpt-2"],
                                   ["--arch", "qwen3"],
                                   ["--arch", "zamba2-7b"]])
def test_serve_refuses_unported(flags, monkeypatch, capsys):
    """Every architecture of the reference's zoo is served; an --arch
    outside it is refused, as the reference's launcher refuses it."""
    with pytest.raises(SystemExit):
        tserve.parse_args(flags)
    assert "invalid choice" in capsys.readouterr().err
    monkeypatch.setattr("sys.argv", ["serve", *flags])
    with pytest.raises(SystemExit):
        jserve.main()
    assert "invalid choice" in capsys.readouterr().err


def test_unported_paths_raise(f32):
    """What the port still refuses: an arch outside the zoo (KeyError, as
    the reference's ``ARCHS[...]``).  The paths this test once saw
    refused now equal the reference's: attention under a window (within
    it: the flash kernel; past it: the window mask), cross-attention,
    and a windowed decoder's prefill."""
    jcfg, tcfg, jm, jp, tm = f32
    with pytest.raises(KeyError):
        get_config("gpt-2")
    with pytest.raises(KeyError):
        jget_config("gpt-2")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 8, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((1, 5, tcfg.d_model)).astype(np.float32)
    pos = np.arange(8, dtype=np.int32)
    attn_t = tm.layers[0].tree["attn"]
    attn_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers_dense"])[
        "attn"]
    for kw in (dict(window=4), dict(window=16)):
        np.testing.assert_allclose(
            tlayers.full_attention(attn_t, tcfg, torch.from_numpy(x),
                                   torch.from_numpy(pos), **kw).numpy(),
            np.asarray(jlayers.full_attention(attn_j, jcfg, jnp.asarray(x),
                                              jnp.asarray(pos), **kw)),
            atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        tlayers.full_attention(attn_t, tcfg, torch.from_numpy(x),
                               torch.from_numpy(pos),
                               memory=torch.from_numpy(mem)).numpy(),
        np.asarray(jlayers.full_attention(attn_j, jcfg, jnp.asarray(x),
                                          jnp.asarray(pos),
                                          memory=jnp.asarray(mem))),
        atol=2e-5, rtol=2e-5)
    jw, tw = _cfgs(sliding_window=16)
    toks = rng.integers(0, 512, (1, 40))
    jl, _ = jbuild(jw).prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.inference_mode():
        tl, _ = DecoderLM(tw, tm.top.tree, [layer.tree for layer in
                                            tm.layers]).prefill(
            torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_cuda_default_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the CUDA path runs in chip_smoke.py")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tcfg).init(prng_key(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.run(tcfg, 1, 4, 1)
