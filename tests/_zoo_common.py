"""Shared helpers of the zoo's parity tests (``test_torch_zoo*.py``,
``test_torch_moe.py``, ``test_torch_ssm.py``, ``test_torch_xlstm.py``):
the reduced configs of both packages, the reference's weights carried
across, the two packages' caches in one flat layout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import build_model as jbuild
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models.transformer import STACKS

TOL = dict(atol=1e-4, rtol=1e-4)


def cfgs(arch, **kw):
    return (dataclasses.replace(jreduced(jget_config(arch)), **kw),
            dataclasses.replace(reduced_config(get_config(arch)), **kw))


def setup(arch, **kw):
    """(jax cfg, port cfg, jax model, jax params, port model on the
    reference's weights)."""
    jcfg, tcfg = cfgs(arch, **kw)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = STACKS[tcfg.family].from_tree(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))
    return jcfg, tcfg, jm, jp, tm


def inputs(cfg, B, S, seed):
    """(tokens (B, S) int, the family's extra prefill inputs as numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    extra = {}
    if cfg.family == "vlm":
        extra["prefix_embeds"] = rng.normal(
            0, 0.1, (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["enc_frames"] = rng.normal(
            0, 0.1, (B, S, cfg.d_model)).astype(np.float32)
    return toks, extra


def prefix_len(cfg):
    return cfg.n_prefix_tokens if cfg.family == "vlm" else 0


def jax_prefill(jm, jp, toks, extra, capacity):
    batch = {"tokens": jnp.asarray(toks, jnp.int32),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    return jm.prefill(jp, batch, capacity=capacity)


def port_prefill(tm, cfg, toks, extra, capacity):
    with torch.inference_mode():
        kw = {k: torch.from_numpy(v) for k, v in extra.items()}
        if cfg.family == "ssm":
            return tm.prefill(torch.from_numpy(toks))
        return tm.prefill(torch.from_numpy(toks), capacity=capacity, **kw)


def flat_jax_cache(family, c):
    """The reference's cache as {name: array}, in the port's layout."""
    c = jax.tree_util.tree_map(np.asarray, c)
    if family in ("dense", "moe", "vlm"):
        stacks = [c[n] for n in ("layers_dense", "layers_moe") if n in c]
        return {kv: np.concatenate([s[kv] for s in stacks])
                for kv in ("k", "v")}
    if family == "hybrid":
        return {"k": c["k"], "v": c["v"], "ssm": c["ssm"]["ssm"],
                "conv": c["ssm"]["conv"]}
    if family == "ssm":
        return {**{f"m{i}": a for i, a in enumerate(c["m"])},
                **{f"s{i}": a for i, a in enumerate(c["s"])}}
    return {k: c[k] for k in ("k", "v", "mk", "mv")}


def flat_port_cache(family, c):
    if family == "hybrid":
        return {"k": c["k"], "v": c["v"], "ssm": c["ssm"]["ssm"],
                "conv": c["ssm"]["conv"]}
    if family == "ssm":
        return {**{f"m{i}": a for i, a in enumerate(c["m"])},
                **{f"s{i}": a for i, a in enumerate(c["s"])}}
    keys = ("k", "v", "mk", "mv") if family == "audio" else ("k", "v")
    return {k: c[k] for k in keys}


def assert_cache_close(family, tc, jc, tol=TOL):
    want = flat_jax_cache(family, jc)
    got = flat_port_cache(family, tc)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, **tol,
                                   err_msg=name)


def port_tree(model):
    """The port model's parameters in the reference's tree layout (stacked
    leaves), as numpy."""
    def stack(trees):
        first = trees[0]
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([t[k].numpy() for t in trees])
                for k, v in first.items()}

    def np_tree(t):
        return {k: np_tree(v) if isinstance(v, dict) else v.numpy()
                for k, v in t.items()}

    cfg = model.cfg
    out = np_tree(model.top.tree)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        n_dense = model.n_dense(cfg)
        trees = [layer.tree for layer in model.layers]
        if n_dense:
            out["layers_dense"] = stack(trees[:n_dense])
        if len(trees) > n_dense:
            out["layers_moe"] = stack(trees[n_dense:])
    elif fam == "hybrid":
        L = model.per_group
        trees = [m.tree for m in model.mamba]
        groups = [stack(trees[g * L:(g + 1) * L])
                  for g in range(model.n_groups)]
        out["mamba"] = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                              *groups)
        out["shared_attn"] = np_tree(model.shared.tree)
    elif fam == "ssm":
        out["mblocks"] = stack([b.tree for b in model.mblocks])
        out["sblocks"] = stack([b.tree for b in model.sblocks])
    else:
        out["enc"] = stack([b.tree for b in model.enc])
        out["dec"] = stack([b.tree for b in model.dec])
    return out


def leaves(tree, pre=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def ulps(a, b) -> int:
    """The largest distance in f32 units in the last place."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max()) if ia.size else 0


_SETUPS = {}


def cached_setup(arch):
    """:func:`setup` of ``arch``, made once per test process."""
    if arch not in _SETUPS:
        _SETUPS[arch] = setup(arch)
    return _SETUPS[arch]


_DECODES = {}


def jax_decode(arch):
    """The reference's ``decode_step`` under ``jax.jit``, one per arch and
    process (its compilations cached across tests)."""
    if arch not in _DECODES:
        _DECODES[arch] = jax.jit(cached_setup(arch)[2].decode_step)
    return _DECODES[arch]


def one_torch_thread():
    """Torch ops on one thread for a module's tests: the reduced models'
    ops are too small for a pool, which only contends with the other test
    processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_init(arch):
    """Every leaf of the port's init(prng_key(0)) bitwise the reference's
    init(PRNGKey(0))."""
    from repro_torch.models import build_model
    from repro_torch.prng import prng_key
    _, tcfg, _, jp, _ = cached_setup(arch)
    got = dict(leaves(port_tree(build_model(tcfg).init(prng_key(0),
                                                       "cpu"))))
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, jp)))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert ulps(g, w) == 0, (path, ulps(g, w))


#: the cache capacity of every prefill of :func:`check_prefill_decode`
#: (the longest prompt, 200, and its decode steps), so that the jitted
#: decode compiles once per arch
CAPACITY = 208


def check_prefill_decode(arch, S, steps=8):
    """Prefill logits and cache or state, then ``steps`` teacher-forced
    decode steps, against the reference (MoE: 8 prompts, so that at
    S = 200 the tokens fill whole groups of 64)."""
    jcfg, tcfg, jm, jp, tm = cached_setup(arch)
    B = 8 if tcfg.family == "moe" else 2
    toks, extra = inputs(tcfg, B, S, S)
    pre = prefix_len(tcfg)
    cap = CAPACITY + pre
    jl, jc = jax_prefill(jm, jp, toks, extra, cap)
    tl, tc = port_prefill(tm, tcfg, toks, extra, cap)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_cache_close(tcfg.family, tc, jc)
    forced = np.random.default_rng(S + 1).integers(0, tcfg.vocab_size,
                                                   (steps, B))
    decode = jax_decode(arch)
    for i, tok in enumerate(forced):
        jl, jc = decode(jp, jc, jnp.asarray(tok, jnp.int32),
                        jnp.int32(S + pre + i))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tc, torch.from_numpy(tok), S + pre + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {i}")
    assert_cache_close(tcfg.family, tc, jc)
