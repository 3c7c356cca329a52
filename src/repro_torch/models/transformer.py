"""The model zoo's stacks for serving (the reference's
``models/transformer.py``): prefill fills a KV cache or recurrent state,
decode steps against it.

  * :class:`DecoderLM` (dense, moe, vlm; the reference's
    ``_build_decoder_lm``, ``:121-284``): the ``first_k_dense`` dense
    layers, then the MoE layers (:mod:`.moe`, a shared expert beside
    the routed ones); the VLM projects its patch-embedding prefix and
    puts it before the prompt, so decode runs at ``pos = S + n_prefix +
    i``.
  * :class:`HybridLM` (zamba2, ``:292-406``): groups of Mamba2 layers
    (:mod:`.ssm`), the one shared attention block after each group with
    a KV cache of its own per group.
  * :class:`XLSTMLM` (``:414-493``): mLSTM / sLSTM pairs (:mod:`.xlstm`);
    prefill hands the mLSTM's closed-form states and the sLSTM's carry to
    decode.
  * :class:`EncDecLM` (seamless, ``:501-658``): a non-causal encoder over
    frame embeddings, a causal decoder with cross-attention whose K / V
    are computed once at prefill.

Each module keeps its parameters in the reference's nested-dict layout
(``(in, out)`` dense weights), so :func:`repro_torch.convert.params_from_jax`
copies the reference's tree across leaf by leaf (the reference stacks
layer i's leaves at index i of axis 0; the hybrid's Mamba2 layers at
(group, layer) of axes 0 and 1), and ``init`` draws every weight from a
reference key in the reference's order, so ``init(prng_key(0))`` gives
the reference's ``init(PRNGKey(0))``, drawn on the device
(:func:`repro_torch.prng.normal_torch`, bitwise ``jax.random.normal``).

Serving: self-attention at prefill goes through the flash kernel
(:func:`repro_torch.models.layers.full_attention`): once a layer in the
decoder LMs, once a group in the hybrid, once a layer in both of the
enc-dec's stacks.  ``decode_step(cache, tokens, pos, window=None)``
passes ``window`` to every attention layer, as the reference's does
(prefill keeps ``cfg.sliding_window``).  The modules' parameters take no
gradient.  KV caches are (layers, B, capacity, Hkv, hd) in the compute
dtype, written in place by decode.

Training is functional over the reference's params tree (the layers
stacked on axis 0, as :func:`init_params` draws it and
:func:`repro_torch.convert.params_from_jax` carries it across):
``forward(cfg, params, batch)`` and ``train_loss(cfg, params, batch) ->
(loss, metrics)``, the reference's per family (``:176-195, 318-340,
434-454, 566-584``): the decoders return ``loss + 0.01 * aux`` (the MoE
layers' Switch aux losses summed) with ``{"loss", "aux"}``, the others
``{"loss"}``.  Each stack's leaves are unbound into per-layer views once
(their gradients stack back in one op); attention runs the training form
(``full_attention(..., train=True)``, never the flash kernel); the
embedding lookup is ``F.embedding``, whose backward is deterministic on
the card; with ``cfg.remat`` each of the reference's scanned bodies runs
under ``torch.utils.checkpoint`` (non-reentrant, nothing saved but its
inputs), as ``_maybe_remat`` does (``:54-56``).  Gradients come from
autograd: :func:`repro_torch.launch.steps.value_and_grad`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import prng
from repro_torch import tree as treemod
from repro_torch.device import resolve_device
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class ParamTree(nn.Module):
    """A nested dict of tensors held as this module's parameters (no
    gradient), read back in the same layout by :attr:`tree`."""

    def __init__(self, tree: Dict[str, object]):
        super().__init__()
        self._names = {}
        for path, t in _leaves(tree):
            name = "__".join(path)
            self.register_parameter(name, nn.Parameter(t,
                                                       requires_grad=False))
            self._names[path] = name

    @property
    def tree(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for path, name in self._names.items():
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = getattr(self, name)
        return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class DecoderLayer(ParamTree):
    """Pre-norm decoder layer: ``{"ln1", "attn", "ln2", "mlp"}``, or
    ``"moe"`` in place of ``"mlp"``."""

    def __init__(self, cfg, tree: Dict[str, object]):
        super().__init__(tree)
        self.cfg = cfg

    @staticmethod
    def init_tree(cfg, key: prng.Key, dtype, device,
                  use_moe: bool = False) -> Dict[str, object]:
        k1, k2 = prng.split(key, 2)
        p = {
            "ln1": layers.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": layers.attention_init(k1, cfg, dtype, device),
            "ln2": layers.rmsnorm_init(cfg.d_model, dtype, device),
        }
        if use_moe:
            p["moe"] = moe_lib.moe_init(k2, cfg, dtype, device)
        else:
            p["mlp"] = layers.mlp_init(k2, cfg, dtype, device)
        return p

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: Optional[int] = None):
        """Prefill: (B, S, D) -> ((B, S, D), (k, v))."""
        x, _, kv = decoder_layer(self.cfg, self.tree, x, positions, window)
        return x, kv

    def decode(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: int, window: Optional[int] = None) -> torch.Tensor:
        """One token: (B, 1, D) -> (B, 1, D), the cache written in
        place."""
        cfg, p = self.cfg, self.tree
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn, _, _ = layers.decode_attention(p["attn"], cfg, h, ck, cv, pos,
                                             window=window)
        x = x + attn
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + _ffn(cfg, p, h)[0]


def _ffn(cfg, p, h: torch.Tensor):
    """The layer's MLP or MoE -> (y, the MoE's aux loss; 0.0 for an MLP,
    so serving launches nothing for it)."""
    if "moe" in p:
        return moe_lib.moe_apply(p["moe"], cfg, h)
    return layers.mlp(p["mlp"], cfg, h), 0.0


def decoder_layer(cfg, p, x: torch.Tensor, positions: torch.Tensor,
                  window: Optional[int] = None, *, train: bool = False):
    """The pre-norm decoder layer of tree ``p`` (the reference's
    ``_decoder_layer_apply``): (B, S, D) -> ((B, S, D), aux, (k, v));
    ``train`` picks the training form of attention."""
    h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
    attn, kv = layers.full_attention(p["attn"], cfg, h, positions,
                                     window=window, return_kv=True,
                                     train=train)
    x = x + attn
    h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
    y, aux = _ffn(cfg, p, h)
    return x + y, aux, kv


class _LM(nn.Module):
    """The embedding, final norm and head (``top``) that every stack
    shares."""

    def __init__(self, cfg, top: Dict[str, object]):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.top = ParamTree(top)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        top = self.top.tree
        x = layers.rmsnorm(top["ln_f"], x, self.cfg.norm_eps)
        return layers.lm_head(top["embed"], top.get("head"), x,
                              self.cfg.tie_embeddings)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.top.tree["embed"][tokens].to(
            _dtype(self.cfg.compute_dtype))

    @staticmethod
    def _top(cfg, ke, kh, dtype, device, tied: bool = False):
        top = {
            "embed": layers.embed_init(ke, cfg.padded_vocab, cfg.d_model,
                                       dtype, device),
            "ln_f": layers.rmsnorm_init(cfg.d_model, dtype, device),
        }
        if not tied:
            top["head"] = layers.dense_init(kh, cfg.d_model,
                                            cfg.padded_vocab, dtype, device)
        return top


def _kv_cache(cfg, n: int, B: int, capacity: int, dtype, device):
    shape = (n, B, capacity, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class DecoderLM(_LM):
    """Dense, MoE and VLM decoders: embedding, ``layers`` (a
    ``ModuleList`` of :class:`DecoderLayer`: the dense ones, then the MoE
    ones), final norm and untied head (the tied head reads the
    embedding), and the VLM's ``projector``."""

    def __init__(self, cfg, top: Dict[str, object], layer_trees):
        super().__init__(cfg, top)
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM serves dense, moe and vlm, not "
                             f"{cfg.family!r}")
        self.layers = nn.ModuleList(DecoderLayer(cfg, t) for t in layer_trees)

    @staticmethod
    def n_dense(cfg) -> int:
        return cfg.first_k_dense if cfg.family == "moe" else cfg.n_layers

    @classmethod
    def from_tree(cls, cfg, tree: Dict[str, object]) -> "DecoderLM":
        """From the reference's params layout: ``layers_dense`` then
        ``layers_moe``, leaves stacked on axis 0 (layer i reads views of
        index i)."""
        n_dense = cls.n_dense(cfg)
        trees = [_index(tree["layers_dense"], i) for i in range(n_dense)]
        trees += [_index(tree["layers_moe"], i)
                  for i in range(cfg.n_layers - n_dense)]
        return cls(cfg, {k: v for k, v in tree.items()
                         if k not in ("layers_dense", "layers_moe")}, trees)

    @classmethod
    def parts(cls, cfg, key: prng.Key, device):
        """The weights drawn from the reference key ``key`` on ``device``:
        ``split(key, 5)`` -> embed, dense stack, moe stack, head,
        projector; each stack's key split into its layers, each layer's
        in 2 (attention, then MLP or MoE).  -> (the top tree, [(stack
        name, a layer's init of its key, the layers' keys)])."""
        dtype = _dtype(cfg.param_dtype)
        n_dense = cls.n_dense(cfg)
        n_moe = cfg.n_layers - n_dense
        ke, kd, km, kh, kp = prng.split(key, 5)
        top = cls._top(cfg, ke, kh, dtype, device, cfg.tie_embeddings)
        if cfg.family == "vlm":
            top["projector"] = layers.dense_init(kp, cfg.d_model,
                                                 cfg.d_model, dtype, device)
        stacks = []
        if n_dense:
            stacks.append(("layers_dense", lambda k: DecoderLayer.init_tree(
                cfg, k, dtype, device), prng.split(kd, n_dense)))
        if n_moe:
            stacks.append(("layers_moe", lambda k: DecoderLayer.init_tree(
                cfg, k, dtype, device, True), prng.split(km, n_moe)))
        return top, stacks

    @classmethod
    def init(cls, cfg, key: prng.Key, device="cuda") -> "DecoderLM":
        """Weights drawn from the reference key ``key`` (:meth:`parts`) on
        ``device`` (the GPU unless the caller asks for the CPU)."""
        top, stacks = cls.parts(cfg, key, resolve_device(device))
        return cls(cfg, top, [make(k) for _, make, keys in stacks
                              for k in keys])

    def _inputs(self, tokens: torch.Tensor, prefix_embeds=None):
        x = self._embed(tokens)
        if self.cfg.family == "vlm" and prefix_embeds is not None:
            cdt = x.dtype
            pre = (prefix_embeds.to(cdt)
                   @ self.top.tree["projector"].to(cdt))
            x = torch.cat([pre, x], dim=1)
        return x

    def prefill(self, tokens: torch.Tensor, capacity: Optional[int] = None,
                prefix_embeds: Optional[torch.Tensor] = None):
        """tokens (B, S) (after the VLM's ``prefix_embeds`` (B, P, D), if
        given) -> (logits of the last position (B, V) f32, the KV cache
        with room for ``capacity`` >= P + S positions)."""
        cfg = self.cfg
        x = self._inputs(tokens, prefix_embeds)
        B, S = x.shape[0], x.shape[1]
        capacity = max(capacity or S, S)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        cache = _kv_cache(cfg, len(self.layers), B, capacity, x.dtype,
                          x.device)
        for i, layer in enumerate(self.layers):
            x, (k, v) = layer(x, positions, cfg.sliding_window)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        return self._logits(x[:, -1:])[:, 0], cache

    def decode_step(self, cache, tokens: torch.Tensor, pos: int,
                    window: Optional[int] = None):
        """tokens (B,) at absolute position ``pos`` -> (logits (B, V) f32,
        the cache, written in place); ``window`` masks (and, on a cache
        of the window's capacity, rings) every layer's attention."""
        x = self._embed(tokens)[:, None, :]
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache["k"][i], cache["v"][i], pos, window)
        return self._logits(x)[:, 0], cache


class HybridLM(_LM):
    """Zamba2: ``mamba`` (a ``ModuleList`` of ``{"ln", "ssm"}`` trees,
    group g's layer l at index g * per_group + l) and ``shared``, the one
    attention + MLP block applied after each group."""

    def __init__(self, cfg, top, mamba_trees, shared_tree):
        super().__init__(cfg, top)
        self.per_group = cfg.hybrid_attn_every - 1
        self.n_groups = cfg.n_layers // cfg.hybrid_attn_every
        self.mamba = nn.ModuleList(ParamTree(t) for t in mamba_trees)
        self.shared = DecoderLayer(cfg, shared_tree)

    @classmethod
    def from_tree(cls, cfg, tree) -> "HybridLM":
        G, L = (cfg.n_layers // cfg.hybrid_attn_every,
                cfg.hybrid_attn_every - 1)
        mamba = [_index(_index(tree["mamba"], g), l)
                 for g in range(G) for l in range(L)]
        return cls(cfg, {k: tree[k] for k in ("embed", "ln_f", "head")},
                   mamba, tree["shared_attn"])

    @classmethod
    def parts(cls, cfg, key: prng.Key, device):
        """``split(key, 4)`` -> embed, mamba, shared attention, head; the
        mamba key split into groups, each group's into its layers.  ->
        (the top tree with ``shared_attn``, a mamba layer's init of its
        key, the groups' lists of layer keys)."""
        dtype = _dtype(cfg.param_dtype)
        ke, km, ka, kh = prng.split(key, 4)
        G, L = (cfg.n_layers // cfg.hybrid_attn_every,
                cfg.hybrid_attn_every - 1)
        top = cls._top(cfg, ke, kh, dtype, device)
        top["shared_attn"] = DecoderLayer.init_tree(cfg, ka, dtype, device)

        def mamba(k):
            return {"ln": layers.rmsnorm_init(cfg.d_model, dtype, device),
                    "ssm": ssm_lib.ssm_init(k, cfg, dtype, device)}
        return top, mamba, [prng.split(gk, L) for gk in prng.split(km, G)]

    @classmethod
    def init(cls, cfg, key: prng.Key, device="cuda") -> "HybridLM":
        """Weights drawn from the reference key ``key`` (:meth:`parts`)."""
        top, mamba, groups = cls.parts(cfg, key, resolve_device(device))
        shared = top.pop("shared_attn")
        return cls(cfg, top, [mamba(k) for keys in groups for k in keys],
                   shared)

    def prefill(self, tokens: torch.Tensor,
                capacity: Optional[int] = None):
        """-> (last-position logits, ``{"ssm": {"ssm": (G, L, B, H, P, N)
        f32, "conv": (G, L, B, k - 1, Ch)}, "k", "v": (G, B, capacity,
        Hkv, hd)}``)."""
        cfg = self.cfg
        x = self._embed(tokens)
        B, S = tokens.shape
        capacity = max(capacity or S, S)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        G, L = self.n_groups, self.per_group
        cache = _kv_cache(cfg, G, B, capacity, x.dtype, x.device)
        states = []
        for g in range(G):
            for l in range(L):
                lp = self.mamba[g * L + l].tree
                h = layers.rmsnorm(lp["ln"], x, cfg.norm_eps)
                y, st = ssm_lib.ssd_forward(lp["ssm"], cfg, h,
                                            return_state=True)
                x = x + y
                states.append(st)
            x, (k, v) = self.shared(x, positions, None)
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
        cache["ssm"] = {
            n: torch.stack([st[n] for st in states]).reshape(
                G, L, *states[0][n].shape) for n in ("ssm", "conv")}
        return self._logits(x[:, -1:])[:, 0], cache

    def decode_step(self, cache, tokens: torch.Tensor, pos: int,
                    window: Optional[int] = None):
        cfg = self.cfg
        x = self._embed(tokens)[:, None, :]
        L = self.per_group
        ss, cs = cache["ssm"]["ssm"], cache["ssm"]["conv"]
        for g in range(self.n_groups):
            for l in range(L):
                lp = self.mamba[g * L + l].tree
                h = layers.rmsnorm(lp["ln"], x, cfg.norm_eps)
                y, st = ssm_lib.ssd_decode_step(
                    lp["ssm"], cfg, h, {"ssm": ss[g, l], "conv": cs[g, l]})
                x = x + y
                ss[g, l] = st["ssm"]
                cs[g, l] = st["conv"]
            x = self.shared.decode(x, cache["k"][g], cache["v"][g], pos,
                                   window)
        return self._logits(x)[:, 0], cache


class XLSTMLM(_LM):
    """xLSTM: ``mblocks`` and ``sblocks``, one of each a pair."""

    def __init__(self, cfg, top, mtrees, strees):
        super().__init__(cfg, top)
        if tuple(cfg.block_pattern) != ("mlstm", "slstm"):
            raise ValueError("the xLSTM stack takes alternating (mlstm, "
                             f"slstm) pairs, not {cfg.block_pattern}")
        self.mblocks = nn.ModuleList(ParamTree(t) for t in mtrees)
        self.sblocks = nn.ModuleList(ParamTree(t) for t in strees)

    @classmethod
    def from_tree(cls, cfg, tree) -> "XLSTMLM":
        n = cfg.n_layers // 2
        return cls(cfg, {k: tree[k] for k in ("embed", "ln_f", "head")},
                   [_index(tree["mblocks"], i) for i in range(n)],
                   [_index(tree["sblocks"], i) for i in range(n)])

    @classmethod
    def parts(cls, cfg, key: prng.Key, device):
        """``split(key, 4)`` -> embed, mLSTM blocks, sLSTM blocks, head.
        -> (the top tree, [(stack name, a block's init, the keys)])."""
        dtype = _dtype(cfg.param_dtype)
        ke, k1, k2, kh = prng.split(key, 4)
        n = cfg.n_layers // 2
        return cls._top(cfg, ke, kh, dtype, device), [
            ("mblocks", lambda k: xlstm.mlstm_block_init(k, cfg, dtype,
                                                         device),
             prng.split(k1, n)),
            ("sblocks", lambda k: xlstm.slstm_block_init(k, cfg, dtype,
                                                         device),
             prng.split(k2, n))]

    @classmethod
    def init(cls, cfg, key: prng.Key, device="cuda") -> "XLSTMLM":
        """Weights drawn from the reference key ``key`` (:meth:`parts`)."""
        top, stacks = cls.parts(cfg, key, resolve_device(device))
        return cls(cfg, top, *([make(k) for k in keys]
                               for _, make, keys in stacks))

    def prefill(self, tokens: torch.Tensor,
                capacity: Optional[int] = None):
        """-> (last-position logits, ``{"m": (C, n, m), "s": (c, n, h,
        m)}``, each leaf stacked over the pairs); ``capacity`` is unused
        (the state is O(1))."""
        del capacity
        x = self._embed(tokens)
        mst, sst = [], []
        for mb, sb in zip(self.mblocks, self.sblocks):
            x, st = xlstm.mlstm_block(mb.tree, self.cfg, x,
                                      return_state=True)
            mst.append(st)
            x, st = xlstm.slstm_block(sb.tree, self.cfg, x)
            sst.append(st)
        return self._logits(x[:, -1:])[:, 0], {"m": _stack(mst),
                                               "s": _stack(sst)}

    def decode_step(self, cache, tokens: torch.Tensor, pos: int,
                    window: Optional[int] = None):
        del pos, window  # recurrent: no positions, no window
        x = self._embed(tokens)[:, None, :]
        mst, sst = [], []
        for i, (mb, sb) in enumerate(zip(self.mblocks, self.sblocks)):
            x, st = xlstm.mlstm_block(
                mb.tree, self.cfg, x, tuple(t[i] for t in cache["m"]),
                decode=True)
            mst.append(st)
            x, st = xlstm.slstm_block(sb.tree, self.cfg, x,
                                      tuple(t[i] for t in cache["s"]))
            sst.append(st)
        return self._logits(x)[:, 0], {"m": _stack(mst), "s": _stack(sst)}


class EncDecLM(_LM):
    """The audio encoder-decoder: ``enc`` (``{"ln1", "attn", "ln2",
    "mlp"}``) and ``dec`` (``{"ln1", "attn", "lnx", "xattn", "ln2",
    "mlp"}``) layers; ``top`` adds the encoder's final norm ``ln_enc``."""

    def __init__(self, cfg, top, enc_trees, dec_trees):
        super().__init__(cfg, top)
        self.enc = nn.ModuleList(ParamTree(t) for t in enc_trees)
        self.dec = nn.ModuleList(ParamTree(t) for t in dec_trees)

    @classmethod
    def from_tree(cls, cfg, tree) -> "EncDecLM":
        Le = cfg.enc_layers or cfg.n_layers
        return cls(cfg, {k: tree[k] for k in ("embed", "ln_enc", "ln_f",
                                              "head")},
                   [_index(tree["enc"], i) for i in range(Le)],
                   [_index(tree["dec"], i) for i in range(cfg.n_layers)])

    @classmethod
    def parts(cls, cfg, key: prng.Key, device):
        """``split(key, 4)`` -> embed, encoder, decoder, head; an encoder
        layer's key split in 2 (attention, MLP), a decoder layer's in 3
        (self-attention, cross-attention, MLP).  -> (the top tree with
        ``ln_enc``, [(stack name, a layer's init, the keys)])."""
        dtype = _dtype(cfg.param_dtype)
        ke, k1, k2, kh = prng.split(key, 4)
        D = cfg.d_model

        def enc_layer(key):
            a, m = prng.split(key, 2)
            return {"ln1": layers.rmsnorm_init(D, dtype, device),
                    "attn": layers.attention_init(a, cfg, dtype, device),
                    "ln2": layers.rmsnorm_init(D, dtype, device),
                    "mlp": layers.mlp_init(m, cfg, dtype, device)}

        def dec_layer(key):
            a, xa, m = prng.split(key, 3)
            return {"ln1": layers.rmsnorm_init(D, dtype, device),
                    "attn": layers.attention_init(a, cfg, dtype, device),
                    "lnx": layers.rmsnorm_init(D, dtype, device),
                    "xattn": layers.attention_init(xa, cfg, dtype, device),
                    "ln2": layers.rmsnorm_init(D, dtype, device),
                    "mlp": layers.mlp_init(m, cfg, dtype, device)}

        top = cls._top(cfg, ke, kh, dtype, device)
        top["ln_enc"] = layers.rmsnorm_init(D, dtype, device)
        return top, [
            ("enc", enc_layer, prng.split(k1, cfg.enc_layers or cfg.n_layers)),
            ("dec", dec_layer, prng.split(k2, cfg.n_layers))]

    @classmethod
    def init(cls, cfg, key: prng.Key, device="cuda") -> "EncDecLM":
        """Weights drawn from the reference key ``key`` (:meth:`parts`)."""
        top, stacks = cls.parts(cfg, key, resolve_device(device))
        return cls(cfg, top, *([make(k) for k in keys]
                               for _, make, keys in stacks))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, T, D) -> the encoder's memory (B, T, D):
        non-causal self-attention through the flash kernel."""
        cfg = self.cfg
        x = frames.to(_dtype(cfg.compute_dtype))
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for layer in self.enc:
            lp = layer.tree
            h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            x = x + layers.full_attention(lp["attn"], cfg, h, positions,
                                          causal=False)
            h = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + layers.mlp(lp["mlp"], cfg, h)
        return layers.rmsnorm(self.top.tree["ln_enc"], x, cfg.norm_eps)

    def prefill(self, tokens: torch.Tensor, capacity: Optional[int] = None,
                enc_frames: Optional[torch.Tensor] = None):
        """-> (last-position logits, ``{"k", "v": (L, B, capacity, Hkv,
        hd), "mk", "mv": (L, B, T, Hkv, hd)}``: the decoder's KV cache and
        each layer's cross-attention K / V of the encoder's memory)."""
        cfg = self.cfg
        mem = self.encode(enc_frames)
        x = self._embed(tokens)
        B, S = tokens.shape
        capacity = max(capacity or S, S)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        L, Sm, hd = cfg.n_layers, mem.shape[1], cfg.hd
        cache = _kv_cache(cfg, L, B, capacity, x.dtype, x.device)
        mshape = (L, B, Sm, cfg.n_kv_heads, hd)
        cache["mk"] = torch.empty(mshape, dtype=mem.dtype, device=x.device)
        cache["mv"] = torch.empty(mshape, dtype=mem.dtype, device=x.device)
        for i, layer in enumerate(self.dec):
            lp = layer.tree
            h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            a, (k, v) = layers.full_attention(lp["attn"], cfg, h, positions,
                                              return_kv=True)
            x = x + a
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            h = layers.rmsnorm(lp["lnx"], x, cfg.norm_eps)
            x = x + layers.full_attention(lp["xattn"], cfg, h, positions,
                                          memory=mem)
            h = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + layers.mlp(lp["mlp"], cfg, h)
            xa = lp["xattn"]
            cache["mk"][i] = (mem @ xa["wk"].to(mem.dtype)).reshape(
                B, Sm, cfg.n_kv_heads, hd)
            cache["mv"][i] = (mem @ xa["wv"].to(mem.dtype)).reshape(
                B, Sm, cfg.n_kv_heads, hd)
        return self._logits(x[:, -1:])[:, 0], cache

    def decode_step(self, cache, tokens: torch.Tensor, pos: int,
                    window: Optional[int] = None):
        cfg = self.cfg
        x = self._embed(tokens)[:, None, :]
        for i, layer in enumerate(self.dec):
            lp = layer.tree
            h = layers.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            a, _, _ = layers.decode_attention(
                lp["attn"], cfg, h, cache["k"][i], cache["v"][i], pos,
                window=window)
            x = x + a
            h = layers.rmsnorm(lp["lnx"], x, cfg.norm_eps)
            x = x + layers.cross_attention_decode(
                lp["xattn"], cfg, h, cache["mk"][i], cache["mv"][i])
            h = layers.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            x = x + layers.mlp(lp["mlp"], cfg, h)
        return self._logits(x)[:, 0], cache


def _stack(states):
    """A list of per-layer tuples of tensors -> a tuple of stacked
    tensors."""
    return tuple(torch.stack(ts) for ts in zip(*states))


def _index(tree, i: int):
    """Layer i's tree (views into the stacked leaves)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


#: the stack of each family
STACKS = {"dense": DecoderLM, "moe": DecoderLM, "vlm": DecoderLM,
          "hybrid": HybridLM, "ssm": XLSTMLM, "audio": EncDecLM}


# ===========================================================================
# Training: functional over the reference's params tree
# ===========================================================================


def _stacked(make, keys):
    """``make(key)`` of each key -> one tree of (len(keys), ...) leaves,
    filled a layer at a time (one layer's tree beside the stack)."""
    out = None
    for i, k in enumerate(keys):
        t = make(k)
        if out is None:
            out = treemod.tree_map(
                lambda leaf: leaf.new_empty((len(keys),) + leaf.shape), t)
        treemod.tree_map(lambda o, leaf: o[i].copy_(leaf), out, t)
    return out


def init_params(cfg, key: prng.Key, device="cuda") -> Dict[str, object]:
    """The reference's ``init(key)``: the params tree, each stack's layers
    on axis 0 (the hybrid's Mamba2 layers (group, layer) on axes 0 and
    1), drawn from ``key`` on ``device`` as :meth:`init` draws the
    serving module's."""
    device = resolve_device(device)
    cls = STACKS[cfg.family]
    if cls is HybridLM:
        top, mamba, groups = cls.parts(cfg, key, device)
        return {**top, "mamba": _stacked(lambda keys: _stacked(mamba, keys),
                                         groups)}
    top, stacks = cls.parts(cfg, key, device)
    return {**top, **{name: _stacked(make, keys)
                      for name, make, keys in stacks}}


def _unstack(stacked, n: int):
    """A tree of (n, ...) leaves -> n trees of views, one ``unbind`` a
    leaf, so that autograd stacks the n layers' gradients in one op."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in stacked.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _n(stacked) -> int:
    return treemod.tree_leaves(stacked)[0].shape[0]


def _remat(cfg, fn):
    """``fn`` run under ``torch.utils.checkpoint`` with ``cfg.remat``:
    only its inputs are kept; the backward recomputes the rest."""
    if not cfg.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["embed"]).to(
        _dtype(cfg.compute_dtype))


def _head(cfg, params, x: torch.Tensor, tied: bool = False):
    x = layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return layers.lm_head(params["embed"], params.get("head"), x, tied)


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def _decoder_forward(cfg, params, batch, window=None):
    """Dense, MoE, VLM -> (logits (B, P + S, V) f32, the summed aux)."""
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm" and "prefix_embeds" in batch:
        cdt = x.dtype
        pre = batch["prefix_embeds"].to(cdt) @ params["projector"].to(cdt)
        x = torch.cat([pre, x], dim=1)
    positions = _positions(x)
    window = window or cfg.sliding_window
    body = _remat(cfg, lambda x, lp: decoder_layer(
        cfg, lp, x, positions, window, train=True)[:2])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name in ("layers_dense", "layers_moe"):
        if name in params:
            for lp in _unstack(params[name], _n(params[name])):
                x, a = body(x, lp)
                aux = aux + a
    return _head(cfg, params, x, cfg.tie_embeddings), aux


def _hybrid_forward(cfg, params, batch):
    """Groups of Mamba2 layers (each its own remat body), the shared
    attention block after each group -> logits."""
    x = _embed(cfg, params, batch["tokens"])
    positions = _positions(x)

    def mamba(x, lp):
        h = layers.rmsnorm(lp["ln"], x, cfg.norm_eps)
        return x + ssm_lib.ssd_forward(lp["ssm"], cfg, h)
    body = _remat(cfg, mamba)
    for group in _unstack(params["mamba"], _n(params["mamba"])):
        for lp in _unstack(group, _n(group)):
            x = body(x, lp)
        x = decoder_layer(cfg, params["shared_attn"], x, positions, None,
                          train=True)[0]
    return _head(cfg, params, x)


def _xlstm_forward(cfg, params, batch):
    """mLSTM / sLSTM pairs (a pair one remat body) -> logits."""
    x = _embed(cfg, params, batch["tokens"])

    def pair(x, mp, sp):
        x, _ = xlstm.mlstm_block(mp, cfg, x)
        return xlstm.slstm_block(sp, cfg, x)[0]
    body = _remat(cfg, pair)
    n = _n(params["mblocks"])
    for mp, sp in zip(_unstack(params["mblocks"], n),
                      _unstack(params["sblocks"], n)):
        x = body(x, mp, sp)
    return _head(cfg, params, x)


def _encdec_forward(cfg, params, batch):
    """The non-causal encoder over ``enc_frames``, then the decoder with
    cross-attention to its memory -> logits."""
    eps = cfg.norm_eps
    x = batch["enc_frames"].to(_dtype(cfg.compute_dtype))
    positions = _positions(x)

    def enc(x, lp):
        h = layers.rmsnorm(lp["ln1"], x, eps)
        x = x + layers.full_attention(lp["attn"], cfg, h, positions,
                                      causal=False, train=True)
        h = layers.rmsnorm(lp["ln2"], x, eps)
        return x + layers.mlp(lp["mlp"], cfg, h)
    body = _remat(cfg, enc)
    for lp in _unstack(params["enc"], _n(params["enc"])):
        x = body(x, lp)
    mem = layers.rmsnorm(params["ln_enc"], x, eps)

    x = _embed(cfg, params, batch["tokens"])
    positions = _positions(x)

    def dec(x, lp):
        h = layers.rmsnorm(lp["ln1"], x, eps)
        x = x + layers.full_attention(lp["attn"], cfg, h, positions,
                                      train=True)
        h = layers.rmsnorm(lp["lnx"], x, eps)
        x = x + layers.full_attention(lp["xattn"], cfg, h, positions,
                                      memory=mem, train=True)
        h = layers.rmsnorm(lp["ln2"], x, eps)
        return x + layers.mlp(lp["mlp"], cfg, h)
    body = _remat(cfg, dec)
    for lp in _unstack(params["dec"], _n(params["dec"])):
        x = body(x, lp)
    return _head(cfg, params, x)


_FORWARDS = {"hybrid": _hybrid_forward, "ssm": _xlstm_forward,
             "audio": _encdec_forward}


def forward(cfg, params, batch):
    """The training forward of ``params`` on ``batch`` (``tokens`` (B, S)
    int64; the VLM's ``prefix_embeds`` (B, P, D), the enc-dec's
    ``enc_frames`` (B, T, D)) -> logits (B, S, V) f32, and for the
    decoders (dense, moe, vlm; logits (B, P + S, V)) the summed aux
    loss beside them."""
    if cfg.family in ("dense", "moe", "vlm"):
        return _decoder_forward(cfg, params, batch)
    return _FORWARDS[cfg.family](cfg, params, batch)


def train_loss(cfg, params, batch):
    """-> (the loss to differentiate, metrics): the next-token cross
    entropy over ``tokens`` (``loss_mask`` (B, S - 1) optional); the
    decoders add ``0.01 * aux`` and report ``{"loss", "aux"}``, the rest
    ``{"loss"}``."""
    tokens = batch["tokens"]
    out = forward(cfg, params, batch)
    decoder = cfg.family in ("dense", "moe", "vlm")
    logits, aux = out if decoder else (out, None)
    if cfg.family == "vlm" and "prefix_embeds" in batch:
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
    loss = layers.cross_entropy(logits[:, :-1], tokens[:, 1:],
                                batch.get("loss_mask"))
    if not decoder:
        return loss, {"loss": loss}
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def param_count(params) -> int:
    return sum(leaf.numel() for leaf in treemod.tree_leaves(params))


@dataclasses.dataclass
class Model:
    """The reference's ``Model`` surface: ``init(key, device)`` -> the
    serving module (whose ``prefill``, ``decode_step`` and
    ``param_count`` are its methods); ``init_params(key, device)`` -> the
    params tree that ``forward(params, batch)`` and ``train_loss(params,
    batch)`` take; ``param_count(params)``."""
    cfg: object
    init: Callable[..., nn.Module]
    init_params: Callable[..., Dict[str, object]]
    forward: Callable
    train_loss: Callable
    param_count: Callable[[Dict[str, object]], int] = param_count


def build_model(cfg) -> Model:
    """The model of ``cfg``, any family."""
    cfg.validate()
    cls = STACKS[cfg.family]
    return Model(
        cfg, lambda key, device="cuda": cls.init(cfg, key, device),
        lambda key, device="cuda": init_params(cfg, key, device),
        lambda params, batch: forward(cfg, params, batch),
        lambda params, batch: train_loss(cfg, params, batch))
