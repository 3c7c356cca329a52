"""The dense decoder LM (the reference's ``models/transformer.py:65-118``
decoder layer and ``:121-289 _build_decoder_lm``), as ``nn.Module``s for
serving: prefill fills a KV cache, decode steps against it.

:class:`DecoderLM` holds the embedding, the final norm, the head and an
``nn.ModuleList`` of :class:`DecoderLayer`; each module keeps its
parameters in the reference's nested-dict layout (``(in, out)`` dense
weights), so :func:`repro_torch.convert.params_from_jax` copies the
reference's tree across leaf by leaf (the reference stacks layer i's
leaves at index i of axis 0).  :meth:`DecoderLM.init` draws every
weight from a reference key in the reference's order (``split(key, 5)``
-> embed, dense stack, moe stack, head, projector; the stack splits its
key into ``n_layers``, each layer in 2, attention then MLP), so
``init(prng_key(0))`` gives the reference's ``init(PRNGKey(0))``, drawn
on the device (:func:`repro_torch.prng.normal_torch`, bitwise
``jax.random.normal``).

Parameters take no gradient: this is the serving path.  The KV cache is
``{"k", "v"}`` of (n_layers, B, capacity, Hkv, hd) in the compute dtype,
updated in place by decode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import layers


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(see ROADMAP.md, queue 1)")


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
    """Pre-norm decoder layer: ``{"ln1", "attn", "ln2", "mlp"}``."""

    def __init__(self, cfg, tree: Dict[str, object]):
        super().__init__(tree)
        self.cfg = cfg

    @staticmethod
    def init_tree(cfg, key: prng.Key, dtype, device) -> Dict[str, object]:
        k1, k2 = prng.split(key, 2)
        return {
            "ln1": layers.rmsnorm_init(cfg.d_model, dtype, device),
            "attn": layers.attention_init(k1, cfg, dtype, device),
            "ln2": layers.rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": layers.mlp_init(k2, cfg, dtype, device),
        }

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Prefill: (B, S, D) -> ((B, S, D), (k, v))."""
        cfg, p = self.cfg, self.tree
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn, kv = layers.full_attention(p["attn"], cfg, h, positions,
                                         window=cfg.sliding_window,
                                         return_kv=True)
        x = x + attn
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + layers.mlp(p["mlp"], cfg, h), kv

    def decode(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: int) -> torch.Tensor:
        """One token: (B, 1, D) -> (B, 1, D), the cache written in
        place."""
        cfg, p = self.cfg, self.tree
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn, _, _ = layers.decode_attention(p["attn"], cfg, h, ck, cv, pos,
                                             window=cfg.sliding_window)
        x = x + attn
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + layers.mlp(p["mlp"], cfg, h)


class DecoderLM(nn.Module):
    """The dense decoder LM: embedding, ``layers`` (a ``ModuleList`` of
    :class:`DecoderLayer`), final norm and untied head (the tied head
    reads the embedding)."""

    def __init__(self, cfg, top: Dict[str, object], layer_trees):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.top = ParamTree(top)
        self.layers = nn.ModuleList(DecoderLayer(cfg, t) for t in layer_trees)

    @classmethod
    def from_tree(cls, cfg, tree: Dict[str, object]) -> "DecoderLM":
        """From the reference's params layout: ``layers_dense`` leaves
        stacked on axis 0 (layer i reads views of index i)."""
        stack = tree["layers_dense"]
        return cls(cfg, {k: v for k, v in tree.items()
                         if k != "layers_dense"},
                   [_index(stack, i) for i in range(cfg.n_layers)])

    @classmethod
    def init(cls, cfg, key: prng.Key, device="cuda") -> "DecoderLM":
        """Weights drawn from the reference key ``key`` on ``device`` (the
        GPU unless the caller asks for the CPU)."""
        device = resolve_device(device)
        dtype = _dtype(cfg.param_dtype)
        ke, kd, _km, kh, _kp = prng.split(key, 5)
        top = {
            "embed": layers.embed_init(ke, cfg.padded_vocab, cfg.d_model,
                                       dtype, device),
            "ln_f": layers.rmsnorm_init(cfg.d_model, dtype, device),
        }
        if not cfg.tie_embeddings:
            top["head"] = layers.dense_init(kh, cfg.d_model,
                                            cfg.padded_vocab, dtype, device)
        return cls(cfg, top, [DecoderLayer.init_tree(cfg, k, dtype, device)
                              for k in prng.split(kd, cfg.n_layers)])

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

    def prefill(self, tokens: torch.Tensor, capacity: Optional[int] = None):
        """tokens (B, S) -> (logits of the last position (B, V) f32, the
        KV cache with room for ``capacity`` >= S positions)."""
        cfg = self.cfg
        x = self._embed(tokens)
        B, S = x.shape[0], x.shape[1]
        capacity = max(capacity or S, S)
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        shape = (cfg.n_layers, B, capacity, cfg.n_kv_heads, cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
        for i, layer in enumerate(self.layers):
            x, (k, v) = layer(x, positions)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
        return self._logits(x[:, -1:])[:, 0], cache

    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """tokens (B,) at absolute position ``pos`` -> (logits (B, V) f32,
        the cache, written in place)."""
        x = self._embed(tokens)[:, None, :]
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, cache["k"][i], cache["v"][i], pos)
        return self._logits(x)[:, 0], cache


def _index(tree, i: int):
    """Layer i's tree (views into the stacked leaves)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@dataclasses.dataclass
class Model:
    """The reference's ``Model`` surface for serving: ``init(key)`` ->
    the module; ``prefill``, ``decode_step`` and ``param_count`` are the
    module's methods."""
    cfg: object
    init: Callable[..., DecoderLM]


def build_model(cfg) -> Model:
    """The model of ``cfg`` (dense only; the other families raise)."""
    cfg.validate()
    _require_dense(cfg)
    return Model(cfg, lambda key, device="cuda": DecoderLM.init(
        cfg, key, device))
