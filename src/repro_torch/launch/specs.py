"""Input stand-ins for every (arch x input shape) pair of the dry run (the
reference's ``repro/launch/specs.py``): tensors on the meta device
(shapes and dtypes, no data), each tree paired with its spec tree
(:mod:`repro_torch.sharding.rules`), and :func:`local_shape` /
:func:`tree_bytes`, the per-device shapes and bytes those specs give.

The decoders' caches are one ``{"k", "v"}`` stack over all layers here,
where the reference splits them into ``layers_dense`` / ``layers_moe``;
:func:`repro_torch.sharding.rules.cache_specs` gives each stack the same
spec (the batch dim is found from dim 0, and no stacked layer count of
the zoo equals a batch of ``INPUT_SHAPES``), so the per-device bytes are
the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.kernels import checks
from repro_torch.models.transformer import STACKS
from repro_torch.prng import prng_key
from repro_torch.sharding.rules import (batch_spec, cache_specs,
                                        map_with_path)

META = torch.device("meta")


def input_shape(shape) -> InputShape:
    """An ``INPUT_SHAPES`` entry by its name, or an :class:`InputShape` as
    it is."""
    return shape if isinstance(shape, InputShape) else INPUT_SHAPES[shape]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _batch_specs(batch: Dict[str, torch.Tensor], mesh):
    """Each leaf's batch dim over the data-parallel axes, the rest
    replicated."""
    return {k: batch_spec(mesh) + (None,) * (v.dim() - 1)
            for k, v in batch.items()}


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """Each dim divided by the product of its spec entry's axis sizes
    (rounded up, as a padded shard)."""
    def shards(entry):
        if entry is None:
            return 1
        axes = entry if isinstance(entry, tuple) else (entry,)
        return math.prod(mesh.shape[a] for a in axes)
    return tuple(-(-d // shards(e)) for d, e in zip(shape, spec))


def with_specs(tree, specs) -> List[Tuple[torch.Tensor, Tuple]]:
    """(tensor, spec) for each leaf of ``tree``, its spec from ``specs``
    (a spec tree matching ``tree``; None: every leaf replicated)."""
    out = []

    def one(path, t):
        spec = specs
        for k in path.split(".") if path and specs is not None else ():
            spec = spec[int(k)] if isinstance(spec, (list, tuple)) \
                else spec[k]
        out.append((t, spec if spec is not None else (None,) * t.dim()))

    map_with_path(one, tree)
    return out


def tree_bytes(tree, specs, mesh) -> int:
    """The per-device bytes of ``tree``'s tensors under ``specs``
    (:func:`with_specs`)."""
    return sum(math.prod(local_shape(t.shape, spec, mesh)) * t.element_size()
               for t, spec in with_specs(tree, specs))


def param_structs(model):
    """``init_params(prng_key(0))`` on the meta device."""
    return model.init_params(prng_key(0), device=META)


def stack_structs(tree, n: int):
    """Each leaf with a leading axis of ``n`` (the pods' stacked trees)."""
    return map_with_path(lambda _, t: torch.empty(
        (n,) + tuple(t.shape), dtype=t.dtype, device=META), tree)


def prepend_pod(spec_tree):
    """Each spec with "pod" on the new leading axis."""
    return map_with_path(lambda _, s: ("pod",) + s, spec_tree)


def _prompt(cfg, B: int, S: int, S_text: int, mesh):
    cdt = _dtype(cfg.compute_dtype)
    batch = {"tokens": torch.empty((B, S_text), dtype=torch.int32,
                                   device=META)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = torch.empty(
            (B, cfg.n_prefix_tokens, cfg.d_model), dtype=cdt, device=META)
    elif cfg.family == "audio":
        batch["enc_frames"] = torch.empty((B, S, cfg.d_model), dtype=cdt,
                                          device=META)
    return batch, _batch_specs(batch, mesh)


def train_batch_structs(cfg, shape, mesh):
    """Token / embedding stand-ins for a training step of ``shape`` (a
    name or an :class:`InputShape`) -> (batch, specs)."""
    sh = input_shape(shape)
    B, S = sh.global_batch, sh.seq_len
    S_text = S - cfg.n_prefix_tokens if cfg.family == "vlm" else S
    return _prompt(cfg, B, S, S_text, mesh)


def prompt_batch_structs(cfg, B: int, S: int, mesh):
    """A prefill prompt of length S -> (batch, specs)."""
    S_text = max(1, S - cfg.n_prefix_tokens) if cfg.family == "vlm" else S
    return _prompt(cfg, B, S, S_text, mesh)


def decode_window(cfg, shape) -> Optional[int]:
    """Ring-buffer window for long-context decode of softmax-attention
    decoders; None = linear cache."""
    if input_shape(shape).name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return cfg.sliding_window or cfg.long_context_window
    return cfg.sliding_window  # native window (starcoder2) applies always


def decode_cache_structs(cfg, model, shape, mesh):
    """The caches of a one-token prompt's prefill on the meta device ->
    (cache, cache specs, pos, capacity)."""
    sh = input_shape(shape)
    B, S = sh.global_batch, sh.seq_len
    win = decode_window(cfg, sh)
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        capacity = min(S, win) if win else S
    else:
        capacity = 0  # state caches are O(1)

    # a minimal prompt; the enc-dec needs its encoder length S (the
    # cross-attention memory)
    prompt, _ = prompt_batch_structs(cfg, B, S, mesh)
    prompt["tokens"] = torch.empty((B, 1), dtype=torch.int32, device=META)
    extra = {k: v for k, v in prompt.items() if k != "tokens"}
    module = STACKS[cfg.family].from_tree(cfg, param_structs(model))
    with checks.meta_trace(), torch.no_grad():
        if cfg.family == "ssm":
            _, cache = module.prefill(prompt["tokens"])
        else:
            _, cache = module.prefill(prompt["tokens"],
                                      capacity=max(capacity, 2), **extra)
    pos = S - 1  # ring caches index pos % capacity; linear caches clamp
    return cache, cache_specs(cache, mesh, B), pos, capacity
