"""Config registry: the ported architectures and the FL experiment
config.

``get_config(arch_id)`` returns the full-width :class:`ModelConfig` of a
ported architecture; ``reduced_config(cfg)`` the CPU-smoke variant of the
same family (the reference's ``configs/__init__.py:32``, ``:38``).  Any
other architecture is refused.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import qwen3_1_7b
from repro_torch.configs.base import FLConfig, ModelConfig  # noqa: F401

#: the ported architectures
ARCHS = {
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ported: "
            f"{sorted(ARCHS)}; see ROADMAP.md, queue 1)")
    cfg = ARCHS[arch_id]
    cfg.validate()
    return cfg


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the dense family, as the reference reduces
    it: 2 layers, d_model 256, 4 / 2 heads, d_ff 512, vocab 512 padded to
    128, f32 params and compute."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    out = dataclasses.replace(
        cfg, d_model=256, n_heads=4, n_kv_heads=2, head_dim=0,
        vocab_size=512, vocab_pad_to=128, param_dtype="float32",
        compute_dtype="float32",
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else None, n_layers=2, d_ff=512)
    out.validate()
    return out
