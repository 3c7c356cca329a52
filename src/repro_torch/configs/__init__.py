"""Config registry: the ten architectures of the model zoo and the FL
experiment config.

``get_config(arch_id)`` returns the full-width :class:`ModelConfig`;
``reduced_config(cfg)`` the CPU-smoke variant of the same family (the
reference's ``configs/__init__.py:32``, ``:38``): at most 4 layers,
d_model 256, at most 4 experts.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    granite_moe_1b_a400m, internlm2_20b, internvl2_76b, kimi_k2_1t_a32b,
    minitron_4b, qwen3_1_7b, seamless_m4t_medium, starcoder2_3b,
    xlstm_125m, zamba2_2_7b,
)
from repro_torch.configs.base import (INPUT_SHAPES, FLConfig,  # noqa: F401
                                      InputShape, ModelConfig)

#: the zoo, in the reference's order
ARCHS = {
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "qwen3-1.7b": qwen3_1_7b.CONFIG,
    "zamba2-2.7b": zamba2_2_7b.CONFIG,
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (known: {list(ARCHS)})")
    cfg = ARCHS[arch_id]
    cfg.validate()
    return cfg


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family, as the reference reduces
    it: d_model 256, 4 / 2 heads, vocab 512 padded to 128, f32 params and
    compute, no q-chunking, a window of at most 64; 2 layers (d_ff 512)
    for dense and vlm (8 prefix tokens), 2 for moe (d_ff 128, 4 experts
    top-2, groups of 64, at most one dense and one shared), 4 for the
    hybrid (attention every 2nd, state 16, head dim 32, chunk 16), 2 for
    the xLSTM, 2 + 2 for the enc-dec."""
    kw = dict(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=0,
        vocab_size=512, vocab_pad_to=128, param_dtype="float32",
        compute_dtype="float32", remat=False, attn_chunk=0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window
        else None,
        long_context_window=64, sharding="megatron",
    )
    if cfg.family in ("dense", "vlm"):
        kw.update(n_layers=2, d_ff=512,
                  n_prefix_tokens=8 if cfg.family == "vlm" else 0)
    elif cfg.family == "moe":
        kw.update(n_layers=2, d_ff=128, n_experts=4, top_k=2,
                  moe_group_size=64,
                  first_k_dense=1 if cfg.first_k_dense else 0,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    elif cfg.family == "hybrid":
        kw.update(n_layers=4, hybrid_attn_every=2, d_ff=512,
                  ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    elif cfg.family == "ssm":
        kw.update(n_layers=2, d_ff=0)
    elif cfg.family == "audio":
        kw.update(n_layers=2, enc_layers=2, d_ff=512)
    out = dataclasses.replace(cfg, **kw)
    out.validate()
    return out
