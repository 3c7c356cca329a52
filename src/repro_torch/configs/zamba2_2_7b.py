"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention block.

54 layers; after every 5 Mamba2 layers the one shared attention + MLP
block is applied in sequence (the reference's simplification of the
paper's concat-input variant; ``configs/zamba2_2_7b.py``, field for
field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6, act="gelu",
    attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="arXiv:2411.15242",
)
