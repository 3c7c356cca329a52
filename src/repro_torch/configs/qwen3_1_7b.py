"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — dense GQA with qk-norm (the
reference's ``configs/qwen3_1_7b.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936,
    rope_theta=1e6, qk_norm=True, act="swiglu",
    attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="hf:Qwen/Qwen3-8B",
)
