"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family] — dense GQA with qk-norm (the
reference's ``configs/qwen3_1_7b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936,
    rope_theta=1e6, qk_norm=True, act="swiglu",
    param_dtype="float32", source="hf:Qwen/Qwen3-8B",
)
