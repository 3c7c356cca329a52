"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] — 32e top-8. (the
reference's ``configs/granite_moe_1b_a400m.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    n_experts=32, top_k=8, capacity_factor=1.25, moe_group_size=512,
    attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
