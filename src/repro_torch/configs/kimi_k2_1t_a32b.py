"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-parameter MoE.

61 layers (the first dense), 384 experts top-8 + 1 shared expert, d_ff
2048 per expert, bf16 params (the reference's
``configs/kimi_k2_1t_a32b.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, n_shared_experts=1, first_k_dense=1,
    capacity_factor=1.25, moe_group_size=512,
    attn_chunk=2048, param_dtype="bfloat16", optimizer="sgd",
    sharding="fsdp", source="arXiv:2501.kimi2",
)
