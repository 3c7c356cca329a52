"""Minitron-4B [arXiv:2407.14679] — pruned Nemotron; 256k vocab. (the
reference's ``configs/minitron_4b.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    rope_theta=1e4, act="gelu",
    attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="arXiv:2407.14679",
)
