"""StarCoder2-3B [arXiv:2402.19173] — dense GQA, RoPE, native sliding window. (the
reference's ``configs/starcoder2_3b.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152,
    rope_theta=1e5, act="gelu", sliding_window=4096,
    attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="arXiv:2402.19173",
)
