"""SeamlessM4T-medium [arXiv:2308.11596] — enc-dec; speech frontend stubbed.

The conv/mel frontend is a stub: the
caller provides precomputed frame embeddings (B, T, d_model); we implement the
transformer backbone (12 enc + 12 dec layers at the assigned dims).

The reference's ``configs/seamless_m4t_medium.py``, field for field."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    act="gelu", attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="arXiv:2308.11596",
)
