"""InternLM2-20B [arXiv:2403.17297] — dense GQA. (the
reference's ``configs/internlm2_20b.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    rope_theta=1e6, act="swiglu",
    attn_chunk=2048, param_dtype="float32", optimizer="adamw",
    sharding="fsdp", source="arXiv:2403.17297",
)
