"""InternVL2-76B [arXiv:2404.16821] — InternViT (stubbed) + InternLM2 LM.

The vision encoder + projector frontend is a stub:
the caller provides precomputed patch embeddings
(B, 1024, d_model); we implement the 80-layer language backbone.

The reference's ``configs/internvl2_76b.py``, field for field."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    n_prefix_tokens=1024,
    rope_theta=1e6, act="swiglu",
    attn_chunk=2048, param_dtype="bfloat16", optimizer="sgdm",
    sharding="fsdp", source="arXiv:2404.16821",
)
