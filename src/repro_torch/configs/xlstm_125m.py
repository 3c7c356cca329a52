"""xLSTM-125M [arXiv:2405.04517] — alternating mLSTM/sLSTM blocks, no FFN. (the
reference's ``configs/xlstm_125m.py``, field for field)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    param_dtype="float32", optimizer="adamw",
    sharding="megatron", source="arXiv:2405.04517",
)
