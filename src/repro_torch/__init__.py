"""PyTorch + CUDA port of the SAFL/SFL reproduction (``repro``), for one
NVIDIA H100.  Module names mirror the JAX package's; entry points run on
the GPU unless the caller passes ``device="cpu"``."""
