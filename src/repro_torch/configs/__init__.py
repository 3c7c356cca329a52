from repro_torch.configs.base import FLConfig  # noqa: F401
