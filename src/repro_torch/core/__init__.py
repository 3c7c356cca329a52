from repro_torch.core.safl import FLEngine, FLResult  # noqa: F401
from repro_torch.core.metrics import MetricsLog  # noqa: F401
