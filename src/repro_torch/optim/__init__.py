"""Pytree optimizers and learning-rate schedules (:mod:`.optim`)."""
from repro_torch.optim.optim import (Optimizer, adamw, cosine_schedule,  # noqa: F401
                                     make_optimizer, sgd, sgdm,
                                     warmup_cosine)
