"""The port's models: the paper's CNN, ResNet-18 and VGG-16
(:mod:`.vision_cnn`), its LSTM with the char and sentiment heads
(:mod:`.lstm`), and the dense decoder LM (:mod:`.transformer`), whose :func:`build_model` is the
reference's ``models.build_model`` for the ported families."""
from repro_torch.models.transformer import Model, build_model  # noqa: F401
