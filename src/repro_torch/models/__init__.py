"""The port's models: the paper's CNN, ResNet-18 and VGG-16
(:mod:`.vision_cnn`), its LSTM with the char and sentiment heads
(:mod:`.lstm`), and the serving zoo (:mod:`.transformer`: the dense, MoE
and VLM decoders, the Mamba2 hybrid, the xLSTM and the audio
encoder-decoder), whose :func:`build_model` is the reference's
``models.build_model``."""
from repro_torch.models.transformer import Model, build_model  # noqa: F401
