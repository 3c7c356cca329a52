"""The port's models: the paper CNN (:mod:`.vision_cnn`) and the dense
decoder LM (:mod:`.transformer`), whose :func:`build_model` is the
reference's ``models.build_model`` for the ported families."""
from repro_torch.models.transformer import Model, build_model  # noqa: F401
