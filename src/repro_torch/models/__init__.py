"""repro_torch.models — the model zoo (``repro.models``): the config
dataclasses, the decoder's layers, its MoE FFN and
:class:`~repro_torch.models.model.Transformer` with prefill, ring-cache
decode and the training losses."""

from repro_torch.models.model import (  # noqa: F401
    Transformer,
    chunked_lm_loss,
    init_params,
    lm_loss,
    train_loss,
)
