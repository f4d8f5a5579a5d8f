"""repro_torch.models — the model zoo's serving side (``repro.models``):
the config dataclasses, the dense decoder's layers and
:class:`~repro_torch.models.model.Transformer` with prefill and
ring-cache decode."""
