"""repro_torch.optim — AdamW (``repro.optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig,
    apply_updates,
    init_opt_state,
    lr_at,
)
