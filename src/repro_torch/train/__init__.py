"""repro_torch.train — the train step (``repro.train``)."""

from repro_torch.train.train_loop import (  # noqa: F401
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
)
