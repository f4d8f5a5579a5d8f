"""repro_torch.train — the train step (``repro.train``)."""

from repro_torch.train.train_loop import (  # noqa: F401
    TrainConfig,
    TrainState,
    abstract_train_state,
    init_train_state,
    make_train_step,
)
