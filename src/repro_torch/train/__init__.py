from repro_torch.train.optimizer import adamw_init, adamw_update, lr_schedule  # noqa: F401
from repro_torch.train.step import TrainState, init_state, make_train_step  # noqa: F401
