from repro_torch.train.step import make_train_step  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
