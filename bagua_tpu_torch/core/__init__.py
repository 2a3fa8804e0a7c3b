from .backend import BaguaTrainer, TrainState  # noqa: F401
