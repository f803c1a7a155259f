"""Training: the dense single-device Trainer, optimizers with optax's
arithmetic, metrics, the non-finite guard and the tasks."""

from .loop import Trainer  # noqa: F401
from .state import TrainState  # noqa: F401
