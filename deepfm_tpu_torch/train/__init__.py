"""Training: the single-device Trainer (dense or sparse embedding update),
optimizers with optax's arithmetic and the lazy sparse Adam, metrics, the
non-finite guard and the tasks."""

from .loop import Trainer  # noqa: F401
from .state import TrainState  # noqa: F401
