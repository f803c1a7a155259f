"""Retry/backoff primitives for the I/O stack (the port's copy of
``deepfm_tpu.utils.retry``).

The input path owns every byte it reads, so its retry policy lives here:
bounded attempts, exponential backoff with full jitter (decorrelates retry
storms across a fleet of readers), a retryable-exception classifier, and an
optional per-op deadline.

Everything time-related is injectable (``sleep``, ``clock``, jitter seed) so
fault-injection tests run in milliseconds with zero real sleeps.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional

# Non-transient OSError subclasses: retrying a missing file or a permission
# wall only delays the real error. Everything else in the OSError family
# (connection resets, timeouts, EIO from a flaky mount) is presumed
# transient — the object-store failure mode this module exists for.
_FATAL_OS_ERRORS = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
    FileExistsError,
)

# tf.errors.OpError subclasses that are NOT worth retrying, matched by class
# name so TF never has to be imported to classify.
_FATAL_TF_ERRORS = frozenset({
    "NotFoundError",
    "PermissionDeniedError",
    "InvalidArgumentError",
    "UnimplementedError",
    "FailedPreconditionError",
})


def default_is_retryable(exc: BaseException) -> bool:
    """Classify an exception as transient (retry) or permanent (raise).

    ``tf.io.gfile`` raises ``tf.errors.OpError`` subclasses — which are NOT
    ``OSError``s — for remote-path failures, so classification walks the MRO
    by class name rather than importing TensorFlow.
    """
    if isinstance(exc, _FATAL_OS_ERRORS):
        return False
    if isinstance(exc, OSError):  # IOError/ConnectionError/TimeoutError...
        return True
    for klass in type(exc).__mro__:
        if klass.__name__ == "OpError" and "tensorflow" in (
                getattr(klass, "__module__", "") or ""):
            return type(exc).__name__ not in _FATAL_TF_ERRORS
    return False


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and full jitter.

    ``max_attempts`` counts total tries (1 = no retry). Delay before retry
    ``i`` (0-based) is uniform in ``[0, min(max_delay, base_delay * 2**i)]``.
    ``deadline`` (seconds, measured on ``clock``) bounds the whole op: once
    exceeded no further attempt is made. ``sleep``/``clock`` are injectable
    so tests drive backoff with a fake clock and zero real sleeping.
    """

    max_attempts: int = 4
    base_delay: float = 0.1
    max_delay: float = 5.0
    deadline: Optional[float] = None
    is_retryable: Callable[[BaseException], bool] = default_is_retryable
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    jitter_seed: Optional[int] = None

    def backoff_delay(self, attempt: int, rng: random.Random) -> float:
        """Full-jitter delay before retry number ``attempt`` (0-based)."""
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        return rng.uniform(0.0, max(cap, 0.0))

    def call(self, fn: Callable[..., Any], *args: Any, op_name: str = "",
             on_retry: Optional[Callable[[BaseException, int], None]] = None,
             **kwargs: Any) -> Any:
        """Run ``fn(*args, **kwargs)``, retrying transient failures.

        ``on_retry(exc, attempt)`` fires before each backoff sleep (attempt
        is 1-based: the number of the attempt that just failed) — the hook
        the pipeline uses to aggregate retry counts into ``DataHealth``.
        """
        rng = random.Random(self.jitter_seed)
        start = self.clock()
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                attempt += 1
                if not self.is_retryable(e):
                    raise
                out_of_budget = attempt >= max(self.max_attempts, 1)
                past_deadline = (self.deadline is not None
                                 and self.clock() - start >= self.deadline)
                if out_of_budget or past_deadline:
                    reason = ("deadline" if past_deadline else
                              f"{attempt} attempts")
                    e.args = ((f"{op_name or 'I/O op'} failed after "
                               f"{reason}: {e}"),)
                    raise
                if on_retry is not None:
                    on_retry(e, attempt)
                self.sleep(self.backoff_delay(attempt - 1, rng))

    def with_(self, **kw: Any) -> "RetryPolicy":
        return dataclasses.replace(self, **kw)


def retrying(policy: Optional[RetryPolicy] = None, *, op_name: str = ""):
    """Decorator form of ``RetryPolicy.call``."""
    pol = policy or RetryPolicy()

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        def wrapped(*args: Any, **kwargs: Any) -> Any:
            return pol.call(fn, *args, op_name=op_name or fn.__name__,
                            **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco


def policy_from_config(cfg: Any) -> RetryPolicy:
    """Build the I/O retry policy from Config knobs (see config.py)."""
    return RetryPolicy(
        max_attempts=max(int(getattr(cfg, "io_retries", 4)), 1),
        base_delay=float(getattr(cfg, "io_retry_backoff_secs", 0.1)),
        deadline=(float(cfg.io_retry_deadline_secs)
                  if getattr(cfg, "io_retry_deadline_secs", 0) else None),
    )
