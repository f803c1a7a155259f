"""The port's retry policy (``deepfm_tpu_torch.utils.retry``) against the
JAX package's: the same classification, the same seeded full-jitter
backoff sequence, the same give-up message, and the ``--io_retry_*``
knobs; plus ``ResilientStream`` healing a broken read. No real sleeps."""

import io

import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.utils import retry as jax_retry
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import fileio
from deepfm_tpu_torch.utils import retry

torch.set_num_threads(1)


class _FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s

    def __call__(self):
        return self.t


@pytest.mark.parametrize("exc,want", [
    (IOError("eio"), True), (ConnectionResetError(), True),
    (TimeoutError(), True), (FileNotFoundError(), False),
    (PermissionError(), False), (IsADirectoryError(), False),
    (ValueError("x"), False), (KeyError("k"), False),
])
def test_classification_matches_jax(exc, want):
    assert retry.default_is_retryable(exc) is want
    assert jax_retry.default_is_retryable(exc) is want


def _failing(n_fail, exc=IOError):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= n_fail:
            raise exc(f"fail #{calls[0]}")
        return "ok"
    return fn, calls


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_seeded_backoff_sequence_equals_jax(seed):
    seqs = []
    for mod in (retry, jax_retry):
        clock = _FakeClock()
        pol = mod.RetryPolicy(max_attempts=6, base_delay=0.05, max_delay=0.3,
                              sleep=clock.sleep, clock=clock,
                              jitter_seed=seed)
        fn, calls = _failing(5)
        seen = []
        assert pol.call(fn, on_retry=lambda e, n: seen.append(n)) == "ok"
        assert calls[0] == 6 and seen == [1, 2, 3, 4, 5]
        seqs.append(clock.sleeps)
    assert seqs[0] == seqs[1]
    caps = [min(0.3, 0.05 * 2 ** i) for i in range(5)]
    assert all(0.0 <= s <= c for s, c in zip(seqs[0], caps))


@pytest.mark.parametrize("attempts,deadline,reason", [
    (3, None, "failed after 3 attempts"), (50, 0.25, "failed after deadline")])
def test_gives_up_with_the_jax_message(attempts, deadline, reason):
    msgs = []
    for mod in (retry, jax_retry):
        clock = _FakeClock()
        pol = mod.RetryPolicy(max_attempts=attempts, base_delay=0.1,
                              deadline=deadline, sleep=clock.sleep,
                              clock=clock, jitter_seed=1)
        fn, _ = _failing(10 ** 6)
        with pytest.raises(IOError) as ei:
            pol.call(fn, op_name="read(x)")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and reason in msgs[0]


def test_fatal_errors_are_not_retried():
    clock = _FakeClock()
    pol = retry.RetryPolicy(sleep=clock.sleep, clock=clock)
    fn, calls = _failing(1, FileNotFoundError)
    with pytest.raises(FileNotFoundError):
        pol.call(fn)
    assert calls[0] == 1 and clock.sleeps == []


def test_retrying_decorator():
    clock = _FakeClock()
    fn, calls = _failing(2)
    wrapped = retry.retrying(retry.RetryPolicy(sleep=clock.sleep,
                                               clock=clock))(fn)
    assert wrapped() == "ok" and calls[0] == 3


@pytest.mark.parametrize("kw", [
    {}, dict(io_retries=1), dict(io_retries=7, io_retry_backoff_secs=0.5,
                                 io_retry_deadline_secs=3.0)])
def test_policy_from_config_equals_jax(kw):
    got = retry.policy_from_config(Config(**kw))
    want = jax_retry.policy_from_config(JaxConfig(**kw))
    for f in ("max_attempts", "base_delay", "max_delay", "deadline"):
        assert getattr(got, f) == getattr(want, f), f


class _Breaking(io.RawIOBase):
    """A stream over ``data`` whose reads fail at the given read calls."""

    def __init__(self, data, fail_at, counter, seekable=True):
        self._b = io.BytesIO(data)
        self._fail_at = fail_at
        self._counter = counter
        self._seekable = seekable

    def readable(self):
        return True

    def seekable(self):
        return self._seekable

    def seek(self, off, whence=0):
        return self._b.seek(off, whence)

    def read(self, n=-1):
        self._counter[0] += 1
        if self._counter[0] in self._fail_at:
            raise ConnectionResetError("peer reset")
        return self._b.read(min(n, 7))  # short reads


@pytest.mark.parametrize("seekable", [True, False])
def test_resilient_stream_reopens_and_repositions(seekable):
    data = bytes(range(256)) * 3
    counter = [0]
    retries = []
    s = fileio.ResilientStream(
        "mem", opener=lambda: _Breaking(data, {3, 9, 20}, counter, seekable),
        policy=retry.RetryPolicy(base_delay=0.0, max_delay=0.0),
        on_retry=lambda e, n: retries.append(n))
    out = b""
    while True:
        chunk = s.read(50)
        if not chunk:
            break
        out += chunk
    assert out == data
    assert s.reopen_count == len(retries) == 3
