"""Bad-record skipping and read retries of the port's input path, each case
of ``tests/test_bad_records.py`` held against the JAX package on the same
corrupted files: the same surviving records, the same ``DataHealth``
counts and the same error text, on the native and the Python framer.
CPU only, no real backoff sleeps.
"""

import os
import struct

import numpy as np
import pytest
import torch

from deepfm_tpu.data import health as jax_health
from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu.utils import faults as jax_faults
from deepfm_tpu.utils import retry as jax_retry
from deepfm_tpu_torch.data import libsvm, pipeline, tfrecord
from deepfm_tpu_torch.data.health import BadRecordPolicy, DataHealth
from deepfm_tpu_torch.utils import faults
from deepfm_tpu_torch.utils import retry as retry_lib

torch.set_num_threads(1)

NO_SLEEP = retry_lib.RetryPolicy(base_delay=0.0, max_delay=0.0)
JAX_NO_SLEEP = jax_retry.RetryPolicy(base_delay=0.0, max_delay=0.0)
NATIVE = [pytest.param(False, id="python"), pytest.param(True, id="native")]


@pytest.fixture
def data_dir(tmp_path):
    libsvm.generate_synthetic_ctr(
        str(tmp_path), num_files=2, examples_per_file=40, feature_size=64,
        field_size=5, prefix="tr", seed=9)
    return tmp_path


def _files(data_dir):
    return sorted(str(p) for p in data_dir.glob("*.tfrecords"))


def _frames(path):
    data = open(path, "rb").read()
    out, pos = [], 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        out.append((pos, length))
        pos += 16 + length
    return out


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _corrupt_data_crc(path, idx):
    start, length = _frames(path)[idx]
    _flip_byte(path, start + 12 + length)
    return start


def _corrupt_length_crc(path, idx):
    start, _ = _frames(path)[idx]
    _flip_byte(path, start + 8)
    return start


def _both(path, native, on_bad="skip", max_bad=0):
    """(records, health snapshot or error text) from each package."""
    out = []
    for mod, health_mod, no_sleep in (
            (pipeline, None, NO_SLEEP),
            (jax_pipeline, jax_health, JAX_NO_SLEEP)):
        if health_mod is None:
            health = DataHealth()
            policy = BadRecordPolicy(on_bad, max_bad, health)
        else:
            health = health_mod.DataHealth()
            policy = health_mod.BadRecordPolicy(on_bad, max_bad, health)
        try:
            recs = list(mod._iter_file_records(
                path, native, True, policy=policy, retry_policy=no_sleep))
            out.append((recs, health.snapshot()))
        except IOError as exc:
            out.append((None, str(exc)))
    return out


@pytest.mark.parametrize("native", NATIVE)
def test_flipped_data_crc_raises_the_same_message(data_dir, native):
    path = _files(data_dir)[0]
    offset = _corrupt_data_crc(path, 7)
    (got, msg), (want, jmsg) = _both(path, native, on_bad="raise")
    assert got is None and want is None
    assert msg == jmsg
    assert path in msg and f"at byte {offset}" in msg
    assert "data CRC mismatch" in msg


@pytest.mark.parametrize("native", NATIVE)
def test_flipped_data_crc_skips_one_record(data_dir, native):
    path = _files(data_dir)[0]
    clean = list(tfrecord.iter_records(path, verify_crc=True))
    _corrupt_data_crc(path, 7)
    _corrupt_data_crc(path, 31)
    (got, snap), (want, jsnap) = _both(path, native)
    assert got == want == clean[:7] + clean[8:31] + clean[32:]
    assert snap == jsnap
    assert snap["bad_records"] == 2 and snap["truncated_tails"] == 0
    assert snap["per_file"][path]["skipped"] == 2


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("on_bad", ["skip", "raise"])
def test_truncated_tail(data_dir, native, on_bad):
    path = _files(data_dir)[0]
    clean = list(tfrecord.iter_records(path, verify_crc=True))
    last_start, _ = _frames(path)[-1]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 9)
    (got, snap), (want, jsnap) = _both(path, native, on_bad=on_bad)
    assert snap == jsnap
    if on_bad == "raise":
        assert got is None and f"at byte {last_start}" in snap
        return
    assert got == want == clean[:-1]
    assert snap["truncated_tails"] == 1 and snap["bad_records"] == 1


@pytest.mark.parametrize("native", NATIVE)
def test_length_crc_discards_the_tail(data_dir, native):
    path = _files(data_dir)[0]
    clean = list(tfrecord.iter_records(path, verify_crc=True))
    _corrupt_length_crc(path, 35)
    (got, snap), (want, jsnap) = _both(path, native)
    assert got == want == clean[:35]
    assert snap == jsnap and snap["truncated_tails"] == 1


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("max_bad,survive", [(1, None), (2, 38), (0, 38)])
def test_skip_budget(data_dir, native, max_bad, survive):
    path = _files(data_dir)[0]
    _corrupt_data_crc(path, 3)
    _corrupt_data_crc(path, 11)
    (got, snap), (want, jsnap) = _both(path, native, max_bad=max_bad)
    assert snap == jsnap
    if survive is None:
        assert got is None and "bad-record budget exceeded" in snap
    else:
        assert got == want and len(got) == survive


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("every", [2, 3])
def test_transient_faults_heal_to_the_clean_run(data_dir, native, every,
                                                monkeypatch):
    """Every ``every``-th read fails once; reopen-and-seek heals it, and
    both packages count the same retries (and skip the one corrupt
    record the same way)."""
    for mod in (pipeline, jax_pipeline):
        monkeypatch.setattr(mod, "_NATIVE_CHUNK_BYTES", 512)
    path = _files(data_dir)[1]
    clean = list(tfrecord.iter_records(path, verify_crc=True))
    _corrupt_data_crc(path, 20)
    results = []
    for mod, fs_mod, health_mod, no_sleep in (
            (pipeline, faults, None, NO_SLEEP),
            (jax_pipeline, jax_faults, jax_health, JAX_NO_SLEEP)):
        health = (DataHealth() if health_mod is None
                  else health_mod.DataHealth())
        policy = (BadRecordPolicy("skip", 0, health) if health_mod is None
                  else health_mod.BadRecordPolicy("skip", 0, health))
        with fs_mod.FlakyFS(read_fail_every=every) as fs:
            recs = list(mod._iter_file_records(
                path, native, True, policy=policy, retry_policy=no_sleep))
        results.append((recs, health.snapshot(), fs.injected_read_faults))
    (got, snap, n), (want, jsnap, jn) = results
    assert got == want == clean[:20] + clean[21:]
    assert snap == jsnap and n == jn > 0
    assert snap["read_retries"] == n and snap["bad_records"] == 1


@pytest.mark.parametrize("native", NATIVE)
def test_fault_at_an_offset_heals(data_dir, native):
    path = _files(data_dir)[1]
    clean = list(tfrecord.iter_records(path, verify_crc=True))
    mid = _frames(path)[20][0]
    health = DataHealth()
    with faults.FlakyFS(read_fail_offsets=[(os.path.basename(path),
                                            mid)]) as fs:
        out = list(pipeline._iter_file_records(
            path, native, True, policy=BadRecordPolicy("raise", 0, health),
            retry_policy=NO_SLEEP))
    assert out == clean
    assert fs.injected_read_faults == 1
    assert health.snapshot()["read_retries"] == 1


def test_permanent_outage_gives_up(data_dir):
    path = _files(data_dir)[0]
    with faults.FlakyFS(read_fail_every=1):
        with pytest.raises(IOError, match="failed after 4 attempts"):
            list(pipeline._iter_file_records(
                path, True, True, policy=BadRecordPolicy("raise"),
                retry_policy=NO_SLEEP))


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("shuffle", [False, True])
def test_pipeline_skips_and_counts_as_jax(data_dir, native, shuffle):
    """The whole pipeline (pooled on the native path, per record on the
    Python one): the same batches as the JAX pipeline, one record fewer,
    and equal DataHealth counts; ``raise`` names the mismatch."""
    files = _files(data_dir)
    _corrupt_data_crc(files[0], 7)
    kw = dict(field_size=5, batch_size=16, shuffle=shuffle,
              shuffle_files=False, drop_remainder=False, verify_crc=True,
              use_native_decoder=native, prefetch_batches=0,
              shuffle_buffer=50, seed=4)
    port = pipeline.CtrPipeline(files, on_bad_record="skip",
                                retry_policy=NO_SLEEP, **kw)
    jax_side = jax_pipeline.CtrPipeline(files, on_bad_record="skip",
                                        retry_policy=JAX_NO_SLEEP, **kw)
    got, want = list(port), list(jax_side)
    assert sum(b["label"].shape[0] for b in got) == 79
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])
    assert port.health.snapshot() == jax_side.health.snapshot()
    assert port.health.snapshot()["bad_records"] == 1
    with pytest.raises(IOError, match="data CRC mismatch"):
        list(pipeline.CtrPipeline(files, on_bad_record="raise", **kw))


def test_env_read_faults_arm_the_injector(monkeypatch):
    from deepfm_tpu_torch.data import fileio
    monkeypatch.delenv(faults.READ_FAULT_ENV, raising=False)
    assert faults.install_env_faults() is None
    monkeypatch.setenv(faults.READ_FAULT_ENV, "5")
    try:
        fs = faults.install_env_faults()
        assert fs.read_fail_every == 5 and fileio._injector is fs
    finally:
        fileio.set_fault_injector(None)


def test_remote_paths_are_not_ported():
    from deepfm_tpu_torch.data import fileio
    with pytest.raises(NotImplementedError, match="not yet ported"):
        fileio.open_resilient("gs://bucket/tr.tfrecords")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        fileio.size("gs://bucket/tr.tfrecords")


def test_failed_opens_and_stats_are_retried(data_dir, monkeypatch):
    """Scripted open and size failures fail inside the retry loop and
    heal: the same records as a clean read."""
    from deepfm_tpu_torch.data import fileio
    monkeypatch.setattr(fileio, "_retry_policy", NO_SLEEP)
    path = _files(data_dir)[0]
    clean = list(tfrecord.iter_records(path, verify_crc=True))
    with faults.FlakyFS(op_failures={"open": 2, "size": 1}) as fs:
        out = list(pipeline._iter_file_records(
            path, True, True, policy=BadRecordPolicy("raise"),
            retry_policy=NO_SLEEP))
    assert out == clean and fs.injected_op_faults == 3
