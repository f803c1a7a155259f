"""Pipe mode of the port (``ChainedFileStream``, ``StreamingCtrPipeline``
and the pipe-mode train task) against the JAX package's, on the CPU.

The emission is compared byte for byte (tolerance: none) with the read
chunk shrunk to 4 KiB on both sides, so every file reaches the framer in
many chunks with carried tails across file boundaries; over k in {1, 8},
resume skips, ``drop_remainder``, the native and the per-record decode and
a flipped-CRC record skipped by policy. The pipe-mode task's preempted and
resumed run ends bit-identical to its uninterrupted run.
"""

import glob
import os
import struct

import numpy as np
import pytest
import torch

from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm, pipeline
from deepfm_tpu_torch.train import tasks
from deepfm_tpu_torch.utils import preempt as preempt_lib

torch.set_num_threads(1)

F = 6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    return sorted(libsvm.generate_synthetic_ctr(
        str(d), num_files=3, examples_per_file=170, feature_size=500,
        field_size=F, seed=21))


@pytest.fixture
def small_chunks(monkeypatch):
    for mod in (pipeline, jax_pipeline):
        monkeypatch.setattr(mod, "_NATIVE_CHUNK_BYTES", 4096)


def _streams(files, epochs=2, **kw):
    common = dict(num_epochs=epochs, shuffle_each_epoch=True, seed=4, **kw)
    return (pipeline.ChainedFileStream(files, **common),
            jax_pipeline.ChainedFileStream(files, **common))


def _pipes(files, *, native=True, epochs=2, **kw):
    port_stream, jax_stream = _streams(files, epochs=epochs)
    common = dict(field_size=F, use_native_decoder=native, **kw)
    return (pipeline.StreamingCtrPipeline(port_stream, **common),
            jax_pipeline.StreamingCtrPipeline(jax_stream, **common))


def _collect(pipe, k):
    if k == 1:
        return [{key: v.copy() for key, v in b.items()} for b in pipe]
    return [({key: v.copy() for key, v in rows.items()}, m, n)
            for rows, m, n in pipe.iter_superbatches(k)]


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(g, tuple):  # (rows, m, n_ex)
            assert g[1:] == w[1:]
            g, w = g[0], w[0]
        assert set(g) == set(w) == {"feat_ids", "feat_vals", "label"}
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("k,bs,skip,drop,native", [
    (1, 32, 0, True, True),
    (1, 50, 3, False, True),
    (8, 32, 0, False, True),
    (8, 50, 5, True, True),
    (8, 32, 11, False, True),
    (1, 32, 2, False, False),
    (8, 50, 5, True, False),
])
def test_emission_equals_jax(files, small_chunks, k, bs, skip, drop, native):
    port, jax_side = _pipes(files, native=native, batch_size=bs,
                            skip_batches=skip, drop_remainder=drop,
                            prefetch_batches=2 if k == 1 else 0)
    _same(_collect(port, k), _collect(jax_side, k))


def test_groups_hold_the_k1_sequence(files, small_chunks):
    """The k-batch feed is the per-batch sequence regrouped: a resume's skip
    count lines up across both feeds."""
    a, _ = _pipes(files, batch_size=32, prefetch_batches=0)
    b, _ = _pipes(files, batch_size=32, prefetch_batches=0)
    flat = [{key: v[i * 32:(i + 1) * 32] for key, v in rows.items()}
            for rows, m, _ in b.iter_superbatches(8) for i in range(m)]
    _same(_collect(a, 1), flat)


def test_single_pass(files):
    port, _ = _pipes(files, batch_size=32, prefetch_batches=0)
    list(port)
    with pytest.raises(RuntimeError, match="single-pass"):
        list(port)


def test_chained_order_shuffles_per_epoch_as_jax(files):
    port, jax_side = _streams(files, epochs=3, epoch_offset=5)
    assert port._files == jax_side._files
    per_epoch = [port._files[i:i + 3] for i in (0, 3, 6)]
    assert all(sorted(e) == files for e in per_epoch)
    assert len({tuple(e) for e in per_epoch}) > 1
    # The stream is those files' bytes, back to back.
    want = b"".join(open(p, "rb").read() for p in port._files)
    got = bytearray()
    while True:
        chunk = port.read(5000)
        if not chunk:
            break
        got += chunk
    assert bytes(got) == want


def _flip_data_crc(path, record):
    data = bytearray(open(path, "rb").read())
    pos = 0
    for _ in range(record):
        (length,) = struct.unpack_from("<Q", data, pos)
        pos += 16 + length
    (length,) = struct.unpack_from("<Q", data, pos)
    data[pos + 12 + length] ^= 0xFF
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("native", [True, False])
def test_flipped_crc_skipped_as_jax(tmp_path, small_chunks, native):
    paths = sorted(libsvm.generate_synthetic_ctr(
        str(tmp_path), num_files=2, examples_per_file=90, feature_size=500,
        field_size=F, seed=8))
    _flip_data_crc(paths[1], 3)
    port, jax_side = _pipes(paths, native=native, epochs=1, batch_size=16,
                            drop_remainder=False, verify_crc=True,
                            on_bad_record="skip", prefetch_batches=0)
    got, want = _collect(port, 8), _collect(jax_side, 8)
    _same(got, want)
    assert sum(n for _, _, n in got) == 2 * 90 - 1
    assert port.health.bad_records == jax_side.health.bad_records == 1
    port, _ = _pipes(paths, native=native, epochs=1, batch_size=16,
                     verify_crc=True, prefetch_batches=0)
    with pytest.raises(IOError, match="CRC"):
        list(port)


# -- the pipe-mode task ------------------------------------------------------

V = 300


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pipe_task"))
    libsvm.generate_synthetic_ctr(d, num_files=3, examples_per_file=100,
                                  feature_size=V, field_size=5, seed=31)
    return d


def _cfg(data_dir, model_dir, **kw):
    base = dict(task_type="train", feature_size=V, field_size=5,
                embedding_size=4, deep_layers="8", dropout="0.5",
                batch_size=16, learning_rate=0.01, log_steps=0,
                steps_per_loop=4, num_epochs=2, pipe_mode=1,
                data_dir=data_dir, model_dir=model_dir,
                save_checkpoints_steps=6, seed=3)
    base.update(kw)
    return Config(**base)


def _final(model_dir):
    steps = sorted(int(n[5:-3]) for n in os.listdir(model_dir)
                   if n.startswith("ckpt-"))
    return torch.load(os.path.join(model_dir, f"ckpt-{steps[-1]}.pt"),
                      weights_only=True)


@pytest.fixture
def clean_listener():
    preempt_lib.get_listener().clear()
    yield
    preempt_lib.get_listener().clear()


def test_pipe_task_steps_and_producer_epochs(data_dir, tmp_path):
    res = tasks.run(_cfg(data_dir, str(tmp_path / "m")), device="cpu")
    # One stream of 2 x 300 records; drop_remainder cuts only its end.
    assert res["steps"] == 600 // 16 and np.isfinite(res["loss"])


def test_pipe_resume_equals_uninterrupted(data_dir, tmp_path, monkeypatch,
                                          clean_listener):
    clean = str(tmp_path / "clean")
    tasks.run(_cfg(data_dir, clean), device="cpu")
    cut = str(tmp_path / "cut")
    monkeypatch.setenv(tasks.PREEMPT_AFTER_ENV, "13")
    with pytest.raises(preempt_lib.Preempted):
        tasks.run(_cfg(data_dir, cut), device="cpu")
    monkeypatch.delenv(tasks.PREEMPT_AFTER_ENV)
    preempt_lib.get_listener().clear()
    assert 13 <= _final(cut)["step"] < 37
    res = tasks.run(_cfg(data_dir, cut), device="cpu")
    assert res["steps"] == 37
    a, b = _final(clean), _final(cut)
    assert a["step"] == b["step"] == 37
    for part in ("params", "model_state"):
        for key in a[part]:
            assert torch.equal(a[part][key], b[part][key]), key
    assert torch.equal(a["rng"], b["rng"])
    assert sorted(glob.glob(os.path.join(cut, "ckpt-*.pt")))
