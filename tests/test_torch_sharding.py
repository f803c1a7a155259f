"""The port's input-shard policy and its multi-process task helpers against
the JAX package's, on the CPU.

``data.sharding`` is a copy of the JAX package's: ``shard_files`` and
``validate_shard_coverage`` must agree on the whole multi_path x s3_shard
matrix (file shards, record shards, ragged counts), and the pipelines
built from a shard spec must emit the JAX pipelines' batches bit for bit.
``_eval_check_due``, ``resolve_channel_dirs`` (with its errors) and
``_local_batch_size`` (with its error) must agree as well. Integer and
host-side logic: exact equality throughout.
"""

import os

import numpy as np
import pytest
import torch

from deepfm_tpu.config import Config as JaxConfig
from deepfm_tpu.data import pipeline as jax_pipe
from deepfm_tpu.data import sharding as jax_shard
from deepfm_tpu.train import tasks as jax_tasks
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import libsvm
from deepfm_tpu_torch.data import pipeline as pipe
from deepfm_tpu_torch.data import sharding
from deepfm_tpu_torch.parallel import bootstrap
from deepfm_tpu_torch.train import tasks

torch.set_num_threads(1)

FILES = [f"/d/tr-{i:02d}.tfrecords" for i in range(9)]


def _spec_tuple(s):
    return (tuple(s.files), s.record_shard)


@pytest.mark.parametrize("multi_path", [False, True])
@pytest.mark.parametrize("s3", [False, True])
@pytest.mark.parametrize("world,wph", [(1, 1), (2, 1), (2, 2), (3, 1),
                                       (4, 2), (4, 4), (8, 4), (6, 3)])
def test_shard_files_matches_jax(multi_path, s3, world, wph):
    """Every rank's spec, for 0..9 files: the same files and record shard,
    the same ``shard_records`` answers, and the same coverage verdict."""
    for n in range(len(FILES) + 1):
        files = list(reversed(FILES[:n]))
        specs, jspecs = [], []
        for rank in range(world):
            kw = dict(enable_data_multi_path=multi_path, enable_s3_shard=s3,
                      rank=rank, local_rank=rank % wph, world_size=world,
                      workers_per_host=wph)
            got = sharding.shard_files(files, **kw)
            want = jax_shard.shard_files(files, **kw)
            assert _spec_tuple(got) == _spec_tuple(want), (n, rank)
            assert ([got.shard_records(i) for i in range(12)]
                    == [want.shard_records(i) for i in range(12)])
            specs.append(got)
            jspecs.append(want)
        outcomes = []
        for mod, ss in ((sharding, specs), (jax_shard, jspecs)):
            try:
                mod.validate_shard_coverage(ss, sorted(files))
                outcomes.append("ok")
            except AssertionError:
                outcomes.append("mismatch")
        assert outcomes[0] == outcomes[1], n


def test_sharding_module_is_the_jax_code():
    """Below the module docstring the two files are the same code."""
    def body(mod):
        with open(mod.__file__, encoding="utf-8") as f:
            src = f.read()
        return src[src.index("from __future__"):]
    assert body(sharding) == body(jax_shard)


@pytest.mark.parametrize("start", [1, 251, 501, 751])
def test_eval_check_due_matches_jax(start):
    got = [tasks._eval_check_due(n) for n in range(start, start + 250)]
    want = [jax_tasks._eval_check_due(n) for n in range(start, start + 250)]
    assert got == want


def _channel_cfgs(root):
    return [
        dict(data_dir=root),
        dict(data_dir=root, val_data_dir="/v"),
        dict(data_dir=root, channels='["eval","a","b"]'),
        dict(data_dir=root, channels='["train"]'),
        dict(data_dir=root, channels='["eval","a","b"]',
             enable_data_multi_path=True, worker_per_host=2),
        dict(data_dir=root, channels='["eval","a","zz"]',
             enable_data_multi_path=True, worker_per_host=2),
        dict(data_dir=root, channels='["eval","a"]',
             enable_data_multi_path=True, worker_per_host=2),
    ]


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("env", [False, True])
def test_resolve_channel_dirs_matches_jax(tmp_path, monkeypatch, case, env):
    """The same (train, eval) pair for every local worker, or the same
    error (a private channel that resolves nowhere, too few channels)."""
    root = str(tmp_path)
    for name in ("eval", "a", "b"):
        os.makedirs(os.path.join(root, name))
    if env:
        monkeypatch.setenv("SM_CHANNEL_B", "/from/env/b")
    kw = _channel_cfgs(root)[case]
    for rank in range(3):
        outcome = []
        for mod, cfg_cls in ((tasks, Config), (jax_tasks, JaxConfig)):
            try:
                outcome.append(mod.resolve_channel_dirs(
                    cfg_cls(**kw), process_index=rank))
            except (ValueError, FileNotFoundError) as exc:
                outcome.append((type(exc).__name__, str(exc)))
        assert outcome[0] == outcome[1], (kw, rank)


@pytest.mark.parametrize("batch,world", [(64, 1), (64, 2), (64, 4), (64, 3),
                                         (96, 8), (30, 4)])
def test_local_batch_size_matches_jax(monkeypatch, batch, world):
    import jax  # noqa: PLC0415
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(bootstrap, "process_count", lambda: world)
    outcome = []
    for mod, cfg_cls in ((tasks, Config), (jax_tasks, JaxConfig)):
        try:
            outcome.append(mod._local_batch_size(cfg_cls(batch_size=batch)))
        except ValueError as exc:
            outcome.append(str(exc))
    assert outcome[0] == outcome[1]


# ---------------------------------------------------------------------------
# Sharded pipelines: bit-equal emission
# ---------------------------------------------------------------------------

F_, V_ = 6, 500


@pytest.fixture(scope="module")
def shard_files_on_disk(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("shards"))
    return sorted(libsvm.generate_synthetic_ctr(
        d, num_files=3, examples_per_file=150, feature_size=V_,
        field_size=F_, seed=4))


def _emit(mod, files, spec, **kw):
    p = mod.CtrPipeline(files, field_size=F_, batch_size=16, num_epochs=2,
                        shard=spec, seed=3, shuffle_buffer=64,
                        prefetch_batches=0, **kw)
    return list(p)


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (4, 3), (3, 2)])
@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_sharded_pipeline_emission_matches_jax(shard_files_on_disk, world,
                                               rank, native, shuffle):
    """The record shard (3 files for 4 ranks) and the file shard (3 files
    for 2 or 3 ranks) through both packages' ``CtrPipeline``: the same
    batches, bit for bit, on the pooled native and the per-record path."""
    files = shard_files_on_disk
    kw = dict(rank=rank, local_rank=rank, world_size=world,
              workers_per_host=1)
    spec = sharding.shard_files(files, **kw)
    jspec = jax_shard.shard_files(files, **kw)
    got = _emit(pipe, files, spec, use_native_decoder=native,
                shuffle=shuffle)
    want = _emit(jax_pipe, files, jspec, use_native_decoder=native,
                 shuffle=shuffle)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("native", [True, False])
def test_record_sharded_stream_matches_jax(shard_files_on_disk, native):
    """Pipe mode with fewer files than ranks: each rank keeps every
    world-th record of the stream, as the JAX streaming pipeline does."""
    files = shard_files_on_disk
    out = []
    for mod in (pipe, jax_pipe):
        stream = mod.ChainedFileStream(files, num_epochs=1,
                                       shuffle_each_epoch=False, seed=1)
        p = mod.StreamingCtrPipeline(stream, field_size=F_, batch_size=16,
                                     drop_remainder=False,
                                     use_native_decoder=native,
                                     record_shard=(4, 1),
                                     prefetch_batches=0)
        out.append(list(p))
    assert len(out[0]) == len(out[1]) > 0
    for g, w in zip(*out):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_record_shard_turns_the_cache_and_workers_off(shard_files_on_disk):
    """A record-sharded pipeline keeps rows by global index: the decoded
    cache and the input service are off (with a warning), as in the JAX
    package."""
    spec = sharding.ShardSpec(tuple(shard_files_on_disk), record_shard=(2, 0))
    with pytest.warns(RuntimeWarning, match="record-level sharding"):
        p = pipe.CtrPipeline(shard_files_on_disk, field_size=F_,
                             batch_size=16, shard=spec, decoded_cache="ram",
                             input_workers=2)
    assert p.decoded_cache == "off" and p.input_workers == 0
