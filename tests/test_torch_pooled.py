"""The port's pooled native emission (``CtrPipeline.iter_superbatches`` and
``__iter__`` with ``use_native_decoder=True``) against the JAX package's,
byte for byte, on the CPU.

The read chunk is shrunk to 4 KiB on both sides, so every file arrives in
many chunks with carried tails and the shuffle pool drains several times an
epoch: any difference in chunking, pending order or the rng stream moves
every later batch.
"""

import hashlib

import numpy as np
import pytest
import torch

from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu_torch.data import libsvm, pipeline

torch.set_num_threads(1)

F = 7


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pooled")
    return libsvm.generate_synthetic_ctr(
        str(d), num_files=3, examples_per_file=410, feature_size=800,
        field_size=F, seed=12)


@pytest.fixture
def small_chunks(monkeypatch):
    for mod in (pipeline, jax_pipeline):
        monkeypatch.setattr(mod, "_NATIVE_CHUNK_BYTES", 4096)
        monkeypatch.setattr(mod, "_SCATTER_SPLIT_MIN", 64)


def _pipes(files, **kw):
    common = dict(field_size=F, seed=3, shuffle_buffer=300, **kw)
    return (pipeline.CtrPipeline(files, **common),
            jax_pipeline.CtrPipeline(files, use_native_decoder=True,
                                     **common))


def _same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(g, tuple):  # (rows, m, n_ex)
            assert g[1:] == w[1:]
            g, w = g[0], w[0]
        assert set(g) == set(w) == {"feat_ids", "feat_vals", "label"}
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            assert g[key].shape == w[key].shape, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


CASES = [
    # k, batch, skip, drop_remainder, reader_threads, native_assembly
    (1, 64, 0, True, 1, True),
    (1, 50, 5, False, 4, False),
    (4, 64, 0, True, 4, True),
    (4, 50, 5, False, 1, True),
    (4, 64, 5, True, 4, False),
    (4, 50, 0, False, 1, False),
    (8, 64, 0, False, 4, True),
    (8, 50, 5, True, 1, False),
    (8, 64, 5, False, 1, True),
    (8, 50, 0, True, 4, False),
]


@pytest.mark.parametrize("k,bs,skip,drop,threads,assembly", CASES)
def test_superbatches_equal_jax(files, small_chunks, k, bs, skip, drop,
                                threads, assembly):
    port, jax_side = _pipes(files, batch_size=bs, num_epochs=2,
                            skip_batches=skip, drop_remainder=drop,
                            reader_threads=threads, native_assembly=assembly,
                            epoch_offset=3)
    got = list(port.iter_superbatches(k))
    _same(got, list(jax_side.iter_superbatches(k)))
    assert max(m for _, m, _ in got) == k
    assert port.health.snapshot()["bad_records"] == 0


@pytest.mark.parametrize("bs,skip,drop,threads,assembly,shuffle", [
    (64, 0, True, 4, True, True),
    (50, 5, False, 1, False, True),
    (64, 5, False, 4, True, False),
    (50, 0, True, 1, True, False),
])
def test_iter_equals_jax(files, small_chunks, bs, skip, drop, threads,
                         assembly, shuffle):
    port, jax_side = _pipes(files, batch_size=bs, num_epochs=2,
                            skip_batches=skip, drop_remainder=drop,
                            reader_threads=threads, native_assembly=assembly,
                            shuffle=shuffle, shuffle_files=shuffle,
                            prefetch_batches=2)
    _same(list(port), list(jax_side))


def test_skip_is_applied_once_inside_the_stream(files, small_chunks):
    """``skip_batches`` slices a partly covered k-group and drops whole
    ones; the rest equals the unskipped stream past its first 5 batches."""
    full, _ = _pipes(files, batch_size=32, drop_remainder=False)
    skipped, _ = _pipes(files, batch_size=32, drop_remainder=False,
                        skip_batches=5)

    def flat(p, k):
        out = []
        for rows, m, _ in p.iter_superbatches(k):
            ids = rows["feat_ids"]
            out += [ids[i * 32:(i + 1) * 32] for i in range(m)]
        return out

    want = flat(full, 4)[5:]
    got = flat(skipped, 4)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    first = next(iter(skipped.iter_superbatches(4)))
    assert first[1] == 3 and first[2] == 96  # a 4-group sliced to 3


GOLDEN = {  # tests/test_data.py's pooled-emission goldens
    (8, 64, 0, True): "26fff204f1d9b877c88d8696",
    (4, 32, 5, False): "5130307b96f68f89dadc8fa5",
    (1, 64, 0, True): "3d50f093770b87683461989f",
}


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    libsvm.generate_synthetic_ctr(
        str(d), num_files=3, examples_per_file=500, feature_size=1000,
        field_size=7, prefix="tr", seed=5)
    return sorted(str(p) for p in d.glob("tr*.tfrecords"))


def _emission_hash(files, k, bs, skip, drop, **kw):
    pipe = pipeline.CtrPipeline(
        files, field_size=7, batch_size=bs, num_epochs=2, shuffle=True,
        shuffle_files=True, shuffle_buffer=300, drop_remainder=drop, seed=9,
        skip_batches=skip, **kw)
    h = hashlib.sha256()
    for rows, m, n_ex in pipe.iter_superbatches(k):
        h.update(str(m).encode())
        h.update(str(n_ex).encode())
        h.update(rows["feat_ids"].tobytes())
        h.update(rows["feat_vals"].tobytes())
        h.update(rows["label"].tobytes())
    return h.hexdigest()[:24]


@pytest.mark.parametrize("key", sorted(GOLDEN), ids=str)
@pytest.mark.parametrize("assembly", [True, False])
def test_emission_matches_jax_golden(golden_files, key, assembly):
    assert _emission_hash(golden_files, *key,
                          native_assembly=assembly) == GOLDEN[key]


def test_two_live_iterators(files, small_chunks):
    """Two interleaved iterators of one pipeline each emit the whole
    stream: each owns its drain pool."""
    port, _ = _pipes(files, batch_size=40, reader_threads=4, num_epochs=2)
    want = [rows["feat_ids"].copy() for rows, _, _ in
            port.iter_superbatches(4)]
    a, b = port.iter_superbatches(4), port.iter_superbatches(4)
    got_a, got_b = [], []
    for ra, rb in zip(a, b):
        got_a.append(ra[0]["feat_ids"])
        got_b.append(rb[0]["feat_ids"])
    assert len(got_a) == len(got_b) == len(want)
    for x, y, w in zip(got_a, got_b, want):
        np.testing.assert_array_equal(x, w)
        np.testing.assert_array_equal(y, w)


def test_stage_stats_cover_the_host_stages(files):
    from deepfm_tpu_torch.utils.profiling import HostStageStats
    port, _ = _pipes(files, batch_size=64, prefetch_batches=0)
    port.stage_stats = stats = HostStageStats()
    n = sum(int(rows["label"].shape[0])
            for rows, _, _ in port.iter_superbatches(4))
    per = stats.ns_per_record(n)
    assert set(per) == {"read", "frame", "decode_assemble", "emit"}
    assert all(v > 0 for v in per.values())
