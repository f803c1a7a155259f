"""The port's decoded-epoch cache (``deepfm_tpu_torch.data.cache``) on the
CPU: cached emission equal to the streamed emission and to the JAX
package's cached emission (``ram`` and ``disk``), a hit decodes nothing,
a touched file rebuilds, a corrupt slab is counted and rebuilt, and
``disk`` needs a directory."""

import os

import numpy as np
import pytest
import torch

from deepfm_tpu.data import cache as jax_cache
from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu_torch.data import cache as cache_lib
from deepfm_tpu_torch.data import libsvm, pipeline

torch.set_num_threads(1)

F = 5


@pytest.fixture()
def dataset(tmp_path):
    data = tmp_path / "data"
    libsvm.generate_synthetic_ctr(
        str(data), num_files=3, examples_per_file=60, field_size=F,
        feature_size=200, seed=9, prefix="tr")
    return sorted(str(p) for p in data.glob("tr*.tfrecords"))


def _kw(**kw):
    base = dict(field_size=F, batch_size=16, num_epochs=2, shuffle=True,
                shuffle_buffer=70, seed=13, drop_remainder=False,
                prefetch_batches=0)
    base.update(kw)
    return base


def _emitted(pipe, k=1):
    rows = [r for r, _, _ in pipe.iter_superbatches(k)] if k > 1 \
        else list(pipe)
    return {key: np.concatenate([r[key] for r in rows]) for key in rows[0]}


@pytest.mark.parametrize("mode", ["ram", "disk"])
@pytest.mark.parametrize("k", [1, 4])
def test_cached_emission_equals_streamed_and_jax(dataset, tmp_path, mode, k):
    """Streamed, cold cache, warm cache and the JAX package's cached
    pipeline emit the same rows in the same order (the pool drains several
    times an epoch here, at the same file boundaries on every path)."""
    cache_lib.clear_ram_cache()
    jax_cache.clear_ram_cache()
    cache_dir = str(tmp_path / f"slabs_{mode}")
    ckw = dict(decoded_cache=mode,
               decoded_cache_dir=cache_dir if mode == "disk" else "")
    streamed = _emitted(pipeline.CtrPipeline(dataset, **_kw()), k)
    cold = _emitted(pipeline.CtrPipeline(dataset, **_kw(**ckw)), k)
    warm = _emitted(pipeline.CtrPipeline(dataset, **_kw(**ckw)), k)
    jax_dir = str(tmp_path / f"jax_slabs_{mode}")
    jckw = dict(ckw, decoded_cache_dir=jax_dir if mode == "disk" else "")
    want = _emitted(jax_pipeline.CtrPipeline(dataset, **_kw(**jckw)), k)
    for name, got in (("cold", cold), ("warm", warm), ("jax", want)):
        for key in streamed:
            np.testing.assert_array_equal(got[key], streamed[key],
                                          err_msg=f"{name}:{key}")
    if mode == "disk":
        entries = [d for d in os.listdir(cache_dir) if not d.startswith(".")]
        assert len(entries) == 1


def test_a_hit_decodes_nothing(dataset, monkeypatch):
    cache_lib.clear_ram_cache()
    builds = []
    real = pipeline.CtrPipeline._build_cache_columns

    def counting(self):
        builds.append(1)
        return real(self)

    monkeypatch.setattr(pipeline.CtrPipeline, "_build_cache_columns",
                        counting)
    first = pipeline.CtrPipeline(dataset, **_kw(decoded_cache="ram"))
    cols = first.decoded_epoch_columns()
    assert cols.num_records == 180 and cols.counts.tolist() == [60] * 3
    assert cols.ids.shape == (180, F) and cols.labels.dtype == np.float32
    second = pipeline.CtrPipeline(dataset, **_kw(decoded_cache="ram",
                                                 epoch_offset=1))
    list(second)
    assert len(builds) == 1
    assert second.decoded_epoch_columns() is cols


def test_columns_equal_jax_columns(dataset):
    cache_lib.clear_ram_cache()
    jax_cache.clear_ram_cache()
    got = pipeline.CtrPipeline(
        dataset, **_kw(decoded_cache="ram")).decoded_epoch_columns()
    for native in (True, False):
        want = jax_pipeline.CtrPipeline(
            dataset, **_kw(decoded_cache="ram", use_native_decoder=native)
        ).decoded_epoch_columns()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        jax_cache.clear_ram_cache()
    # The Python decode builds the same columns under its own identity.
    py = pipeline.CtrPipeline(dataset, **_kw(decoded_cache="ram",
                                             use_native_decoder=False))
    assert py.decoded_cache_fingerprint() != pipeline.CtrPipeline(
        dataset, **_kw(decoded_cache="ram")).decoded_cache_fingerprint()
    for a, b in zip(py.decoded_epoch_columns(), got):
        np.testing.assert_array_equal(a, b)


def test_touched_file_rebuilds(dataset, tmp_path):
    cache_dir = str(tmp_path / "slabs")
    kw = _kw(decoded_cache="disk", decoded_cache_dir=cache_dir)
    p1 = pipeline.CtrPipeline(dataset, **kw)
    fp1 = p1.decoded_cache_fingerprint()
    p1.decoded_epoch_columns()
    st = os.stat(dataset[0])
    os.utime(dataset[0], ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    p2 = pipeline.CtrPipeline(dataset, **kw)
    assert p2.decoded_cache_fingerprint() != fp1
    p2.decoded_epoch_columns()
    entries = [d for d in os.listdir(cache_dir) if not d.startswith(".")]
    assert sorted(entries) == sorted({fp1, p2.decoded_cache_fingerprint()})
    a = pipeline.CtrPipeline(dataset, **_kw(decoded_cache="ram",
                                            on_bad_record="raise"))
    b = pipeline.CtrPipeline(dataset, **_kw(decoded_cache="ram",
                                            on_bad_record="skip"))
    assert a.decoded_cache_fingerprint() != b.decoded_cache_fingerprint()


def test_corrupt_slab_is_counted_and_rebuilt(dataset, tmp_path):
    cache_dir = str(tmp_path / "slabs")
    kw = _kw(decoded_cache="disk", decoded_cache_dir=cache_dir)
    p1 = pipeline.CtrPipeline(dataset, **kw)
    golden = _emitted(p1)
    entry = os.path.join(cache_dir, p1.decoded_cache_fingerprint())
    with open(os.path.join(entry, "feat_ids.npy"), "wb") as f:
        f.write(b"\x93NUMPYgarbage")
    p2 = pipeline.CtrPipeline(dataset, **kw)
    with pytest.warns(RuntimeWarning, match="rebuilding from source"):
        got = _emitted(p2)
    for key in golden:
        np.testing.assert_array_equal(golden[key], got[key], err_msg=key)
    assert p2.health.snapshot()["bad_records"] == 1
    assert pipeline.CtrPipeline(dataset, **kw)._make_cache().load() \
        is not None


def test_disk_needs_a_directory(dataset):
    with pytest.raises(ValueError, match="cache dir"):
        pipeline.CtrPipeline(
            dataset, **_kw(decoded_cache="disk")).decoded_epoch_columns()
    with pytest.raises(ValueError, match="decoded_cache must be one of"):
        cache_lib.DecodedEpochCache("tape", "", dataset, field_size=F,
                                    verify_crc=False, on_bad_record="raise",
                                    max_bad_records=0)


def test_epoch_chunks_follow_the_file_order(dataset):
    cache_lib.clear_ram_cache()
    cols = pipeline.CtrPipeline(
        dataset, **_kw(decoded_cache="ram")).decoded_epoch_columns()
    chunks = cache_lib.epoch_chunks(cols, [2, 0, 1], chunk_records=25)
    assert [len(c[0]) for c in chunks] == [25, 25, 10] * 3
    np.testing.assert_array_equal(chunks[0][1], cols.ids[120:145])
    np.testing.assert_array_equal(chunks[3][1], cols.ids[0:25])
