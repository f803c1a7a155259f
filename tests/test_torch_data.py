"""The port's TFRecord input plane (``deepfm_tpu_torch.data``) against the
JAX package's: files byte for byte, batches bit for bit.

Both are host-side numpy code, so nothing here has a tolerance: the port's
``generate_synthetic_ctr`` writes the JAX package's bytes, and its
``CtrPipeline`` emits the batches of the JAX ``CtrPipeline`` with the
native decoder off, for the same files and seed.
"""

import os

import numpy as np
import pytest
import torch

from deepfm_tpu.data import example_codec as jax_codec
from deepfm_tpu.data import libsvm as jax_libsvm
from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu.data import tfrecord as jax_tfrecord
from deepfm_tpu_torch.data import example_codec, libsvm, pipeline, tfrecord

torch.set_num_threads(1)

GEN = dict(num_files=3, examples_per_file=97, feature_size=200, field_size=5,
           seed=4)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("port")
    return libsvm.generate_synthetic_ctr(str(d), **GEN)


def test_synthetic_tfrecords_byte_identical(tmp_path, files):
    want = jax_libsvm.generate_synthetic_ctr(str(tmp_path), **GEN)
    assert [os.path.basename(p) for p in files] == [
        os.path.basename(p) for p in want]
    for a, b in zip(files, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_codec_round_trip_and_jax_bytes():
    ids = np.array([3, 0, 2 ** 40, -7], np.int64)
    vals = np.array([0.5, -1.25, 3.0, 0.0], np.float32)
    rec = example_codec.encode_ctr_example(1.0, ids, vals)
    assert rec == jax_codec.encode_ctr_example(1.0, ids, vals)
    label, got_ids, got_vals = example_codec.decode_ctr_example(rec, 4)
    assert label == 1.0
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_vals, vals)
    with pytest.raises(ValueError, match="field_size=5"):
        example_codec.decode_ctr_example(rec, 5)
    legacy = jax_codec.encode_example({
        "label": (np.asarray([0.0], np.float32), "float"),
        "feat_ids": (ids, "int64"), "feat_vals": (vals, "float")})
    assert example_codec.decode_ctr_example(legacy, 4)[0] == 0.0


def test_tfrecord_crc_and_corruption(tmp_path):
    path = str(tmp_path / "x.tfrecords")
    with tfrecord.TFRecordWriter(path) as w:
        for r in (b"abc", b"", b"x" * 1000):
            w.write(r)
    assert list(tfrecord.iter_records(path)) == [b"abc", b"", b"x" * 1000]
    assert jax_tfrecord.read_all_records(path) == [b"abc", b"", b"x" * 1000]
    for data in (b"", b"123456789", b"abcdefgh" * 9 + b"z"):
        assert tfrecord.masked_crc32c(data) == jax_tfrecord.masked_crc32c(data)
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF  # inside the first payload
    with open(path, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(IOError, match="data CRC mismatch"):
        list(tfrecord.iter_records(path))
    assert len(list(tfrecord.iter_records(path, verify_crc=False))) == 3


def test_convert_libsvm_matches_jax(tmp_path):
    src = tmp_path / "a.libsvm"
    src.write_text("1 3:0.5 7:-1 9:2\n\n0 1:1 2:2 3:3\n")
    n = libsvm.convert_libsvm_file(str(src), str(tmp_path / "p.tfrecords"),
                                   field_size=3)
    assert n == jax_libsvm.convert_libsvm_file(
        str(src), str(tmp_path / "j.tfrecords"), field_size=3) == 2
    assert (tmp_path / "p.tfrecords").read_bytes() == (
        tmp_path / "j.tfrecords").read_bytes()


def _both(files, **kw):
    common = dict(field_size=GEN["field_size"], seed=7, **kw)
    port = pipeline.CtrPipeline(files, **common)
    jax_side = jax_pipeline.CtrPipeline(files, use_native_decoder=False,
                                        **common)
    return list(port), list(jax_side)


@pytest.mark.parametrize("kw", [
    dict(batch_size=32, shuffle=False, shuffle_files=False),
    dict(batch_size=32, num_epochs=2, shuffle_buffer=50),
    dict(batch_size=40, num_epochs=3, shuffle_buffer=1000,
         drop_remainder=False),
    dict(batch_size=16, num_epochs=2, shuffle_buffer=64, skip_batches=5,
         epoch_offset=3),
    dict(batch_size=25, shuffle_buffer=10, drop_remainder=False,
         skip_batches=11, prefetch_batches=0),
])
def test_pipeline_batches_bit_identical_to_jax(files, kw):
    got, want = _both(files, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"feat_ids", "feat_vals", "label"}
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_pipeline_epochs_reshuffle_and_count(files):
    p = pipeline.CtrPipeline(files, field_size=5, batch_size=50,
                             num_epochs=2, seed=1)
    batches = list(p)
    assert len(batches) == 2 * (3 * 97 // 50)
    assert not np.array_equal(batches[0]["feat_ids"], batches[5]["feat_ids"])
    assert p.count_examples() == 3 * 97


def test_prefetch_propagates_producer_errors(tmp_path):
    bad = tmp_path / "tr_bad.tfrecords"
    bad.write_bytes(b"\x01\x02\x03")
    p = pipeline.CtrPipeline([str(bad)], field_size=5, batch_size=4)
    with pytest.raises(IOError, match="truncated TFRecord header"):
        list(p)
