"""The port's native TFRecord decoder (``deepfm_tpu_torch.native.loader``)
against the JAX package's loader and the Python codec, on the CPU.

Integer and float outputs are host bytes, held bit for bit: framing at
every chunk boundary, the eager, scatter and assemble decodes, CRC32C,
error texts, negative and large ids, and the build, which raises rather
than fall back when the compiler fails.
"""

import os
import stat
import struct

import numpy as np
import pytest
import torch

from deepfm_tpu.data import example_codec as jax_codec
from deepfm_tpu.native import loader as jax_loader
from deepfm_tpu_torch import _native
from deepfm_tpu_torch.data import example_codec, libsvm, pipeline, tfrecord
from deepfm_tpu_torch.native import loader

torch.set_num_threads(1)

F = 9


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    files = libsvm.generate_synthetic_ctr(
        str(d), num_files=2, examples_per_file=300, feature_size=5000,
        field_size=F, seed=3)
    return [open(p, "rb").read() for p in files]


def _frames(buf):
    """(payload offset, length) per record, by walking the headers."""
    out, pos = [], 0
    while pos < len(buf):
        (length,) = struct.unpack_from("<Q", buf, pos)
        out.append((pos + 12, length))
        pos += 16 + length
    return out


def test_split_frames_matches_jax_and_python(raw):
    buf = raw[0]
    offs, lens = loader.split_frames(buf)
    j_offs, j_lens = jax_loader.split_frames(buf)
    np.testing.assert_array_equal(offs, j_offs)
    np.testing.assert_array_equal(lens, j_lens)
    want = _frames(buf)
    assert offs.tolist() == [o for o, _ in want]
    assert lens.tolist() == [n for _, n in want]
    assert [buf[o:o + n] for o, n in zip(offs, lens)] == \
        tfrecord.split_record_frames(buf, verify_crc=True)


@pytest.mark.parametrize("verify_crc", [True, False])
def test_split_frames_partial_at_every_chunk_boundary(raw, verify_crc):
    """Cut the buffer at every byte of the first records and at frame edges
    further on: the framed prefix, the consumed count and the carried tail
    equal the JAX loader's and the Python framer's."""
    buf = raw[1]
    edges = [o - 12 for o, _ in _frames(buf)]
    cuts = list(range(0, 3 * (edges[1] - edges[0]) + 5)) + [
        e + d for e in edges[10:200:17] for d in (-1, 0, 1, 13)] + [len(buf)]
    for cut in cuts:
        part = buf[:cut]
        got = loader.split_frames_partial(part, verify_crc=verify_crc)
        want = jax_loader.split_frames_partial(part, verify_crc=verify_crc)
        py = tfrecord.scan_frames_partial(part, verify_crc=verify_crc)
        for a, b, c in zip(got[:2], want[:2], py[:2]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert got[2] == want[2] == py[2], cut
        assert not py[3]


def test_decode_spans_matches_jax_and_python_codec(raw):
    buf = raw[0]
    offs, lens = loader.split_frames(buf)
    labels, ids, vals = loader.decode_spans(buf, offs, lens, F)
    j = jax_loader.decode_spans(buf, offs, lens, F)
    py = pipeline.decode_batch_python(
        [buf[o:o + n] for o, n in zip(offs, lens)], F)
    for got, want, ref in zip((labels, ids, vals), j, py):
        assert got.dtype == want.dtype == ref.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
    recs = [buf[o:o + n] for o, n in zip(offs[:50], lens[:50])]
    for got, want in zip(loader.decode_batch(recs, F),
                         loader.decode_file_bytes(buf, F)):
        np.testing.assert_array_equal(got, want[:50])


def _pool(n):
    return (np.full((n, 1), -1, np.float32), np.full((n, F), -1, np.int32),
            np.full((n, F), -1, np.float32))


def _jobs(raw, perm):
    """One job per file (and the second file split in two), with each
    record's destination row from ``perm``."""
    jobs, off = [], 0
    for buf in raw:
        offs, lens = loader.split_frames(buf)
        m = len(offs)
        half = m // 2
        for s, e in ((0, half), (half, m)):
            jobs.append((buf, offs[s:e], lens[s:e], perm[off + s:off + e]))
        off += m
    return jobs, off


def test_scatter_and_assemble_routes_write_the_same_bytes(raw):
    """``decode_spans_scatter`` per job, ``assemble_spans`` in one call,
    the Python mirror and the JAX loader's assemble fill the same rows with
    the same bytes (the pooled path's two routes)."""
    n = sum(len(loader.split_frames(b)[0]) for b in raw)
    perm = np.random.default_rng(5).permutation(n)
    jobs, _ = _jobs(raw, perm)
    outs = {}
    for route in ("scatter", "assemble", "python", "jax"):
        labels, ids, vals = _pool(n)
        if route == "scatter":
            for buf, offs, lens, dest in jobs:
                loader.decode_spans_scatter(buf, offs, lens, F, dest,
                                            labels.reshape(-1), ids, vals)
        elif route == "assemble":
            loader.assemble_spans(jobs, F, labels, ids, vals)
        elif route == "python":
            loader.assemble_spans_python(jobs, F, labels, ids, vals)
        else:
            jax_loader.assemble_spans(jobs, F, labels, ids, vals)
        outs[route] = (labels, ids, vals)
    for route in ("assemble", "python", "jax"):
        for got, want in zip(outs[route], outs["scatter"]):
            np.testing.assert_array_equal(got, want, err_msg=route)
    # Row perm[j] holds arrival record j.
    eager = [loader.decode_file_bytes(b, F) for b in raw]
    arrival_ids = np.concatenate([e[1] for e in eager])
    np.testing.assert_array_equal(outs["scatter"][1][perm], arrival_ids)


@pytest.mark.parametrize("dest", [[-1, 0], [0, 10 ** 6], [0]],
                         ids=["negative", "past_the_pool", "short"])
def test_out_of_bounds_destinations_raise(raw, dest):
    buf = raw[0]
    offs, lens = loader.split_frames(buf)
    offs, lens = offs[:2], lens[:2]
    labels, ids, vals = _pool(8)
    dest = np.array(dest, np.int64)
    with pytest.raises(ValueError, match="dest"):
        loader.decode_spans_scatter(buf, offs, lens, F, dest,
                                    labels.reshape(-1), ids, vals)
    with pytest.raises(ValueError, match="dest"):
        loader.assemble_spans([(buf, offs, lens, dest)], F, labels, ids,
                              vals)
    assert (ids == -1).all()  # nothing was written


def test_crc_vectors_match_python_and_jax():
    assert loader.crc32c(b"123456789") == 0xE3069283  # the CRC32C check value
    assert loader.crc32c(b"") == 0
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 63, 64, 65, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert loader.crc32c(data) == tfrecord.crc32c(data) == \
            jax_loader.crc32c(data)


def test_corrupt_crc_detected(raw):
    buf = bytearray(raw[0])
    o, n = _frames(bytes(buf))[5]
    buf[o + n] ^= 0x01  # the data CRC of record 5
    with pytest.raises(IOError, match="CRC mismatch"):
        loader.split_frames(bytes(buf), verify_crc=True)
    with pytest.raises(IOError, match="CRC mismatch"):
        loader.split_frames_partial(bytes(buf), verify_crc=True)
    offs, _ = loader.split_frames(bytes(buf), verify_crc=False)
    assert len(offs) == 300
    with pytest.raises(IOError, match="truncated TFRecord"):
        loader.split_frames(raw[0][:-3])


def test_wrong_field_size_names_the_field(raw):
    buf = raw[0]
    offs, lens = loader.split_frames(buf)
    with pytest.raises(ValueError) as got:
        loader.decode_spans(buf, offs, lens, F + 1)
    with pytest.raises(ValueError) as want:
        jax_loader.decode_spans(buf, offs, lens, F + 1)
    assert str(got.value) == str(want.value)
    assert f"'ids' length != field_size={F + 1}" in str(got.value)
    missing = example_codec.encode_example(
        {"label": (np.asarray([1.0], np.float32), "float")})
    with pytest.raises(ValueError, match="required keys missing"):
        loader.decode_batch([missing], F)


def test_negative_and_large_ids_decode_as_the_python_codec():
    """int64 ids outside int32 wrap as numpy's ``astype(np.int32)`` does in
    the Python codec, on both packages' decoders."""
    ids = np.array([-1, -7, 2 ** 31 - 1, 2 ** 31, 2 ** 40 + 3, -(2 ** 35),
                    0, 123456789, -2 ** 31], np.int64)
    vals = np.linspace(-2, 2, len(ids)).astype(np.float32)
    recs = [example_codec.encode_ctr_example(1.0, ids, vals),
            jax_codec.encode_ctr_example(0.0, ids[::-1].copy(),
                                         vals[::-1].copy())]
    got = loader.decode_batch(recs, len(ids))
    want = jax_loader.decode_batch(recs, len(ids))
    py = pipeline.decode_batch_python(recs, len(ids))
    for a, b, c in zip(got, want, py):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got[1][0], ids.astype(np.int32))


# ---------------------------------------------------------------------------
# The build: hash-named, serialized, and no fallback
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A private _build/ dir and no loaded library."""
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(loader, "_lib", None)
    return tmp_path


def _fake_gxx(bindir, body):
    bindir.mkdir(exist_ok=True)
    path = bindir / "g++"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)


def test_failed_build_raises_with_compiler_output(fresh_build, monkeypatch):
    _fake_gxx(fresh_build / "bin", 'echo "error: no decoder today"; exit 1\n')
    monkeypatch.setenv("PATH", str(fresh_build / "bin"))
    with pytest.raises(_native.KernelBuildError, match="no decoder today"):
        loader.load()
    assert os.listdir(_native.BUILD_DIR) == [".tfrecord.lock"]
    # The pipeline raises too: no switch to the per-record decode.
    with pytest.raises(_native.KernelBuildError, match="no decoder today"):
        pipeline.CtrPipeline(["x.tfrecords"], field_size=F, batch_size=4)
    pipeline.CtrPipeline(["x.tfrecords"], field_size=F, batch_size=4,
                         use_native_decoder=False)  # the explicit path


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_build / "empty"))
    with pytest.raises(_native.KernelBuildError, match="g\\+\\+ not found"):
        loader.build()


def test_library_is_keyed_on_source_and_built_once(fresh_build, monkeypatch):
    src = fresh_build / "tfrecord_native.cc"
    src.write_text(open(loader.SOURCE).read())
    monkeypatch.setattr(loader, "SOURCE", str(src))
    first = loader.library_path()
    assert first.startswith(_native.BUILD_DIR)
    assert os.path.basename(first).startswith("libtfrecord_")
    assert loader.build() > 0 and os.path.exists(first)
    assert loader.build() == 0.0  # already built
    assert loader.crc32c(b"123456789") == 0xE3069283
    src.write_text(src.read_text() + "\n// edited\n")
    assert loader.library_path() != first
