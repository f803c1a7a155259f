"""The port's last helpers against the JAX package's: ``utils.mfu`` (the
basis labels, the CPU's nominal peak, the card's datasheet table),
``utils.profiling``'s ``maybe_trace`` and ``annotate``, ``data.libsvm``'s
``format_libsvm_line``, ``tfrecord_to_libsvm`` and sharded
``convert_libsvm_file``, ``data.tfrecord.read_all_records``, the
converter module ``deepfm_tpu_torch.tools.libsvm_to_tfrecord``, and the
last public names a module-by-module diff found: the feature codec's
``encode_feature``/``decode_feature`` and ``train.metrics.mean_update``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepfm_tpu.data import example_codec as jax_codec
from deepfm_tpu.data import libsvm as jax_libsvm
from deepfm_tpu.data import tfrecord as jax_tfrecord
from deepfm_tpu.train import metrics as jax_metrics
from deepfm_tpu.utils import mfu as jax_mfu
from deepfm_tpu_torch.data import example_codec, libsvm, tfrecord
from deepfm_tpu_torch.train import metrics
from deepfm_tpu_torch.tools import libsvm_to_tfrecord
from deepfm_tpu_torch.utils import mfu, profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- mfu --------------------------------------------------------------------

def test_basis_labels_match_jax():
    assert (mfu.BASIS_MEASURED, mfu.BASIS_NOMINAL, mfu.BASIS_UNAVAILABLE) \
        == (jax_mfu.BASIS_MEASURED, jax_mfu.BASIS_NOMINAL,
            jax_mfu.BASIS_UNAVAILABLE)
    assert mfu.NOMINAL_CPU_PEAK_FLOPS == jax_mfu.NOMINAL_CPU_PEAK_FLOPS


@pytest.mark.parametrize("flops,rate", [(1.0e6, 1.0e3), (2.5e7, 333.0),
                                        (4.1e5, 12345.6)])
def test_cpu_numbers_match_jax(flops, rate):
    assert mfu.device_peak_flops("cpu") == jax_mfu.device_peak_flops()
    assert mfu.mfu_pct(flops, rate, "cpu") == jax_mfu.mfu_pct(flops, rate)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.5e12),
    ("NVIDIA H100 SXM5 80GB", 989.5e12),
    ("NVIDIA H100 PCIe", 756.5e12),
])
def test_h100_names_take_the_datasheet_peak(monkeypatch, name, peak):
    assert mfu.peak_for_name(name) == (peak, mfu.BASIS_MEASURED)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert mfu.device_peak_flops("cuda") == (peak, name, mfu.BASIS_MEASURED)
    pct, basis, got = mfu.mfu_pct(1e9, 1e5, "cuda")
    assert (pct, basis, got) == (round(100.0 * 1e14 / peak, 4),
                                 mfu.BASIS_MEASURED, name)


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA L4",
                                  "Tesla V100-SXM2-16GB"])
def test_an_unknown_card_is_unavailable(monkeypatch, name):
    assert mfu.peak_for_name(name) == (None, mfu.BASIS_UNAVAILABLE)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert mfu.device_peak_flops("cuda") == (None, name,
                                             mfu.BASIS_UNAVAILABLE)
    assert mfu.mfu_pct(1e9, 1e5, "cuda") == (None, mfu.BASIS_UNAVAILABLE,
                                             name)


# -- maybe_trace / annotate ---------------------------------------------------

def test_annotate_names_appear_in_a_maybe_trace_export(tmp_path):
    with profiling.maybe_trace(str(tmp_path), device="cpu") as out:
        for i in range(3):
            with profiling.annotate(f"dfm_region_{i}"):
                torch.ones(64, 64).sum()
    with open(out["path"]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"dfm_region_0", "dfm_region_1", "dfm_region_2"} <= names
    assert os.path.dirname(out["path"]) == str(tmp_path)
    # A second block writes the next file.
    with profiling.maybe_trace(str(tmp_path), device="cpu") as out2:
        torch.zeros(3).sum()
    assert out2["path"] != out["path"] and len(os.listdir(tmp_path)) == 2


def test_maybe_trace_without_a_dir_is_a_noop(tmp_path):
    with profiling.maybe_trace("") as out:
        with profiling.annotate("unseen"):
            torch.ones(4).sum()
    assert out is None
    with profiling.maybe_trace(None) as out:
        pass
    assert out is None


# -- libsvm -------------------------------------------------------------------

def _libsvm_text(path, n, f, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as out:
        for _ in range(n):
            feats = " ".join(f"{rng.integers(0, 1000)}:"
                             f"{rng.uniform(-1, 1):.4f}" for _ in range(f))
            out.write(f"{int(rng.random() < 0.3)} {feats}\n")
        out.write("\n")  # a blank line is skipped


def test_format_libsvm_line_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        ids = rng.integers(0, 10**6, size=7)
        vals = rng.standard_normal(7).astype(np.float32)
        label = float(rng.integers(0, 2))
        assert libsvm.format_libsvm_line(label, ids, vals) == \
            jax_libsvm.format_libsvm_line(label, ids, vals)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_convert_libsvm_file_matches_jax(tmp_path, num_shards):
    src = str(tmp_path / "in.libsvm")
    _libsvm_text(src, 40, 6, seed=num_shards)
    n = libsvm.convert_libsvm_file(src, str(tmp_path / "port.tfrecords"),
                                   field_size=6, num_shards=num_shards)
    m = jax_libsvm.convert_libsvm_file(src, str(tmp_path / "jax.tfrecords"),
                                       field_size=6, num_shards=num_shards)
    assert n == m == 40
    ours = sorted(p for p in os.listdir(tmp_path) if p.startswith("port"))
    theirs = sorted(p for p in os.listdir(tmp_path) if p.startswith("jax"))
    assert [p[4:] for p in ours] == [p[3:] for p in theirs]
    assert len(ours) == num_shards
    if num_shards > 1:
        assert ours[0] == "port.tfrecords-00000-of-00003"
    for a, b in zip(ours, theirs):
        with open(tmp_path / a, "rb") as fa, open(tmp_path / b, "rb") as fb:
            assert fa.read() == fb.read()
        assert tfrecord.read_all_records(str(tmp_path / a)) == \
            jax_tfrecord.read_all_records(str(tmp_path / b))


def test_convert_validates_like_jax(tmp_path):
    src = str(tmp_path / "in.libsvm")
    _libsvm_text(src, 5, 6, seed=1)
    with pytest.raises(ValueError, match="expected 7 features, got 6"):
        libsvm.convert_libsvm_file(src, str(tmp_path / "o"), field_size=7)
    with pytest.raises(ValueError, match="num_shards must be >= 1"):
        libsvm.convert_libsvm_file(src, str(tmp_path / "o"), num_shards=0)


def test_tfrecord_to_libsvm_round_trip_matches_jax(tmp_path):
    src = str(tmp_path / "in.libsvm")
    _libsvm_text(src, 30, 5, seed=7)
    rec = str(tmp_path / "tr.tfrecords")
    libsvm.convert_libsvm_file(src, rec, field_size=5)
    n = libsvm.tfrecord_to_libsvm(rec, str(tmp_path / "port.txt"), 5)
    m = jax_libsvm.tfrecord_to_libsvm(rec, str(tmp_path / "jax.txt"), 5)
    assert n == m == 30
    port = (tmp_path / "port.txt").read_text()
    assert port == (tmp_path / "jax.txt").read_text()
    # Converting the round-tripped text gives the same records again.
    back = str(tmp_path / "back.tfrecords")
    libsvm.convert_libsvm_file(str(tmp_path / "port.txt"), back)
    assert tfrecord.read_all_records(back) == tfrecord.read_all_records(rec)


def test_converter_runs_as_a_module(tmp_path):
    src = str(tmp_path / "in.libsvm")
    _libsvm_text(src, 12, 4, seed=2)
    out = str(tmp_path / "tr.tfrecords")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "deepfm_tpu_torch.tools.libsvm_to_tfrecord",
         "--input", src, "--output", out, "--field-size", "4",
         "--num-shards", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"wrote 12 records to {out} (2 shard(s))"
    jax_libsvm.convert_libsvm_file(src, str(tmp_path / "j"), field_size=4,
                                   num_shards=2)
    for s in range(2):
        with open(f"{out}-{s:05d}-of-00002", "rb") as a, \
                open(str(tmp_path / "j") + f"-{s:05d}-of-00002", "rb") as b:
            assert a.read() == b.read()


def test_converter_main_in_process(tmp_path, capsys):
    src = str(tmp_path / "in.libsvm")
    _libsvm_text(src, 3, 4, seed=5)
    out = str(tmp_path / "x.tfrecords")
    assert libsvm_to_tfrecord.main(["--input", src, "--output", out]) == 0
    assert "wrote 3 records" in capsys.readouterr().out
    assert len(tfrecord.read_all_records(out)) == 3


# -- the feature codec and the mean metric ------------------------------------

@pytest.mark.parametrize("kind,value", [
    ("float", np.array([0.5, -1.25, 3e-8], np.float32)),
    ("int64", np.array([0, 1, 2**40, -7], np.int64)),
    ("bytes", [b"", b"abc", bytes(range(200))]),
])
def test_feature_codec_matches_jax(kind, value):
    buf = example_codec.encode_feature(value, kind)
    assert buf == jax_codec.encode_feature(value, kind)
    k, got = example_codec.decode_feature(buf)
    jk, want = jax_codec.decode_feature(buf)
    assert k == jk == kind
    if kind == "bytes":
        assert [bytes(x) for x in got] == [bytes(x) for x in want] == value
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, value)
    assert example_codec.decode_feature(b"") == jax_codec.decode_feature(b"")
    with pytest.raises(ValueError, match="unknown feature kind"):
        example_codec.encode_feature(value, "string")


def test_examples_keep_their_bytes_and_values():
    feats = {"label": (np.array([1.0], np.float32), "float"),
             "ids": (np.array([3, 9], np.int64), "int64")}
    buf = example_codec.encode_example(feats)
    assert buf == jax_codec.encode_example(feats)
    out = example_codec.decode_example(buf)
    np.testing.assert_array_equal(out["ids"], [3, 9])


def test_mean_update_matches_jax():
    import jax.numpy as jnp
    st, jst = metrics.mean_init(), jax_metrics.mean_init()
    for v, c in ((0.5, 1.0), (2.25, 3.0), (-1.0, 2.0)):
        st = metrics.mean_update(st, torch.tensor(v), c)
        jst = jax_metrics.mean_update(jst, jnp.asarray(v), c)
    assert float(metrics.mean_compute(st)) == pytest.approx(
        float(jax_metrics.mean_compute(jst)), abs=1e-7)
    assert float(st.count) == float(jst.count) == 6.0
