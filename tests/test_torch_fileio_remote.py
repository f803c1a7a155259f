"""The port's remote-storage seam (``deepfm_tpu_torch.data.fileio``): the
counterpart of each test in ``tests/test_fileio_remote.py``, plus the
default fsspec backend, its absence, and byte equality with the JAX
package's writer.

A fake ``mock://`` scheme backed by a local directory stands in for GCS,
installed with ``fileio.set_remote_fs``: if any code path bypasses the
seam, either the raw URI leaks to POSIX (creating a literal ``mock:``
directory) or the fake store never sees the file; both are asserted.
"""

import glob as _glob
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from deepfm_tpu.data import fileio as jax_fileio
from deepfm_tpu.data import tfrecord as jax_tfrecord
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import fileio, libsvm, tfrecord
from deepfm_tpu_torch.models import get_model
from deepfm_tpu_torch.train import Trainer, tasks
from deepfm_tpu_torch.train.publish import Publisher
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib
from deepfm_tpu_torch.utils import export as export_lib

torch.set_num_threads(1)


class FakeGfile:
    """``tf.io.gfile``'s duck type: any ``scheme://rest`` path maps into a
    local backing root. Records calls so tests can assert the seam was
    used."""

    def __init__(self, root: str):
        self.root = str(root)
        self.calls = []

    def _local(self, path: str) -> str:
        assert "://" in path, f"FakeGfile got a non-remote path: {path!r}"
        rest = path.split("://", 1)[1]
        return os.path.join(self.root, *rest.split("/"))

    def GFile(self, path, mode="r"):  # noqa: N802 (gfile's name)
        self.calls.append(("GFile", path, mode))
        local = self._local(path)
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(local), exist_ok=True)
        return open(local, mode)

    def glob(self, pattern):
        self.calls.append(("glob", pattern))
        scheme = pattern.split("://", 1)[0]
        return [f"{scheme}://"
                + os.path.relpath(p, self.root).replace(os.sep, "/")
                for p in _glob.glob(self._local(pattern))]

    def isdir(self, path):
        self.calls.append(("isdir", path))
        return os.path.isdir(self._local(path))

    def exists(self, path):
        self.calls.append(("exists", path))
        return os.path.exists(self._local(path))

    def stat(self, path):
        self.calls.append(("stat", path))

        class _S:
            length = os.path.getsize(self._local(path))
        return _S()

    def makedirs(self, path):
        self.calls.append(("makedirs", path))
        os.makedirs(self._local(path), exist_ok=True)

    def rmtree(self, path):
        self.calls.append(("rmtree", path))
        shutil.rmtree(self._local(path))

    def remove(self, path):
        self.calls.append(("remove", path))
        os.remove(self._local(path))

    def rename(self, src, dst, overwrite=False):
        self.calls.append(("rename", src, dst))
        s, d = self._local(src), self._local(dst)
        if os.path.exists(d) and overwrite:
            shutil.rmtree(d) if os.path.isdir(d) else os.remove(d)
        os.rename(s, d)


@pytest.fixture
def fake_store(tmp_path, monkeypatch):
    fake = FakeGfile(str(tmp_path / "store"))
    os.makedirs(fake.root, exist_ok=True)
    monkeypatch.setattr(fileio, "_remote_fs", None)
    prev = fileio.set_remote_fs(fake)
    assert prev is None
    yield fake
    fileio.set_remote_fs(None)
    # The raw URI leaking into POSIX would have created a literal 'mock:'
    # entry under the cwd or tmp_path; assert neither exists.
    assert not os.path.exists("mock:"), "raw remote URI hit POSIX open/mkdir"
    assert not (tmp_path / "mock:").exists()


class TestFileioHelpers:
    def test_normalize_dir_keeps_remote_uri(self):
        assert fileio.normalize_dir("mock://b/ckpt/") == "mock://b/ckpt"
        assert fileio.normalize_dir("gs://b/x") == "gs://b/x"
        assert os.path.isabs(fileio.normalize_dir("relative/dir"))
        for p in ("mock://b/ckpt/", "gs://b/x", "relative/dir"):
            assert fileio.normalize_dir(p) == jax_fileio.normalize_dir(p)

    def test_join(self):
        assert fileio.join("mock://b/data", "pred.txt") == \
            "mock://b/data/pred.txt"
        assert fileio.join("mock://b/", "sub", "5") == "mock://b/sub/5"
        assert fileio.join("/tmp/x", "y") == os.path.join("/tmp/x", "y")

    def test_open_stream_roundtrip(self, fake_store):
        with fileio.open_stream("mock://b/dir/f.txt", "w") as f:
            f.write("hello")
        assert fileio.exists("mock://b/dir/f.txt")
        with fileio.open_stream("mock://b/dir/f.txt", "r") as f:
            assert f.read() == "hello"
        assert ("GFile", "mock://b/dir/f.txt", "w") in fake_store.calls
        assert fileio.size("mock://b/dir/f.txt") == 5
        assert fileio.read_bytes("mock://b/dir/f.txt") == b"hello"

    def test_dir_ops(self, fake_store):
        fileio.makedirs("mock://b/d1/d2")
        assert fileio.isdir("mock://b/d1/d2")
        with fileio.open_stream("mock://b/d1/d2/a.tfrecords", "wb") as f:
            f.write(b"x")
        assert fileio.glob("mock://b/d1/d2/*.tfrecords") == [
            "mock://b/d1/d2/a.tfrecords"]
        fileio.rmtree("mock://b/d1")
        assert not fileio.exists("mock://b/d1")

    def test_write_atomic_append_replace_and_fsync(self, fake_store):
        fileio.write_atomic("mock://b/p/LATEST", "7")
        assert ("GFile", "mock://b/p/LATEST", "wb") in fake_store.calls
        fileio.append("mock://b/p/h.jsonl", "a\n")
        fileio.append("mock://b/p/h.jsonl", "b\n")
        assert fileio.read_bytes("mock://b/p/h.jsonl") == b"a\nb\n"
        fileio.fsync_dir("mock://b/p")  # a no-op on a remote store
        fileio.makedirs("mock://b/p/.staging")
        fileio.write_atomic("mock://b/p/.staging/x", b"1")
        fileio.replace("mock://b/p/.staging", "mock://b/p/5")
        assert ("rename", "mock://b/p/.staging", "mock://b/p/5") in \
            fake_store.calls
        assert fileio.read_bytes("mock://b/p/5/x") == b"1"
        fileio.remove("mock://b/p/5/x")
        assert not fileio.exists("mock://b/p/5/x")
        assert not [n for n in os.listdir(os.path.join(fake_store.root, "b",
                                                       "p")) if ".tmp" in n]


def _tiny_cfg(**kw):
    base = dict(
        feature_size=64, field_size=5, embedding_size=4, deep_layers="8",
        dropout="1.0", batch_size=32, compute_dtype="float32",
        mesh_data=1, log_steps=0, scale_lr_by_world=False, seed=11)
    base.update(kw)
    return Config(**base)


class TestCheckpointRemoteSeam:
    def test_manager_does_not_mangle_remote_dir(self, fake_store):
        mgr = ckpt_lib.CheckpointManager("mock://bucket/run1/ckpt/",
                                         max_to_keep=2)
        # The URI is kept verbatim, not /cwd/mock:/bucket/...
        assert mgr.directory == "mock://bucket/run1/ckpt"
        assert ("makedirs", "mock://bucket/run1/ckpt") in fake_store.calls
        trainer = Trainer(_tiny_cfg(), device="cpu")
        state = trainer.init_state()
        for step in (1, 2, 3):
            state.step = step
            assert mgr.save(step, state)
        assert mgr.all_steps() == [2, 3]  # pruned through the seam
        assert ("remove", "mock://bucket/run1/ckpt/ckpt-1.pt") in \
            fake_store.calls
        restored = mgr.restore(trainer.init_state(seed=5))
        mgr.close()
        assert restored.step == 3
        for k in state.params:
            assert torch.equal(restored.params[k], state.params[k]), k

    def test_clear_model_dir_remote(self, fake_store):
        fileio.makedirs("mock://bucket/old_ckpt")
        ckpt_lib.clear_model_dir("mock://bucket/old_ckpt")
        assert not fileio.exists("mock://bucket/old_ckpt")
        assert ("rmtree", "mock://bucket/old_ckpt") in fake_store.calls

    def test_forced_save_dedups_in_flight_async_step(self, tmp_path):
        """With async saves a forced save on the step of one still in
        flight is a no-op (this manager's own tracking)."""
        mgr = ckpt_lib.CheckpointManager(str(tmp_path / "c"),
                                         async_save=True)
        try:
            state = Trainer(_tiny_cfg(), device="cpu").init_state()
            assert mgr.save(7, state) is True
            assert mgr.save(7, state, force=True) is False
        finally:
            mgr.close()


class TestExportRemoteSeam:
    def test_export_serving_remote_dir(self, fake_store, tmp_path):
        cfg = _tiny_cfg()
        model = get_model(cfg, device="cpu")
        out = export_lib.export_serving(model, cfg,
                                        "mock://bucket/servable/5", step=5)
        assert out == "mock://bucket/servable/5"
        meta_local = os.path.join(
            fake_store.root, "bucket", "servable", "5", "model_config.json")
        with open(meta_local) as f:
            meta = json.load(f)
        assert meta["signature"]["inputs"]["feat_ids"] == ["batch", 5,
                                                           "int32"]
        local = export_lib.export_serving(model, cfg, str(tmp_path / "5"),
                                          step=5)
        for name in ("params.pt", "model_config.json",
                     export_lib.COMPLETE_MARKER):
            with open(os.path.join(local, name), "rb") as f:
                assert fileio.read_bytes(f"{out}/{name}") == f.read(), name
        ids = np.arange(20, dtype=np.int64).reshape(4, 5) % 64
        vals = np.linspace(-1, 1, 20, dtype=np.float32).reshape(4, 5)
        remote = export_lib.load_serving(out, device="cpu")(ids, vals)
        np.testing.assert_array_equal(
            remote, export_lib.load_serving(local, device="cpu")(ids, vals))

    def test_publisher_to_a_remote_dir(self, fake_store):
        """The publisher stages, renames and moves LATEST on the store, as
        the JAX Publisher does, with no special case."""
        cfg = _tiny_cfg()
        state = Trainer(cfg, device="cpu").init_state()
        pdir = "mock://bucket/publish"
        pub = Publisher(cfg, pdir)
        pub.publish_now(state, 4)
        pub.close()
        assert export_lib.read_latest(pdir) == f"{pdir}/4"
        assert [e["version"] for e in export_lib.pointer_history(pdir)] \
            == ["4"]
        assert any(c[0] == "rename" and c[2] == f"{pdir}/4"
                   for c in fake_store.calls)
        assert not [n for n in os.listdir(os.path.join(
            fake_store.root, "bucket", "publish")) if n.startswith(".")]
        assert export_lib.load_serving(f"{pdir}/4", device="cpu")(
            np.zeros((2, 5), np.int64),
            np.ones((2, 5), np.float32)).shape == (2,)


class TestWriterRemoteSeam:
    def test_tfrecord_writer_remote(self, fake_store):
        """Converter output can target the object store directly."""
        with tfrecord.TFRecordWriter("mock://bucket/out/tr.tfrecords") as w:
            w.write(b"hello")
            w.write(b"world")
        recs = list(tfrecord.iter_records(
            "mock://bucket/out/tr.tfrecords", verify_crc=True))
        assert recs == [b"hello", b"world"]
        assert tfrecord.read_all_records("mock://bucket/out/tr.tfrecords") \
            == recs

    def test_both_packages_write_the_same_bytes(self, fake_store,
                                                monkeypatch):
        monkeypatch.setattr(jax_fileio, "_gfile_mod", fake_store)
        recs = [bytes([i]) * (i * 7 + 1) for i in range(20)]
        for mod, name in ((tfrecord, "port"), (jax_tfrecord, "jax")):
            with mod.TFRecordWriter(f"mock://bucket/{name}.tfrecords") as w:
                for r in recs:
                    w.write(r)
        assert fileio.read_bytes("mock://bucket/port.tfrecords") == \
            fileio.read_bytes("mock://bucket/jax.tfrecords")


class TestInferRemoteSeam:
    def test_infer_reads_and_writes_remote(self, fake_store, tmp_path):
        """te*.tfrecords live in the (fake) object store, the checkpoint is
        local, pred.txt lands back in the store."""
        data_remote_local = os.path.join(fake_store.root, "bucket", "data")
        libsvm.generate_synthetic_ctr(
            data_remote_local, num_files=1, examples_per_file=96,
            feature_size=64, field_size=5, prefix="te", seed=12)
        tr_dir = tmp_path / "tr"
        libsvm.generate_synthetic_ctr(
            str(tr_dir), num_files=1, examples_per_file=64,
            feature_size=64, field_size=5, prefix="tr", seed=13)
        ckpt_dir = str(tmp_path / "ckpt")
        tasks.run(_tiny_cfg(task_type="train", num_epochs=1,
                            data_dir=str(tr_dir), model_dir=ckpt_dir),
                  device="cpu")
        out = tasks.run(_tiny_cfg(
            task_type="infer", data_dir=str(tr_dir),
            val_data_dir="mock://bucket/data", model_dir=ckpt_dir),
            device="cpu")
        assert out["num_predictions"] == 96
        with open(os.path.join(data_remote_local, "pred.txt")) as f:
            probs = [float(x) for x in f.read().split()]
        assert len(probs) == 96 and all(0.0 <= p <= 1.0 for p in probs)
        assert ("GFile", "mock://bucket/data/pred.txt", "w") in \
            fake_store.calls

    def test_train_on_a_remote_model_dir(self, fake_store, tmp_path):
        """Data, checkpoints, the resume sidecar and the export all on the
        store: a second run resumes from the store's checkpoint."""
        data = os.path.join(fake_store.root, "bucket", "data")
        libsvm.generate_synthetic_ctr(data, num_files=1, examples_per_file=96,
                                      feature_size=64, field_size=5,
                                      prefix="tr", seed=12)
        cfg = _tiny_cfg(task_type="train", num_epochs=1,
                        data_dir="mock://bucket/data",
                        model_dir="mock://bucket/ckpt",
                        servable_model_dir="mock://bucket/servable")
        assert tasks.run(cfg, device="cpu")["steps"] == 3
        assert fileio.exists("mock://bucket/ckpt/resume_meta.json")
        assert fileio.exists(f"mock://bucket/servable/3/"
                             f"{export_lib.COMPLETE_MARKER}")
        # Resumed from the store's checkpoint: a finished run trains
        # num_epochs more epochs, as the JAX package's does.
        assert tasks.run(cfg.replace(num_epochs=2),
                         device="cpu")["steps"] == 3 + 2 * 3


class TestDefaultBackend:
    def test_fsspec_memory_scheme(self, monkeypatch, tmp_path):
        """No backend installed: the first remote op builds the fsspec one,
        and ``memory://`` (in-process, no network) carries a checkpoint,
        an artifact and a TFRecord round trip."""
        pytest.importorskip("fsspec")
        monkeypatch.setattr(fileio, "_remote_fs", None)
        root = f"memory://dfm-{os.getpid()}-{id(tmp_path)}"
        try:
            with tfrecord.TFRecordWriter(f"{root}/d/tr.tfrecords") as w:
                w.write(b"abc")
            assert isinstance(fileio._remote_fs, fileio.FsspecGfile)
            assert fileio.glob(f"{root}/d/*.tfrecords") == [
                f"{root}/d/tr.tfrecords"]
            assert fileio.size(f"{root}/d/tr.tfrecords") == 19
            assert tfrecord.read_all_records(f"{root}/d/tr.tfrecords") == \
                [b"abc"]
            cfg = _tiny_cfg()
            trainer = Trainer(cfg, device="cpu")
            state = trainer.init_state()
            state.step = 3
            mgr = ckpt_lib.CheckpointManager(f"{root}/ckpt")
            mgr.save(3, state, force=True)
            assert mgr.restore(trainer.init_state(seed=9)).step == 3
            mgr.close()
            pub = Publisher(cfg, f"{root}/publish")
            pub.publish_now(state, 2)
            pub.close()
            latest = export_lib.read_latest(f"{root}/publish")
            assert latest == f"{root}/publish/2"
            assert fileio.isdir(latest) and not fileio.exists(
                f"{root}/publish/.staging-2-{os.getpid()}")
            assert export_lib.load_serving(latest, device="cpu")(
                np.zeros((1, 5), np.int64),
                np.ones((1, 5), np.float32)).shape == (1,)
        finally:
            fileio.rmtree(root)

    def test_without_fsspec_a_remote_path_names_the_package(
            self, monkeypatch):
        monkeypatch.setattr(fileio, "_remote_fs", None)
        monkeypatch.setitem(sys.modules, "fsspec", None)
        with pytest.raises(RuntimeError,
                           match=r"s3:// scheme needs the fsspec package"):
            fileio.exists("s3://bucket/x")
        with pytest.raises(RuntimeError, match="fsspec"):
            ckpt_lib.CheckpointManager("gs://bucket/ckpt")
        assert fileio._remote_fs is None
        # Local paths never need it.
        assert fileio.exists(os.getcwd())
