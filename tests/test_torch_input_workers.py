"""The port's multi-process input service (``data.shm_ring``,
``data.workers`` and ``CtrPipeline(input_workers=...)``), on the CPU.

The slab ring's protocol runs in process with thread queues
(``THREAD_CTX``). The service spawns real worker processes (2 workers, a
few hundred records): its emission must equal the in-process pooled
path's and the JAX package's byte for byte and reproduce the JAX goldens
(tolerance: none), survive a worker's death under ``respawn`` replay-exact
within its budget, fold the workers' data health into the pipeline's, and
raise, naming ``--input_workers``, when it cannot start.
"""

import glob
import hashlib
import os
import struct

import numpy as np
import pytest
import torch

from deepfm_tpu.data import pipeline as jax_pipeline
from deepfm_tpu.data import shm_ring as jax_shm_ring
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.data import example_codec, libsvm, pipeline, shm_ring
from deepfm_tpu_torch.data import tfrecord, workers
from deepfm_tpu_torch.data.health import DataHealth
from deepfm_tpu_torch.train import tasks
from deepfm_tpu_torch.utils import retry as retry_lib

torch.set_num_threads(1)

pytestmark = pytest.mark.input_service

NO_SLEEP = retry_lib.RetryPolicy(base_delay=0.0, max_delay=0.0)
F = 6


# -- the slab ring -----------------------------------------------------------

def _ring(slab_records=8, field_size=3, capacity=2):
    spec = shm_ring.SlabSpec(slab_records, field_size)
    return shm_ring.ShmRing.create(spec, capacity, shm_ring.THREAD_CTX)


@pytest.mark.parametrize("s,f", [(10, 4), (1, 1), (4096, 39)])
def test_slab_layout_equals_jax(s, f):
    port, jax_side = shm_ring.SlabSpec(s, f), jax_shm_ring.SlabSpec(s, f)
    assert (port.labels_bytes, port.ids_bytes, port.slab_bytes) == \
        (jax_side.labels_bytes, jax_side.ids_bytes, jax_side.slab_bytes)


def test_ring_rejects_degenerate_geometry():
    with pytest.raises(ValueError):
        shm_ring.SlabSpec(0, 4)
    with pytest.raises(ValueError, match="capacity"):
        shm_ring.ShmRing.create(shm_ring.SlabSpec(8, 3), 1,
                                shm_ring.THREAD_CTX)
    ring = _ring()
    try:
        with pytest.raises(IndexError):
            ring.arrays(2, 1)
        with pytest.raises(ValueError):
            ring.arrays(0, 9)
    finally:
        ring.close()


def test_ring_backpressure():
    """The producer runs out of credits while the consumer holds every
    slot; one release returns exactly one credit."""
    ring = _ring(capacity=2)
    try:
        a, b = ring.acquire(timeout=0), ring.acquire(timeout=0)
        assert {a, b} == {0, 1}
        assert ring.acquire(timeout=0) is None
        ring.send(("chunk", 0, a))
        ring.send(("chunk", 1, b))
        msg = ring.pop(timeout=0)
        ring.release(msg[2])
        assert ring.acquire(timeout=0) == msg[2]
        assert ring.acquire(timeout=0) is None
    finally:
        ring.close()


def test_ring_wraparound_and_out_of_order_release():
    """Nine slabs through a capacity-3 ring, released in reverse pairs:
    slots recycle and every incarnation reads back intact."""
    ring = _ring(slab_records=4, field_size=2, capacity=3)
    try:
        produced, consumed, held = 0, [], []
        while len(consumed) < 9:
            slot = ring.acquire(timeout=0) if produced < 9 else None
            if slot is not None:
                lab, ids, vals = ring.arrays(slot, 3)
                lab[:], ids[:], vals[:] = produced, produced, produced * 0.5
                del lab, ids, vals
                ring.send((produced, slot))
                produced += 1
                continue
            tag, slot = ring.pop(timeout=0)
            lab, ids, vals = ring.arrays(slot, 3)
            assert (lab == tag).all() and (ids == tag).all()
            assert (vals == tag * 0.5).all()
            del lab, ids, vals
            consumed.append(tag)
            held.append(slot)
            if len(held) == 2 or len(consumed) == 9:
                for s in reversed(held):
                    ring.release(s)
                held = []
        assert consumed == list(range(9))
    finally:
        ring.close()


# -- the service -------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("svc")
    return sorted(libsvm.generate_synthetic_ctr(
        str(d), num_files=4, examples_per_file=60, feature_size=300,
        field_size=F, prefix="tr", seed=11))


def _emissions(mod, files, k=4, **kw):
    base = dict(field_size=F, batch_size=32, num_epochs=2, shuffle=True,
                shuffle_files=True, shuffle_buffer=150, drop_remainder=True,
                seed=7, prefetch_batches=0, use_native_decoder=True)
    base.update(kw)
    return [(m, n, {key: v.copy() for key, v in rows.items()})
            for rows, m, n in mod.CtrPipeline(files, **base)
            .iter_superbatches(k)]


def _same(a, b):
    assert len(a) == len(b) > 0
    for (m1, n1, r1), (m2, n2, r2) in zip(a, b):
        assert (m1, n1) == (m2, n2)
        for key in r1:
            np.testing.assert_array_equal(r1[key], r2[key], err_msg=key)


@pytest.mark.parametrize("shuffle", [True, False])
def test_service_emission_equals_in_process_and_jax(files, shuffle):
    """Slabs smaller than a chunk force multi-fragment reassembly; without
    shuffle the service is read in copy mode."""
    kw = dict(shuffle=shuffle, num_epochs=2 if shuffle else 1)
    service = _emissions(pipeline, files, input_workers=2,
                         input_worker_slab_records=25, **kw)
    _same(service, _emissions(pipeline, files, **kw))
    _same(service, _emissions(jax_pipeline, files, **kw))


GOLDEN = {  # tests/test_data.py's pooled-emission goldens
    (8, 64, 0, True): "26fff204f1d9b877c88d8696",
    (4, 32, 5, False): "5130307b96f68f89dadc8fa5",
}


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    libsvm.generate_synthetic_ctr(
        str(d), num_files=3, examples_per_file=500, feature_size=1000,
        field_size=7, prefix="tr", seed=5)
    return sorted(str(p) for p in d.glob("tr*.tfrecords"))


@pytest.mark.parametrize("key", sorted(GOLDEN), ids=str)
def test_service_reproduces_jax_golden(golden_files, key):
    k, bs, skip, drop = key
    pipe = pipeline.CtrPipeline(
        golden_files, field_size=7, batch_size=bs, num_epochs=2,
        shuffle=True, shuffle_files=True, shuffle_buffer=300,
        drop_remainder=drop, seed=9, skip_batches=skip, input_workers=2)
    h = hashlib.sha256()
    for rows, m, n_ex in pipe.iter_superbatches(k):
        h.update(str(m).encode())
        h.update(str(n_ex).encode())
        for col in ("feat_ids", "feat_vals", "label"):
            h.update(rows[col].tobytes())
    assert h.hexdigest()[:24] == GOLDEN[key]


def _reference_rows(paths):
    """Every record of ``paths`` in file order, through the codec."""
    labs, idss, valss = [], [], []
    for path in paths:
        for rec in tfrecord.iter_records(path):
            lab, ids, vals = example_codec.decode_ctr_example(rec, F)
            labs.append(lab)
            idss.append(ids)
            valss.append(vals)
    return (np.array(labs, np.float32), np.stack(idss).astype(np.int32),
            np.stack(valss).astype(np.float32))


def _service_rows(service):
    labs, idss, valss = [], [], []
    with service:
        for labels, ids, vals in service.chunks(copy=True):
            labs.append(labels)
            idss.append(ids)
            valss.append(vals)
    return np.concatenate(labs), np.concatenate(idss), np.concatenate(valss)


def test_worker_death_raises_by_default(files):
    svc = workers.ShmInputService(files, field_size=F, num_workers=1,
                                  fault_die_after=1, poll_secs=0.05)
    with pytest.raises(RuntimeError, match="input worker 0 died"):
        _service_rows(svc)


def test_respawn_replays_exactly(files):
    """The replacement worker restarts at the first sequence number of the
    chunk in flight: the stream is the crash-free one, nothing lost or
    repeated."""
    got = _service_rows(workers.ShmInputService(
        files, field_size=F, num_workers=2, slab_records=25,
        fault_die_after=3, on_worker_death="respawn", max_respawns=2,
        poll_secs=0.05))
    for g, w in zip(got, _reference_rows(files)):
        np.testing.assert_array_equal(g, w)


def test_respawn_in_the_pipeline_is_bit_identical(files):
    pipe_kw = dict(field_size=F, batch_size=32, num_epochs=1, shuffle=True,
                   shuffle_buffer=150, seed=7, prefetch_batches=0,
                   input_workers=2, input_worker_slab_records=25,
                   input_worker_death="respawn")
    pipe = pipeline.CtrPipeline(files, **pipe_kw)
    pipe.input_worker_fault_die_after = 2
    got = [(m, n, {k: v.copy() for k, v in r.items()})
           for r, m, n in pipe.iter_superbatches(4)]
    _same(got, _emissions(pipeline, files, num_epochs=1))


def test_respawn_budget_exhausted_raises(files):
    svc = workers.ShmInputService(files, field_size=F, num_workers=1,
                                  fault_die_after=1,
                                  on_worker_death="respawn", max_respawns=0,
                                  poll_secs=0.05)
    with pytest.raises(RuntimeError, match="respawns used 0/0"):
        _service_rows(svc)


def test_invalid_death_policy_rejected(files):
    with pytest.raises(ValueError, match="on_worker_death"):
        workers.ShmInputService(files, field_size=F, num_workers=1,
                                on_worker_death="retry")


def test_worker_bad_records_reach_pipeline_health(tmp_path):
    paths = sorted(libsvm.generate_synthetic_ctr(
        str(tmp_path), num_files=2, examples_per_file=60, feature_size=300,
        field_size=F, prefix="tr", seed=11))
    data = bytearray(open(paths[1], "rb").read())
    (length,) = struct.unpack_from("<Q", data, 0)
    data[12 + length] ^= 0xFF  # record 0's data CRC
    open(paths[1], "wb").write(bytes(data))
    pipe = pipeline.CtrPipeline(
        paths, field_size=F, batch_size=16, num_epochs=1, shuffle=True,
        shuffle_buffer=150, drop_remainder=False, seed=7, verify_crc=True,
        on_bad_record="skip", retry_policy=NO_SLEEP, prefetch_batches=0,
        input_workers=2)
    assert sum(n for _, _, n in pipe.iter_superbatches(2)) == 2 * 60 - 1
    snap = pipe.health.snapshot()
    assert snap["bad_records"] == 1
    assert snap["per_file"][paths[1]]["skipped"] == 1


def test_alive_but_silent_worker_raises_stall():
    class EmptyRing:
        def pop(self, timeout):
            raise workers._queue.Empty

    class AliveProc:
        def is_alive(self):
            return True

    svc = workers.ShmInputService.__new__(workers.ShmInputService)
    svc._rings, svc._procs = [EmptyRing()], [AliveProc()]
    svc._poll_secs, svc._stall_timeout_s = 0.05, 0.2
    svc.health = DataHealth()
    with pytest.raises(workers.InputStallError, match="stall_timeout_s"):
        svc._pop(0)


def test_service_that_cannot_start_raises_naming_the_flag(files,
                                                          monkeypatch):
    class Unstartable:
        def __init__(self, *a, **kw):
            raise OSError("shm forbidden")

    monkeypatch.setattr(workers, "ShmInputService", Unstartable)
    with pytest.raises(RuntimeError, match="--input_workers 2"):
        _emissions(pipeline, files, input_workers=2)


def test_flags_reach_the_pipeline(files, tmp_path):
    cfg = Config(data_dir=str(tmp_path), field_size=F, batch_size=16,
                 input_workers=3, dispatch_timeout_s=2.5)
    pipe = tasks.make_pipeline(cfg, files)
    assert pipe.input_workers == 3 and pipe.stall_timeout_s == 2.5


def test_train_task_with_workers_equals_in_process(files, tmp_path):
    kw = dict(task_type="train", data_dir=os.path.dirname(files[0]),
              feature_size=300, field_size=F, embedding_size=4,
              deep_layers="8", batch_size=32, steps_per_loop=2,
              shuffle_buffer=150, log_steps=0, num_epochs=1)
    runs = {}
    for n in (0, 2):
        model_dir = str(tmp_path / f"w{n}")
        res = tasks.run(Config(model_dir=model_dir, input_workers=n, **kw),
                        device="cpu")
        ckpt = glob.glob(os.path.join(model_dir, "ckpt-*.pt"))
        runs[n] = (res["steps"], torch.load(ckpt[0], weights_only=True))
    assert runs[0][0] == runs[2][0] == 240 // 32
    for key, v in runs[0][1]["params"].items():
        assert torch.equal(v, runs[2][1]["params"][key]), key


def test_spawned_workers_do_not_import_the_main_module():
    """While a worker starts, spawn is told nothing of the parent's main
    module (a trainer's main imports torch), and the main module is whole
    again afterwards."""
    import multiprocessing.spawn as mp_spawn
    import sys
    main = sys.modules["__main__"]
    before = (main.__spec__, getattr(main, "__file__", None))
    with workers._main_module_hidden():
        prep = mp_spawn.get_preparation_data("dfm-input-0")
    assert "init_main_from_name" not in prep
    assert "init_main_from_path" not in prep
    assert (main.__spec__, getattr(main, "__file__", None)) == before
