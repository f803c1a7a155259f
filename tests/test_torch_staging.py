"""The port's device staging ring (``--staging_buffers``,
``--transfer_ahead``; ``deepfm_tpu_torch.train.loop._StagingRing``) on the
CPU, mirroring the JAX package's ``TestDoubleBufferedStaging``.

On the CPU the ring keeps its slot discipline (transfer j waits until
dispatch j - n_slots has retired), its preallocated slots and its timing,
with no streams: the slot's buffer is the batch. The trajectory must be
bit-identical across slot counts and staging depths, untiered and through
the hot/cold tier.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deepfm_tpu.train.loop import _staged_records as jax_staged_records
from deepfm_tpu_torch.config import Config
from deepfm_tpu_torch.train import Trainer
from deepfm_tpu_torch.train.loop import (RingClosed, _staged_records,
                                         _StagingRing)

torch.set_num_threads(1)

V, F, K, B = 500, 6, 8, 32

LAYOUTS = {
    "dense": {},
    "hashed": {"embedding_update": "sparse", "embedding_buckets": "97,131,61"},
    "tiered": {"embedding_update": "sparse", "embedding_tiering": "hot_cold",
               "embedding_hot_rows": 256, "steps_per_loop": 1},
}


def _kw(**kw):
    base = dict(feature_size=V, field_size=F, embedding_size=K,
                deep_layers="16,8", dropout="0.5,0.5", batch_size=B,
                compute_dtype="float32", l2_reg=1e-3, learning_rate=5e-3,
                log_steps=0, seed=11, scale_lr_by_world=False, mesh_data=1,
                mesh_model=1, steps_per_loop=2)
    base.update(kw)
    return base


def _batches(n, seed=0, bs=B):
    rng = np.random.default_rng(seed)
    return [{"label": rng.integers(0, 2, (bs, 1)).astype(np.float32),
             "feat_ids": rng.integers(0, V, (bs, F)).astype(np.int32),
             "feat_vals": rng.standard_normal((bs, F)).astype(np.float32)}
            for _ in range(n)]


def _final(tr, st):
    if tr._tier is not None:
        st = tr._tier.checkpoint_state(st)
    return {k: v.detach().clone() for k, v in st.params.items()}


def _run(layout, buffers, depth, n=9):
    tr = Trainer(Config(**_kw(staging_buffers=buffers, transfer_ahead=depth,
                              **LAYOUTS[layout])), device="cpu")
    losses = []
    st, out = tr.fit(tr.init_state(), _batches(n), hooks=[
        lambda s, m: losses.append(m["loss"])])
    return _final(tr, st), torch.stack(losses), out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bit_identity_across_slot_counts_and_depths(layout):
    """staging_buffers 1 and 2, transfer_ahead 0 and 2: final tables and
    every dispatch's loss bit-identical (dropout on, so the generator's
    draws are compared too); 9 batches at steps_per_loop 2 leave a tail
    batch of its own."""
    runs = {(nb, d): _run(layout, nb, d) for nb in (1, 2) for d in (0, 2)}
    tables, losses, _ = runs[(2, 2)]
    for key, (t, l, out) in runs.items():
        assert torch.equal(l, losses), key
        for name in tables:
            assert torch.equal(t[name], tables[name]), (key, name)
        assert out["steps"] == 9
        assert 0.0 <= out["staging_overlap_fraction"] <= 1.0
        assert out["staging_transfer_s"] >= 0.0
        assert out["staging_wait_s"] >= 0.0


def test_ring_fences_and_instrumentation():
    ring = _StagingRing(2)
    for i in range(4):
        assert ring.put(lambda i=i: i) == i
        ring.retire()
    ring.close()
    assert 0.0 <= ring.overlap_fraction() <= 1.0
    assert ring.transfer_s >= 0.0 and ring.wait_s >= 0.0
    # An untouched ring reports full overlap (nothing ever fenced).
    assert _StagingRing(1).overlap_fraction() == 1.0


def test_staged_records_matches_jax():
    b = _batches(1, bs=16)[0]
    for args in ((b,), ([b, b],), (np.zeros(3), 2)):
        assert _staged_records(args) == jax_staged_records(args)
    assert _staged_records((b,)) == 16
    assert _staged_records(([b, b],)) == 32
    assert _staged_records((np.zeros(3), 2)) == 0


@pytest.mark.parametrize("n_slots", [1, 2])
def test_transfer_waits_for_the_dispatch_n_slots_earlier(n_slots):
    """Transfer j blocks until dispatch j - n_slots has retired, and not
    longer; the time blocked counts as wait_s."""
    ring = _StagingRing(n_slots)
    for i in range(n_slots):
        ring.put(lambda: None)
    done = threading.Event()

    def stage_next():
        ring.put(lambda: None)
        done.set()

    t = threading.Thread(target=stage_next)
    t.start()
    assert not done.wait(0.2), "transfer ran before its fence retired"
    ring.retire()
    assert done.wait(5.0)
    t.join()
    assert ring.wait_s >= 0.15
    assert 0.0 <= ring.overlap_fraction() < 1.0
    ring.close()


def test_close_unparks_a_waiting_transfer():
    ring = _StagingRing(1)
    ring.put(lambda: None)
    err = []

    def stage_next():
        try:
            ring.put(lambda: None)
        except RingClosed as e:
            err.append(e)

    t = threading.Thread(target=stage_next)
    t.start()
    time.sleep(0.05)
    ring.close()
    t.join(5.0)
    assert not t.is_alive() and len(err) == 1


def test_slots_are_preallocated_and_reused():
    """stage() fills slot j % n: the third group lands in the first group's
    buffers; a shorter tail group is a view of a slot; the batches read
    back the host values."""
    ring = _StagingRing(2)
    groups = [_batches(2, seed=s) for s in range(3)] + [_batches(1, seed=9)]
    ptrs = []
    for g in groups:
        dev, ready = ring.stage(g)
        assert ready is None  # no copy event on the CPU
        assert len(dev) == len(g)
        for d, h in zip(dev, g):
            for key in h:
                np.testing.assert_array_equal(d[key].numpy(), h[key])
        ptrs.append(dev[0]["feat_ids"].data_ptr())
        ring.retire()
    assert ptrs[0] == ptrs[2] and ptrs[1] == ptrs[3] and ptrs[0] != ptrs[1]
    ring.close()


def test_fit_reports_overlap_with_a_synthetic_transfer(monkeypatch):
    """A synthetic per-record transfer cost (the CPU has no transfer to
    overlap): transfer_s takes it, and at 2 slots, 2 groups ahead, the
    transfers run beside the dispatches."""
    monkeypatch.setenv(_StagingRing.SYNTH_TRANSFER_ENV, "100000")  # 3.2 ms
    _, _, out = _run("dense", 2, 2)
    assert out["staging_transfer_s"] >= 5 * 2 * B * 100000e-9
    assert 0.0 < out["staging_overlap_fraction"] <= 1.0


def _staging_threads():
    return {t for t in threading.enumerate()
            if t.name == "pipeline-prefetch" and t.is_alive()}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("buffers", [1, 2])
def test_abandoned_fit_leaves_no_staging_thread(buffers):
    """A hook that raises mid-fit: the ring closes, the staging thread
    (parked on a slot fence or not) ends, and the trainer holds no ring."""
    tr = Trainer(Config(**_kw(staging_buffers=buffers, transfer_ahead=2)),
                 device="cpu")
    before = _staging_threads()

    def stop(s, m):
        if s.step >= 4:
            raise _Stop

    with pytest.raises(_Stop):
        tr.fit(tr.init_state(), _batches(12), hooks=[stop])
    deadline = time.time() + 10
    while _staging_threads() - before and time.time() < deadline:
        time.sleep(0.01)
    assert not _staging_threads() - before
    assert tr._ring is None
