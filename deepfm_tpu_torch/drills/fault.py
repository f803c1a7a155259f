"""Fault drill: train under injected I/O faults, assert parity with a clean
run (the port's copy of the JAX repo's ``scripts/fault_drill.py``).

The acceptance check of the fault-tolerance layer:

  1. **Read faults + a bad record.** Dataset B is dataset A plus one extra
     record whose data CRC is then flipped. Training on B with
     ``on_bad_record=skip`` under injected transient read faults (every
     k-th read fails once, healed by ``ResilientStream``) must end with
     params bit-identical to a clean run on A, since the surviving record
     streams are equal; ``DataHealth`` must report exactly the injected
     retries and one skipped record per pass over B.
  2. **Raise policy.** The same corrupt input with ``on_bad_record=raise``
     fails with an error naming the file's path and the byte offset.
  3. **Checkpoint saves.** One injected save failure does not stop
     training: the final forced save lands, and the run resumes from it.
  4. **Every input path.** The faulty input through the RAM decoded cache
     and through the device-resident dataset ends bit-identical to the
     clean staged run too.

The model's width is a parameter: :data:`TINY_MODEL` is the JAX drill's
(the CPU tests run it); ``--width reference`` takes ``Config()``'s. It
runs on the card unless given ``--device cpu``.

    python -m deepfm_tpu_torch.drills.fault [--device cpu]
        [--width tiny|reference] [--workdir DIR] [--read_fail_every K]
"""

from __future__ import annotations

import argparse
import os
import struct
import tempfile
import time
from typing import Dict, Tuple

import numpy as np

from ..config import Config
from ..data import cache as cache_lib
from ..data import libsvm, tfrecord
from ..train import Trainer, tasks
from ..utils import checkpoint as ckpt_lib
from ..utils import faults
from .production import TINY_MODEL
from .serving import reference_model

NUM_FILES = 4
RECORDS_PER_FILE = 60
VICTIM_FILE_IDX = 1
VICTIM_RECORD_IDX = 30


def _cfg(data_dir, model_dir, model=None, **kw):
    base = dict(
        task_type="train", data_dir=data_dir, model_dir=model_dir,
        **(TINY_MODEL if model is None else model),
        batch_size=16, num_epochs=2, mesh_data=1, log_steps=0,
        scale_lr_by_world=False, seed=17, verify_crc=True,
        # Zero backoff keeps the drill fast; the jittered sleep is tested
        # with a fake clock.
        io_retry_backoff_secs=0.0)
    base.update(kw)
    return Config(**base)


def frame_offsets(path):
    """[(frame_start, payload_len), ...] of a clean TFRecord file."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        out.append((pos, length))
        pos += 12 + length + 4
    return out


def build_datasets(root, model=None):
    """Write the faulty dir B, then the clean dir A = B without the victim
    record, and flip the victim's data CRC in B. Returns (clean, faulty,
    victim_path, victim_offset)."""
    model = TINY_MODEL if model is None else model
    faulty = os.path.join(root, "data_faulty")
    clean = os.path.join(root, "data_clean")
    os.makedirs(clean, exist_ok=True)
    files = sorted(libsvm.generate_synthetic_ctr(
        faulty, num_files=NUM_FILES, examples_per_file=RECORDS_PER_FILE,
        feature_size=model["feature_size"], field_size=model["field_size"],
        prefix="tr", seed=5))
    victim_path = files[VICTIM_FILE_IDX]
    for path in files:
        records = tfrecord.read_all_records(path)
        out = os.path.join(clean, os.path.basename(path))
        with tfrecord.TFRecordWriter(out) as w:
            for i, rec in enumerate(records):
                if path == victim_path and i == VICTIM_RECORD_IDX:
                    continue
                w.write(rec)
    victim_offset, victim_len = frame_offsets(victim_path)[VICTIM_RECORD_IDX]
    with open(victim_path, "r+b") as f:
        f.seek(victim_offset + 12 + victim_len)  # first data-CRC byte
        crc0 = f.read(1)
        f.seek(victim_offset + 12 + victim_len)
        f.write(bytes([crc0[0] ^ 0xFF]))
    return clean, faulty, victim_path, victim_offset


def final_params(cfg: Config, device="cuda"
                 ) -> Tuple[Dict[str, np.ndarray], int]:
    """The newest checkpoint of ``cfg.model_dir``: ({name: params}, step)."""
    trainer = Trainer(cfg, device=device)
    mgr = ckpt_lib.CheckpointManager(cfg.model_dir)
    try:
        state = mgr.restore(trainer.init_state())
    finally:
        mgr.close()
    return ({k: v.detach().cpu().numpy() for k, v in state.params.items()},
            int(state.step))


def assert_tree_equal(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                      what: str) -> None:
    """Bit equality of two ``{name: array}`` dicts, key for key."""
    assert sorted(a) == sorted(b), (
        f"{what}: keys differ ({sorted(set(a) ^ set(b))})")
    for k in sorted(a):
        xa, xb = np.asarray(a[k]), np.asarray(b[k])
        if xa.shape != xb.shape or not np.array_equal(xa, xb):
            diff = (np.abs(xa.astype(np.float64) - xb.astype(np.float64))
                    .max() if xa.shape == xb.shape else "shape")
            raise AssertionError(f"{what}: parameter {k!r} differs "
                                 f"(max abs diff {diff})")


def run_drill(workdir, *, read_fail_every=7, model=None, device="cuda",
              verbose=True) -> Dict:
    """All four parts; every assertion raises. Returns a summary: steps,
    runs, faults injected and healed, records skipped, seconds."""
    def say(msg):
        if verbose:
            print(f"[fault_drill] {msg}", flush=True)

    t0 = time.time()
    clean_dir, faulty_dir, victim_path, victim_offset = build_datasets(
        workdir, model)
    say(f"datasets ready; victim {os.path.basename(victim_path)} "
        f"at byte {victim_offset}")

    def cfg(data_dir, name, **kw):
        return _cfg(data_dir, os.path.join(workdir, name), model, **kw)

    runs = []

    def run(c):
        runs.append(c.model_dir)
        return tasks.run(c, device=device)

    # 1a. The clean baseline on A.
    cfg_clean = cfg(clean_dir, "ckpt_clean")
    res_clean = run(cfg_clean)
    assert res_clean["bad_records"] == 0 and res_clean["read_retries"] == 0
    params_clean, step_clean = final_params(cfg_clean, device)
    say(f"clean run done: {step_clean} steps")

    # 1b. The faulty run on B: injected read faults, one record skipped.
    cfg_faulty = cfg(faulty_dir, "ckpt_faulty", on_bad_record="skip",
                     max_bad_records=1)
    with faults.FlakyFS(read_fail_every=read_fail_every) as fs:
        res_faulty = run(cfg_faulty)
    assert fs.injected_read_faults > 0, (
        f"read_fail_every={read_fail_every} injected nothing; the dataset "
        f"is too small for the cadence")
    assert res_faulty["read_retries"] == fs.injected_read_faults, (
        f"DataHealth retries {res_faulty['read_retries']} != injected "
        f"{fs.injected_read_faults}")
    # One skip per pass over the victim file: each epoch trains once and
    # runs the post-epoch eval once over the same (faulty) directory.
    n_epochs = cfg_faulty.num_epochs
    assert res_faulty["bad_records"] == 2 * n_epochs, (
        f"expected 1 skip per train + eval pass ({2 * n_epochs}), got "
        f"{res_faulty['bad_records']}")
    params_faulty, step_faulty = final_params(cfg_faulty, device)
    assert step_faulty == step_clean, (
        f"step count diverged: {step_faulty} vs {step_clean}")
    assert_tree_equal(params_clean, params_faulty,
                      "clean-vs-faulty final params")
    healed = {"staged": fs.injected_read_faults}
    say(f"faulty run done: params bit-identical to clean; "
        f"{fs.injected_read_faults} read faults healed, "
        f"{int(res_faulty['bad_records'])} records skipped")

    # 2. The same corrupt input under on_bad_record=raise.
    try:
        run(cfg(faulty_dir, "ckpt_raise"))
    except IOError as e:
        msg = str(e)
        assert victim_path in msg and f"at byte {victim_offset}" in msg, (
            f"error lacks path+offset: {msg}")
        say(f"raise policy: correct error ({msg.splitlines()[0][:100]})")
    else:
        raise AssertionError("raise policy did not raise on corrupt record")

    # 3. One failed interval save; training goes on, the final forced save
    # lands, and the run resumes from it.
    cfg_hard = cfg(clean_dir, "ckpt_hardened", save_checkpoints_steps=4,
                   steps_per_loop=4)
    with faults.FlakyFS(save_failures=1) as fs_save:
        res_hard = run(cfg_hard)
    assert fs_save.injected_save_faults == 1, "save fault was never injected"
    assert res_hard["steps"] == step_clean, "save failure aborted training"
    _, step_hard = final_params(cfg_hard, device)
    assert step_hard == step_clean, "final forced save missing"
    res_resume = run(cfg_hard.replace(num_epochs=3))
    assert res_resume["steps"] > res_hard["steps"], (
        "resume-from-latest did not continue training")
    say(f"checkpoint drill done: 1 save fault tolerated, resumed "
        f"{int(res_hard['steps'])} -> {int(res_resume['steps'])} steps")

    # 4. The faulty input through the RAM decoded cache and the device-
    # resident fit: the healed, skipped record stream feeds the cache build,
    # and the params still equal the clean staged run's.
    for label, extra in (("decoded_cache=ram", dict(decoded_cache="ram")),
                         ("device_dataset", dict(decoded_cache="ram",
                                                 device_dataset=True))):
        cfg_path = cfg(faulty_dir, f"ckpt_{label.split('=')[0]}",
                       on_bad_record="skip", max_bad_records=1, **extra)
        # The RAM cache is process-global: drop the last label's columns so
        # this run decodes through the faulty filesystem again.
        cache_lib.clear_ram_cache()
        with faults.FlakyFS(read_fail_every=read_fail_every) as fs_p:
            res_path = run(cfg_path)
        assert fs_p.injected_read_faults > 0, f"{label}: nothing injected"
        assert res_path["read_retries"] == fs_p.injected_read_faults, (
            f"{label}: retries {res_path['read_retries']} != injected "
            f"{fs_p.injected_read_faults}")
        params_path, step_path = final_params(cfg_path, device)
        assert step_path == step_clean, (
            f"{label}: step count diverged: {step_path} vs {step_clean}")
        assert_tree_equal(params_clean, params_path,
                          f"clean-vs-faulty final params ({label})")
        healed[label.split("=")[0]] = fs_p.injected_read_faults
        say(f"{label} run done: params bit-identical to clean "
            f"({fs_p.injected_read_faults} read faults healed, "
            f"{int(res_path['bad_records'])} records skipped)")
    cache_lib.clear_ram_cache()

    return {
        "steps": step_clean,
        "runs": len(runs),
        "read_faults_injected": int(res_faulty["read_retries"]),
        "read_faults_healed": healed,
        "save_faults_injected": fs_save.injected_save_faults,
        "bad_records": int(res_faulty["bad_records"]),
        "victim": [os.path.basename(victim_path), victim_offset],
        "seconds": round(time.time() - t0, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="",
                    help="scratch dir (default: a fresh TemporaryDirectory)")
    ap.add_argument("--read_fail_every", type=int, default=7,
                    help="every k-th stream read raises once (default 7)")
    ap.add_argument("--width", choices=("tiny", "reference"), default="tiny",
                    help="the JAX drill's model, or Config()'s reference "
                         "width")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(read_fail_every=args.read_fail_every,
              model=(reference_model() if args.width == "reference"
                     else TINY_MODEL),
              device=args.device)
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        summary = run_drill(args.workdir, **kw)
    else:
        with tempfile.TemporaryDirectory(prefix="fault_drill_") as d:
            summary = run_drill(d, **kw)
    print(f"[fault_drill] PASS {summary}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
