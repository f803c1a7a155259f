"""Online-training drill: read faults and repeated SIGTERMs, then artifact
parity (the port's copy of the JAX repo's ``scripts/online_drill.py``).

The acceptance check of continuous online training with atomic hot
publishing (``data/stream.py``, ``train/publish.py`` and the online branch
of the train task):

  1. **A live online job under faults.** A real launcher subprocess in
     ``--online_mode`` over a directory holding the first half of the
     shards, with ``DEEPFM_TPU_READ_FAULT_EVERY`` injecting transient read
     faults (healed inside the stream). It is SIGTERMed at the hold
     sentinel mid-stream and must drain any publish in flight, force-save
     and exit 42.
  2. **Feed and supervised resume.** New shards land in the directory (an
     atomic rename, as a producer must write them). The supervised
     relaunches preempt themselves every few steps until the stream's idle
     timeout ends the run cleanly; the stream's sidecar admitted every
     shard in order.
  3. **Artifact audit.** Every published artifact loads through
     ``load_serving`` and serves finite answers, its marker's step equals
     its directory's version, versions rise in publish order, and
     ``LATEST`` names the newest.
  4. **Replay parity.** A clean, uninterrupted online run over the same
     shards publishes bit-identical params at every version the two runs
     share, and both share the final version and the final step: each
     record trained exactly once across every preemption.

The JAX drill reads an artifact's params through Orbax; here they are the
artifact's ``state_dict`` through ``export.load_model`` on the CPU. The
model's width is a parameter (``--width``); the trainer runs on the card
unless given ``--device cpu``.

    python -m deepfm_tpu_torch.drills.online [--device cpu]
        [--width tiny|reference] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict

import numpy as np

from ..config import Config
from ..data import libsvm
from ..train import tasks
from ..utils import export as export_lib
from ..utils import faults as faults_lib
from ..utils import preempt as preempt_lib
from .fault import assert_tree_equal, final_params
from .preempt import hold_and_kill, supervised_resume
from .production import TINY_MODEL
from .serving import reference_model
from .supervise import child_env, launcher_cmd

NUM_FILES = 4             # the first half pre-staged, the second fed live
RECORDS_PER_FILE = 48     # batch 16: 3 batches a file, 12 steps in all
INITIAL_FILES = 2
HOLD_AFTER_STEPS = 3      # SIGTERM point: mid-stream of the first shards
RESUME_PREEMPT_EVERY = 4  # supervised relaunches re-preempt this often
PUBLISH_EVERY_STEPS = 4   # boundary crossings at steps 4, 8, 12
READ_FAULT_EVERY = 7      # every 7th read fails once (healed in-stream)


def _flags(data_dir, model_dir, model=None, **kw):
    base = dict(
        task_type="train", data_dir=data_dir, model_dir=model_dir,
        **(TINY_MODEL if model is None else model),
        batch_size=16, num_epochs=1, mesh_data=1, log_steps=0,
        scale_lr_by_world=False, seed=17, verify_crc=True,
        save_checkpoints_steps=0, io_retry_backoff_secs=0.0,
        pipe_mode=1, online_mode=1, steps_per_loop=1,
        publish_every_steps=PUBLISH_EVERY_STEPS,
        stream_poll_secs=0.1, stream_idle_timeout_secs=2.0)
    base.update(kw)
    return base


def _feed(src_path, data_dir):
    """Deliver one shard as a producer must: the whole file under a hidden
    temporary name, then an atomic rename into the watched directory."""
    tmp = os.path.join(data_dir, "." + os.path.basename(src_path) + ".part")
    shutil.copyfile(src_path, tmp)
    os.replace(tmp, os.path.join(data_dir, os.path.basename(src_path)))


def artifact_params(artifact_dir) -> Dict[str, np.ndarray]:
    """An artifact's ``state_dict`` as numpy, loaded on the CPU."""
    model, _, _ = export_lib.load_model(artifact_dir, device="cpu")
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _audit_publish_dir(publish_dir, say, *,
                       field_size=TINY_MODEL["field_size"], device="cpu"):
    """Every artifact loads and serves finite answers, its marker's step is
    its version, versions rise in publish order, ``LATEST`` resolves to
    the newest. Returns {version_step: artifact_dir}."""
    versions = {}
    for name in os.listdir(publish_dir):
        path = os.path.join(publish_dir, name)
        if not os.path.isdir(path):
            continue
        assert not name.startswith("."), (
            f"staging dir {name} leaked into {publish_dir}")
        versions[int(name)] = path
    assert versions, f"no artifacts published under {publish_dir}"
    for step, path in sorted(versions.items()):
        # load_serving raises on any torn artifact.
        serve = export_lib.load_serving(path, device=device)
        probs = serve(np.zeros((2, field_size), np.int64),
                      np.ones((2, field_size), np.float32))
        assert probs.shape[0] == 2 and np.all(np.isfinite(probs)), (
            f"artifact {path} served non-finite output")
        with open(os.path.join(path, export_lib.COMPLETE_MARKER)) as f:
            assert json.load(f)["step"] == step, (
                f"artifact {path} marker step != dir version")
    by_mtime = sorted(versions.items(),
                      key=lambda kv: os.path.getmtime(kv[1]))
    published_order = [step for step, _ in by_mtime]
    assert published_order == sorted(published_order), (
        f"versions not monotonic in publish order: {published_order}")
    latest = export_lib.read_latest(publish_dir)
    assert latest is not None and int(os.path.basename(latest)) == max(
        versions), f"LATEST resolves to {latest}, newest is {max(versions)}"
    say(f"audited {len(versions)} artifact(s): all load, "
        f"monotonic, LATEST={max(versions)}")
    return versions


def run_drill(workdir, *, model=None, device="cuda", verbose=True) -> Dict:
    """All four parts; every assertion raises. Returns the counts and the
    seconds."""
    def say(msg):
        if verbose:
            print(f"[online_drill] {msg}", flush=True)

    t0 = time.time()
    model = TINY_MODEL if model is None else model
    # Every shard is written up front into a source dir; the live dir
    # starts with the first half and receives the rest mid-run.
    shards = sorted(libsvm.generate_synthetic_ctr(
        os.path.join(workdir, "src"), num_files=NUM_FILES,
        examples_per_file=RECORDS_PER_FILE,
        feature_size=model["feature_size"], field_size=model["field_size"],
        prefix="tr", seed=5))
    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir)
    for path in shards[:INITIAL_FILES]:
        _feed(path, data_dir)

    # 1. The live online job under read faults, SIGTERMed at the sentinel:
    # it drains its publish, force-saves and exits 42.
    model_dir = os.path.join(workdir, "ckpt_online")
    flags = _flags(data_dir, model_dir, model)
    cmd = launcher_cmd(flags, device)
    rc = hold_and_kill(
        cmd, model_dir,
        child_env(**{tasks.PREEMPT_HOLD_ENV: HOLD_AFTER_STEPS,
                     faults_lib.READ_FAULT_ENV: READ_FAULT_EVERY}), say)
    assert rc == preempt_lib.EXIT_PREEMPTED, (
        f"preempted online run exited {rc}, "
        f"expected {preempt_lib.EXIT_PREEMPTED}")
    say(f"SIGTERM at step >= {HOLD_AFTER_STEPS} under read faults: "
        f"exit {rc}, checkpoint + stream sidecar saved")

    # 2. The stream grows; the supervised resume re-preempts itself until
    # the idle timeout ends the run cleanly.
    for path in shards[INITIAL_FILES:]:
        _feed(path, data_dir)
    say(f"fed {NUM_FILES - INITIAL_FILES} new shard(s) into the live dir")
    logs = supervised_resume(
        cmd, child_env(**{tasks.PREEMPT_AFTER_ENV: RESUME_PREEMPT_EVERY}),
        say)
    restarts = sum("; restart " in m for m in logs)

    # The stream's sidecar admitted every shard, in sorted order (the
    # producer feeds names in sorted order).
    with open(os.path.join(model_dir, "stream_manifest.json")) as f:
        admitted = [os.path.basename(p)
                    for p, _ in json.load(f)["admitted"]]
    expect = [os.path.basename(p) for p in shards]
    assert admitted == expect, (
        f"sidecar admitted {admitted}, expected {expect}")

    # 3. The artifact audit of the interrupted and resumed run.
    audit = dict(field_size=model["field_size"], device=device)
    versions_live = _audit_publish_dir(os.path.join(model_dir, "publish"),
                                       say, **audit)

    # 4. A clean, uninterrupted replay over the same shards.
    clean_model_dir = os.path.join(workdir, "ckpt_clean")
    tasks.run(Config(**_flags(data_dir, clean_model_dir, model)),
              device=device)
    versions_clean = _audit_publish_dir(
        os.path.join(clean_model_dir, "publish"), say, **audit)

    _, step_live = final_params(Config(**flags), device)
    _, step_clean = final_params(
        Config(**_flags(data_dir, clean_model_dir, model)), device)
    assert step_live == step_clean, (
        f"final step diverged: interrupted {step_live} vs clean "
        f"{step_clean}: some record trained twice or never")
    final_version = max(versions_clean)
    assert final_version in versions_live, (
        f"final version {final_version} missing from the interrupted run "
        f"({sorted(versions_live)})")
    common = sorted(set(versions_live) & set(versions_clean))
    for step in common:
        assert_tree_equal(
            artifact_params(versions_live[step]),
            artifact_params(versions_clean[step]),
            f"published params @ step {step} (interrupted vs clean)")
    say(f"replay parity: {len(common)} common version(s) {common} "
        f"bit-identical; final step {step_live} matches")
    return {"steps": step_live, "subprocesses": 2 + restarts,
            "restarts": restarts, "exit_42": 1 + restarts,
            "shards_admitted": len(admitted),
            "versions_live": sorted(versions_live),
            "versions_clean": sorted(versions_clean),
            "versions_bit_equal": len(common),
            "seconds": round(time.time() - t0, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="",
                    help="scratch dir (default: a fresh TemporaryDirectory)")
    ap.add_argument("--width", choices=("tiny", "reference"), default="tiny",
                    help="the JAX drill's model, or Config()'s reference "
                         "width")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    kw = dict(model=(reference_model() if args.width == "reference"
                     else TINY_MODEL), device=args.device)
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        summary = run_drill(args.workdir, **kw)
    else:
        with tempfile.TemporaryDirectory(prefix="online_drill_") as d:
            summary = run_drill(d, **kw)
    print(f"[online_drill] PASS {summary}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
