"""Preemption drill: SIGTERM a live run mid-epoch, resume, assert parity
(the port's copy of the JAX repo's ``scripts/preempt_drill.py``).

The acceptance check of the preemption-safe runtime (``utils/preempt.py``,
the train task's preemption hook and :mod:`.supervise`), per input path:

  1. **Baseline.** An uninterrupted run gives the final params.
  2. **Kill.** The same run as a real launcher subprocess under
     ``DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS=N``: after N steps it
     writes the ``.preempt_hold`` sentinel into ``model_dir`` and waits for
     a signal. The drill SIGTERMs it there, a real asynchronous preemption
     mid-epoch, and the process must force-save and exit 42.
  3. **Supervised resume.** :func:`~.supervise.run_supervised` restarts
     it, and the relaunches preempt themselves every few steps
     (``DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS``), so the supervisor's loop
     restarts real exit-42 children until the run completes.
  4. **Parity.** The final params are bit-identical to the baseline's.

Both paths of the JAX drill: the staged input, and ``--decoded_cache ram
--device_dataset 1`` (whose resumed mid-epoch segment stages by design:
the skip-offset replay owns the trained-prefix drop).

The model's width is a parameter (:data:`~.production.TINY_MODEL`, the JAX
drill's, or ``--width reference``). The trainer is ``python -m
deepfm_tpu_torch.launch`` on the card, ``launch.main(argv, device="cpu")``
on the CPU (``--device cpu``).

    python -m deepfm_tpu_torch.drills.preempt [--device cpu]
        [--width tiny|reference] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import tempfile
import time
from typing import Dict

from ..config import Config
from ..data import libsvm
from ..train import tasks
from ..utils import preempt as preempt_lib
from .fault import assert_tree_equal, final_params
from .production import TINY_MODEL
from .serving import reference_model
from .supervise import REPO_ROOT, child_env, launcher_cmd, run_supervised

NUM_FILES = 2
RECORDS_PER_FILE = 48
HOLD_AFTER_STEPS = 3      # SIGTERM point: mid-epoch (6 steps/epoch)
RESUME_PREEMPT_EVERY = 4  # supervised relaunches re-preempt this often
WAIT_S = 300.0            # for the sentinel, and for the exit after SIGTERM
PATHS = (("staged", {}),
         ("device", dict(decoded_cache="ram", device_dataset=True)))


def _flags(data_dir, model_dir, model=None, **kw):
    base = dict(
        task_type="train", data_dir=data_dir, model_dir=model_dir,
        **(TINY_MODEL if model is None else model),
        batch_size=16, num_epochs=2, mesh_data=1, log_steps=0,
        scale_lr_by_world=False, seed=17, verify_crc=True,
        save_checkpoints_steps=0)
    base.update(kw)
    return base


def hold_and_kill(cmd, model_dir: str, env: dict, say) -> int:
    """Start ``cmd``, wait for its ``.preempt_hold`` sentinel, SIGTERM it
    there; returns its exit code."""
    sentinel = os.path.join(model_dir, ".preempt_hold")
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, env=env)
    try:
        deadline = time.time() + WAIT_S
        while not os.path.exists(sentinel):
            if proc.poll() is not None:
                raise AssertionError(f"run exited (code {proc.returncode}) "
                                     f"before the hold point")
            if time.time() > deadline:
                raise AssertionError("timed out waiting for the hold "
                                     "sentinel")
            time.sleep(0.05)
        with open(sentinel, encoding="utf-8") as f:
            say(f"sentinel reads step {f.read()}; sending SIGTERM")
        proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=WAIT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def supervised_resume(cmd, env: dict, say) -> list:
    """Run ``cmd`` under the supervisor; returns its log lines. Raises
    unless it completed after at least one restart."""
    logs = []
    rc = run_supervised(
        cmd, max_restarts=10, backoff_secs=0.0,
        spawn=lambda c: subprocess.call(c, cwd=REPO_ROOT, env=env),
        log=lambda m: (logs.append(m), say(m)))
    assert rc == 0, f"supervised resume failed with exit code {rc}"
    assert any("restart 1/" in m for m in logs), (
        "supervisor never restarted; the re-preempt trigger did not fire")
    return logs


def drill_path(workdir, data_dir, *, label, extra_flags, model=None,
               device="cuda", verbose=True) -> Dict:
    """One path's four steps; returns its counts."""
    def say(msg):
        if verbose:
            print(f"[preempt_drill:{label}] {msg}", flush=True)

    # 1. The uninterrupted baseline.
    base = _flags(data_dir, os.path.join(workdir, f"ckpt_base_{label}"),
                  model, **extra_flags)
    tasks.run(Config(**base), device=device)
    params_base, step_base = final_params(Config(**base), device)
    say(f"baseline done: {step_base} steps")

    # 2. Kill a live subprocess at the sentinel: it must force-save and
    # exit 42.
    flags = _flags(data_dir, os.path.join(workdir, f"ckpt_pre_{label}"),
                   model, **extra_flags)
    cmd = launcher_cmd(flags, device)
    rc = hold_and_kill(
        cmd, flags["model_dir"],
        child_env(**{tasks.PREEMPT_HOLD_ENV: HOLD_AFTER_STEPS}), say)
    assert rc == preempt_lib.EXIT_PREEMPTED, (
        f"preempted run exited {rc}, expected {preempt_lib.EXIT_PREEMPTED}")
    say(f"SIGTERM at step >= {HOLD_AFTER_STEPS}: exit code {rc}, "
        f"checkpoint + sidecar saved")

    # 3. The supervised resume, re-preempted every few steps.
    logs = supervised_resume(
        cmd, child_env(**{tasks.PREEMPT_AFTER_ENV: RESUME_PREEMPT_EVERY}),
        say)
    restarts = sum("; restart " in m for m in logs)

    # 4. Bit-identity with the uninterrupted baseline.
    params_pre, step_pre = final_params(Config(**flags), device)
    assert step_pre == step_base, (
        f"step count diverged: {step_pre} vs {step_base}")
    assert_tree_equal(params_base, params_pre,
                      f"{label}: interrupted-vs-baseline final params")
    say(f"resume complete: params bit-identical to baseline "
        f"({len(logs)} supervisor event(s))")
    # The held run and each supervised launch are subprocesses.
    return {"steps": step_base, "subprocesses": 2 + restarts,
            "restarts": restarts, "exit_42": 1 + restarts}


def run_drill(workdir, *, model=None, device="cuda", verbose=True,
              paths=PATHS) -> Dict:
    """Both paths (``paths`` picks a subset); every assertion raises.
    Returns {path: counts} plus the seconds."""
    t0 = time.time()
    model = TINY_MODEL if model is None else model
    data_dir = os.path.join(workdir, "data")
    libsvm.generate_synthetic_ctr(
        data_dir, num_files=NUM_FILES, examples_per_file=RECORDS_PER_FILE,
        feature_size=model["feature_size"], field_size=model["field_size"],
        prefix="tr", seed=5)
    out = {label: drill_path(workdir, data_dir, label=label,
                             extra_flags=extra, model=model, device=device,
                             verbose=verbose)
           for label, extra in paths}
    out["seconds"] = round(time.time() - t0, 3)
    return out


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
        with tempfile.TemporaryDirectory(prefix="preempt_drill_") as d:
            summary = run_drill(d, **kw)
    print(f"[preempt_drill] PASS {summary}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
