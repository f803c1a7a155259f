"""Relaunch-on-preemption supervisor for ``deepfm_tpu_torch.launch`` runs
(the port's copy of the JAX repo's ``scripts/supervise.py``).

The orchestrator half of the preemption contract (see
``deepfm_tpu_torch/utils/preempt.py``): the training process exits with a
restartable code (42 = graceful preemption, 43 = stall-watchdog abort)
after force-saving its checkpoint and resume sidecar; this wrapper
relaunches it (checkpoint auto-resume makes the restart replay-exact) with
a restart cap and exponential backoff, so a crash-looping job cannot spin
forever. Ordinary failures (any other nonzero code) are not retried.

Usage:
    python -m deepfm_tpu_torch.drills.supervise [--max_restarts N] \\
        [--backoff_secs S] -- python -m deepfm_tpu_torch.launch ...

Everything after ``--`` is the command to supervise.

Also here, for the drills that supervise a trainer: :func:`launcher_cmd`,
the trainer's command line, and :func:`child_env`, its environment.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from ..utils import faults as faults_lib
from ..utils import preempt as preempt_lib

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The trainer's step triggers (``train.tasks``' ``PREEMPT_HOLD_ENV``,
#: ``PREEMPT_AFTER_ENV`` and ``FAULT_AFTER_ENV``), read faults and chaos
#: variables: :func:`child_env` drops them, so a drill passes its trainer
#: only its own.
CHILD_ENV_DROP = ("DEEPFM_TPU_TORCH_PREEMPT_HOLD_AFTER_STEPS",
                  "DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS",
                  "DEEPFM_TPU_TORCH_FAULT_AFTER_STEPS",
                  faults_lib.READ_FAULT_ENV, faults_lib.CHAOS_ENV,
                  faults_lib.CHAOS_STATE_ENV)


def launcher_cmd(flags, device) -> list:
    """The trainer's command line for ``flags`` (``{name: value}``): the
    launcher on the card, or (``device`` on the CPU) ``launch.main`` with
    ``device="cpu"``."""
    if str(device).startswith("cuda"):
        argv = [sys.executable, "-m", "deepfm_tpu_torch.launch"]
    else:
        argv = [sys.executable, "-c",
                "import sys; from deepfm_tpu_torch import launch; "
                "sys.exit(launch.main(sys.argv[1:], device='cpu'))"]
    for name, value in flags.items():
        argv += [f"--{name}", str(int(value) if isinstance(value, bool)
                                  else value)]
    return argv


def child_env(**extra) -> dict:
    """This process's environment with the repo on ``PYTHONPATH``, without
    :data:`CHILD_ENV_DROP`, plus ``extra``."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in CHILD_ENV_DROP:
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_supervised(cmd, *, max_restarts=5, backoff_secs=1.0,
                   healthy_secs=0.0, max_total_restarts=0, sleep=time.sleep,
                   spawn=None, log=print, clock=time.monotonic):
    """Run ``cmd`` until it exits cleanly, restarting on preemption codes.

    Returns the final exit code: 0 on success, the child's code on a
    non-restartable failure, or the last restartable code when the restart
    budget is exhausted. With ``healthy_secs > 0``, a child that ran at
    least that long before a restartable exit resets the restart counter
    and backoff. ``max_total_restarts > 0`` is a lifetime cap on restarts
    that ``healthy_secs`` never resets (0 = unlimited). ``sleep``/
    ``spawn``/``clock`` are injectable for tests (``spawn(cmd) -> int``
    defaults to ``subprocess.call``).
    """
    spawn = spawn if spawn is not None else (lambda c: subprocess.call(c))
    restarts = 0
    total_restarts = 0
    # Exit-code histogram over every nonzero child exit, so a drill can
    # assert why relaunches happened, not just how many.
    exits = {preempt_lib.EXIT_PREEMPTED: 0, preempt_lib.EXIT_WATCHDOG: 0,
             "other": 0}

    def summarize():
        log(f"[supervise] exit histogram: "
            f"preempted(42)={exits[preempt_lib.EXIT_PREEMPTED]} "
            f"watchdog(43)={exits[preempt_lib.EXIT_WATCHDOG]} "
            f"other={exits['other']}; total restarts {total_restarts}")
    while True:
        started = clock()
        rc = spawn(cmd)
        ran_secs = clock() - started
        if rc != 0:
            exits[rc if rc in exits else "other"] += 1
        if rc == 0:
            if total_restarts:
                log(f"[supervise] run completed after {total_restarts} "
                    f"restart(s)")
            summarize()
            return 0
        if rc not in preempt_lib.RESTARTABLE_EXIT_CODES:
            log(f"[supervise] child failed with non-restartable exit code "
                f"{rc}; giving up")
            summarize()
            return rc
        if healthy_secs > 0 and ran_secs >= healthy_secs and restarts:
            log(f"[supervise] child ran healthy for {ran_secs:.0f}s "
                f"(>= {healthy_secs:g}s); resetting restart counter")
            restarts = 0
        if restarts >= max_restarts:
            log(f"[supervise] restart budget exhausted "
                f"({restarts}/{max_restarts}); last exit code {rc}")
            summarize()
            return rc
        if max_total_restarts > 0 and total_restarts >= max_total_restarts:
            log(f"[supervise] total restart cap reached "
                f"({total_restarts}/{max_total_restarts}); last exit "
                f"code {rc}")
            summarize()
            return rc
        delay = backoff_secs * (2 ** restarts)
        restarts += 1
        total_restarts += 1
        log(f"[supervise] exit code {rc} "
            f"({'preempted' if rc == preempt_lib.EXIT_PREEMPTED else 'stalled'}"
            f"); restart {restarts}/{max_restarts} in {delay:g}s")
        if delay > 0:
            sleep(delay)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max_restarts", type=int, default=5,
                    help="restart budget for preemption exits (default 5)")
    ap.add_argument("--backoff_secs", type=float, default=1.0,
                    help="base backoff, doubled per restart (default 1.0)")
    ap.add_argument("--healthy_secs", type=float, default=0.0,
                    help="a child that ran at least this long before a "
                         "restartable exit resets the restart counter "
                         "(0 = lifetime budget; default 0)")
    ap.add_argument("--max_total_restarts", type=int, default=0,
                    help="lifetime restart cap that --healthy_secs never "
                         "resets (0 = unlimited; default 0)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to supervise (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command given (put it after --)")
    return run_supervised(cmd, max_restarts=args.max_restarts,
                          backoff_secs=args.backoff_secs,
                          healthy_secs=args.healthy_secs,
                          max_total_restarts=args.max_total_restarts)


if __name__ == "__main__":
    sys.exit(main())
