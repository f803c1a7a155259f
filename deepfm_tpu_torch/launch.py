"""CLI launcher: ``python -m deepfm_tpu_torch.launch --task_type train ...``

Takes the JAX launcher's flags (``deepfm_tpu.launch``; every ``Config``
field as ``--flag value``), runs the task on the card and prints the
result as one JSON line ``{"task": ..., **metrics}``. There is no device
flag: the CLI runs on the GPU and raises on a host without one. A caller
that wants the CPU calls ``main(argv, device="cpu")``.

Under ``--dist_mode 1|2`` (``deepfm_tpu_torch.fanout`` starts one child
per GPU) the process group is bootstrapped before the task, on the card
the local rank names (``parallel.bootstrap``): NCCL on the card, gloo on
the CPU, or the ``backend`` a Python caller names. Logging is then
rank-aware (``utils.logging``): the chief logs, every line carries its
rank. Every rank prints its own result line (``fanout`` prefixes each
with its worker). The mesh (``--mesh_data`` x ``--mesh_model``) must
cover ``--num_processes``, checked before the group starts.

A preempted train task (SIGTERM/SIGINT, after its forced checkpoint)
prints ``{"task": ..., "preempted": true, "step": N}`` and returns
``EXIT_PREEMPTED`` (42) once the abandoned fit's prefetch threads have
dropped out (a daemon thread still inside a torch call when the
interpreter finalizes can abort the process); the stall watchdog exits
the process with ``EXIT_WATCHDOG`` (43) itself (``utils.preempt``).
"""

from __future__ import annotations

import json
import logging
import sys

from .config import parse_args
from .data import pipeline as pipe_lib
from .parallel import bootstrap
from .train import tasks
from .utils import device as device_lib
from .utils import logging as ulog
from .utils import preempt as preempt_lib


def main(argv=None, *, device="cuda", backend=None) -> int:
    cfg = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr, datefmt="%H:%M:%S",
        format="%(asctime)s %(levelname)s deepfm_tpu_torch: %(message)s")
    log = logging.getLogger("deepfm_tpu_torch.launch")
    tasks.check_task_ported(cfg)
    bootstrap.initialize(cfg, device=device_lib.resolve(device),
                         backend=backend)
    ulog.install()
    log.info("config: %s", json.dumps(cfg.to_dict(), sort_keys=True))
    try:
        result = tasks.run(cfg, device=device)
    except preempt_lib.Preempted as p:
        # The checkpoint and the resume sidecar are already saved; the
        # exit code tells an orchestrator "restart me", not "crashed".
        log.warning("exiting after preemption: %s", p)
        if not pipe_lib.join_prefetch_threads(timeout=30.0):
            log.warning("a prefetch thread is still running at exit")
        print(json.dumps({"task": cfg.task_type, "preempted": True,
                          "step": p.step}))
        return preempt_lib.EXIT_PREEMPTED
    log.info("task %s finished: %s", cfg.task_type, result)
    print(json.dumps({"task": cfg.task_type, **result}))
    bootstrap.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
