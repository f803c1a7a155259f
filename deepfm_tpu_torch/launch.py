"""CLI launcher: ``python -m deepfm_tpu_torch.launch --task_type train ...``

Takes the JAX launcher's flags (``deepfm_tpu.launch``; every ``Config``
field as ``--flag value``), runs the task on the card and prints the
result as one JSON line ``{"task": ..., **metrics}``. There is no device
flag: the CLI runs on the GPU and raises on a host without one. A caller
that wants the CPU calls ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import json
import logging
import sys

from .config import parse_args
from .train import tasks


def main(argv=None, *, device="cuda") -> int:
    cfg = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr, datefmt="%H:%M:%S",
        format="%(asctime)s %(levelname)s deepfm_tpu_torch: %(message)s")
    log = logging.getLogger("deepfm_tpu_torch.launch")
    log.info("config: %s", json.dumps(cfg.to_dict(), sort_keys=True))
    result = tasks.run(cfg, device=device)
    log.info("task %s finished: %s", cfg.task_type, result)
    print(json.dumps({"task": cfg.task_type, **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
