"""Local worker fan-out: spawn ``worker_per_host`` training processes on
this host, one per GPU (port of ``deepfm_tpu.fanout``; the analog of the
reference's ``mpirun -np 4``, ``2-hvd-gpu/deepfm-sagemaker-hvd-gpu.ipynb:
87-92``).

Usage (one command per host):

    python -m deepfm_tpu_torch.fanout --worker_per_host 4 \\
        [--num_hosts 2 --host_index 0 --coordinator_address host0:12355] \\
        --task_type train --data_dir ... <any launch flags>

Spawns ``worker_per_host`` copies of ``python -m deepfm_tpu_torch.launch``
with:
  * ``--process_id``    = host_index * worker_per_host + local worker;
  * ``--num_processes`` = num_hosts * worker_per_host;
  * ``--dist_mode 1``, rendezvous on the coordinator (a free local port by
    default for one host; ``file:///path`` names a file store);
  * ``CUDA_VISIBLE_DEVICES=<local worker>``: each child sees one card, its
    ``cuda:0`` (the reference's ``visible_device_list = local_rank``,
    ``2-hvd-gpu/...py:355-357``; the JAX package's
    ``TPU_VISIBLE_DEVICES``). NCCL needs one rank per card.

``--mesh_data D --mesh_model M`` (launch flags, passed through) must
cover the processes: D * M = ``num_hosts * worker_per_host`` (``D`` 0:
every process the model axis leaves), checked before any child starts
(``ValueError`` naming the flags). Model peers are adjacent ranks, so a
host holds whole mesh rows when M divides ``worker_per_host``.

Each child's output is prefixed ``[worker N]``. When one child fails the
others are terminated (they would wait in a collective for the dead rank)
and the parent exits with the first nonzero code.

``main(argv, child=[...])`` replaces the child command's prefix (the
tests run ``launch.main(argv, device="cpu")`` children this way); the CLI
has no device flag.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pump(stream, sink, prefix: str) -> None:
    for line in iter(stream.readline, ""):
        sink.write(f"[{prefix}] {line}")
        sink.flush()
    stream.close()


def main(argv: Optional[List[str]] = None, *,
         child: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        "deepfm_tpu_torch.fanout",
        description="spawn worker_per_host launch processes on this host")
    ap.add_argument("--worker_per_host", type=int, required=True)
    ap.add_argument("--num_hosts", type=int, default=1)
    ap.add_argument("--host_index", type=int, default=0)
    ap.add_argument("--coordinator_address", default="",
                    help="host:port (or file:///path) all workers "
                         "rendezvous on (default: localhost:<free port>; "
                         "required for num_hosts > 1)")
    args, passthrough = ap.parse_known_args(argv)

    n = args.worker_per_host
    if n < 1:
        raise SystemExit("--worker_per_host must be >= 1")
    if args.num_hosts > 1 and not args.coordinator_address:
        raise SystemExit(
            "--coordinator_address is required for num_hosts > 1 "
            "(every host must rendezvous on host 0's address)")
    coord = args.coordinator_address or f"localhost:{_free_port()}"
    world = args.num_hosts * n
    peek = argparse.ArgumentParser(add_help=False)
    peek.add_argument("--mesh_data", type=int, default=0)
    peek.add_argument("--mesh_model", type=int, default=1)
    mesh, _ = peek.parse_known_args(passthrough)
    from .parallel import mesh as mesh_lib  # noqa: PLC0415 (torch)
    mesh_lib.mesh_shape(mesh, world)
    prefix = (list(child) if child is not None
              else [sys.executable, "-m", "deepfm_tpu_torch.launch"])

    procs = []
    pumps = []
    for local in range(n):
        pid = args.host_index * n + local
        cmd = [*prefix, *passthrough,
               "--dist_mode", "1",
               "--num_processes", str(world),
               "--process_id", str(pid),
               "--coordinator_address", coord,
               "--worker_per_host", str(n)]
        env = dict(os.environ)
        env["CUDA_VISIBLE_DEVICES"] = str(local)
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        t = threading.Thread(target=_pump,
                             args=(p.stdout, sys.stdout, f"worker {pid}"),
                             daemon=True)
        t.start()
        pumps.append(t)

    # One failure terminates the siblings: they would otherwise wait in a
    # collective for the dead rank until their group's timeout.
    rc = 0
    remaining = set(range(len(procs)))
    while remaining:
        for i in sorted(remaining):
            r = procs[i].poll()
            if r is None:
                continue
            remaining.discard(i)
            if r != 0:
                gpid = args.host_index * n + i
                print(f"fanout: worker {gpid} exited rc={r}", file=sys.stderr)
                rc = rc or r
        if rc and remaining:
            print(f"fanout: terminating {len(remaining)} remaining "
                  "worker(s)", file=sys.stderr)
            for i in remaining:
                procs[i].terminate()
            for i in remaining:
                try:
                    procs[i].wait(timeout=15)
                except subprocess.TimeoutExpired:
                    procs[i].kill()
                    procs[i].wait()
            remaining.clear()
        if remaining:
            time.sleep(0.2)
    for t in pumps:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    sys.exit(main())
