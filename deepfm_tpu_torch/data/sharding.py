"""Input-shard policy: the reference's 4-way decision matrix (the port's
copy of ``deepfm_tpu.data.sharding``, code for code).

Reference: Horovod flavor ``2-hvd-gpu/DeepFM-hvd-tfrecord-vectorized-map.py:92-120``
keyed on (``enable_data_multi_path`` x ``enable_s3_shard``), documented as a
decision table in ``README-EN.md:86-91``; PS flavor host-level shard at
``1-ps-cpu/...py:114-117``. ``rank``/``world_size`` come from
``torch.distributed`` (``parallel.bootstrap``) instead of ``hvd.rank()``/
``hvd.size()``.

Policy matrix (matching README-EN.md:86-91):

  multi_path  s3_shard   behavior
  ----------  --------   -----------------------------------------------------
  True        True       each worker reads its private channel dir AND storage
                         already sharded per host; no shard
  True        False      private channel dir per worker, but the same channel
                         name maps to the same storage on every host: shard
                         across hosts (num_hosts, host_index) — reference
                         2-hvd-gpu/...py:98-102
  False       True       storage already sharded files per host; shard the
                         host's files among its local workers by local_rank
  False       False      every worker sees all files; shard files by global
                         rank, falling back to record-level sharding when
                         there are fewer files than workers
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Result of the policy: which files to read and an optional record-level
    (modulus, index) shard to apply while reading."""

    files: Tuple[str, ...]
    record_shard: Optional[Tuple[int, int]] = None  # (num_shards, index)

    def shard_records(self, n_seen: int) -> bool:
        """True if record index ``n_seen`` belongs to this shard."""
        if self.record_shard is None:
            return True
        num, idx = self.record_shard
        return n_seen % num == idx


def shard_files(
    files: Sequence[str],
    *,
    enable_data_multi_path: bool = False,
    enable_s3_shard: bool = False,
    rank: int = 0,
    local_rank: int = 0,
    world_size: int = 1,
    workers_per_host: int = 1,
) -> ShardSpec:
    files = tuple(sorted(files))
    if world_size <= 1 and workers_per_host <= 1:
        return ShardSpec(files)
    if enable_data_multi_path:
        # Each worker gets its own channel (2-hvd-gpu/...py:376-380,403):
        # the caller passed this worker's private file list. With S3-sharded
        # storage that is already disjoint per host — no further shard. With
        # replicated storage, worker i on EVERY host reads channel i, so the
        # channel must still be split across hosts (reference :98-102).
        if enable_s3_shard:
            return ShardSpec(files)
        num_hosts = max(world_size // max(workers_per_host, 1), 1)
        if num_hosts <= 1:
            return ShardSpec(files)
        host_index = rank // max(workers_per_host, 1)
        if len(files) >= num_hosts:
            return ShardSpec(files[host_index::num_hosts])
        return ShardSpec(files, record_shard=(num_hosts, host_index))
    if enable_s3_shard:
        # Files were distributed per host by storage (ShardedByS3Key analog,
        # deepfm-sagemaker-ps-cpu.ipynb:135). Split the host's files among its
        # local workers (2-hvd-gpu/...py:101-106).
        if workers_per_host <= 1:
            return ShardSpec(files)
        if len(files) >= workers_per_host:
            return ShardSpec(files[local_rank::workers_per_host])
        return ShardSpec(files, record_shard=(workers_per_host, local_rank))
    # Unsharded storage: all workers see all files (2-hvd-gpu/...py:108-120).
    if len(files) >= world_size:
        return ShardSpec(files[rank::world_size])
    return ShardSpec(files, record_shard=(world_size, rank))


def validate_shard_coverage(specs: Sequence[ShardSpec], all_files: Sequence[str]) -> None:
    """Assert the per-worker specs jointly cover every file exactly once
    (file-level shards) — the property the README decision table guarantees."""
    seen: List[str] = []
    for s in specs:
        if s.record_shard is not None:
            return  # record-level sharding covers by construction
        seen.extend(s.files)
    if sorted(seen) != sorted(all_files):
        raise AssertionError(f"shard coverage mismatch: {sorted(seen)} vs {sorted(all_files)}")
