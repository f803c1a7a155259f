"""Rank-aware logging (port of ``deepfm_tpu.utils.logging``): the chief
logs by default, the other ranks only with ``DEEPFM_LOG_ALL_RANKS=1``, and
every line carries its rank.

The port's modules log through the standard ``logging`` tree under
``deepfm_tpu_torch``; :func:`install` puts :class:`RankFilter` on the
root handlers (the launcher calls it once the process group is up), so
the same records are filtered and prefixed wherever they come from.
Errors pass on every rank.
"""

from __future__ import annotations

import logging as _logging
import os

from ..parallel import bootstrap

ALL_RANKS_ENV = "DEEPFM_LOG_ALL_RANKS"


class RankFilter(_logging.Filter):
    """Drops a non-chief rank's records below ERROR (unless
    ``DEEPFM_LOG_ALL_RANKS=1``) and prefixes every message with its rank
    in a multi-process run."""

    def filter(self, record: _logging.LogRecord) -> bool:
        if bootstrap.process_count() <= 1:
            return True
        rank = bootstrap.process_index()
        if (rank != 0 and os.environ.get(ALL_RANKS_ENV, "0") != "1"
                and record.levelno < _logging.ERROR):
            return False
        if not getattr(record, "_rank_prefixed", False):
            record.msg = f"[rank {rank}] {record.msg}"
            record._rank_prefixed = True
        return True


def install() -> None:
    """Put a :class:`RankFilter` on every root handler (once)."""
    for h in _logging.getLogger().handlers:
        if not any(isinstance(f, RankFilter) for f in h.filters):
            h.addFilter(RankFilter())
