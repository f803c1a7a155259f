"""The port's drills: whole-system checks run as programs.

  * :mod:`.supervise` — relaunch-on-preemption supervisor (exit 42 and 43
    restart, with a cap and backoff).
  * :mod:`.serving` — a replicated serving fleet hot-swapping behind a live
    publisher, optionally fed by spawned frontend clients.
  * :mod:`.production` — the production day: serve, log, join delayed
    labels, train online, publish, hot-swap, under a seeded chaos
    schedule; plus the overload, cache and experiment drills.
  * :mod:`.fault` — read faults, a corrupt record and a failed save, each
    ending bit-identical to a clean run.
  * :mod:`.preempt` — a launcher SIGTERMed mid-epoch, resumed under the
    supervisor, bit-identical to an uninterrupted run.
  * :mod:`.online` — the same for the online trainer under read faults,
    with every published artifact audited.

Run as ``python -m deepfm_tpu_torch.drills.<name>``. They run on the card
unless given ``--device cpu``.
"""
