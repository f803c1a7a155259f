#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepfm_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. The card's name and power limit (``nvidia-smi``); build every CUDA
   kernel of the port from ``deepfm_tpu_torch/csrc`` with nvcc, in parallel.
2. Kernel phase: the ``fused_fm`` forward kernel against ``reference_fm``
   (plain PyTorch) on the card, float32 and bfloat16 inputs, at the serving
   and training shapes and others that take its 16-byte vector path (K = 8,
   32, 64; F = 1) or its scalar path (K = 33, 48, and xv misaligned by one
   element); then the kernel's time at B = 1, 7, 256 and 1,024 beside its
   bound, the plain version's time and, in turns, the scalar path's (the
   previous design) at the same shape.
3. Backward kernel phase: the ``fused_fm`` backward kernel against
   ``reference_fm_bwd``, float32 and bfloat16, at the training shapes and a
   few others, with the gradients' dtypes, and ``torch.autograd.grad``
   through ``fused_fm`` against the same through ``reference_fm``; then its
   time beside its bound and the plain version's at the training shape.
4. Plan kernel phase: the plan build kernel (one cluster launch for up to
   8 tables) against its plain version ``make_plan_counting`` on the card
   and the numpy oracle, bit-equal uids, inv and touched (rank under
   touched), at one hashed table's training view (N = 1024*39 ids, 262,144
   rows, 3/4 of the positions at the fill id), the monolithic table, N = 1,
   all ids equal, all fill, N > rows, 2,000,000 rows, and N = 4096*39 (a
   batch of 4,096, more ids than one pass of a CTA holds) on a hashed
   and on the monolithic table, one table a launch; then four tables of
   262,144, 4,096, 1 and 2,000,000 rows in one launch, and the hashed
   step's four tables (the ids the timing uses). Then the times of one table's launch and of the hashed step's
   four-table launch beside their bounds, the plain version's and
   ``torch.unique``'s, and of a launch with almost no work (the design's
   fixed cost).
5. Take kernel phase: the fused gather forward, one table (bit-equal to
   ``rows[inv]``, and times its mask) and the hashed step's four masked
   tables summed (bit-equal to the plain composition), at D = 1 and 32;
   the segment-sum backward, one table a launch, bit-equal to the CPU
   position-order oracle and to its own second launch, and within a
   tolerance of the plain backward on the card, U = N = 39,936; the
   hashed step's four tables in one backward launch, bit-equal to the
   numpy ascending-p oracle, to its second launch and to one launch per
   table, and the gradients through ``TakeRowsSum`` (one launch each way)
   bit-equal to it; the four tables' position segments built per table
   by the plain versions (a sort each, one sort over a composite key) and
   by the segments kernel in one launch, bit-equal, with the device time
   and events of each.
   Then times beside the bounds, the plain versions and the library
   calls: ``index_select`` for one table, ``embedding_bag`` (sum, masks as
   per-sample weights, over the tables concatenated) for the four,
   ``index_add_`` for one table's backward and one ``index_add_`` over the
   four tables' outputs end to end for theirs.
   Before it, the segments kernel phase: ``dfm_segments`` (the counting
   sort that orders the take backward's positions, one launch for 1 to 8
   tables) bit-equal to its plain version on the card and to a numpy
   stable-argsort oracle on uniform, Zipf, all-one-slot, fill-slot,
   medium-run, N = 0 and 1, U >> N, U = 0 and 1, out-of-range and
   T = 1..8 inputs, with and without ``keep``; then its time and device
   events at the hashed step's, the dense lookups', the fused leg's and
   the dense hashed lookups' shapes beside its bound, the plain version's
   and ``torch.sort`` + ``searchsorted``'s.
6. Segment-sum phase: ``ek.segment_sum`` (one segments launch, then one
   take backward launch), which sums the dense lookups' and the monolithic
   fused leg's
   gradients in position order, at their shapes: bit-equal to the numpy
   ascending-p oracle and to its second call; its time beside the
   ``index_add_`` it replaces.
7. Install kernel phase: the hot/cold cache install (``dfm_install``) in
   place into the tier's two hot tables of 81,920 rows, fm_w (D = 1) and
   fm_v (D = 32), in one launch over one transaction of 10,000 installs
   padded to 16,384 slots (real slots drawn without replacement),
   bit-equal to ``reference_install`` per table on the card and to a
   numpy oracle, untouched rows and out-of-range slots left alone; then
   I = 1, every slot out of range and I = H; then times of the two-table
   launch (and of each table alone) beside the bound, the plain version's
   and the ``index_copy_`` calls' on the real slots.
   Then the accumulation kernel phase: the same kernels at the shapes of
   an accumulation group (a = 4 microbatches of 1,024: 159,744 positions
   per table): the merged plan over the hashed step's four tables in one
   launch (the plan kernel's multi-pass branch), the segments of its inv
   and of the fused leg's group, the fused take forward and backward over
   the group at D = 1 and 32 and ``ek.segment_sum`` at the fused leg's
   group shape, each bit-equal to its plain version and the numpy oracle,
   then timed beside its bound, its plain version and its library call.
   Then the history lookup's kernels at DIN's and BST's shape (B = 1,024 x
   L = 20 = 20,480 positions of fm_v, padded positions at id 0): its
   segments build and ``ek.segment_sum`` at D = 32, bit-equal to the
   numpy oracle, timed beside their bound and library calls. Then the
   take backward's long-run path at the benchmark cell's shape (B =
   131,072 x 39 positions over the padded vocabulary, 13 runs of 131,072)
   at D = 32 and 1: bit-equal to the numpy oracle and its second launch,
   the launch's long runs and positions, its time by kernel beside the
   recorded figures before the path; and at the hashed step's four tables
   (no long run) the long kernel's own time, the cost of finding none.
   ``python3 chip_smoke.py --phase take_bwd`` runs every take-backward
   check of these phases alone (no result lines).
8. Determinism: the dense, sparse monolithic and dense hashed layouts
   and DIN over ragged histories trained twice for 20 steps from the same
   seed on the same batches; losses and every embedding table must be
   bit-identical between the two runs (the embedding gradients sum in
   position order, not by float atomics; DIN's fm_v gradient adds the
   feature and the history lookups' segment sums), and so must the dense
   and dense hashed layouts under ``--embedding_kernels xla``. The sparse
   monolithic layout under ``xla`` and ``off`` is run the same way and
   its diffs printed, not asserted: under ``xla`` its fused leg sums
   through ``index_add_``, the library yardstick, whose float atomics may
   add in another order from run to run; under ``off`` through autograd's
   ``index_put_``.
9. Train parity: DeepFM at the reference width, one seeded init, 20 steps
   on the same batches (dropout keep 1.0) with the kernels
   (``use_pallas=True``) and with the plain path; the losses must agree.
   Then the same for the sparse update with hashed tables: kernels
   (``embedding_kernels=auto``) against the plain legs (``xla``, no fused
   FM). Then the hot/cold tier through ``fit`` (81,920 hot rows,
   ``transfer_ahead=2``): tiered against the untiered sparse monolithic
   run, and against the tier with the plain install leg (``xla``); losses
   and densified tables must agree. Then gradient accumulation (a = 4) on
   the dense, sparse monolithic and hashed layouts: a = 4 x B = 256
   against one B = 1,024 step, kernels against the plain legs with the
   launches of each apply, two same-seed runs bit-identical, and the peak
   memory of an apply, a B = 1,024 step and a B = 4,096 step. Then the
   device staging ring through ``fit`` (dense and tiered; ``staging_buffers``
   1 and 2, ``transfer_ahead`` 0 and 2: bit-identical tables, overlap and
   host ms per dispatch); ``--on_nonfinite skip`` (a NaN batch skipped,
   bit-identical to a clean run without it, and the state snapshot's
   device time); the stall watchdog (an input that stalls, an injected
   abort, one dump).
10. Input path and train phases: synthetic TFRecords at the reference
   width written once with the port's ``generate_synthetic_ctr``. The
   native TFRecord decoder (g++, built beside the kernels) decodes every
   train file bit-equal to the Python codec; the host's decode rates
   (records/s beside the card line and the usable core count): the
   per-record pipeline, the codec alone, eager ``decode_spans``, the pooled
   ``iter_superbatches(8)`` at 1 and 4 reader threads, and the pooled
   path's ns/record per stage (``HostStageStats``); the pooled emission
   reproduces the JAX package's three goldens on both assembly routes.
   Then ``tasks.run`` train
   (the ``Config()`` defaults: dropout keep 0.5, Adam, batch 1024; two
   epochs, an eval after each), eval and export, all on the card, four
   times: the dense update, the sparse update on the monolithic table, the
   sparse update on 4 hashed tables of 262,144 rows, and the sparse update
   through the hot/cold tier (81,920 hot rows, float32 cold store,
   ``steps_per_loop=1``, ``transfer_ahead=2``); eval and infer go through
   the CLI entry point (``deepfm_tpu_torch.launch``). The logged loss must
   fall, eval AUC exceed 0.5, the FM backward kernel launch once per train
   step and the forward once per train step and eval batch, the plan
   kernel once and the take forward twice (fm_w, fm_v) per hashed step and
   never on the other layouts, the take backward twice per step on the
   dense and hashed layouts (once per name) and once per step on the
   monolithic and tiered ones (the fused leg, all names at once), the
   segments kernel once per step on every layout (the dense lookups of
   both names share one build), the
   install kernel once per tiered plan and never elsewhere; each trained
   artifact then serves. Every train task reads through the pooled native
   path (``Config()``'s default) and prints its examples/s and step p50
   beside the per-record path's recorded figures; one dense run of one
   epoch with ``--use_native_decoder false`` gives the per-record path in
   the same
   process. Then ``--grad_accum_steps 4 --steps_per_loop 8``
   on the dense, sparse monolithic and hashed layouts, one epoch each:
   the embedding kernels launch per apply as predicted, and the final
   checkpoint's step counts microbatches and its optimizer count applies.
   Then the decoded cache: ``ram`` and ``disk`` emit two epochs equal to
   the streamed emission, decode once (the second epoch is a hit) with
   each epoch's host ms, and each trains the dense task with one decode
   pass per file set. Then the device-resident dataset: ``--decoded_cache
   ram --device_dataset --shuffle_buffer 65537`` through the launcher on
   the dense, sparse monolithic and sparse hashed layouts, against the
   staged run with the same flags less ``--device_dataset``: no fallback
   warning, bit-identical tables and generator, equal launch counts,
   examples/s and step p50 of both, the columns' bytes against the
   budget; then one k-step dispatch of each feed, one after the other
   (time, device busy time, idle share, host-to-device copies and data
   bytes per dispatch). Then bad records: a copy of one train file with one flipped
   data-CRC byte trains under ``--verify_crc --on_bad_record skip`` with
   exactly one record dropped and counted, and under ``raise`` fails
   naming the path and the byte offset; a read fault every 3rd read
   (``DEEPFM_TPU_READ_FAULT_EVERY``) heals to the clean emission and the
   clean task's tables.
   Then the online trainer and its neighbours (exact launch counts on
   each): a dense ``--pipe_mode 1`` task, two epochs in one stream, its
   rate beside the file-mode task's; the dense task with
   ``--input_workers 2`` against in-process decode, and once more with
   every worker crashing after two slabs under ``respawn``, all three with
   bit-identical tables; the online trainer (``--online_mode
   --publish_every_steps 8``) on the train files cut into 16 shards of
   4,096 records that arrive during the run (temp name, then rename),
   while ``ServingEngine.serve_latest`` serves its versions on the same
   card to 6 client threads: exactly 64 steps, no staging dir left,
   ``LATEST`` on the newest version, every version loads, at least two
   hot swaps, the final answer bit-equal to the final artifact's at one
   bucket, publish latency and staleness, and the serving tail during
   training beside the same server's with no training; an online run
   preempted in process (``DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS``) with
   half its shards still to come, resumed after they arrive to tables
   bit-identical to a clean online run, and an online run on the hashed
   layout; a task with ``--profile_dir`` whose ``torch.profiler`` trace
   holds the port's kernels (and whether ``--tensorboard_dir`` wrote).
   Then, on 8 Ki records, ``--on_nonfinite rollback`` replays a NaN batch
   from the last checkpoint to tables bit-identical to an uninterrupted
   run, and the CLI in a child process with the preempt-after hook exits
   42 and, run again, resumes to the same tables. Then the step time at
   B=1024 of the dense kernel
   and plain paths, of the three untiered layouts (one step, with its
   device busy time and idle share; no sort kernel may run in their
   steps), and of the tier (per dispatch through ``fit``: plan, apply and
   step), and one a = 4 apply against one step per layout.
11. Zoo phase: Wide&Deep, DCN-v2 (3 full-rank cross layers, D = 1,248),
   DLRM (a 1,989-wide top input), ``--tasks ctr,cvr`` under
   ``shared_bottom``, ``mmoe`` (4 experts) and ``esmm`` on records that
   carry ``label2``, and DIN and BST at ``--history_max_len 20`` on
   records with ragged histories of 0-30 ids (some empty, some longer
   than 20), at the reference width: each through the launcher (train
   one epoch of 32 steps with its eval, eval, infer, export) with exact
   launch counts per kernel, its artifact (named outputs, F + L wide
   inputs) served through ``serve_latest`` to several clients and held
   against its plain forward; the non-history models once more on the
   sparse hashed layout and MMoE on the tier; each model's 16-step
   trajectory and final tables on the card held against the same run on
   the CPU (float32 tower, dropout off); then one timing line per model
   (B = 1,024 train step ms and device busy ms, B = 256 forward ms,
   beside the card's name and power limit).
12. Retrieval phase, on the zoo's DIN records and DIN artifact: the
   twin tower trained by ``train_twin_tower`` (two epochs at B = 1,024,
   D = 32, MLPs 32-64-32, Adam) with exact launch counts (a segments
   launch and a take backward per lookup, two lookups a step), one step's
   call and device time and idle share, and the take backward at the
   history shape (B x L = 20,480 positions, D = 32, U = 117,632) bit-equal
   to the numpy oracle beside its bound and ``index_add_``; the item matrix
   over all 117,581 items, the brute index on the card and the int8 ANN at
   its default P = 342, nprobe = 85 and at P = 32, nprobe = 16, with
   recall@50 against brute force (brute must read 1.0) and search times;
   ``export_cascade`` of the DIN ranker, the towers and the brute index
   behind ``LATEST``, served by a staged and a fused ``CascadeEngine``
   (retrieve 50, rank to 10): fused equals staged bit for bit over 32
   single users (empty histories included), the FM kernel launches once per
   request on each path, sequential p50/p99/QPS of both and
   ``recommend_batch`` at 64 users; a float32 copy of the ranker served on
   the card and on the CPU (the same 50 items, probabilities within 1e-5);
   a v2 published by ``Publisher(extra_export=cascade_extra_export(...))``
   hot-swapped into both engines (answers equal a fresh v2 engine's) and a
   torn v3 whose swap is deferred.
13. Data-parallel phase (``torch.distributed``; DeepFM at the reference
   width, dropout off, one epoch of the train phases' records at the
   global batch of 1,024): (a) two gloo ranks on ``cuda:0`` (NCCL takes
   one rank per card) in child processes, train, eval, infer and export
   through the launcher at 512 rows a rank, float32 tower; held against
   one device over the same global batches: the last logged loss within
   1e-4, the tables' difference at most 10% of their movement, eval AUC
   within 5e-3 with equal example counts, ``pred.txt`` in global record
   order within 1e-5; only rank 0 saves, exports and writes; each rank's
   launches equal a single-device run at B = 512 over rank 0's shard
   (``launches_by_path`` key ``train_dp_gloo``). (b) ``python -m
   deepfm_tpu_torch.fanout --worker_per_host 1``: NCCL, world 1, tables
   bit-equal to the single-device task's. (c) With two or more cards,
   ``fanout --worker_per_host min(count, 4)`` over NCCL, held as (a),
   with per-rank examples/s, step and dispatch ms and the all_reduce's
   device ms per apply in training and alone (back-to-back calls) beside
   its bytes and its NVLink bound; then 1,024 rows a card (three epochs,
   the last one's rate) beside (b)'s one-card rate. ``python3
   chip_smoke.py --phase dp`` runs this phase alone (no result lines).
14. Serve phase: DeepFM at the reference width (``Config()`` defaults:
   V=117,581, F=39, K=32, tower 128-64-32, bfloat16 tower) with random
   weights from a seed, exported, published behind ``LATEST`` and served by
   ``ServingEngine.serve_latest`` to several client threads. Every response
   is checked against the plain forward (``use_pallas=False``) on the same
   weights on the card, and the kernel's launch count over the requests
   must equal the number of flushes.
15. Production phase (``deepfm_tpu_torch.drills``), DeepFM at the reference
   width: the serving drill (``ReplicatedEngine.serve_latest``, 2 replicas,
   inflight 2, small_rows 4, behind a live in-process ``Publisher``: at
   least 2 hot swaps a replica, zero failures, each replica's blackout;
   padded answers bit-equal to unpadded on the card), then 4 spawned
   ``client_main`` processes through a ``FrontendServer`` over a fleet
   of the same settings on the drill's last artifact, all exiting 0, and
   the same drill on one engine; the production
   loop in smoke mode (in-process trainer) and full mode (the launcher as
   a supervised subprocess on the same card; read faults, a publish crash
   before the rename and a SIGTERM with a supervised resume), each gated
   on zero lost requests across >= 3 hot swaps, a clean skew audit, the
   joiner's audit equal to the seed-pure simulation, finite final params,
   monotonic versions and ``LATEST`` = max; the experiment drill at seed 7
   at the same width (promotion, then three poisoned challengers rolled
   back and quarantined with their reasons); the overload and cache drills
   on their small cascade. ``python3 chip_smoke.py --phase production``
   runs this phase alone (no result lines); ``--phase experiment`` runs the
   experiment drill alone at the reference width over several seeds, at
   the drill's overrides for that width and at the JAX drill's parameters.
16. Drills phase (``deepfm_tpu_torch.drills.{fault,preempt,online}``) at
   the reference width: the fault drill (read faults healed, one corrupt
   record skipped, bit-identical to a clean run on the staged, RAM-cache
   and device-resident paths; the raise policy's path and offset; one
   failed save tolerated), the preemption drill (a launcher subprocess
   SIGTERMed at its hold sentinel exits 42, supervised relaunches preempt
   themselves, final params bit-identical to the baseline, staged and
   device-resident) and the online drill (the same under read faults while
   shards arrive; every artifact audited; the versions shared with a clean
   replay bit-equal). One line a drill: seconds, subprocesses, restarts,
   faults injected and healed.
17. Remote-seam phase: a local stand-in for an object store (``LocalStore``,
   ``tf.io.gfile``'s duck type over a temporary directory, no network)
   installed with ``fileio.set_remote_fs`` carries a checkpoint save and
   restore, ``export_serving``/``load_serving``, a ``Publisher`` publish and
   one served batch (bit-equal to the same weights exported locally), and a
   TFRecord round trip through ``python -m
   deepfm_tpu_torch.tools.libsvm_to_tfrecord``. Also one ``mfu`` line: the
   card's datasheet peak (``utils.mfu.device_peak_flops``), basis
   ``measured-device-peak``. ``python3 chip_smoke.py --phase drills`` runs
   phases 16 and 17 alone (no result lines).

Each group of phases ends with a ``phase <name>: <s>s (total <s>s)`` line
(wall clock). The line before the last is a JSON object describing each
kernel; the last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero and prints no result. Every kernel's launch count is read
over main-path runs with the counts set to 0 just before each: the FM
kernels over the dense train task (``launches``), the sparse train tasks
and serving; the plan, take and segments kernels over the hashed sparse
train task (the take backward and segments also over the other three);
the install kernel over the tiered train task. ``launches_by_path`` also
holds the three accumulation train tasks, the per-record dense task, the
two decoded-cache tasks, the device-resident tasks with their staged
counterparts, the pipe-mode task (``train_pipe``), the input-service task
(``train_input_workers``), the online trainer's training and serving
(``train_online``, ``serve_online``), the hashed online run
(``train_online_hashed``), every zoo model's train task (``zoo_<name>``,
``zoo_<name>_sparse_hashed``, ``zoo_mmoe_sparse_tiered``), the twin
tower's training (``train_twin_tower``), the cascade's staged and fused
requests (``cascade_staged``, ``cascade_fused``), rank 0 of the
one-card data-parallel train task (``train_dp_gloo``) and the production
phase's drills (``serve_replicas``, ``serve_frontend``, ``serve_single``,
``production_smoke``, ``production_serve``, ``experiment``,
``cascade_drills``); the full production drill's trainer is a launcher
subprocess, whose launches stay in its process
(``launches_not_counted``).

Kernel times come from torch.profiler's device events. A time the
profiler does not see in three tries prints as "missing (profiler saw no
kernel)" (null in the JSON line), never as the CUDA-event call time,
which every line prints under its own ``*_call_ms`` key.

Numerics: float32 matmuls run in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False``) and bfloat16 matmuls
accumulate without reduced-precision reductions
(``allow_bf16_reduced_precision_reduction = False``); the serve tolerance
below assumes both.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import hashlib
import io
import json
import logging
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from deepfm_tpu_torch import _native, launch  # noqa: E402
from deepfm_tpu_torch import config as config_lib  # noqa: E402
from deepfm_tpu_torch.config import Config  # noqa: E402
from deepfm_tpu_torch.data import cache as cache_lib  # noqa: E402
from deepfm_tpu_torch.data import fileio, libsvm, tfrecord  # noqa: E402
from deepfm_tpu_torch.drills import fault as fault_drill  # noqa: E402
from deepfm_tpu_torch.drills import online as online_drill  # noqa: E402
from deepfm_tpu_torch.drills import preempt as preempt_drill  # noqa: E402
from deepfm_tpu_torch.drills import production as prod_drill  # noqa: E402
from deepfm_tpu_torch.drills import serving as serving_drill  # noqa: E402
from deepfm_tpu_torch.data import pipeline as pipe_lib  # noqa: E402
from deepfm_tpu_torch.models import get_model  # noqa: E402
from deepfm_tpu_torch.models.twin_tower import (  # noqa: E402
    TwinTower, tower_batch, train_twin_tower, twin_tower_step)
from deepfm_tpu_torch.native import loader as tfr_loader  # noqa: E402
from deepfm_tpu_torch.obs import trace as trace_lib  # noqa: E402
from deepfm_tpu_torch.parallel import bootstrap  # noqa: E402
from deepfm_tpu_torch.ops import embedding as emb_ops  # noqa: E402
from deepfm_tpu_torch.ops import embedding_kernels as ek  # noqa: E402
from deepfm_tpu_torch.ops import fused_fm as ffm  # noqa: E402
from deepfm_tpu_torch.ops.fused_fm import fused_fm, reference_fm  # noqa: E402
from deepfm_tpu_torch.rec.cascade import (  # noqa: E402
    ITEM_SLOT, TOWERS_FILE, CascadeEngine, cascade_extra_export,
    export_cascade)
from deepfm_tpu_torch.rec.index import INDEX_FILE, CandidateIndex  # noqa: E402
from deepfm_tpu_torch.serve import ReplicatedEngine, ServingEngine  # noqa: E402
from deepfm_tpu_torch.train import Trainer, tasks  # noqa: E402
from deepfm_tpu_torch.train import guard as guard_lib  # noqa: E402
from deepfm_tpu_torch.train import loop as loop_lib  # noqa: E402
from deepfm_tpu_torch.train.optimizers import Adam  # noqa: E402
from deepfm_tpu_torch.train.publish import Publisher  # noqa: E402
from deepfm_tpu_torch.train.state import StateSnapshot  # noqa: E402
from deepfm_tpu_torch.utils import checkpoint as ckpt_lib  # noqa: E402
from deepfm_tpu_torch.utils import export as export_lib  # noqa: E402
from deepfm_tpu_torch.tools import libsvm_to_tfrecord  # noqa: E402
from deepfm_tpu_torch.utils import faults  # noqa: E402
from deepfm_tpu_torch.utils import mfu as mfu_lib  # noqa: E402
from deepfm_tpu_torch.utils import preempt as preempt_lib  # noqa: E402
from deepfm_tpu_torch.utils import profiling as prof_lib  # noqa: E402

SEED = 0

# Published peaks of one H100 SXM (NVIDIA data sheet), at a 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# fused_fm vs reference_fm: both convert to float32 after the load and sum
# in float32, in another order; the tolerance of tests/test_pallas_fm.py.
FM_RTOL, FM_ATOL = 1e-4, 1e-3
# The forward's vector path (16-byte chunks) at the reference width, at
# K = 8 and 64 (2 and 16 chunks a field in float32, 1 and 8 in bfloat16)
# and at F = 1; its scalar path at K = 33 and 48 (a field's bytes not a
# divisor of 512 in 16-byte chunks).
# B = 4, 16, 32, 64: the production phase's serving buckets and its
# trainers' batches.
FM_CASES = [(b, 39, 32) for b in (1, 4, 7, 16, 32, 64, 256, 1024)] + [
    (256, 13, 8), (256, 39, 48), (7, 39, 33), (257, 39, 33), (3, 1, 64),
    (257, 39, 64), (257, 1, 8)]
# xv one element past a 16-byte boundary: the scalar path at the shapes the
# vector path takes (and so the previous design's time at them).
FM_MISALIGNED_CASES = [(b, 39, 32) for b in (1, 7, 256, 1024)]
TIMED_SHAPE = (256, 39, 32)  # one full serving flush (serve_max_batch)

# Backward kernel vs reference_fm_bwd: one float32 sum over F (in another
# order) then elementwise float32 products; float32 cotangents agree to
# 1e-5 relative. bfloat16 cotangents are rounded from float32 on both
# sides, so a value at a rounding boundary can land one bf16 ulp apart
# (at most 2^-7 of its magnitude).
BWD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}
BWD_CASES = [(b, 39, 32) for b in (1, 7, 16, 32, 1024, 4096)] + [
    (1024, 13, 8), (1024, 39, 48)]
TRAIN_SHAPE = (1024, 39, 32)  # one training batch at the reference width

# Train parity, kernels vs plain path, 20 steps at lr 5e-4. They differ
# only in float32 sum order (the FM reductions; both sum the embedding
# gradients in position order) until a bfloat16 tower rounds an input one
# ulp apart; between the JAX package and the port on the CPU the same bf16
# trajectory agreed to 2e-5 per step (tests/test_torch_train.py).
PARITY_STEPS = 20
PARITY_LOSS_ATOL = 1e-3

# Same-seed determinism: the layouts whose embedding gradient sums the
# cotangents of repeated ids, each trained twice for 20 steps.
DETERMINISM_STEPS = 20
DETERMINISM_LAYOUTS = {
    "dense": {},
    "sparse_monolithic": dict(embedding_update="sparse"),
    "dense_hashed": dict(embedding_buckets="262144,262144,262144,262144",
                         embedding_assign="hash"),
    # DIN: fm_v's gradient adds the feature lookup's and the history
    # lookup's position-ordered segment sums.
    "din": dict(model="din", history_max_len=20),
    # Under --embedding_kernels xla the dense lookups, hashed or not, still
    # sum their gradients through the take backward (ek.index_rows).
    "xla_dense": dict(embedding_kernels="xla"),
    "xla_dense_hashed": dict(embedding_buckets="262144,262144,262144,262144",
                             embedding_assign="hash",
                             embedding_kernels="xla"),
}
# The legs whose card sums are the library's, measured the same way and
# printed, not asserted. Under ``xla`` the monolithic table's fused leg sums
# through ``index_add_`` (the library yardstick), whose float atomics may
# add in another order from run to run (two same-seed runs on an H100 80GB
# HBM3 at 700 W: table diffs of 1e-9 to 2e-9); under ``off`` the plan leg's
# take backward is autograd's ``index_put_`` with accumulate (0.0 there,
# but its order is the library's to keep, not the port's).
ORDER_FREE_LEGS = {
    "xla_sparse_monolithic": dict(embedding_update="sparse",
                                  embedding_kernels="xla"),
    "off_sparse_monolithic": dict(embedding_update="sparse",
                                  embedding_kernels="off"),
}


# Train phases: the reference width with 64 Ki train and 8 Ki eval records,
# decoded per record in Python on the pipeline's prefetch thread.
TRAIN_FILES, TRAIN_PER_FILE, EVAL_RECORDS = 8, 8192, 8192
TRAIN_EPOCHS = 2

# The sparse update's two layouts at the reference width. Hashed: the
# repo's own hashed shape, 4 tables x 262,144 buckets (scripts/
# bench_embedding.py), ids assigned to tables by hash.
SPARSE_LAYOUTS = {
    "sparse_monolithic": dict(embedding_update="sparse"),
    "sparse_hashed": dict(embedding_update="sparse",
                          embedding_buckets="262144,262144,262144,262144",
                          embedding_assign="hash"),
}
HASHED_TABLES = 4
EMB_PARAMS = 2  # fm_w, fm_v

# Plan and take kernels: one hashed table's view of a training batch.
PLAN_N = 1024 * 39
HASHED_ROWS = 262_144
MONO_ROWS = 117_632
PLAN_CASES = [  # (label, ids, rows, share of positions at the fill id)
    ("hashed_table", PLAN_N, HASHED_ROWS, 0.75),
    ("monolithic", PLAN_N, MONO_ROWS, 0.0),
    ("n1", 1, HASHED_ROWS, 0.0),
    ("all_equal", PLAN_N, HASHED_ROWS, "equal"),
    ("all_fill", PLAN_N, HASHED_ROWS, 1.0),
    ("n_gt_rows", PLAN_N, 4096, "every_row"),
    ("rows_2m", PLAN_N, 2_000_000, 0.0),
    # More ids than one pass of a CTA's threads holds (N / 8 > 8 * 1024):
    # the plan kernel's multi-pass marking and inv loop.
    ("batch_4096_hashed", 4096 * 39, HASHED_ROWS, 0.75),
    ("batch_4096_monolithic", 4096 * 39, MONO_ROWS, 0.0),
]
# One plan launch over tables of unequal rows (the smallest and the largest
# the counting plan takes, 3/4 of each table's positions at its fill id).
MIXED_ROWS = (HASHED_ROWS, 4096, 1, 2_000_000)
# The previous plan design's single-table time at the hashed shape (a memset
# and five dependent kernels per table), as PERF.md records it for an H100
# 80GB HBM3 at 700 W: printed beside the one-launch design's times as a
# recorded figure, never as a number of this run.
FIVE_PASS_PLAN_MS = 0.013058
# The previous take-backward design's time per table launch at the hashed
# shape (one thread per element, one launch per table), as PERF.md records
# it for an H100 80GB HBM3 at 700 W: printed beside the one-launch design's
# times as a recorded figure, never as a number of this run.
PREV_TAKE_BWD_MS = {1: 0.001961, 32: 0.005849}
# The take backward against the plain backward on the card: a float32 sum
# of the same terms that autograd's accumulate may take in another order;
# at most a few dozen terms per slot here, so within 1e-5 of the value.
TAKE_BWD_TOL = dict(rtol=1e-5, atol=1e-5)
# Sparse train parity (hashed, kernels vs plain legs): the take backward
# and plan are bit-equal across legs; the fused FM's float32 sum order and
# the bf16 tower differ as in the dense parity.
SPARSE_PARITY_LOSS_ATOL = 1e-3

# The hot/cold tier at the reference width: 81,920 hot rows hold about 2.4
# batches' unique ids (one B=1024 batch touches ~33.9k of the 117,581), the
# ratio of the repo's own tiered bench (24,576 hot rows over ~10k unique
# ids, scripts/bench_embedding.py). One batch per dispatch: a group of 8
# would touch ~93% of the ids, and the config keeps hot rows below the
# vocabulary.
TIERED = dict(embedding_update="sparse", embedding_tiering="hot_cold",
              embedding_hot_rows=81_920, steps_per_loop=1, transfer_ahead=2)
# Tiered parity (20 steps through fit, dropout off): the tier moves where
# rows live, never their values, and the install legs are bit-identical,
# so the runs differ only where a fused embedding backward adds a row's
# cotangents with float atomics (the ``xla`` leg's ``index_add_``, in
# another order from run to run; the kernel legs add in position order),
# which the bf16 tower can carry into a one-ulp rounding flip, as in the
# sparse parity above. Lazy Adam moves a touched row by
# lr * m / (sqrt(v) + eps): a gradient a few ulps apart moves that step by
# a few ulps of it, and a bf16 flip moves it by ~1e-3 of lr. The tables are
# held within lr / 5 = 1e-4 (an H100 run measured 5.4e-9), 40x below the
# tables' glorot scale (~4e-3), which one misplaced row would show.
TIER_PARITY_LOSS_ATOL = 1e-3
TIER_PARITY_TABLE_ATOL = 1e-4
# Install kernel: hot tables of 81,920 rows; one transaction of 10,000
# installs (about one batch's misses), padded to the next power of two.
INSTALL_H = 81_920
INSTALL_I = 10_000
INSTALL_P = 16_384
INSTALL_ARGS = ("w", "m", "v", "tau", "slots", "wv", "mv", "vv", "tv")
# The tier's two tables, which share one transaction's slots: fm_w (the 1-D
# table) and fm_v at the reference width.
INSTALL_WIDTHS = (1, 32)
# The previous install design's time per table launch at this shape (one
# thread per element, one launch per table), as PERF.md records it for an
# H100 80GB HBM3 at 700 W: printed as a recorded figure, never as a number
# of this run.
PREV_INSTALL_MS = {1: 0.002541, 32: 0.004340}

# Serve phase. Embedding tables are scaled up from their glorot init so the
# FM term moves probabilities well away from 0.5: a wrong kernel then shows
# in the responses. Served and reference probabilities differ only by the
# bfloat16 tower's rounding (the GEMMs run at the bucket's batch size vs
# the request's; a flip of one bf16 ulp of a logit near 1 is 2^-8, at most
# 1e-3 in probability) and float32 sum order in the FM term.
EMB_SCALE = 25.0
SERVE_ATOL = 5e-3
REQUEST_SIZES = (1, 3, 17, 64, 200, 256)
N_REQUESTS = 384
N_CLIENTS = 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean ms per call of ``fn`` on the device timeline (CUDA events around
    ``iters`` back-to-back calls, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 50):
    """(ms of device activity per call, device events per call) of ``fn``,
    from torch.profiler's CUDA events; (None, 0) when the profiler records
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans or sum(spans) <= 0:
        return None, 0
    return sum(spans) / 1000.0 / iters, len(spans) / iters


def profiled_ms(fn, iters: int = 50, tries: int = 3):
    """Device ms per call of ``fn`` from torch.profiler, re-run up to
    ``tries`` times while the profiler records no device event; None when
    it never does (printed as missing, never replaced by a call time)."""
    for _ in range(tries):
        dev_ms = device_profile(fn, iters=iters)[0]
        if dev_ms is not None:
            return dev_ms
    return None


MISSING = "missing (profiler saw no kernel)"


def ms(x) -> str:
    """A profiler time for a result line: six decimals, or MISSING."""
    return MISSING if x is None else f"{x:.6f}"


def fm_inputs(b, f, k, dtype, seed, misaligned: bool = False):
    """w, vals [B,F] and xv [B,F,K] on the card; ``misaligned`` puts xv one
    element past the start of its buffer (no 16-byte chunks)."""
    g = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        g.standard_normal(s, dtype=np.float32)).to("cuda", dtype)
    xv = mk(b, f, k)
    if misaligned:
        buf = torch.empty(xv.numel() + 1, dtype=dtype, device="cuda")
        buf[1:].copy_(xv.reshape(-1))
        xv = buf[1:].view(b, f, k)
        assert xv.is_contiguous() and xv.data_ptr() % 16 != 0
    return mk(b, f), mk(b, f), xv


def fm_bound(b, f, k, itemsize):
    """(bound_ms, bound_by): each input read once, the output written once,
    over HBM bandwidth; vs ~3 flops per xv element and 2 per w element over
    the float32 rate."""
    nbytes = b * f * (k + 2) * itemsize + 4 * b
    flops = b * f * (3 * k + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase():
    max_err = 0.0
    cases = [(c, False) for c in FM_CASES] + [
        (c, True) for c in FM_MISALIGNED_CASES]
    for dtype in (torch.float32, torch.bfloat16):
        for i, ((b, f, k), misaligned) in enumerate(cases):
            w, vals, xv = fm_inputs(b, f, k, dtype, SEED + i, misaligned)
            got = fused_fm(w, vals, xv)
            want = reference_fm(w, vals, xv)
            torch.cuda.synchronize()
            assert got.shape == (b,) and got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=FM_RTOL, atol=FM_ATOL)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"fused_fm check dtype={str(dtype)[6:]} B={b} F={f} K={k}"
                  f"{' xv misaligned (scalar path)' if misaligned else ''} "
                  f"max_abs_err={err:.3e}")

    # Two times per call: the device time of its kernels (torch.profiler),
    # which is what the bound compares with, and the per-call time on the
    # device timeline of back-to-back calls (CUDA events), which includes
    # the host's launch cost between kernels. Each shape also through the
    # scalar path (xv misaligned: the previous design), in turns with the
    # vector path.
    timing = {}
    for b in (1, 7, 256, 1024):
        f, k = TIMED_SHAPE[1:]
        w, vals, xv = fm_inputs(b, f, k, torch.float32, SEED)
        _, _, xv_off = fm_inputs(b, f, k, torch.float32, SEED, True)
        kern_call = cuda_ms(lambda: fused_fm(w, vals, xv))
        plain_call = cuda_ms(lambda: reference_fm(w, vals, xv))
        kern = profiled_ms(lambda: fused_fm(w, vals, xv))
        plain = profiled_ms(lambda: reference_fm(w, vals, xv))
        scalar = [profiled_ms(lambda: fused_fm(w, vals, x))
                  for x in (xv_off, xv, xv_off)]
        source = "profiler"
        bound, bound_by = fm_bound(b, f, k, 4)
        timing[(b, f, k)] = (kern, plain, bound, bound_by, source)
        print(f"fused_fm time f32 B={b} F={f} K={k}: kernel_ms={ms(kern)} "
              f"plain_ms={ms(plain)} ({source}) kernel_call_ms={kern_call:.6f} "
              f"plain_call_ms={plain_call:.6f} (cuda_events) "
              f"bound_ms={bound:.6f} ({bound_by}: HBM "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, f32 "
              f"{F32_FLOPS_PER_S / 1e12} TFLOP/s); turns scalar/vector/"
              f"scalar: {ms(scalar[0])} {ms(scalar[1])} {ms(scalar[2])} "
              f"({source})")
    print("fused_fm library_ms: none (no single PyTorch call computes the "
          "fused first+second order FM)")
    return max_err, timing


def bwd_bound(b, f, k, itemsize):
    """(bound_ms, bound_by) of the backward: w, vals, xv and g read once,
    dw, dvals, dxv written once, over HBM bandwidth; vs ~2 flops per
    output element over the float32 rate."""
    nbytes = 2 * b * f * (k + 2) * itemsize + 4 * b
    flops = b * f * (2 * k + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_bwd_phase():
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (b, f, k) in enumerate(BWD_CASES):
            w, vals, xv = fm_inputs(b, f, k, dtype, SEED + 100 + i)
            g = torch.randn(b, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(i))
            got = ffm._launch_bwd(g, w, vals, xv)
            want = ffm.reference_fm_bwd(g, w, vals, xv)
            torch.cuda.synchronize()
            for name, gt, wt, prim in zip(("dw", "dvals", "dxv"), got, want,
                                          (w, vals, xv)):
                assert gt.dtype == wt.dtype == prim.dtype, (name, gt.dtype)
                assert gt.shape == prim.shape, (name, gt.shape)
                torch.testing.assert_close(gt, wt, **BWD_TOL[dtype])
                max_err = max(max_err, float((gt.float() - wt.float())
                                             .abs().max()))
            # autograd through the kernels vs through the plain forward
            tw, tv, tx = (t.clone().requires_grad_() for t in (w, vals, xv))
            kern = torch.autograd.grad(fused_fm(tw, tv, tx), (tw, tv, tx), g)
            plain = torch.autograd.grad(reference_fm(tw, tv, tx),
                                        (tw, tv, tx), g)
            torch.cuda.synchronize()
            for kt, pt in zip(kern, plain):
                assert kt.dtype == pt.dtype == dtype
                torch.testing.assert_close(kt, pt, **BWD_TOL[dtype])
            print(f"fused_fm_bwd check dtype={str(dtype)[6:]} B={b} F={f} "
                  f"K={k} grads ok, autograd ok")

    b, f, k = TRAIN_SHAPE
    w, vals, xv = fm_inputs(b, f, k, torch.float32, SEED)
    g = torch.randn(b, device="cuda")
    kern_call = cuda_ms(lambda: ffm._launch_bwd(g, w, vals, xv))
    plain_call = cuda_ms(lambda: ffm.reference_fm_bwd(g, w, vals, xv))
    kern = profiled_ms(lambda: ffm._launch_bwd(g, w, vals, xv))
    plain = profiled_ms(lambda: ffm.reference_fm_bwd(g, w, vals, xv))
    source = "profiler"
    bound, bound_by = bwd_bound(b, f, k, 4)
    print(f"fused_fm_bwd time f32 B={b} F={f} K={k}: kernel_ms={ms(kern)} "
          f"plain_ms={ms(plain)} ({source}) kernel_call_ms={kern_call:.6f} "
          f"plain_call_ms={plain_call:.6f} (cuda_events) "
          f"bound_ms={bound:.6f} ({bound_by}: HBM "
          f"{HBM_BYTES_PER_S / 1e12} TB/s)")
    print("fused_fm_bwd library_ms: none (no single PyTorch call computes "
          "the FM cotangents)")
    return max_err, (kern, plain, bound, bound_by, source)


def timed(fn, iters: int = 200):
    """(device ms per call from the profiler, or None when the profiler
    records no device event in three tries; call ms from CUDA events;
    source). The call time is never passed off as the kernel time: its
    own key prints it. ``iters`` below 20 (a slow plain version) also cuts
    the warm-up and profiled calls."""
    call = cuda_ms(fn, iters=iters, warmup=min(20, iters))
    dev_ms = profiled_ms(fn, iters=min(50, iters))
    return dev_ms, call, "profiler" if dev_ms is not None else MISSING


def bound_of(nbytes: int, ops: int):
    """(bound_ms, bound_by): bytes over the HBM rate vs operations over
    the float32 (non-tensor-core) rate, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plan_case_ids(n: int, rows: int, kind, rng) -> np.ndarray:
    if kind == "equal":
        return np.full(n, rows // 3, np.int32)
    if kind == "every_row":
        ids = np.concatenate([np.arange(rows), rng.integers(0, rows,
                                                            n - rows)])
        return rng.permutation(ids).astype(np.int32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[rng.random(n) < kind] = rows
    return ids


def hashed_step_ids(rng, t: int = HASHED_TABLES, n: int = PLAN_N):
    """The hashed step's view of one batch (``n`` = B*F positions; an
    accumulation group's a*B*F): every position reads exactly one of ``t``
    tables of HASHED_ROWS rows (drawn uniformly, as the id hash assigns
    them), and the other tables see their fill id there. Returns (ids int32
    [t, n], masks float32 [t, n])."""
    owner = rng.integers(0, t, n)
    ids = rng.integers(0, HASHED_ROWS, (t, n)).astype(np.int32)
    masks = (owner[None, :] == np.arange(t)[:, None])
    ids[~masks] = HASHED_ROWS
    return ids, masks.astype(np.float32)


def _check_plans(label: str, ids_list, rows_list) -> None:
    """One plan launch over the tables vs each table's plain version on the
    card and the numpy oracle."""
    dev = torch.device("cuda")
    on = [torch.from_numpy(x).to(dev) for x in ids_list]
    before = ek.plan_launches
    got = ek.plan_build_tables(on, rows_list)
    assert ek.plan_launches - before == 1
    for i, (ids, t, rows, g) in enumerate(zip(ids_list, on, rows_list, got)):
        want = emb_ops.make_plan_counting(t, rows)
        torch.cuda.synchronize()
        for f in ("uids", "inv", "touched"):
            assert torch.equal(getattr(g, f), getattr(want, f)), (label, i, f)
        assert torch.equal(g.rank[g.touched], want.rank[want.touched])
        uids, inv, touched, _ = ek.reference_plan_numpy(ids, rows)
        assert np.array_equal(g.uids.cpu().numpy(), uids), (label, i)
        assert np.array_equal(g.inv.cpu().numpy(), inv), (label, i)
        assert np.array_equal(g.touched.cpu().numpy(), touched), (label, i)
    print(f"plan check {label}: N={ids_list[0].size} rows={list(rows_list)} "
          f"uniques={[int((g.uids < r).sum()) for g, r in zip(got, rows_list)]}"
          f" in one launch, bit-equal to plain and oracle")


def plan_bound(tables: int, n: int = PLAN_N, rows: int = HASHED_ROWS):
    """Each input and output once, per table: ids, uids, inv (4N bytes
    each), touched (rows bytes), rank (4 rows bytes)."""
    nbytes = tables * (3 * 4 * n + rows + 4 * rows)
    return bound_of(nbytes, tables * (4 * n + 4 * rows)) + (nbytes,)


def plan_phase():
    """Plan kernel vs plain (and the numpy oracle) at every listed shape and
    over four tables of unequal rows in one launch; then times of one
    table's launch and of the hashed step's four-table launch."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 20)
    for label, n, rows, kind in PLAN_CASES:
        _check_plans(label, [plan_case_ids(n, rows, kind, rng)], [rows])
    _check_plans("mixed_4_tables",
                 [plan_case_ids(PLAN_N, r, 0.75, rng) for r in MIXED_ROWS],
                 MIXED_ROWS)

    ids, _ = hashed_step_ids(rng)
    rows4 = [HASHED_ROWS] * HASHED_TABLES
    _check_plans("hashed_4_tables", list(ids), rows4)
    t4 = torch.from_numpy(ids).to(dev)
    # The four tables' id spaces laid end to end, so that one torch.unique
    # dedups every table at once.
    offsets = torch.arange(HASHED_TABLES, device=dev)[:, None] * (
        HASHED_ROWS + 1)
    joint = (t4 + offsets).reshape(-1)
    timing = {}
    for tables, kern_fn, plain_fn, lib_fn in (
            (1, lambda: ek.plan_build_tables(t4[:1], rows4[:1]),
             lambda: emb_ops.make_plan_counting(t4[0], HASHED_ROWS),
             lambda: torch.unique(t4[0], sorted=True, return_inverse=True)),
            (HASHED_TABLES, lambda: ek.plan_build_tables(t4, rows4),
             lambda: [emb_ops.make_plan_counting(x, HASHED_ROWS)
                      for x in t4],
             lambda: torch.unique(joint, sorted=True, return_inverse=True))):
        kern, kern_call, source = timed(kern_fn)
        plain, plain_call, _ = timed(plain_fn)
        lib, lib_call, _ = timed(lib_fn)
        bound, bound_by, nbytes = plan_bound(tables)
        timing[tables] = (kern, plain, lib, bound, bound_by, source)
        print(f"plan time T={tables} N={PLAN_N} rows={HASHED_ROWS} (one "
              f"launch): kernel_ms={ms(kern)} plain_ms={ms(plain)} "
              f"library_ms(torch.unique, one call)={ms(lib)} ({source}) "
              f"kernel_call_ms={kern_call:.6f} plain_call_ms="
              f"{plain_call:.6f} library_call_ms={lib_call:.6f} "
              f"(cuda_events) bound_ms={bound:.6f} ({bound_by}: {nbytes} B)"
              f"; recorded, not this run: five-pass design "
              f"{FIVE_PASS_PLAN_MS * tables:.6f} ms for {tables} table"
              f"{'s' if tables > 1 else ''} (PERF.md)")
    # The design's fixed cost: one table of one row and one id (the cluster
    # launch, its barriers and DSMEM round trips, almost no bytes).
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    floor, floor_call, source = timed(lambda: ek.plan_build_tables(one, [1]))
    timing["floor"] = floor
    print(f"plan_floor T=1 N=1 rows=1: kernel_ms={ms(floor)} ({source}) "
          f"kernel_call_ms={floor_call:.6f} (cuda_events)")
    return timing


def take_bound(n: int, d: int, ref_rows, masked: bool):
    """Each input and output once: inv (and masks) per table, each
    referenced row once, the output [N, D]; a product per table (with
    masks) and an add per further table for each output element."""
    t = len(ref_rows)
    nbytes = sum(4 * n * (2 if masked else 1) + 4 * d * r for r in ref_rows)
    ops = ((t if masked else 0) + t - 1) * d * n
    return bound_of(nbytes + 4 * d * n, ops)


def segments_phase(plans):
    """The hashed step's position segments, built by the plain versions per
    table (``reference_position_segments``, a sort each) and for the four
    tables at once (``reference_position_segments_tables``, one sort over a
    composite key), and by the segments kernel in one launch
    (``position_segments_tables``, as ``sparse_plan`` does): bit-equal;
    then the device ms and events of each build."""
    n = plans[0].inv.numel()
    inv = torch.stack([p.inv for p in plans])
    keep = torch.stack([p.mask > 0 for p in plans])
    per_table = lambda: [ek.reference_position_segments(  # noqa: E731
        p.inv, n, keep=p.mask > 0) for p in plans]
    batched = lambda: ek.reference_position_segments_tables(  # noqa: E731
        inv, n, keep)
    kernel = lambda: ek.position_segments_tables(inv, n, keep)  # noqa: E731
    for (o1, s1), (o2, s2), (o3, s3) in zip(per_table(), batched(),
                                            kernel()):
        assert torch.equal(o1, o2) and torch.equal(s1, s2)
        assert torch.equal(o1, o3) and torch.equal(s1, s3)
    out = {}
    for turn in range(2):
        for name, fn in (("per_table", per_table), ("batched", batched),
                         ("kernel", kernel)):
            dms, events = device_profile(fn)
            call = cuda_ms(fn, iters=100)
            out.setdefault(name, []).append((dms, events, call))
            print(f"segments build T={len(plans)} N={n} {name}: "
                  f"device_ms={ms(dms)} "
                  f"device_events={events:g} call_ms={call:.6f} "
                  f"(cuda_events)")
    print("segments check: the plain batched build and the kernel's one "
          "launch are bit-equal to the plain per-table builds")
    return {k: v[0] for k, v in out.items()}


def segments_oracle(inv: np.ndarray, u: int, keep):
    """numpy oracle of one table's segments: the stable argsort of the keys
    (inv, or u where left out or outside [0, u)) and the searchsorted
    starts of the slots 0..u."""
    ok = (inv >= 0) & (inv < u)
    if keep is not None:
        ok &= keep
    key = np.where(ok, inv, u)
    order = np.argsort(key, kind="stable").astype(np.int32)
    starts = np.searchsorted(key[order], np.arange(u + 1), side="left")
    return order, starts.astype(np.int32)


def zipf_ids(rng, shape, u: int) -> np.ndarray:
    """Zipf (s = 1.1) ids below u, the tail clipped to u - 1: a few hot
    slots hold thousands of positions, as Criteo's ids do."""
    return np.minimum(rng.zipf(1.1, shape) - 1, u - 1)


def segment_cases(rng):
    """(label, inv [T, N] numpy int32 or int64, slot counts, keep [T, N]
    or None): every run length the kernel treats apart (one position, a
    thread's sort, a block's sort, a long run's compaction), the left-out
    tail, T = 1..8 tables of unequal slot counts, and the edges."""
    n = PLAN_N
    i32 = np.int32
    fill = rng.integers(0, n, (1, n)).astype(i32)
    fill[rng.random((1, n)) < 0.75] = n - 1
    cases = [
        ("uniform", rng.integers(0, n, (1, n)).astype(i32), [n], None),
        ("zipf_vocab", zipf_ids(rng, (1, n), MONO_ROWS), [MONO_ROWS], None),
        ("zipf_hashed_keep", zipf_ids(rng, (4, n), n).astype(i32), [n] * 4,
         rng.random((4, n)) < 0.25),
        ("all_one_slot", np.full((1, n), 7, i32), [1000], None),
        ("fill_slot_no_keep", fill, [n], None),
        ("medium_runs", rng.integers(0, 200, (1, n)).astype(i32), [200],
         None),
        ("n1", np.zeros((1, 1), i32), [HASHED_ROWS], None),
        ("n1_left_out", np.full((1, 1), 5, i32), [HASHED_ROWS],
         np.zeros((1, 1), bool)),
        ("n0", np.zeros((2, 0), i32), [3, 4], None),
        ("u_much_larger", rng.integers(0, 2_000_000, (1, 1000)),
         [2_000_000], None),
        ("u1", np.zeros((1, n), i32), [1], None),
        ("u0", rng.integers(-3, 3, (1, 100)).astype(i32), [0], None),
        ("out_of_range", rng.integers(-5, 105, (2, 999)), [100, 50],
         rng.random((2, 999)) < 0.5),
        ("batch_4096_keep", rng.integers(0, 4096 * 39, (4, 4096 * 39)
                                         ).astype(i32), [4096 * 39] * 4,
         rng.random((4, 4096 * 39)) < 0.25),
    ]
    for t in range(1, ek.MAX_TABLES + 1):
        keep = rng.random((t, n)) < 0.5 if t % 2 else None
        cases.append((f"tables_{t}", rng.integers(0, 5000, (t, n)).astype(
            i32), [5000 + 7 * i for i in range(t)], keep))
    return cases


def segments_bound(inv: torch.Tensor, slots, keep):
    """Each input and output once: inv and keep read, order and every
    table's starts written; a few integer operations per position."""
    t, n = inv.shape
    nbytes = inv.numel() * inv.element_size() + 4 * t * n
    nbytes += 4 * sum(u + 1 for u in slots)
    if keep is not None:
        nbytes += keep.numel()
    return bound_of(nbytes, 0) + (nbytes,)


def _check_segments(label: str, inv_np: np.ndarray, slots, keep_np):
    """One segments launch over the tables of ``inv_np`` against the plain
    version on the card, its own second launch and the numpy oracle."""
    dev = torch.device("cuda")
    inv = torch.from_numpy(inv_np).to(dev)
    keep = None if keep_np is None else torch.from_numpy(keep_np).to(dev)
    before = ek.segments_launches
    got = ek.position_segments_tables(inv, slots, keep)
    assert ek.segments_launches - before == 1, label
    again = ek.position_segments_tables(inv, slots, keep)
    want = ek.reference_position_segments_tables(inv, slots, keep)
    torch.cuda.synchronize()
    longest = 0
    for i, ((o, st), (o2, st2), (wo, ws)) in enumerate(zip(got, again,
                                                          want)):
        assert torch.equal(o, wo) and torch.equal(st, ws), (label, i)
        assert torch.equal(o, o2) and torch.equal(st, st2), (label, i)
        oo, os_ = segments_oracle(inv_np[i], slots[i],
                                  None if keep_np is None else keep_np[i])
        assert np.array_equal(o.cpu().numpy(), oo), (label, i)
        assert np.array_equal(st.cpu().numpy(), os_), (label, i)
        if os_.size:
            runs = np.diff(np.append(os_, inv_np.shape[1]))
            longest = max(longest, int(runs.max()))
    print(f"segments check {label} T={inv.shape[0]} N={inv.shape[1]} "
          f"U={slots if len(set(slots)) > 1 else slots[0]} "
          f"{str(inv.dtype)[6:]} keep={keep is not None} longest run "
          f"{longest}: one launch, bit-equal to the plain version on the "
          f"card, to its second launch and to the numpy oracle")


def segments_time(label: str, inv: torch.Tensor, slots, keep):
    """The segments kernel's time and device events at one shape beside
    the plain version's, one ``torch.sort`` + ``searchsorted`` over
    precomputed composite keys (the library yardstick) and the bound."""
    dev = inv.device
    t, n = inv.shape
    stride = slots[0] + 1
    keys = ek._segment_keys(inv, slots[0], keep) + torch.arange(
        0, t * stride, stride, dtype=torch.int32, device=dev)[:, None]
    keys = keys.reshape(-1)
    bounds = torch.arange(t * stride, dtype=torch.int32, device=dev)

    def lib():
        sk, order = torch.sort(keys, stable=True)
        return order, torch.searchsorted(sk, bounds, out_int32=True)

    kern_fn = lambda: ek.position_segments_tables(  # noqa: E731
        inv, slots, keep)
    plain_fn = lambda: ek.reference_position_segments_tables(  # noqa: E731
        inv, slots, keep)
    kern = timed(kern_fn)
    plain = timed(plain_fn)
    libt = timed(lib)
    events = [device_profile(f)[1] for f in (kern_fn, plain_fn, lib)]
    bound = segments_bound(inv, slots, keep)
    print(f"segments time {label} T={t} N={n} U={slots[0]} "
          f"{str(inv.dtype)[6:]} keep={keep is not None}: "
          f"kernel_ms={ms(kern[0])} plain_ms={ms(plain[0])} "
          f"library_ms(torch.sort + searchsorted)={ms(libt[0])} "
          f"({kern[2]}) kernel_call_ms={kern[1]:.6f} plain_call_ms="
          f"{plain[1]:.6f} library_call_ms={libt[1]:.6f} (cuda_events) "
          f"device_events kernel/plain/library={events[0]:g}/"
          f"{events[1]:g}/{events[2]:g} bound_ms={bound[0]:.6f} "
          f"({bound[1]}: {bound[2]} B)")
    return kern, plain, libt, bound, events


def segments_kernel_phase():
    """The segments kernel (``dfm_segments``, one launch for 1 to 8
    tables) against its plain version on the card and the numpy oracle,
    bit for bit, on every case of ``segment_cases``; then, at the main
    path's shapes, its time and device events beside the plain version's,
    one ``torch.sort`` + ``searchsorted`` over precomputed composite keys
    (the library yardstick) and the bound. Returns the timings."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 60)
    for label, inv_np, slots, keep_np in segment_cases(rng):
        _check_segments(label, inv_np, slots, keep_np)

    gen = np.random.default_rng(SEED + 61)
    ids, masks = hashed_step_ids(gen)
    plans = ek.plan_build_tables(
        torch.from_numpy(ids).to(dev), [HASHED_ROWS] * HASHED_TABLES,
        [torch.from_numpy(m).to(dev) for m in masks])
    vocab = torch.from_numpy(gen.integers(0, MONO_ROWS - 51, (1, PLAN_N))
                             ).to(dev)
    shapes = {
        "hashed": (torch.stack([p.inv for p in plans]), [PLAN_N] * 4,
                   torch.stack([p.mask > 0 for p in plans])),
        "vocab": (vocab, [MONO_ROWS], None),
        "fused_leg": (vocab, [MONO_ROWS + 1], None),
        "dense_hashed": (torch.from_numpy(gen.integers(
            0, HASHED_ROWS, (HASHED_TABLES, PLAN_N))).to(dev),
            [HASHED_ROWS] * HASHED_TABLES, None),
    }
    return {label: segments_time(label, inv, slots, keep)
            for label, (inv, slots, keep) in shapes.items()}


def take_bwd_oracle(g: torch.Tensor, inv: torch.Tensor, keep, u: int):
    """numpy ascending-p segment sum: d[u] = sum of g[p] over the kept
    positions p with inv[p] = u, from 0.0 (``np.add.at`` adds in order)."""
    gg, iv = g.cpu().numpy(), inv.cpu().numpy()
    if keep is not None:
        k = keep.cpu().numpy()
        gg, iv = gg[k], iv[k]
    out = np.zeros((u,) + gg.shape[1:], gg.dtype)
    np.add.at(out, iv, gg)
    return out


def take_bwd_bound(g_cols: int, kept, num_slots, itemsize: int = 4):
    """Each input and output once: the kept positions' cotangent rows and
    order entries, every table's starts, and every table's [U_t, D]
    output; one add per kept element."""
    nbytes = sum(itemsize * g_cols * k + 4 * k for k in kept)
    nbytes += sum(4 * (u + 1) + itemsize * g_cols * u for u in num_slots)
    return bound_of(nbytes, sum(kept) * g_cols) + (nbytes,)


def take_tables_phase(n: int = PLAN_N, plain_iters: int = 200):
    """The fused forward over the hashed step's four masked tables (one
    plan launch over them; ``n`` positions: one batch's, or an
    accumulation group's), bit-equal to the plain composition at D = 1
    and 32; the one-launch backward over the four tables bit-equal to the
    numpy oracle, to its second launch and to one launch per table, and
    the gradients through ``TakeRowsSum`` (one backward launch) bit-equal
    to it; the segments' build per table and batched; then the times
    (``plain_iters`` calls of the slow plain versions)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    ids, masks = hashed_step_ids(np.random.default_rng(SEED + 33), n=n)
    plans = ek.plan_build_tables(
        torch.from_numpy(ids).to(dev), [HASHED_ROWS] * HASHED_TABLES,
        [torch.from_numpy(m).to(dev) for m in masks])
    inv = [p.inv for p in plans]
    mk = [p.mask for p in plans]
    keep = [p.mask > 0 for p in plans]
    seg_t = segments_phase(plans)
    segs = ek.position_segments_tables(torch.stack(inv), n,
                                       torch.stack(keep))
    ref_rows = [int((p.uids < HASHED_ROWS).sum()) + 1 for p in plans]
    kept = [int(k.sum()) for k in keep]
    slots = [n] * HASHED_TABLES
    timing = {}
    for d in (1, 32):
        # As gather_rows hands them over: the fill slots read zero.
        rows = [torch.where((p.uids < HASHED_ROWS)[:, None], torch.randn(
            n, d, device=dev, generator=gen), 0.0) for p in plans]
        g = torch.randn(n, d, device=dev, generator=gen)
        out = ek._launch_take_fwd(rows, inv, mk)
        want = ek.reference_take_sum(rows, inv, mk)
        torch.cuda.synchronize()
        assert torch.equal(out, want), d
        before = ek.take_bwd_launches
        bwd = ek._launch_take_bwd_tables(g, segs, slots)
        again = ek._launch_take_bwd_tables(g, segs, slots)
        assert ek.take_bwd_launches - before == 2
        for i in range(HASHED_TABLES):
            one = ek._launch_take_bwd(g, segs[i], n)
            torch.cuda.synchronize()
            assert torch.equal(bwd[i], again[i]), (d, i)
            assert torch.equal(bwd[i], one), (d, i)
            assert np.array_equal(bwd[i].cpu().numpy(), take_bwd_oracle(
                g, inv[i], keep[i], n)), (d, i)
        leaves = [r.clone().requires_grad_() for r in rows]
        before = ek.take_fwd_launches, ek.take_bwd_launches
        view = ek.take_rows_sum(leaves, inv, mk, segs)
        grads = torch.autograd.grad(view, leaves, g)
        assert (ek.take_fwd_launches - before[0],
                ek.take_bwd_launches - before[1]) == (1, 1)
        for i, gr in enumerate(grads):
            assert torch.equal(gr, bwd[i]), (d, i)
        print(f"take check T={HASHED_TABLES} masked D={d}: forward one "
              f"launch, bit-equal to the plain composition; backward one "
              f"launch for the {HASHED_TABLES} tables, bit-equal to the "
              f"numpy ascending-p oracle, to its second launch and to one "
              f"launch per table; TakeRowsSum gradients (one launch each "
              f"way) bit-equal")

        # The library's one call for the same backward: one index_add_
        # over the four tables' outputs end to end, each table's inv offset
        # by t * N and its masked positions sent to a dropped last row
        # (built outside the timing). Its atomics may add in another order.
        joint = torch.cat([torch.where(k, v.long() + i * n, HASHED_TABLES * n)
                           for i, (v, k) in enumerate(zip(inv, keep))])
        g_rep = g.repeat(HASHED_TABLES, 1)
        lib_bwd = lambda: torch.zeros(  # noqa: E731
            HASHED_TABLES * n + 1, d, device=dev).index_add_(0, joint, g_rep)
        torch.testing.assert_close(lib_bwd()[:-1], torch.cat(bwd),
                                   **TAKE_BWD_TOL)
        bwd_t = timed(lambda: ek._launch_take_bwd_tables(g, segs, slots))
        bwd_plain = timed(lambda: [ek.reference_take_bwd(
            g * m[:, None], v, n) for v, m in zip(inv, mk)],
            iters=plain_iters)
        bwd_lib = timed(lib_bwd)
        bb = take_bwd_bound(d, kept, slots)
        timing[("take_bwd", HASHED_TABLES, d)] = (bwd_t, bwd_plain, bwd_lib,
                                                  bb[:2])
        print(f"take_bwd time T={HASHED_TABLES} masked D={d} N=U={n} (one "
              f"launch, kept positions {kept}): kernel_ms={ms(bwd_t[0])} "
              f"plain_ms={ms(bwd_plain[0])} library_ms(one index_add_ over "
              f"the tables end to end)={ms(bwd_lib[0])} ({bwd_t[2]}) "
              f"kernel_call_ms={bwd_t[1]:.6f} plain_call_ms="
              f"{bwd_plain[1]:.6f} library_call_ms={bwd_lib[1]:.6f} "
              f"(cuda_events) bound_ms={bb[0]:.6f} ({bb[1]}: {bb[2]} B)"
              + (f"; recorded, not this run: {HASHED_TABLES} launches x "
                 f"{PREV_TAKE_BWD_MS[d]:.6f} ms (PERF.md)" if n == PLAN_N
                 else ""))

        # The library's one call for the same function: a sum bag of T
        # rows per position, the masks as per-sample weights, over the
        # tables concatenated (built once, outside the timing).
        joint = torch.cat(rows)
        first = [0]
        for r in rows[:-1]:
            first.append(first[-1] + r.shape[0])
        bag_ids = torch.stack([v.long() + o for v, o in zip(inv, first)], 1)
        bag_w = torch.stack(mk, 1)
        bag = lambda: torch.nn.functional.embedding_bag(  # noqa: E731
            bag_ids, joint, mode="sum", per_sample_weights=bag_w)
        # One mask is 1 at each position and the others multiply the fill
        # slot's zero row, so any sum order gives the same value.
        torch.testing.assert_close(bag(), want, rtol=1e-6, atol=1e-6)
        fwd = timed(lambda: ek._launch_take_fwd(rows, inv, mk))
        plain = timed(lambda: ek.reference_take_sum(rows, inv, mk),
                      iters=plain_iters)
        lib = timed(bag)
        bound = take_bound(n, d, ref_rows, masked=True)
        timing[("take_fwd", HASHED_TABLES, d)] = (fwd, plain, lib, bound)
        print(f"take_fwd time T={HASHED_TABLES} masked D={d} N={n} "
              f"(referenced rows {ref_rows}): kernel_ms={ms(fwd[0])} "
              f"plain_ms={ms(plain[0])} library_ms(embedding_bag sum with "
              f"per-sample weights)="
              f"{ms(lib[0])} ({fwd[2]}) kernel_call_ms={fwd[1]:.6f} "
              f"plain_call_ms={plain[1]:.6f} library_call_ms={lib[1]:.6f} "
              f"(cuda_events) bound_ms={bound[0]:.6f} ({bound[1]})")
    return timing, seg_t


# The benchmark cell's batch (DeepFM at the reference recipe's widths on
# Criteo, B = 131,072, F = 39, the padded vocabulary): the 13 integer
# fields are ids 0..12, one each at every row; the 26 categorical fields are
# uniform over equal slices of the other ids (perfbench/gen/traffic.py).
CELL_B = 131_072
CELL_F = 39
CELL_INTEGER = 13
CELL_SLICE = (117_581 - CELL_INTEGER) // (CELL_F - CELL_INTEGER)
# The take backward's ms a step at that shape before the long-run path, by
# width, from the benchmark's traced window (PERF.md; H100 80GB HBM3, 700 W):
# printed beside this run's times as recorded figures.
PREV_CELL_TAKE_BWD_MS = {32: 104.7, 1: 10.2}


def cell_ids(rng) -> np.ndarray:
    """int64 [B * F]: one cell batch's ids, position b * F + f."""
    ids = np.empty((CELL_B, CELL_F), np.int64)
    ids[:, :CELL_INTEGER] = np.arange(CELL_INTEGER)
    base = CELL_INTEGER + np.arange(CELL_F - CELL_INTEGER) * CELL_SLICE
    ids[:, CELL_INTEGER:] = base + rng.integers(
        0, CELL_SLICE, (CELL_B, CELL_F - CELL_INTEGER))
    return ids.reshape(-1)


def short_name(name: str) -> str:
    return name.replace("void ", "").replace("at::native::", "").replace(
        "(anonymous namespace)::", "")[:90]


def kernel_ms_by_name(fn, iters: int = 10) -> dict:
    """Device ms per call of ``fn`` by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / (
                1e3 * iters)
    return out


def take_bwd_long_phase() -> dict:
    """The take backward's long-run path (runs of more than ``ek.LONG_RUN``
    positions) at the benchmark cell's shape: T = 1, N = 5,111,808, U =
    117,632, 13 runs of 131,072 beside ~29-position runs, at D = 32 and 1,
    bit-equal to the numpy ascending-p oracle and to a second launch, with
    the launch's long runs and positions; its time by kernel beside the
    recorded figures before the path. Then the hashed step's four tables
    (no run above ``ek.LONG_RUN``): the long kernel's own device time, the
    cost of finding none, and the call's."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 80)
    gen = torch.Generator(device=dev).manual_seed(SEED + 81)
    ids = torch.from_numpy(cell_ids(rng)).to(dev)
    n = ids.shape[0]
    seg = ek.position_segments(ids, MONO_ROWS)
    want = (CELL_INTEGER, CELL_INTEGER * CELL_B)
    out = {}
    for d in (32, 1):
        g = torch.randn(n, d, device=dev, generator=gen)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        a = ek._launch_take_bwd_tables(g, [seg], [MONO_ROWS], stats)[0]
        b = ek._launch_take_bwd_tables(g, [seg], [MONO_ROWS])[0]
        torch.cuda.synchronize()
        assert tuple(stats.tolist()) == want, (d, stats.tolist())
        assert torch.equal(a, b), d
        assert np.array_equal(a.cpu().numpy(), take_bwd_oracle(
            g, ids, None, MONO_ROWS)), d
        fn = lambda: ek._launch_take_bwd_tables(  # noqa: E731
            g, [seg], [MONO_ROWS])
        call = cuda_ms(fn, iters=20, warmup=3)
        split = kernel_ms_by_name(fn)
        bound = take_bwd_bound(d, [n], [MONO_ROWS])[0]
        out[d] = (call, split, bound)
        print(f"take_bwd cell shape D={d} N={n} U={MONO_ROWS} "
              f"({CELL_INTEGER} runs of {CELL_B}): bit-equal to the numpy "
              f"ascending-p oracle and to its second launch; long runs "
              f"{stats[0].item()}, positions {stats[1].item()}; call_ms="
              f"{call:.6f} (cuda_events) device ms by kernel "
              + ", ".join(f"{short_name(k)}={v:.6f}"
                          for k, v in sorted(split.items()))
              + f" (profiler) bound_ms={bound:.6f}; recorded, not this "
              f"run: {PREV_CELL_TAKE_BWD_MS[d]} ms a step before the "
              f"long-run path (PERF.md)")

    ids4, masks = hashed_step_ids(np.random.default_rng(SEED + 82))
    plans = ek.plan_build_tables(
        torch.from_numpy(ids4).to(dev), [HASHED_ROWS] * HASHED_TABLES,
        [torch.from_numpy(m).to(dev) for m in masks])
    segs = ek.position_segments_tables(
        torch.stack([p.inv for p in plans]), PLAN_N,
        torch.stack([p.mask > 0 for p in plans]))
    slots = [PLAN_N] * HASHED_TABLES
    for d in (1, 32):
        g = torch.randn(PLAN_N, d, device=dev, generator=gen)
        stats = torch.ones(2, dtype=torch.int64, device=dev)
        ek._launch_take_bwd_tables(g, segs, slots, stats)
        torch.cuda.synchronize()
        assert stats.tolist() == [0, 0], stats.tolist()
        fn = lambda: ek._launch_take_bwd_tables(g, segs, slots)  # noqa: E731
        call = cuda_ms(fn, iters=200)
        split = kernel_ms_by_name(fn, iters=50)
        out[("hashed", d)] = (call, split)
        print(f"take_bwd hashed step T={HASHED_TABLES} D={d} N=U={PLAN_N} "
              f"(no long run): call_ms={call:.6f} (cuda_events) device ms "
              f"by kernel " + ", ".join(f"{short_name(k)}={v:.6f}" for k, v
                                        in sorted(split.items()))
              + " (profiler); the long kernel's is the "
              "cost of finding none")
    return out


def take_phase():
    """Take forward and backward kernels vs plain and the CPU oracle, at
    D = 1 and 32, U = N = 39,936: random slots (every run a few positions
    long) and one hashed table's plan (3/4 of the positions masked, as the
    train step feeds it), one table a launch; then the hashed step's four
    tables in one launch (``take_tables_phase``). Times at the hashed
    plan's shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    rng = np.random.default_rng(SEED + 31)
    n = PLAN_N
    ids = plan_case_ids(n, HASHED_ROWS, 0.75, rng)
    plan = ek.plan_build_kernel(torch.from_numpy(ids).to(dev), HASHED_ROWS)
    mask = (plan.uids.new_tensor(ids) < HASHED_ROWS).float()
    rand_inv = torch.from_numpy(rng.integers(0, n // 4, n).astype(np.int32)
                                ).to(dev)
    zipf_inv = torch.from_numpy(zipf_ids(rng, n, n).astype(np.int32)).to(dev)
    max_err, timing = 0.0, {}
    for d in (1, 32):
        rows = torch.randn(n, d, device=dev, generator=gen)
        g = torch.randn(n, d, device=dev, generator=gen)
        for label, inv, gg, keep in (
                ("random", rand_inv, g, None),
                ("zipf", zipf_inv, g, None),
                ("hashed_plan", plan.inv, g * mask[:, None], mask > 0)):
            out = ek._launch_take_fwd([rows], [inv])
            assert torch.equal(out, ek.reference_take(rows, inv)), (label, d)
            masked = ek._launch_take_fwd([rows], [inv], [mask])
            assert torch.equal(masked, ek.reference_take_sum(
                [rows], [inv], [mask])), (label, d)
            seg = ek.position_segments(inv, n, keep=keep)
            a = ek._launch_take_bwd(gg, seg, n)
            b = ek._launch_take_bwd(gg, seg, n)
            plain = ek.reference_take_bwd(gg, inv, n)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (label, d)
            oracle = np.zeros((n, d), np.float32)
            np.add.at(oracle, inv.cpu().numpy(), gg.cpu().numpy())
            assert np.array_equal(a.cpu().numpy(), oracle), (label, d)
            err = float((a - plain).abs().max())
            if label != "zipf":
                # TAKE_BWD_TOL covers runs of a few dozen terms; a Zipf
                # slot sums thousands, in another order on the plain side,
                # so that case is held bit for bit to the oracle above only.
                torch.testing.assert_close(a, plain, **TAKE_BWD_TOL)
                max_err = max(max_err, err)
            print(f"take check {label} D={d}: forward bit-equal, backward "
                  f"bit-equal to the CPU oracle and to its second launch, "
                  f"max |kernel - plain on card| {err:.3e}")
        # autograd through one masked table (the path lookup_rows takes)
        leaf = rows.clone().requires_grad_()
        seg = ek.position_segments(plan.inv, n, keep=mask > 0)
        view = ek.take_rows_sum([leaf], [plan.inv], [mask], [seg])
        d_rows, = torch.autograd.grad(view, leaf, g)
        assert torch.equal(d_rows, ek._launch_take_bwd(g * mask[:, None],
                                                       seg, n))

        inv, gg = plan.inv, g * mask[:, None]
        inv64 = inv.long()
        fwd = timed(lambda: ek._launch_take_fwd([rows], [inv]))
        fwd_plain = timed(lambda: ek.reference_take(rows, inv))
        fwd_lib = timed(lambda: rows.index_select(0, inv64))
        bwd = timed(lambda: ek._launch_take_bwd(gg, seg, n))
        bwd_plain = timed(lambda: ek.reference_take_bwd(gg, inv, n))
        bwd_lib = timed(lambda: torch.zeros(n, d, device=dev).index_add_(
            0, inv64, gg))
        # What this run's data needs: the forward reads inv, each referenced
        # row once and writes N rows; the backward reads the kept positions
        # (order and cotangent rows) and starts, and writes U rows.
        ref_rows = int((plan.uids < HASHED_ROWS).sum()) + 1
        kept = int((mask > 0).sum())
        fb = take_bound(n, d, [ref_rows], masked=False)
        bb = take_bwd_bound(d, [kept], [n])[:2]
        timing[("take_fwd", 1, d)] = (fwd, fwd_plain, fwd_lib, fb)
        timing[("take_bwd", 1, d)] = (bwd, bwd_plain, bwd_lib, bb)
        for name, (k, kc, src), (p, pc, _), (lb, lc, _), (bd, by) in (
                ("take_fwd", fwd, fwd_plain, fwd_lib, fb),
                ("take_bwd", bwd, bwd_plain, bwd_lib, bb)):
            lib_name = "index_select" if name == "take_fwd" else "index_add_"
            print(f"{name} time T=1 D={d} N=U={n} (hashed plan, {kept} kept "
                  f"positions, {ref_rows} referenced rows): kernel_ms={ms(k)} "
                  f"plain_ms={ms(p)} library_ms({lib_name})={ms(lb)} ({src}) "
                  f"kernel_call_ms={kc:.6f} plain_call_ms={pc:.6f} "
                  f"library_call_ms={lc:.6f} (cuda_events) bound_ms={bd:.6f} "
                  f"({by})")
    tables_t, seg_t = take_tables_phase()
    timing.update(tables_t)
    return max_err, timing, seg_t


SEGMENT_SUM_CASES = (("dense_fm_w", 1, MONO_ROWS),
                     ("dense_fm_v", 32, MONO_ROWS),
                     ("fused_leg", 2 + 32, MONO_ROWS + 1))


def order_bound(g: torch.Tensor, ids: torch.Tensor, u: int) -> torch.Tensor:
    """Per [slot, column]: how far two float32 sums of the same terms in
    different orders may lie apart, 2 (n - 1) 2^-24 sum |terms| for the n
    terms of the slot (each order within half that of the exact sum)."""
    n = torch.zeros(u, device=g.device).index_add_(
        0, ids, torch.ones(ids.shape[0], device=g.device))
    mag = torch.zeros(u, g.shape[1], device=g.device).index_add_(
        0, ids, g.abs())
    return 2 * (n - 1).clamp(min=0)[:, None] * 2.0 ** -24 * mag


def segment_sum_phase(n: int = PLAN_N, cases=SEGMENT_SUM_CASES,
                      ids: torch.Tensor = None, long_runs: bool = False):
    """The position-order segment sum that replaces float atomics on the
    dense and the monolithic layouts (``ek.segment_sum``: one segments
    launch, then one take backward launch): ``n`` ids (one batch's, or an
    accumulation group's) over the padded vocabulary at the dense lookups'
    widths (D = 1, 32) and over the fused leg's rows + 1 slots at its width
    (1 + 1 + 32 columns), bit-equal to the numpy ascending-p oracle and to
    its second call; then its time (segments build included) beside
    ``index_add_`` into zeros, the call it replaces. ``ids``: the positions'
    ids (default: uniform over the vocabulary). With ``long_runs`` (runs of
    thousands of positions, as the history's padding at id 0) the library
    sum is held to :func:`order_bound` rather than ``TAKE_BWD_TOL``, which
    is sized for runs of a few dozen terms."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 50)
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    if ids is None:
        ids = torch.from_numpy(rng.integers(0, MONO_ROWS - 51, n)).to(dev)
    timing = {}
    for label, d, u in cases:
        g = torch.randn(n, d, device=dev, generator=gen)
        before = ek.take_bwd_launches, ek.segments_launches
        a = ek.segment_sum(g, ids, u)
        b = ek.segment_sum(g, ids, u)
        assert (ek.take_bwd_launches - before[0],
                ek.segments_launches - before[1]) == (2, 2)
        torch.cuda.synchronize()
        assert torch.equal(a, b), label
        assert np.array_equal(a.cpu().numpy(), take_bwd_oracle(
            g, ids, None, u)), label
        lib = lambda: torch.zeros(u, d, device=dev).index_add_(  # noqa: E731
            0, ids, g)
        if long_runs:
            gap = (lib() - a).abs()
            assert bool((gap <= order_bound(g, ids, u)).all()), (
                label, float(gap.max()))
        else:
            torch.testing.assert_close(lib(), a, **TAKE_BWD_TOL)
        kern = timed(lambda: ek.segment_sum(g, ids, u), iters=100)
        lib_t = timed(lib, iters=100)
        timing[label] = (kern, lib_t)
        print(f"segment_sum check {label} N={n} U={u} D={d}: bit-equal to "
              f"the numpy ascending-p oracle and to its second call; time "
              f"(segments + take backward launches) device_ms={ms(kern[0])} "
              f"call_ms="
              f"{kern[1]:.6f}, library index_add_ device_ms={ms(lib_t[0])} "
              f"call_ms={lib_t[1]:.6f} ({kern[2]})")
    return timing


def install_inputs(h: int, d: int, slots: np.ndarray, rng) -> dict:
    """Host arrays for one install: tables [H] (D = 1, the 1-D fm_w) or
    [H, D], tau [H], ``slots`` and values for every slot (the padding's
    values too, so a dropped slot that was written would show)."""
    p = slots.size
    t_shape = (h,) if d == 1 else (h, d)
    v_shape = (p,) if d == 1 else (p, d)
    f = lambda s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return {"w": f(t_shape), "m": f(t_shape), "v": np.abs(f(t_shape)),
            "tau": rng.integers(0, 1000, h).astype(np.int32),
            "slots": slots.astype(np.int32), "wv": f(v_shape),
            "mv": f(v_shape), "vv": np.abs(f(v_shape)),
            "tv": rng.integers(1000, 2000, p).astype(np.int32)}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32)


def install_case_slots(kind, h: int, rng) -> np.ndarray:
    if kind == "out_of_range":
        return np.array([h, h + 7, -1, 2 ** 31 - 1] * 4, np.int64)
    n = h if kind == "all" else kind
    slots = np.full(1 << max(n - 1, 0).bit_length(), h, np.int64)
    slots[:n] = rng.permutation(h)[:n]
    return slots


def _install_split(ons):
    """(tables, values) of ``install_rows_tables`` from per-table dicts."""
    return ([tuple(o[k] for k in INSTALL_ARGS[:4]) for o in ons],
            [tuple(o[k] for k in INSTALL_ARGS[5:]) for o in ons])


def install_phase():
    """The install kernel, one launch for fm_w (D = 1) and fm_v (D = 32)
    sharing one slots array, vs its plain version per table on the card
    and the numpy oracle: one transaction of INSTALL_I installs padded to
    INSTALL_P, I = 1, every slot out of range, I = H. Then times of the
    two-table transaction (and of each table alone) beside the bound, the
    plain version's and the ``index_copy_`` calls on the real slots."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 40)
    timing = {}
    for kind in (INSTALL_I, 1, "out_of_range", "all"):
        slots = install_case_slots(kind, INSTALL_H, rng)
        hosts = [install_inputs(INSTALL_H, d, slots, rng)
                 for d in INSTALL_WIDTHS]
        ons = [{k: torch.from_numpy(v).to(dev) for k, v in h.items()}
               for h in hosts]
        kern = [{**o, **{k: o[k].clone() for k in INSTALL_ARGS[:4]}}
                for o in ons]
        plain = [{**o, **{k: o[k].clone() for k in INSTALL_ARGS[:4]}}
                 for o in ons]
        before = ek.install_launches
        tables, values = _install_split(kern)
        ek._launch_install_tables(tables, ons[0]["slots"], values)
        assert ek.install_launches - before == 1
        for pl in plain:
            ek.reference_install(*(pl[k] for k in INSTALL_ARGS))
        torch.cuda.synchronize()
        keep = (slots >= 0) & (slots < INSTALL_H)
        real = slots[keep]
        untouched = np.ones(INSTALL_H, bool)
        untouched[real] = False
        for d, host, kt, pt in zip(INSTALL_WIDTHS, hosts, kern, plain):
            for key, vkey in zip(INSTALL_ARGS[:4], INSTALL_ARGS[5:]):
                got = kt[key].cpu().numpy()
                oracle = host[key].copy()
                oracle[real] = host[vkey][keep]
                assert np.array_equal(_bits(got), _bits(oracle)), (kind, d,
                                                                   key)
                assert np.array_equal(_bits(got),
                                      _bits(pt[key].cpu().numpy()))
                assert np.array_equal(_bits(got[untouched]),
                                      _bits(host[key][untouched]))
        print(f"install check I={real.size} P={slots.size} D="
              f"{'+'.join(map(str, INSTALL_WIDTHS))} in one launch: "
              f"bit-equal to plain and oracle per table, "
              f"{int(untouched.sum())} untouched rows kept, "
              f"{int((~keep).sum())} out-of-range slots dropped")

    slots = install_case_slots(INSTALL_I, INSTALL_H, rng)
    ons = [{k: torch.from_numpy(v).to(dev) for k, v in install_inputs(
        INSTALL_H, d, slots, rng).items()} for d in INSTALL_WIDTHS]
    sl = ons[0]["slots"]
    idx = sl[:INSTALL_I].long()
    for label, part in (("two", ons), (1, ons[:1]), (32, ons[1:])):
        tables, values = _install_split(part)
        real = [(t, x[:INSTALL_I]) for tab, vals in zip(tables, values)
                for t, x in zip(tab, vals)]
        kern = timed(lambda: ek._launch_install_tables(tables, sl, values))
        plain = timed(lambda: [ek.reference_install(*tab, sl, *vals)
                               for tab, vals in zip(tables, values)])
        lib = timed(lambda: [t.index_copy_(0, idx, x) for t, x in real])
        widths = [1 if tab[0].dim() == 1 else tab[0].shape[1]
                  for tab in tables]
        nbytes = 4 * INSTALL_P + sum(2 * INSTALL_I * (3 * 4 * d + 4)
                                     for d in widths)
        bound = bound_of(nbytes, 0)
        timing[label] = (kern, plain, lib, bound)
        print(f"install time D={'+'.join(map(str, widths))} (one launch) "
              f"H={INSTALL_H} I={INSTALL_I} P={INSTALL_P}: "
              f"kernel_ms={ms(kern[0])} plain_ms={ms(plain[0])} "
              f"library_ms({len(real)}x index_copy_ on the real slots)="
              f"{ms(lib[0])} ({kern[2]}) kernel_call_ms={kern[1]:.6f} "
              f"plain_call_ms={plain[1]:.6f} library_call_ms={lib[1]:.6f} "
              f"(cuda_events) bound_ms={bound[0]:.6f} ({bound[1]}: "
              f"{nbytes} B); recorded, not this run: "
              f"{' + '.join(f'{PREV_INSTALL_MS[d]:.6f}' for d in widths)} ms "
              f"in {len(widths)} launch{'es' if len(widths) > 1 else ''} "
              f"(PERF.md)")
    return timing


def random_batches(cfg: Config, n: int, seed: int):
    rng = np.random.default_rng(seed)
    b, f = cfg.batch_size, cfg.field_size
    return [{"feat_ids": rng.integers(0, cfg.feature_size, (b, f)
                                      ).astype(np.int32),
             "feat_vals": rng.random((b, f), dtype=np.float32),
             "label": (rng.random((b, 1)) < 0.3).astype(np.float32)}
            for _ in range(n)]


def _losses(cfg: Config, dev: torch.device, batches):
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    out = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b))
        out.append(m["loss"])
    return np.array([float(x) for x in out])


def train_parity_phase(cfg: Config, dev: torch.device,
                       steps: int = PARITY_STEPS) -> None:
    """20 steps from one seeded init on the same batches, dropout off: the
    dense update with the kernels and with the plain path, then the sparse
    update on hashed tables with every kernel (plan, take, FM) and with the
    plain legs; per-step losses agree."""
    cfg = cfg.replace(dropout="1.0,1.0,1.0")
    batches = random_batches(cfg, steps, SEED + 7)
    hashed = cfg.replace(**SPARSE_LAYOUTS["sparse_hashed"])
    for name, kern_cfg, plain_cfg, atol in (
            ("dense", cfg, cfg.replace(use_pallas=False), PARITY_LOSS_ATOL),
            ("sparse_hashed", hashed,
             hashed.replace(use_pallas=False, embedding_kernels="xla"),
             SPARSE_PARITY_LOSS_ATOL)):
        counts = (ek.plan_launches, ek.take_fwd_launches,
                  ek.take_bwd_launches, ek.segments_launches)
        kern = _losses(kern_cfg, dev, batches)
        if dev.type == "cuda":
            # One segments launch per step (the dense lookups share theirs).
            assert ek.segments_launches - counts[3] == steps, name
        if name == "sparse_hashed" and dev.type == "cuda":
            # One plan launch for the four tables, one take forward and one
            # take backward per name.
            assert ek.plan_launches - counts[0] == steps
            assert ek.take_fwd_launches - counts[1] == EMB_PARAMS * steps
            assert ek.take_bwd_launches - counts[2] == EMB_PARAMS * steps
        plain = _losses(plain_cfg, dev, batches)
        diff = np.abs(kern - plain)
        assert np.all(np.isfinite(kern)), kern
        assert diff.max() <= atol, (name, kern, plain, diff)
        print(f"train parity {name}: {steps} steps kernel vs plain, max "
              f"|loss diff| {diff.max():.3e} (atol {atol}); loss "
              f"{kern[0]:.5f} -> {kern[-1]:.5f}")


def _seeded_run(cfg: Config, dev: torch.device, batches):
    """Per-step losses and every embedding table after ``train_step`` over
    ``batches`` from the seeded init (dropout drawn from the state's
    seeded generator)."""
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    losses = []
    for b in batches:
        state, m = trainer.train_step(state, trainer.put_batch(b))
        losses.append(m["loss"])
    tables = {k: v.detach().clone() for k, v in state.params.items()
              if k.split(".")[0] in ("fm_w", "fm_v")}
    return torch.stack(losses), tables


def determinism_phase(cfg: Config, dev: torch.device,
                      steps: int = DETERMINISM_STEPS,
                      require_equal: bool = True) -> dict:
    """Each layout whose embedding gradient sums cotangents of repeated
    ids (dense, sparse monolithic through the fused leg, dense over hashed
    tables) trained twice for ``steps`` steps from the same seed on the
    same batches (default dropout, drawn from the seeded generator): the
    max |difference| of the losses and of every embedding table between
    the two runs, which must be 0.0; DIN with ragged histories too. Then
    the same for the ``xla`` and ``off`` legs, printed only."""
    out = {}
    legs = [(n, kw, True) for n, kw in DETERMINISM_LAYOUTS.items()] + [
        (n, kw, False) for n, kw in ORDER_FREE_LEGS.items()]
    for name, kw, ordered in legs:
        batches = zoo_batches(cfg.replace(**kw), steps, SEED + 9)
        la, ta = _seeded_run(cfg.replace(**kw), dev, batches)
        lb, tb = _seeded_run(cfg.replace(**kw), dev, batches)
        dl = float((la - lb).abs().max())
        dt = max(float((ta[k] - tb[k]).abs().max()) for k in ta)
        bits = torch.equal(la, lb) and all(torch.equal(ta[k], tb[k])
                                           for k in ta)
        out[name] = (dl, dt)
        print(f"determinism {name}: {steps} steps twice from seed {SEED}, "
              f"max |loss diff| {dl!r}, max |table diff| {dt!r} over "
              f"{sorted(ta)}; bit-identical={bits}"
              + ("" if ordered else " (order-free leg: printed, not "
                 "asserted)"))
        assert np.isfinite(float(la[-1])), (name, la)
        if require_equal and ordered:
            assert bits, (name, dl, dt)
    return out


def _fit_run(cfg: Config, dev: torch.device, batches):
    """Per-dispatch losses and the (densified) fm_w/fm_v tables of one
    ``fit`` from the seeded init; and the trainer."""
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    losses = []
    state, _ = trainer.fit(state, batches, hooks=[
        lambda s, m: losses.append(m["loss"])])
    if trainer._tier is not None:
        state = trainer._tier.densified(state)
    tables = {n: state.params[n].detach().float().cpu()
              for n in ("fm_w", "fm_v")}
    return np.array([float(x) for x in losses]), tables, trainer


def tiered_parity_phase(cfg: Config, dev: torch.device,
                        steps: int = PARITY_STEPS, tier: dict = TIERED
                        ) -> None:
    """The hot/cold tier, 20 steps through ``fit`` from one seeded init on
    the same batches, dropout off: against the untiered sparse monolithic
    run, and against the tier's plain install leg (``xla``). Losses and
    densified tables agree; the kernel run installs once per plan."""
    cfg = cfg.replace(dropout="1.0,1.0,1.0")
    batches = random_batches(cfg, steps, SEED + 8)
    tiered = cfg.replace(**tier)
    before = ek.install_launches
    loss_t, tab_t, trainer = _fit_run(tiered, dev, batches)
    plans = trainer._tier.stats["plans"]
    assert plans == steps and trainer._tier.stats["installs"] > 0
    if dev.type == "cuda":
        assert ek.install_launches - before == plans
    print(f"tiered parity: {steps} steps, hit_rate="
          f"{trainer._tier.hit_rate():.4f} evictions="
          f"{trainer._tier.stats['evictions']:.0f} installs="
          f"{trainer._tier.stats['installs']:.0f}")
    untiered = cfg.replace(embedding_update="sparse",
                           steps_per_loop=tier["steps_per_loop"])
    for name, other_cfg in (("untiered", untiered),
                            ("tier_xla", tiered.replace(
                                embedding_kernels="xla"))):
        before = ek.install_launches
        loss_o, tab_o, _ = _fit_run(other_cfg, dev, batches)
        assert ek.install_launches == before, name
        assert np.all(np.isfinite(loss_t)), loss_t
        dl = float(np.abs(loss_t - loss_o).max())
        dt = {n: float((tab_t[n] - tab_o[n]).abs().max()) for n in tab_t}
        assert dl <= TIER_PARITY_LOSS_ATOL, (name, loss_t, loss_o)
        assert max(dt.values()) <= TIER_PARITY_TABLE_ATOL, (name, dt)
        print(f"tiered parity vs {name}: max |loss diff| {dl:.3e} (atol "
              f"{TIER_PARITY_LOSS_ATOL}), max |table diff| fm_w "
              f"{dt['fm_w']:.3e} fm_v {dt['fm_v']:.3e} (atol "
              f"{TIER_PARITY_TABLE_ATOL}); loss {loss_t[0]:.5f} -> "
              f"{loss_t[-1]:.5f}")


class _LossLog(logging.Handler):
    """Collects the fit loop's ``step=... loss=...`` log lines."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if record.msg.startswith("step=") and record.args:
            self.losses.append((int(record.args[0]), float(record.args[1])))


def make_train_data(workdir: str, cfg: Config, *, files: int = TRAIN_FILES,
                    per_file: int = TRAIN_PER_FILE,
                    eval_records: int = EVAL_RECORDS) -> dict:
    """Synthetic TFRecords shared by every train phase."""
    data = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    libsvm.generate_synthetic_ctr(
        data, num_files=files, examples_per_file=per_file,
        feature_size=cfg.feature_size, field_size=cfg.field_size, seed=SEED)
    libsvm.generate_synthetic_ctr(
        data, num_files=1, examples_per_file=eval_records,
        feature_size=cfg.feature_size, field_size=cfg.field_size,
        seed=SEED + 1, prefix="va")
    # The infer task reads te* files: the eval records once more.
    shutil.copy(os.path.join(data, "va_0000.tfrecords"),
                os.path.join(data, "te_0000.tfrecords"))
    print(f"train data: {files * per_file} train + {eval_records} eval "
          f"records written in {time.perf_counter() - t0:.1f}s")
    return {"dir": data, "train": files * per_file, "eval": eval_records}


def _launch_argv(cfg: Config, task: str):
    """The launcher's argv for ``task``: ``cfg``'s non-default fields as
    flags."""
    default = Config().to_dict()
    argv = ["--task_type", task]
    for k, v in cfg.to_dict().items():
        if k != "task_type" and v != default[k]:
            argv += [f"--{k}", str(v)]
    return argv


def launch_task(cfg: Config, task: str, dev: torch.device) -> dict:
    """One task through the CLI entry point, ``python -m
    deepfm_tpu_torch.launch``, with ``cfg``'s non-default fields as flags;
    returns its JSON result line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch.main(_launch_argv(cfg, task), device=dev)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _counts() -> dict:
    return {"fused_fm": fused_fm.launches,
            "fused_fm_bwd": fused_fm.bwd_launches,
            "plan_build": ek.plan_launches,
            "take_fwd": ek.take_fwd_launches,
            "take_bwd": ek.take_bwd_launches,
            "segments": ek.segments_launches,
            "install": ek.install_launches}


def _zero_counts() -> None:
    fused_fm.launches = fused_fm.bwd_launches = 0
    ek.plan_launches = ek.take_fwd_launches = ek.take_bwd_launches = 0
    ek.segments_launches = ek.install_launches = 0


def train_phase(workdir: str, data: dict, cfg: Config, dev: torch.device,
                name: str = "dense", epochs: int = TRAIN_EPOCHS):
    """The launcher's tasks on ``dev``: train (with an eval after each
    epoch), eval, export; the trained artifact serves. Returns ({kernel:
    launches in the train task}, train result). Under
    ``--grad_accum_steps a`` the embedding kernels launch per apply (a
    steps), and the final checkpoint's ``step`` must count microbatches and
    its optimizer ``count`` applies. On a CPU device (a rehearsal at a
    small size) the wrappers launch nothing."""
    run_dir = os.path.join(workdir, name)
    cfg = cfg.replace(data_dir=data["dir"], val_data_dir=data["dir"],
                      model_dir=os.path.join(run_dir, "ckpt"),
                      servable_model_dir=os.path.join(run_dir, "servable"),
                      num_epochs=epochs)
    steps = epochs * (data["train"] // cfg.batch_size)
    eval_batches = -(-data["eval"] // cfg.batch_size)
    hashed = bool(cfg.embedding_bucket_sizes)
    tiered = cfg.embedding_tiering == "hot_cold"
    accum = cfg.grad_accum_steps
    applies = steps // accum  # steps_per_loop is a multiple of accum

    loss_log = _LossLog()
    loop_log = logging.getLogger("deepfm_tpu_torch.train.loop")
    loop_log.addHandler(loss_log)
    loop_log.setLevel(logging.INFO)
    _zero_counts()
    t0 = time.perf_counter()
    try:
        res = tasks.run(cfg.replace(task_type="train"), device=dev)
    finally:
        loop_log.removeHandler(loss_log)
    wall = time.perf_counter() - t0
    launches = _counts()
    print(f"train {name}: steps={res['steps']:.0f} wall_s={wall:.2f} "
          f"examples_per_sec={res.get('examples_per_sec', 0):.1f} "
          f"step_ms_p50={res.get('step_ms_p50', 0):.3f} (host clock, whole "
          f"input path) final_loss={res['loss']:.5f} auc={res['auc']:.5f} "
          f"eval_loss={res['eval_loss']:.5f} launches={launches}")
    if name in PER_RECORD_TRAIN:
        eps, p50 = PER_RECORD_TRAIN[name]
        print(f"train {name} per-record input path (recorded in PERF.md, "
              f"H100 80GB HBM3 at 700 W; not this run): examples_per_sec="
              f"{eps:.1f} step_ms_p50={p50:.3f}")
    print(f"train {name} logged losses: " + " ".join(
        f"{s}:{l:.4f}" for s, l in loss_log.losses))
    assert res["steps"] == steps, res
    first = np.mean([l for _, l in loss_log.losses[:3]])
    last = np.mean([l for _, l in loss_log.losses[-3:]])
    assert len(loss_log.losses) >= 6 and last < first, loss_log.losses
    assert res["auc"] > 0.5, res
    on = int(dev.type == "cuda")
    sparse = cfg.embedding_update == "sparse"
    # Plans, takes and the sparse segments run once per apply (one per
    # step without accumulation); the dense lookups once per microbatch.
    emb_applies = applies if hashed else 0
    # The take backward sums the embedding gradients in position order on
    # every layout: once per name (the dense lookups, the hashed views), or
    # once per apply for all names (the fused leg of the monolithic table,
    # tiered or not).
    fused_leg = sparse and not hashed
    take_bwd = (applies if fused_leg else EMB_PARAMS * applies if sparse
                else EMB_PARAMS * steps)
    plans = 0
    if tiered:
        # One plan per dispatch, one dispatch per step; every batch misses
        # rows, so every plan installs (once per embedding param).
        plans = int(res["hotcold_plans"])
        assert plans == steps and res["hotcold_installs"] > 0, res
        print(f"train {name} tier: plans={plans} hit_rate="
              f"{res['hotcold_hit_rate']:.4f} evictions="
              f"{res['hotcold_evictions']:.0f} installs="
              f"{res['hotcold_installs']:.0f} overlap_fraction="
              f"{res['hotcold_overlap_fraction']:.4f} apply_s_per_dispatch="
              f"{res['hotcold_apply_s'] / plans:.6f} (host clock)")
    want = {"fused_fm": on * (steps + epochs * eval_batches),
            "fused_fm_bwd": on * steps,
            "plan_build": on * emb_applies,
            "take_fwd": on * EMB_PARAMS * emb_applies,
            "take_bwd": on * take_bwd,
            # One segments build per step on every layout (per apply on the
            # sparse ones): the dense lookups' (both names, every hashed
            # table), the hashed plan's or the fused leg's.
            "segments": on * (applies if sparse else steps),
            "install": on * plans}
    assert launches == want, (name, launches, want)
    if accum > 1:
        trainer = Trainer(cfg, device=dev)
        final = ckpt_lib.CheckpointManager(cfg.model_dir).restore(
            trainer.init_state())
        opt = final.opt_state
        counts = (opt["count"], opt["base"]["count"]) if sparse else (
            opt["count"],)
        assert final.step == steps and set(counts) == {applies}, (
            final.step, counts)
        print(f"train {name}: a={accum} checkpoint step={final.step} "
              f"(microbatches) optimizer count={counts[0]} (applies); "
              f"launches per apply: " + " ".join(
                  f"{k}={v / applies:g}" for k, v in launches.items()))

    _zero_counts()
    ev = launch_task(cfg, "eval", dev)
    assert ev["task"] == "eval" and abs(ev["auc"] - res["auc"]) < 1e-3, (
        ev, res)
    assert _counts() == {**{k: 0 for k in want},
                         "fused_fm": on * eval_batches}, _counts()
    inf = launch_task(cfg, "infer", dev)
    assert inf["num_predictions"] == data["eval"], inf
    preds = np.loadtxt(os.path.join(data["dir"], "pred.txt"))
    assert preds.shape == (data["eval"],) and np.all((preds > 0)
                                                      & (preds < 1))
    out = tasks.run(cfg.replace(task_type="export",
                                servable_model_dir=os.path.join(
                                    run_dir, "exported")), device=dev)
    assert out["step"] == steps
    artifact = os.path.join(run_dir, "exported", str(steps))
    serve = export_lib.load_serving(artifact, device=dev,
                                    buckets=export_lib.serving_buckets(256))
    rng = np.random.default_rng(SEED + 3)
    ids = rng.integers(0, cfg.feature_size, (100, cfg.field_size)
                       ).astype(np.int32)
    vals = rng.random((100, cfg.field_size), dtype=np.float32)
    probs = serve(ids, vals)
    plain = export_lib.load_model(artifact, device=dev, use_pallas=False)[0]
    with torch.inference_mode():
        ref = torch.sigmoid(plain(torch.from_numpy(ids).to(dev),
                                  torch.from_numpy(vals).to(dev))).cpu()
    assert probs.shape == (100,) and np.all(np.isfinite(probs))
    err = float(np.abs(probs - ref.numpy()).max())
    assert err <= SERVE_ATOL, err
    print(f"eval task {name} (launcher): auc={ev['auc']:.5f} "
          f"loss={ev['loss']:.5f}; infer task (launcher): "
          f"{inf['num_predictions']:.0f} predictions; export step "
          f"{out['step']:.0f} served 100 rows, max_abs_err_vs_plain="
          f"{err:.3e}")
    return launches, res


def device_kernel_names(fn, iters: int = 3) -> set:
    """Names of the device events of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def _step_timing(cfg: Config, name: str, batch, top: bool,
                 no_sort: bool = False) -> None:
    dev = torch.device("cuda")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    dev_batch = trainer.put_batch(batch)
    step = lambda: trainer.train_step(state, dev_batch)  # noqa: E731
    if no_sort:
        # The position segments come from the segments kernel: no radix
        # sort (or any other sort) runs in the step.
        names = device_kernel_names(step)
        sorts = sorted(n for n in names if "sort" in n.lower())
        assert names and not sorts, (name, sorts)
        print(f"train step {name}: no sort among the step's {len(names)} "
              f"device kernel names")
    call = cuda_ms(step, iters=50, warmup=5)
    busy, events = device_profile(step, iters=10)
    busy_txt = "not measured" if busy is None else f"{busy:.4f}"
    idle = ("not measured" if busy is None
            else f"{max(0.0, 1 - busy / call):.3f}")
    print(f"train step B={cfg.batch_size} {name}: step_ms={call:.4f} "
          f"examples_per_sec={cfg.batch_size / call * 1e3:.0f} "
          f"device_busy_ms={busy_txt} device_events={events:g} "
          f"idle_share={idle}")
    if top and busy is not None:
        top_kernels(step, label=name)


def train_step_timing(cfg: Config) -> None:
    """One training step at B=1024, reference width (CUDA events over
    back-to-back steps; device busy time per step from torch.profiler, and
    the idle share): the dense kernel path vs plain path in turns, then the
    dense, sparse monolithic and sparse hashed updates in turns."""
    batch = random_batches(cfg, 1, SEED + 11)[0]
    for i, (name, use_pallas) in enumerate((
            ("kernel_path", True), ("plain_path", False),
            ("kernel_path", True), ("plain_path", False))):
        _step_timing(cfg.replace(use_pallas=use_pallas), name, batch,
                     top=i == 0)
    layouts = {"dense": {}, **SPARSE_LAYOUTS}
    for turn in range(2):
        for name, kw in layouts.items():
            _step_timing(cfg.replace(**kw), name, batch,
                         top=turn == 0 and name != "dense",
                         no_sort=turn == 0)
        tiered_dispatch_timing(cfg.replace(**TIERED), top=turn == 0)


def tiered_dispatch_timing(cfg: Config, top: bool, n: int = 20) -> None:
    """One dispatch of the tier at B=1024 through ``fit`` (plan on the
    staging thread, apply, step): host clock over ``n`` distinct batches
    after a warm-up that fills the cache; then ``n`` more with span tracing
    on, for the time per dispatch of each span (``hotcold.plan`` runs on
    the staging thread) and the tracing's own cost; device busy time and
    events per dispatch from torch.profiler over single-batch fits."""
    dev = torch.device("cuda")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    batches = random_batches(cfg, 5 + 2 * n + 2 * 11, SEED + 12)
    state, _ = trainer.fit(state, batches[:5])
    stats = trainer._tier.stats
    apply0 = stats["apply_s"]
    t0 = time.perf_counter()
    state, _ = trainer.fit(state, batches[5:5 + n])  # ends in a sync
    per = (time.perf_counter() - t0) / n * 1e3
    apply_ms = (stats["apply_s"] - apply0) / n * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace_lib.configure("full", export_env=False)
        try:
            t0 = time.perf_counter()
            state, _ = trainer.fit(state, batches[5 + n:5 + 2 * n])
            traced = (time.perf_counter() - t0) / n * 1e3
            with open(trace_lib.export(os.path.join(tmp, "t.json"))) as f:
                events = json.load(f)["traceEvents"]
        finally:
            trace_lib.reset()
    spans = {}
    for ev in events:
        if ev.get("ph") == "X":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    print(f"train dispatch B={cfg.batch_size} sparse_tiered traced: "
          f"dispatch_ms={traced:.4f} (tracing on; off: {per:.4f}) per "
          "dispatch: " + " ".join(f"{k}={v / n:.4f}ms"
                                  for k, v in sorted(spans.items())))
    rest = iter(batches[5 + 2 * n:])
    one = lambda: trainer.fit(state, [next(rest)])  # noqa: E731
    busy, events = device_profile(one, iters=10)
    busy_txt = "not measured" if busy is None else f"{busy:.4f}"
    idle = ("not measured" if busy is None
            else f"{max(0.0, 1 - busy / per):.3f}")
    print(f"train dispatch B={cfg.batch_size} sparse_tiered: dispatch_ms="
          f"{per:.4f} (host clock, {n} batches through fit: plan + apply + "
          f"step) apply_ms={apply_ms:.4f} examples_per_sec="
          f"{cfg.batch_size / per * 1e3:.0f} device_busy_ms={busy_txt} "
          f"device_events={events:g} idle_share={idle}")
    if top and busy is not None:
        top_kernels(one, label="sparse_tiered")


def top_kernels(fn, iters: int = 10, top: int = 8,
                label: str = "kernel_path") -> None:
    """Device time per step by kernel name, largest first."""
    ranked = sorted(kernel_ms_by_name(fn, iters).items(),
                    key=lambda kv: -kv[1])[:top]
    print(f"train step {label} top kernels (us per step): " + "; ".join(
        f"{short_name(name)}={ms * 1e3:.1f}" for name, ms in ranked))


def serve_phase(workdir: str, cfg: Config, dev: torch.device,
                n_requests: int = N_REQUESTS):
    """Publish a seeded DeepFM, serve it through ``serve_latest`` and check
    every response. Returns (fused_fm launches over the requests, artifact
    path). On a CPU device (a rehearsal at a small size) the kernel's
    wrapper takes its plain version and launches nothing."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = get_model(cfg, device=dev, generator=gen)
    with torch.no_grad():
        model.fm_w.mul_(EMB_SCALE)
        model.fm_v.mul_(EMB_SCALE)
    publish = os.path.join(workdir, "publish")
    artifact = export_lib.export_serving(model, cfg,
                                         os.path.join(publish, "v1"), step=1)
    export_lib.write_latest(publish, "v1")
    print(f"serve config: V={cfg.feature_size} (padded {model.padded_vocab}) "
          f"F={cfg.field_size} K={cfg.embedding_size} tower={cfg.deep_layers} "
          f"compute={cfg.compute_dtype} batch_norm={cfg.batch_norm} "
          f"max_batch={cfg.serve_max_batch} delay_ms={cfg.serve_max_delay_ms} "
          f"inflight={cfg.serve_inflight}")
    del model

    rng = np.random.default_rng(SEED)
    sizes = [min(int(n), cfg.serve_max_batch)
             for n in rng.choice(REQUEST_SIZES, size=n_requests)]
    requests = [(rng.integers(0, cfg.feature_size, (n, cfg.field_size)
                              ).astype(np.int32),
                 rng.random((n, cfg.field_size), dtype=np.float32))
                for n in sizes]

    buckets = export_lib.serving_buckets(cfg.serve_max_batch)
    engine = ServingEngine.serve_latest(
        publish, max_batch=cfg.serve_max_batch,
        max_delay_ms=cfg.serve_max_delay_ms, inflight=cfg.serve_inflight,
        buckets=buckets, watcher_kw={"loader": lambda path: (
            export_lib.load_serving(path, buckets=buckets, device=dev))})
    results = [None] * n_requests
    errors = []
    try:
        # The watcher's bucket warm-up launched the kernel already; count
        # only what the requests drive.
        fused_fm.launches = 0

        def client(c):
            try:
                for j in range(c, n_requests, N_CLIENTS):
                    fut = engine.submit(*requests[j])
                    results[j] = (fut.result(timeout=300), fut.latency_ms)
            except BaseException as e:  # re-raised below on the main thread
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = fused_fm.launches
        flushes = engine.stats.flushes
        summary = engine.stats.summary()
    finally:
        engine.close(timeout=60)
    if errors:
        raise errors[0]

    ref_model = export_lib.load_model(artifact, device=dev,
                                      use_pallas=False)[0]
    max_err = 0.0
    for (ids, vals), (probs, _) in zip(requests, results):
        assert probs.shape == (ids.shape[0],), probs.shape
        assert np.all(np.isfinite(probs)), "non-finite probability"
        assert np.all((probs >= 0) & (probs <= 1)), "probability outside [0,1]"
        with torch.inference_mode():
            ref = torch.sigmoid(ref_model(torch.from_numpy(ids).to(dev),
                                          torch.from_numpy(vals).to(dev)))
        max_err = max(max_err, float(np.abs(probs - ref.cpu().numpy()).max()))
    assert max_err <= SERVE_ATOL, (
        f"served probabilities differ from the plain forward by {max_err}")
    expected = flushes if dev.type == "cuda" else 0
    assert launches == expected and (launches > 0 or dev.type != "cuda"), (
        f"fused_fm launched {launches} times over {flushes} flushes")

    lat = np.array([r[1] for r in results])
    spread = np.concatenate([r[0] for r in results])
    rows = int(sum(sizes))
    print(f"serve: requests={n_requests} rows={rows} clients={N_CLIENTS} "
          f"wall_s={wall:.3f} qps={n_requests / wall:.1f} "
          f"rows_per_s={rows / wall:.1f} p50_ms={np.percentile(lat, 50):.3f} "
          f"p99_ms={np.percentile(lat, 99):.3f} flushes={flushes} "
          f"fused_fm_launches={launches} "
          f"occupancy_pct={summary['batch_occupancy_pct']} "
          f"max_abs_err_vs_plain={max_err:.3e} (atol {SERVE_ATOL}) "
          f"prob_range=[{spread.min():.4f}, {spread.max():.4f}]")
    return launches, artifact


def forward_timing(artifact: str, cfg: Config) -> None:
    """The model forward alone at one full flush: kernel path vs plain."""
    dev = torch.device("cuda")
    model = export_lib.load_model(artifact, device=dev)[0]
    plain = export_lib.load_model(artifact, device=dev, use_pallas=False)[0]
    rng = np.random.default_rng(SEED + 1)
    b = cfg.serve_max_batch
    ids = torch.from_numpy(rng.integers(0, cfg.feature_size,
                                        (b, cfg.field_size)).astype(np.int32)
                           ).to(dev)
    vals = torch.from_numpy(rng.random((b, cfg.field_size),
                                       dtype=np.float32)).to(dev)
    with torch.inference_mode():
        for name, m in (("kernel_path", model), ("plain_path", plain)):
            call = cuda_ms(lambda: m(ids, vals), iters=100)
            busy, events = device_profile(lambda: m(ids, vals))
            busy_txt = "not measured" if busy is None else f"{busy:.4f}"
            idle = ("not measured" if busy is None
                    else f"{max(0.0, 1 - busy / call):.3f}")
            print(f"forward B={b} {name}: call_ms={call:.4f} "
                  f"device_busy_ms={busy_txt} device_events={events:g} "
                  f"idle_share={idle}")


# ---------------------------------------------------------------------------
# Gradient accumulation, the staging ring, the guard and preemption
# ---------------------------------------------------------------------------

# Gradient accumulation at the reference batch: a = 4 microbatches of
# 1,024 per apply. The merged plan dedups a*B*F = 159,744 ids per hashed
# table in one launch (the plan kernel's multi-pass branch), and the takes,
# the segments and the fused leg's segment sum run over 4x a step's
# positions.
ACCUM = 4
ACCUM_N = ACCUM * PLAN_N
ACCUM_LAYOUTS = {"dense": {}, **SPARSE_LAYOUTS}
ACCUM_APPLIES = 5
# a = 4 x B = 256 against one B = 1,024 step, and kernels against the plain
# legs at a = 4. In float32 they add the same terms in another order (a
# microbatch's mean times 1/4 is the big batch's 1/1,024 exactly): the
# losses within 1e-5 and the norm of the tables' difference within 1e-4 of
# the norm of their movement from the init (a probe on the card measured
# 1.3e-6 at most, and max |diff| 4.1e-7). Not element by element: Adam
# normalizes each element's step, so a gradient near zero that rounds to
# the other sign moves that element by up to 2 lr per apply. With the
# reference's bfloat16 tower the tower's weight gradients are GEMM outputs
# rounded to bf16 once per microbatch, so a = 4 sums four rounded partials
# where B = 1,024 rounds once, and the trajectories part at the bf16 level
# (the probe: 4-9% of the movement); there the losses are held as the step
# parities hold theirs (1e-3) and the table difference is printed.
ACCUM_F32_LOSS_ATOL = 1e-5
ACCUM_F32_REL_MOVE = 1e-4
ACCUM_LOSS_ATOL = 1e-3
# The launches one apply at a = 4 makes, by layout (the prediction PERF.md
# states): the FM kernels once per microbatch; the hashed plan, segments
# and takes once per apply (the merged plan); the fused leg's segments and
# take backward once per apply (one segment sum over the group); the dense
# lookups' segments and take backwards per microbatch.
ACCUM_LAUNCHES_PER_APPLY = {
    "dense": dict(fused_fm=4, fused_fm_bwd=4, plan_build=0, take_fwd=0,
                  take_bwd=8, segments=4, install=0),
    "sparse_monolithic": dict(fused_fm=4, fused_fm_bwd=4, plan_build=0,
                              take_fwd=0, take_bwd=1, segments=1, install=0),
    "sparse_hashed": dict(fused_fm=4, fused_fm_bwd=4, plan_build=1,
                          take_fwd=2, take_bwd=2, segments=1, install=0),
}
# Staging through fit: 48 batches at steps_per_loop 8 (dense), 24 at 1
# (the tier), every slot count and depth, dropout on.
STAGING_BATCHES = {"dense": 48, "sparse_tiered": 24}
# The task-level guard and preemption runs: 2 x 4,096 records, batch
# 1,024, two epochs (16 steps), a checkpoint every 4 steps.
RUNTIME_FILES, RUNTIME_PER_FILE = 2, 4096


def accum_kernels_phase() -> dict:
    """The kernels at the accumulation group's shapes (a = 4, B = 1,024:
    N = 159,744 positions per table): the merged plan over the hashed
    step's four tables in one launch; the segments of that plan's inv
    (T = 4, keep) and of the fused leg's group (U = 117,633); the fused
    take forward and backward over the group's positions at D = 1 and 32;
    ``ek.segment_sum`` at the fused leg's group shape. Each bit-equal to
    its plain version on the card and to the numpy oracle, then timed
    beside its bound, its plain version and its library call."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 70)
    ids, masks = hashed_step_ids(rng, n=ACCUM_N)
    rows4 = [HASHED_ROWS] * HASHED_TABLES
    _check_plans("accum_hashed_4_tables", list(ids), rows4)
    t4 = torch.from_numpy(ids).to(dev)
    offsets = torch.arange(HASHED_TABLES, device=dev)[:, None] * (
        HASHED_ROWS + 1)
    joint = (t4 + offsets).reshape(-1)
    kern = timed(lambda: ek.plan_build_tables(t4, rows4))
    plain = timed(lambda: [emb_ops.make_plan_counting(x, HASHED_ROWS)
                           for x in t4])
    lib = timed(lambda: torch.unique(joint, sorted=True,
                                     return_inverse=True))
    bound = plan_bound(HASHED_TABLES, n=ACCUM_N)
    print(f"plan time accum T={HASHED_TABLES} N={ACCUM_N} rows={HASHED_ROWS}"
          f" (one launch, a={ACCUM} x B=1024): kernel_ms={ms(kern[0])} "
          f"plain_ms={ms(plain[0])} library_ms(torch.unique, one call)="
          f"{ms(lib[0])} ({kern[2]}) kernel_call_ms={kern[1]:.6f} "
          f"plain_call_ms={plain[1]:.6f} library_call_ms={lib[1]:.6f} "
          f"(cuda_events) bound_ms={bound[0]:.6f} ({bound[1]}: {bound[2]} B)")
    out = {"plan": (kern, plain, lib, bound)}

    plans = ek.plan_build_tables(t4, rows4, [torch.from_numpy(m).to(dev)
                                             for m in masks])
    inv = torch.stack([p.inv for p in plans])
    keep = torch.stack([p.mask > 0 for p in plans])
    _check_segments("accum_hashed_keep", inv.cpu().numpy(),
                    [ACCUM_N] * HASHED_TABLES, keep.cpu().numpy())
    fused_ids = rng.integers(0, MONO_ROWS - 51, (1, ACCUM_N))
    _check_segments("accum_fused_leg", fused_ids, [MONO_ROWS + 1], None)
    out["segments"] = {
        "accum_hashed": segments_time("accum_hashed", inv,
                                      [ACCUM_N] * HASHED_TABLES, keep),
        "accum_fused_leg": segments_time(
            "accum_fused_leg", torch.from_numpy(fused_ids).to(dev),
            [MONO_ROWS + 1], None)}
    out["take"], _ = take_tables_phase(n=ACCUM_N, plain_iters=10)
    out["segment_sum"] = segment_sum_phase(n=ACCUM_N,
                                           cases=(SEGMENT_SUM_CASES[2],))
    return out


def _accum_losses(cfg: Config, dev: torch.device, groups):
    """Per-apply losses, the fm_w/fm_v tables and the kernel launches of
    ``multi_step`` over each group from the seeded init."""
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    init = {k: v.detach().clone() for k, v in state.params.items()
            if k.split(".")[0] in ("fm_w", "fm_v")}
    before = _counts()
    losses = []
    for group in groups:
        state, m = trainer.multi_step(state, [trainer.put_batch(b)
                                              for b in group])
        losses.append(m["loss"])
    launches = {k: v - before[k] for k, v in _counts().items()}
    tables = {k: v.detach().clone() for k, v in state.params.items()
              if k.split(".")[0] in ("fm_w", "fm_v")}
    tables["init"] = init
    return torch.stack(losses), tables, launches, state


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a if k != "init")


def _rel_move(a: dict, b: dict) -> float:
    """||a - b|| over ||b - init||, over every table."""
    keys = [k for k in a if k != "init"]
    diff = sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in keys)
    move = sum(float(((b[k] - b["init"][k]).double() ** 2).sum())
               for k in keys)
    return (diff / max(move, 1e-300)) ** 0.5


def _peak_mb(cfg: Config, dev: torch.device, groups):
    """Peak device memory (MB) one dispatch of ``groups[0]`` adds above the
    state's own (None on a CPU device: not measured)."""
    if dev.type != "cuda":
        return None
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    dev_group = [trainer.put_batch(b) for b in groups[0]]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if len(dev_group) == 1:
        trainer.train_step(state, dev_group[0])
    else:
        trainer.multi_step(state, dev_group)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def accum_parity_phase(cfg: Config, dev: torch.device,
                       applies: int = ACCUM_APPLIES) -> None:
    """Accumulation at the reference width, one seeded init, dropout keep
    1.0, for the dense, sparse monolithic (fused leg) and hashed layouts:
    a = 4 x B = 256 against one B = 1,024 step per apply, with a float32
    tower and with the reference's bf16 one; kernels against the plain legs
    (``embedding_kernels xla``, no fused FM) at a = 4 x B = 1,024 in
    float32, with the launches of each apply; two same-seed a = 4 runs with
    dropout on, bit-identical in losses and tables; and the peak device
    memory of an a = 4 x B = 1,024 apply, one B = 1,024 step and one
    B = 4,096 step."""
    cfg = cfg.replace(dropout="1.0,1.0,1.0")
    mb = cfg.batch_size // ACCUM
    big = random_batches(cfg, applies, SEED + 16)
    micro = [{k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
             for b in big for i in range(ACCUM)]
    micro_groups = [micro[i * ACCUM:(i + 1) * ACCUM] for i in range(applies)]
    full = random_batches(cfg, ACCUM * applies, SEED + 17)
    full_groups = [full[i * ACCUM:(i + 1) * ACCUM] for i in range(applies)]
    f32 = cfg.replace(compute_dtype="float32")
    for name, kw in ACCUM_LAYOUTS.items():
        for c in (f32, cfg):
            acc = c.replace(grad_accum_steps=ACCUM, **kw)
            la, ta, _, _ = _accum_losses(acc.replace(batch_size=mb), dev,
                                         micro_groups)
            lb, tb, _, _ = _accum_losses(c.replace(**kw), dev,
                                         [[b] for b in big])
            dl, rel = float((la - lb).abs().max()), _rel_move(ta, tb)
            exact = c.compute_dtype == "float32"
            atol = ACCUM_F32_LOSS_ATOL if exact else ACCUM_LOSS_ATOL
            assert torch.isfinite(la).all() and dl <= atol, (name, la, lb)
            assert rel <= ACCUM_F32_REL_MOVE or not exact, (name, rel)
            print(f"accum parity {name} {c.compute_dtype} tower: {applies} "
                  f"applies of a={ACCUM} x B={mb} vs one B={cfg.batch_size} "
                  f"step each: max |loss diff| {dl:.3e} (atol {atol}), table "
                  f"diff {rel:.3e} of the tables' movement"
                  + (f" (at most {ACCUM_F32_REL_MOVE})" if exact else "")
                  + f", max |table diff| {_max_diff(ta, tb):.3e}; loss "
                  f"{float(la[0]):.5f} -> {float(la[-1]):.5f}")

        acc = f32.replace(grad_accum_steps=ACCUM, **kw)
        lk, tk, launches, state = _accum_losses(acc, dev, full_groups)
        per_apply = {k: v / applies for k, v in launches.items()}
        if dev.type == "cuda":
            assert per_apply == ACCUM_LAUNCHES_PER_APPLY[name], (name,
                                                                 per_apply)
        assert state.step == ACCUM * applies
        opt = state.opt_state
        assert opt["count"] == applies, opt["count"]
        plain = acc.replace(use_pallas=False, embedding_kernels="xla")
        lp, tp, _, _ = _accum_losses(plain, dev, full_groups)
        dl, rel = float((lk - lp).abs().max()), _rel_move(tk, tp)
        assert dl <= ACCUM_F32_LOSS_ATOL and rel <= ACCUM_F32_REL_MOVE, (
            name, dl, rel)
        print(f"accum parity {name}: a={ACCUM} x B={cfg.batch_size} kernels "
              f"vs plain legs, float32 tower, {applies} applies: max |loss "
              f"diff| {dl:.3e}, table diff {rel:.3e} of the movement, max "
              f"|table diff| {_max_diff(tk, tp):.3e}; step={state.step} "
              f"count={opt['count']}; launches per apply {per_apply}")

        drop = cfg.replace(grad_accum_steps=ACCUM, dropout=Config().dropout,
                           **kw)
        l1, t1, _, _ = _accum_losses(drop, dev, full_groups)
        l2, t2, _, _ = _accum_losses(drop, dev, full_groups)
        bits = torch.equal(l1, l2) and all(torch.equal(t1[k], t2[k])
                                           for k in t1 if k != "init")
        print(f"accum determinism {name}: two same-seed runs of {applies} "
              f"applies (dropout {drop.dropout}): max |loss diff| "
              f"{float((l1 - l2).abs().max())!r}, max |table diff| "
              f"{_max_diff(t1, t2)!r}; bit-identical={bits}")
        assert bits, name

        acc = cfg.replace(grad_accum_steps=ACCUM, **kw)
        mem = {"a4_B1024_apply": _peak_mb(acc, dev, full_groups),
               "B1024_step": _peak_mb(cfg.replace(**kw), dev, [[full[0]]]),
               "B4096_step": _peak_mb(cfg.replace(
                   batch_size=ACCUM * cfg.batch_size, **kw), dev,
                                      [[{k: np.concatenate([b[k] for b in
                                                            full[:4]])
                                         for k in full[0]}]])}
        print(f"accum peak memory {name} (max_memory_allocated above the "
              f"state): " + " ".join(
                  f"{k}={'not measured' if v is None else f'{v:.1f}MB'}"
                  for k, v in mem.items()))


def accum_step_timing(cfg: Config) -> dict:
    """One a = 4 apply (``multi_step`` over 4 batches of 1,024) against one
    B = 1,024 step, in turns, per layout: call ms (CUDA events over
    back-to-back dispatches), device busy ms and device events per
    dispatch (torch.profiler)."""
    dev = torch.device("cuda")
    batches = random_batches(cfg, ACCUM, SEED + 18)
    out = {}
    for turn in range(2):
        for name, kw in ACCUM_LAYOUTS.items():
            for label, c, group in (
                    ("step", cfg.replace(**kw), batches[:1]),
                    ("apply", cfg.replace(grad_accum_steps=ACCUM, **kw),
                     batches)):
                trainer = Trainer(c, device=dev)
                state = trainer.init_state(SEED)
                dev_group = [trainer.put_batch(b) for b in group]
                fn = (lambda t=trainer, st=state, g=dev_group:
                      t.multi_step(st, g))
                call = cuda_ms(fn, iters=20, warmup=3)
                busy, events = device_profile(fn, iters=5)
                out[(turn, name, label)] = (call, busy, events)
                busy_txt = "not measured" if busy is None else f"{busy:.4f}"
                print(f"accum timing {name} {label} ({len(group)} x B="
                      f"{cfg.batch_size}): call_ms={call:.4f} device_busy_ms="
                      f"{busy_txt} device_events={events:g} "
                      f"(turn {turn + 1})")
    return out


def staging_phase(cfg: Config, dev: torch.device,
                  tier: dict = TIERED) -> dict:
    """The device staging ring through ``fit``, dense (steps_per_loop 8)
    and tiered (81,920 hot rows, one batch a dispatch), dropout on:
    ``staging_buffers`` 1 and 2 and ``transfer_ahead`` 0 and 2 leave the
    tables bit-identical; each prints the ring's overlap fraction, its
    transfer and wait seconds and the host ms per dispatch (the fit's wall
    clock, which ends in a sync, over its dispatches)."""
    out = {}
    for name, kw in (("dense", {}), ("sparse_tiered", tier)):
        base = cfg.replace(**kw)
        k = base.steps_per_loop
        batches = random_batches(base, STAGING_BATCHES[name], SEED + 13)
        warm = Trainer(base, device=dev)
        warm.fit(warm.init_state(SEED), batches[:2 * k])
        ref = None
        for buffers in (1, 2):
            for depth in (0, 2):
                c = base.replace(staging_buffers=buffers,
                                 transfer_ahead=depth)
                trainer = Trainer(c, device=dev)
                state = trainer.init_state(SEED)
                t0 = time.perf_counter()
                state, res = trainer.fit(state, batches)
                wall = time.perf_counter() - t0
                if trainer._tier is not None:
                    state = trainer._tier.densified(state)
                tables = {n: state.params[n].detach().clone()
                          for n in ("fm_w", "fm_v")}
                if ref is None:
                    ref = tables
                same = all(torch.equal(ref[n], tables[n]) for n in ref)
                dispatches = len(batches) // k
                out[(name, buffers, depth)] = (
                    res["staging_overlap_fraction"],
                    res["staging_transfer_s"], res["staging_wait_s"],
                    wall / dispatches * 1e3)
                print(f"staging {name} staging_buffers={buffers} "
                      f"transfer_ahead={depth}: {len(batches)} batches in "
                      f"{dispatches} dispatches, overlap_fraction="
                      f"{res['staging_overlap_fraction']:.4f} transfer_s="
                      f"{res['staging_transfer_s']:.6f} wait_s="
                      f"{res['staging_wait_s']:.6f} host_ms_per_dispatch="
                      f"{wall / dispatches * 1e3:.3f} (host clock); tables "
                      f"bit-identical to staging_buffers=1 transfer_ahead=0: "
                      f"{same}")
                assert same, (name, buffers, depth)
    return out


def guard_phase(cfg: Config, dev: torch.device) -> dict:
    """``--on_nonfinite skip`` through ``fit``, dense and hashed, dropout
    on: one NaN-poisoned batch among 8 leaves the tables, the generator and
    the step bit-identical to a clean run without it; then the device time
    of the state snapshot a skip-guarded dispatch takes, beside the bytes
    it copies and their bound (each byte read once and written once)."""
    out = {}
    for name, kw in (("dense", {}),
                     ("sparse_hashed", SPARSE_LAYOUTS["sparse_hashed"])):
        c = cfg.replace(on_nonfinite="skip", steps_per_loop=1, **kw)
        clean = random_batches(c, 8, SEED + 14)
        poison = dict(clean[0])
        poison["feat_vals"] = np.full_like(poison["feat_vals"], np.nan)
        runs = []
        for batches, guard in ((clean, None),
                               (clean[:3] + [poison] + clean[3:],
                                guard_lib.NonFiniteGuard.from_config(c))):
            trainer = Trainer(c, device=dev)
            state, res = trainer.fit(trainer.init_state(SEED), batches,
                                     guard=guard)
            runs.append((state, res, guard))
        (sc, rc, _), (sg, rg, guard) = runs
        same = all(torch.equal(sc.params[k], sg.params[k]) for k in sc.params)
        same = same and torch.equal(sc.rng.get_state(), sg.rng.get_state())
        assert guard.health.nonfinite_skips == 1 and rg["steps"] == 8
        assert sg.step == sc.step == 8 and same, name
        snap = StateSnapshot()
        snap.take(sg)
        ms = busy = None
        if dev.type == "cuda":
            ms = cuda_ms(lambda: snap.take(sg), iters=50, warmup=5)
            busy = device_profile(lambda: snap.take(sg), iters=20)[0]
        nbytes = snap.nbytes
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = (ms, busy, nbytes, bound)
        print(f"guard skip {name}: one NaN batch of 9 skipped "
              f"(nonfinite_skips=1), tables, generator and step bit-identical "
              f"to the clean 8-batch run: {same}; snapshot per dispatch: "
              f"{nbytes} B, call_ms={ms if ms is None else f'{ms:.6f}'} "
              f"(cuda_events) device_ms="
              f"{busy if busy is None else f'{busy:.6f}'} bound_ms="
              f"{bound:.6f} (bytes, read + write)")
    return out


def watchdog_phase(cfg: Config, dev: torch.device) -> None:
    """The stall watchdog through ``fit``: an input iterator that stalls
    after 3 batches trips it once, and the injected abort receives the
    dump (the default abort would exit the process with code 43)."""
    c = cfg.replace(dispatch_timeout_s=5.0, steps_per_loop=1)
    trainer = Trainer(c, device=dev)
    fired = threading.Event()
    dumps = []
    trainer.watchdog_abort = lambda d: (dumps.append(d), fired.set())
    batches = random_batches(c, 3, SEED + 15)

    def stalling():
        yield from batches
        fired.wait(timeout=60.0)

    t0 = time.perf_counter()
    _, res = trainer.fit(trainer.init_state(SEED), stalling())
    assert fired.is_set() and len(dumps) == 1, dumps
    assert res["steps"] == 3 and "no dispatch completed" in dumps[0]
    assert "step 3" in dumps[0], dumps[0]
    print(f"watchdog: fired once after {time.perf_counter() - t0:.2f}s "
          f"(dispatch_timeout_s=5.0) on an input stalled after 3 batches; "
          f"dump: {dumps[0].splitlines()[0]!r}")


def _final_tables(cfg: Config, dev: torch.device):
    trainer = Trainer(cfg, device=dev)
    state = ckpt_lib.CheckpointManager(cfg.model_dir).restore(
        trainer.init_state())
    return state.step, {k: v.detach().clone() for k, v in
                        state.params.items()}, state.rng.get_state()


def rollback_preempt_phase(workdir: str, cfg: Config, dev: torch.device,
                           per_file: int = RUNTIME_PER_FILE) -> None:
    """Task level, on 8 Ki synthetic records (16 steps over two epochs, a
    checkpoint every 4, dropout on): an uninterrupted run; a run under
    ``--on_nonfinite rollback`` with a NaN batch (step 7), which restores
    the step-4 checkpoint and replays to tables bit-identical to the
    uninterrupted run's; and the CLI (``python -m
    deepfm_tpu_torch.launch`` in a child process) with the preempt-after
    hook, which exits 42 after its forced save at step 5 and, run again,
    resumes to the same tables bit for bit."""
    data = os.path.join(workdir, "runtime_data")
    libsvm.generate_synthetic_ctr(
        data, num_files=RUNTIME_FILES, examples_per_file=per_file,
        feature_size=cfg.feature_size, field_size=cfg.field_size,
        seed=SEED + 4)
    no_eval = os.path.join(workdir, "runtime_no_eval")
    os.makedirs(no_eval, exist_ok=True)
    steps = 2 * RUNTIME_FILES * per_file // cfg.batch_size
    base = cfg.replace(task_type="train", data_dir=data, val_data_dir=no_eval,
                       num_epochs=2, steps_per_loop=1,
                       save_checkpoints_steps=4)

    def run_dir(name):
        return base.replace(model_dir=os.path.join(workdir, "rt_" + name))

    clean = run_dir("clean")
    res = tasks.run(clean, device=dev)
    step, want, rng = _final_tables(clean, dev)
    assert step == res["steps"] == steps

    faults.set_nan_plan([6])
    rb = run_dir("rollback").replace(on_nonfinite="rollback")
    res = tasks.run(rb, device=dev)
    got = _final_tables(rb, dev)
    same = got[0] == steps and all(torch.equal(want[k], got[1][k])
                                   for k in want)
    same = same and torch.equal(rng, got[2])
    assert res["rollbacks"] == 1 and res["steps"] == steps and same, res
    print(f"rollback: NaN at step 7 rolled back to the step-4 checkpoint "
          f"(rollbacks={res['rollbacks']:.0f}) and replayed to step {steps}; "
          f"tables and generator bit-identical to the uninterrupted run: "
          f"{same}")

    pre = run_dir("preempted")
    t0 = time.perf_counter()
    if dev.type == "cuda":
        env = {**os.environ, tasks.PREEMPT_AFTER_ENV: "5"}
        child = subprocess.run(
            [sys.executable, "-m", "deepfm_tpu_torch.launch",
             *_launch_argv(pre, "train")], cwd=HERE, env=env,
            capture_output=True, text=True, timeout=300)
        child_rc, stdout = child.returncode, child.stdout
        assert child_rc == 42, (child_rc, child.stderr[-2000:])
    else:  # a CPU rehearsal: the launcher in this process
        os.environ[tasks.PREEMPT_AFTER_ENV] = "5"
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                child_rc = launch.main(_launch_argv(pre, "train"),
                                       device=dev)
        finally:
            del os.environ[tasks.PREEMPT_AFTER_ENV]
            preempt_lib.get_listener().clear()
        stdout = buf.getvalue()
        assert child_rc == 42, child_rc
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line == {"task": "train", "preempted": True, "step": 5}, line
    assert _final_tables(pre, dev)[0] == 5
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch.main(_launch_argv(pre, "train"), device=dev)
    got = _final_tables(pre, dev)
    same = rc == 0 and got[0] == steps and all(
        torch.equal(want[k], got[1][k]) for k in want)
    same = same and torch.equal(rng, got[2])
    assert same, (rc, got[0])
    print(f"preempt: CLI child with {tasks.PREEMPT_AFTER_ENV}=5 exited "
          f"{child_rc} after {time.perf_counter() - t0:.1f}s printing "
          f"{json.dumps(line)}; resumed through launch.main to step "
          f"{got[0]}, tables and generator bit-identical to the "
          f"uninterrupted run: {same}")


# ---------------------------------------------------------------------------
# The input path: the native decoder, the pooled feed, the decoded cache,
# the device-resident dataset, bad records and read faults
# ---------------------------------------------------------------------------

# The per-record input path's train lines (Python decode; examples/s, step
# p50 ms), as PERF.md records them for an H100 80GB HBM3 at 700 W: printed
# beside the native path's lines as recorded figures, never as numbers of
# this run.
PER_RECORD_TRAIN = {
    "dense": (28300.9, 53.271), "sparse_monolithic": (25137.7, 64.004),
    "sparse_hashed": (14552.2, 87.646), "sparse_tiered": (10918.9, 97.636),
    "accum_dense": (26625.3, 56.082),
    "accum_sparse_monolithic": (27208.4, 55.959),
    "accum_sparse_hashed": (25115.9, 58.712)}
# The pooled emission's goldens (the JAX package's, tests/test_data.py):
# (k, batch, skip_batches, drop_remainder) over 3 x 500 synthetic records
# (F=7, seed 5), two epochs, shuffle_buffer 300, seed 9.
POOLED_GOLDEN = {
    (8, 64, 0, True): "26fff204f1d9b877c88d8696",
    (4, 32, 5, False): "5130307b96f68f89dadc8fa5",
    (1, 64, 0, True): "3d50f093770b87683461989f",
}
# Device-resident runs: the shuffle pool must cover the epoch (65,536
# records, so --shuffle_buffer 65537) for the device gather to replay the
# staged emission.
# Bad records: one flipped data-CRC byte in a copy of one train file; the
# read-fault drill fails every 3rd read.
BAD_RECORD_INDEX = 100
READ_FAULT_EVERY = 3


def _cores() -> int:
    return len(os.sched_getaffinity(0))


def _train_files(data: dict):
    return sorted(os.path.join(data["dir"], n) for n in os.listdir(data["dir"])
                  if n.startswith("tr") and n.endswith(".tfrecords"))


def _emission_digest(pipe, k: int):
    """(digest, records, wall s) of a pipeline's k-group emission."""
    h = hashlib.sha256()
    n = 0
    t0 = time.perf_counter()
    for rows, m, n_ex in pipe.iter_superbatches(k):
        h.update(f"{m},{n_ex};".encode())
        for key in ("feat_ids", "feat_vals", "label"):
            h.update(np.ascontiguousarray(rows[key]).tobytes())
        n += n_ex
    return h.hexdigest()[:24], n, time.perf_counter() - t0


def decoder_phase(data: dict, cfg: Config) -> dict:
    """The native decoder against the Python codec on every train file
    (labels, ids and values bit-equal), then the host's decode rates: the
    per-record pipeline, the codec alone, eager ``decode_spans``, the
    pooled ``iter_superbatches(8)`` at 1 and 4 reader threads, and the
    pooled path's ns/record by stage."""
    files = _train_files(data)
    f = cfg.field_size
    n = 0
    t_eager = t_codec = 0.0
    for path in files:
        with open(path, "rb") as fh:
            buf = fh.read()
        t0 = time.perf_counter()
        offs, lens = tfr_loader.split_frames(buf)
        got = tfr_loader.decode_spans(buf, offs, lens, f)
        t_eager += time.perf_counter() - t0
        recs = [buf[o:o + ln] for o, ln in zip(offs.tolist(), lens.tolist())]
        t0 = time.perf_counter()
        want = pipe_lib.decode_batch_python(recs, f)
        t_codec += time.perf_counter() - t0
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
        n += len(offs)
    rates = {"python_codec": n / t_codec, "eager_decode_spans": n / t_eager}
    kw = dict(field_size=f, batch_size=cfg.batch_size,
              shuffle_buffer=cfg.shuffle_buffer, seed=SEED)
    per_record = pipe_lib.CtrPipeline(files, use_native_decoder=False, **kw)
    t0 = time.perf_counter()
    got_n = sum(int(b["label"].shape[0]) for b in per_record)
    rates["per_record_pipeline"] = got_n / (time.perf_counter() - t0)
    for threads in (1, 4):
        pooled = pipe_lib.CtrPipeline(files, reader_threads=threads, **kw)
        _, got_n, wall = _emission_digest(pooled, 8)
        rates[f"pooled_k8_threads{threads}"] = got_n / wall
    staged = pipe_lib.CtrPipeline(files, prefetch_batches=0, **kw)
    staged.stage_stats = prof_lib.HostStageStats()
    _, got_n, _ = _emission_digest(staged, 8)
    ns = staged.stage_stats.ns_per_record(got_n)
    card, cores = card_line(), _cores()
    print(f"decoder parity: native decode of {len(files)} train files "
          f"({n} records, F={f}) bit-equal to the Python codec (labels, "
          f"ids, vals)")
    for name, r in rates.items():
        print(f"decode rate {name}: {r:.0f} records/s (host, {cores} usable "
              f"cores; card {card})")
    print(f"pooled k=8 host stages (ns/record, prefetch off, "
          f"{staged.reader_threads} reader threads, {cores} usable cores; "
          f"card {card}): " + " ".join(f"{k}={v}" for k, v in ns.items()))
    rates["stage_ns_per_record"] = ns
    return rates


def golden_phase(workdir: str) -> None:
    """The pooled emission reproduces the JAX package's three goldens, on
    the fused assemble route and on per-chunk scatter."""
    d = os.path.join(workdir, "golden")
    libsvm.generate_synthetic_ctr(d, num_files=3, examples_per_file=500,
                                  feature_size=1000, field_size=7,
                                  prefix="tr", seed=5)
    files = sorted(os.path.join(d, x) for x in os.listdir(d))
    for (k, bs, skip, drop), want in POOLED_GOLDEN.items():
        for assembly in (True, False):
            pipe = pipe_lib.CtrPipeline(
                files, field_size=7, batch_size=bs, num_epochs=2,
                shuffle=True, shuffle_files=True, shuffle_buffer=300,
                drop_remainder=drop, seed=9, skip_batches=skip,
                native_assembly=assembly)
            h = hashlib.sha256()
            for rows, m, n_ex in pipe.iter_superbatches(k):
                h.update(str(m).encode())
                h.update(str(n_ex).encode())
                h.update(rows["feat_ids"].tobytes())
                h.update(rows["feat_vals"].tobytes())
                h.update(rows["label"].tobytes())
            got = h.hexdigest()[:24]
            assert got == want, ((k, bs, skip, drop), assembly, got)
    print(f"pooled emission goldens: {len(POOLED_GOLDEN)} of "
          f"{len(POOLED_GOLDEN)} reproduced on both assembly routes")


@contextlib.contextmanager
def _counting_cache_builds():
    """Count ``CtrPipeline._build_cache_columns`` calls (decode passes)."""
    real = pipe_lib.CtrPipeline._build_cache_columns
    calls = []

    def counting(self):
        calls.append(1)
        return real(self)

    pipe_lib.CtrPipeline._build_cache_columns = counting
    try:
        yield calls
    finally:
        pipe_lib.CtrPipeline._build_cache_columns = real


def cache_phase(workdir: str, data: dict, cfg: Config,
                dev: torch.device) -> dict:
    """``--decoded_cache ram`` and ``disk``: two epochs' emissions equal
    the streamed ones, the first epoch decodes once and the second is a
    hit (no decode), each epoch's host ms; then the dense train task with
    each mode, two epochs (one decode pass in the whole task)."""
    files = _train_files(data)
    k = cfg.steps_per_loop
    streamed = {}
    for e in (0, 1):
        pipe = tasks.make_pipeline(cfg, files, epoch_offset=e)
        streamed[e] = _emission_digest(pipe, k)
    paths = {}
    for mode in ("ram", "disk"):
        c = cfg.replace(decoded_cache=mode, decoded_cache_dir=os.path.join(
            workdir, "cache_probe") if mode == "disk" else "")
        cache_lib.clear_ram_cache()
        ms = []
        with _counting_cache_builds() as builds:
            for e in (0, 1):
                digest, n, wall = _emission_digest(
                    tasks.make_pipeline(c, files, epoch_offset=e), k)
                assert digest == streamed[e][0] and n == streamed[e][1], (
                    mode, e)
                ms.append(wall * 1e3)
                assert len(builds) == 1, (mode, e, len(builds))
        print(f"decoded cache {mode}: emission of epochs 1 and 2 equal to "
              f"the streamed emission; epoch 1 decoded once "
              f"(host_ms={ms[0]:.1f}), epoch 2 a hit with no decode "
              f"(host_ms={ms[1]:.1f}); streamed host_ms per epoch "
              f"{streamed[0][2] * 1e3:.1f}, {streamed[1][2] * 1e3:.1f} "
              f"(host clock, {_cores()} usable cores)")
        cache_lib.clear_ram_cache()
        with _counting_cache_builds() as builds:
            launches, _ = train_phase(workdir, data, c.replace(
                decoded_cache_dir=""), dev, name=f"cache_{mode}")
        # One decode pass per file set in the whole run (train, eval and
        # infer files): every later epoch and task is a hit.
        assert len(builds) == 3, (mode, len(builds))
        paths[f"train_cache_{mode}"] = launches
    cache_lib.clear_ram_cache()
    return paths


def _profile_dispatch(fn, iters: int = 5):
    """(device ms, device events, host->device copies) per call of ``fn``
    from torch.profiler; (None, 0, 0) without device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e.time_range.elapsed_us() for e in cuda]
    htod = sum(1 for e in cuda if "htod" in e.name.lower())
    if not spans or sum(spans) <= 0:
        return None, 0, htod / iters
    return sum(spans) / 1000.0 / iters, len(spans) / iters, htod / iters


# One turn of the two feeds per layout: two turns cost ~70 s, most of it
# the profiled hashed dispatches, time the data-parallel phase needs.
DD_TIMING_TURNS = 1


def dd_dispatch_timing(cfg: Config, files) -> dict:
    """One dispatch (k steps) fed from the device-resident columns and one
    fed through the staging ring, ``DD_TIMING_TURNS`` turns: time, device
    busy time, idle
    share, host->device copies per dispatch (profiler) and data bytes each
    feed moves to the card per dispatch."""
    dev = torch.device("cuda")
    k, bs = cfg.steps_per_loop, cfg.batch_size
    out = {}
    for turn in range(DD_TIMING_TURNS):
        for feed in ("device_resident", "staged"):
            trainer = Trainer(cfg, device=dev)
            state = trainer.init_state(SEED)
            pipe = tasks.make_pipeline(cfg, files)
            if feed == "device_resident":
                cols = trainer._dd_upload(pipe)
                idx = torch.from_numpy(pipe.device_epoch_indices(0, k)).to(dev)

                def dispatch():
                    trainer.multi_step(state, trainer._dd_batches(
                        cols, idx, 0, k, bs))
                nbytes = 0
            else:
                rows, m, _ = next(iter(pipe.iter_superbatches(k)))
                assert m == k
                ring = loop_lib._StagingRing(2, dev)

                def dispatch():
                    group, ready = ring.stage_rows(rows, k)
                    ring.wait(ready)
                    trainer.multi_step(state, group)
                    ring.retire()
                nbytes = sum(v.nbytes for v in rows.values())
            call = cuda_ms(dispatch, iters=5, warmup=1)
            busy, events, htod = _profile_dispatch(dispatch, iters=2)
            if feed == "staged":
                ring.close()
            idle = ("not measured" if busy is None
                    else f"{max(0.0, 1 - busy / call):.3f}")
            busy_txt = "not measured" if busy is None else f"{busy:.4f}"
            print(f"dispatch {cfg.embedding_update}/{feed} k={k} B={bs}: "
                  f"ms={call:.4f} (cuda_events) device_busy_ms={busy_txt} "
                  f"device_events={events:g} idle_share={idle} "
                  f"htod_copies={htod:g} data_bytes_to_card={nbytes}")
            out[(feed, turn)] = (call, busy, htod, nbytes)
    return out


def dd_phase(workdir: str, data: dict, cfg: Config,
             dev: torch.device) -> dict:
    """``--decoded_cache ram --device_dataset --shuffle_buffer 65537``
    through the launcher on the dense, sparse monolithic and sparse hashed
    layouts (one epoch): no fallback warning, final tables and generator
    bit-identical to the staged run with the same flags less
    ``--device_dataset``, and equal launch counts; examples/s and step p50
    beside the staged run's, the columns' bytes on the card against the
    budget; then one dispatch's idle share and host->device copies."""
    files = _train_files(data)
    no_eval = os.path.join(workdir, "dd_no_eval")
    os.makedirs(no_eval, exist_ok=True)
    pool = data["train"] + 1
    # A decoded record on the card: a float32 label, F int32 ids and F
    # float32 values, and its int32 slot of the epoch's index.
    record_bytes = 4 + 8 * cfg.field_size + 4
    budget = int(Trainer(cfg, device=dev)._device_memory_bytes()
                 * cfg.device_dataset_hbm_fraction)
    paths = {}
    for name, kw in {"dense": {}, **SPARSE_LAYOUTS}.items():
        base = cfg.replace(decoded_cache="ram", shuffle_buffer=pool,
                           num_epochs=1, data_dir=data["dir"],
                           val_data_dir=no_eval, servable_model_dir="", **kw)
        runs = {}
        for dd in (False, True):
            c = base.replace(device_dataset=dd, model_dir=os.path.join(
                workdir, f"dd_{name}_{int(dd)}"))
            cache_lib.clear_ram_cache()
            _zero_counts()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = launch_task(c, "train", dev)
            fell = [str(w.message) for w in caught
                    if "fell back" in str(w.message)]
            assert not fell, fell
            launches = _counts()
            runs[dd] = (res, launches, _final_tables(c, dev))
        (rs, ls, (ss, ts, gs)), (rd, ld, (sd, td, gd)) = runs[False], runs[True]
        same = ss == sd and all(torch.equal(ts[k], td[k]) for k in ts)
        same = same and torch.equal(gs, gd)
        assert same and ls == ld, (name, ls, ld)
        assert rd["steps"] == data["train"] // cfg.batch_size, rd
        cols_bytes = record_bytes * data["train"]
        assert cols_bytes <= budget
        print(f"device_dataset {name}: no fallback; tables and generator "
              f"bit-identical to the staged run: {same}; launches equal "
              f"{ld}; examples_per_sec={rd['examples_per_sec']:.1f} "
              f"step_ms_p50={rd['step_ms_p50']:.3f} against staged "
              f"examples_per_sec={rs['examples_per_sec']:.1f} "
              f"step_ms_p50={rs['step_ms_p50']:.3f} (host clock); columns "
              f"on the card {cols_bytes} B of a {budget} B budget "
              f"(device_dataset_hbm_fraction="
              f"{cfg.device_dataset_hbm_fraction})")
        paths[f"dd_{name}"] = ld
        paths[f"dd_staged_{name}"] = ls
    cache_lib.clear_ram_cache()
    if dev.type == "cuda":
        for name, kw in {"dense": {}, **SPARSE_LAYOUTS}.items():
            dd_dispatch_timing(cfg.replace(decoded_cache="ram",
                                           shuffle_buffer=pool, **kw), files)
    return paths


def _data_crc_offset(path: str, index: int) -> tuple:
    """(frame start, data-CRC offset) of record ``index`` of a TFRecord."""
    with open(path, "rb") as fh:
        buf = fh.read()
    pos = 0
    for _ in range(index):
        (length,) = struct.unpack_from("<Q", buf, pos)
        pos += 16 + length
    (length,) = struct.unpack_from("<Q", buf, pos)
    return pos, pos + 12 + length


def bad_records_phase(workdir: str, data: dict, cfg: Config,
                      dev: torch.device) -> None:
    """A copy of one train file with one flipped data-CRC byte: under
    ``--verify_crc --on_bad_record skip`` exactly one record is dropped,
    DataHealth counts 1 and the task completes; under ``raise`` the error
    names the path and the byte offset. Then a transient read fault every
    3rd read (``DEEPFM_TPU_READ_FAULT_EVERY``) heals to the clean run's
    emission and, through the train task, to its tables."""
    src = _train_files(data)[0]
    with open(src, "rb") as fh:
        n_file = len(tfr_loader.split_frames(fh.read())[0])
    no_eval = os.path.join(workdir, "bad_no_eval")
    os.makedirs(no_eval, exist_ok=True)
    clean_dir = os.path.join(workdir, "clean_one")
    bad_dir = os.path.join(workdir, "bad_one")
    for d in (clean_dir, bad_dir):
        os.makedirs(d, exist_ok=True)
        shutil.copy(src, os.path.join(d, "tr_0000.tfrecords"))
    bad = os.path.join(bad_dir, "tr_0000.tfrecords")
    frame, crc = _data_crc_offset(bad, BAD_RECORD_INDEX)
    with open(bad, "r+b") as fh:
        fh.seek(crc)
        b = fh.read(1)
        fh.seek(crc)
        fh.write(bytes([b[0] ^ 0xFF]))
    base = cfg.replace(task_type="train", num_epochs=1, val_data_dir=no_eval,
                       servable_model_dir="", verify_crc=True,
                       steps_per_loop=1)
    skip = base.replace(data_dir=bad_dir, on_bad_record="skip",
                        model_dir=os.path.join(workdir, "bad_skip"))
    pipe = tasks.make_pipeline(skip, [bad], drop_remainder=False)
    rows = sum(int(r["label"].shape[0]) for r in pipe)
    assert rows == n_file - 1 and pipe.health.bad_records == 1, (
        rows, pipe.health.snapshot())
    res = tasks.run(skip, device=dev)
    assert res["bad_records"] == 1 and res["steps"] == (
        (n_file - 1) // cfg.batch_size), res
    try:
        tasks.run(skip.replace(on_bad_record="raise", model_dir=os.path.join(
            workdir, "bad_raise")), device=dev)
        raise AssertionError("a corrupt record trained under raise")
    except IOError as exc:
        msg = str(exc)
    assert bad in msg and f"at byte {frame}" in msg, msg
    print(f"bad records: one flipped data-CRC byte (record "
          f"{BAD_RECORD_INDEX}) skipped under --verify_crc --on_bad_record "
          f"skip: {rows} of {n_file} records, bad_records="
          f"{res['bad_records']:.0f}, task completed {res['steps']:.0f} "
          f"steps; under raise: {msg!r}")

    clean = base.replace(data_dir=clean_dir,
                         model_dir=os.path.join(workdir, "fault_clean"))
    clean_files = [os.path.join(clean_dir, "tr_0000.tfrecords")]
    want = _emission_digest(tasks.make_pipeline(clean, clean_files), 8)[0]
    tasks.run(clean, device=dev)
    chunk = pipe_lib._NATIVE_CHUNK_BYTES
    # Reads of a quarter file: each pass reads the file in 4 + 1 calls.
    pipe_lib._NATIVE_CHUNK_BYTES = max(4096, os.path.getsize(src) // 4)
    os.environ[faults.READ_FAULT_ENV] = str(READ_FAULT_EVERY)
    try:
        fs = faults.install_env_faults()
        pipe = tasks.make_pipeline(clean, clean_files)
        got = _emission_digest(pipe, 8)[0]
        retries = pipe.health.read_retries
        assert got == want and retries == fs.injected_read_faults > 0, (
            got, want, retries, fs.injected_read_faults)
        flaky = clean.replace(model_dir=os.path.join(workdir, "fault_flaky"))
        res = tasks.run(flaky, device=dev)
    finally:
        del os.environ[faults.READ_FAULT_ENV]
        fileio.set_fault_injector(None)
        pipe_lib._NATIVE_CHUNK_BYTES = chunk
    a, b = _final_tables(clean, dev), _final_tables(flaky, dev)
    same = a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert same and res["read_retries"] > 0, res
    print(f"read faults: every {READ_FAULT_EVERY}rd read failed once "
          f"({faults.READ_FAULT_ENV}); the emission healed to the clean "
          f"run's ({retries} retries counted, {retries} injected) and the "
          f"train task healed to the clean task's tables "
          f"(read_retries={res['read_retries']:.0f}): {same}")


# ---------------------------------------------------------------------------
# The online trainer, pipe mode, the input service and the profiler window
# ---------------------------------------------------------------------------

# Train-while-serve: 16 shards of 4,096 records (the dense train files cut
# in two), 4 present at the start and one more every ONLINE_ARRIVAL_S; a
# version published every 8 steps; 6 client threads on the same card.
ONLINE_PER_SHARD, ONLINE_AT_START = 4096, 4
ONLINE_ARRIVAL_S = 0.3
ONLINE_PUBLISH_EVERY = 8
ONLINE_CLIENTS = 6
ONLINE_BASELINE_S = 3.0
# The online preempt/resume runs: two train files cut into 8 shards of
# 2,048 records, the back half hidden until after the preemption at step 5.
RESUME_PER_SHARD, RESUME_PREEMPT_AFTER = 2048, 5
INPUT_WORKERS = 2
PROFILE_STEPS = 8
# The layer spans of one dense DeepFM step (obs.trace).
STEP_SPANS = ("train.step", "embed.fwd", "fm.fwd", "tower.fwd", "train.loss",
              "train.backward", "embed.bwd", "fm.bwd", "train.optimizer")
# Names of the port's CUDA kernels in a torch.profiler trace.
PROFILED_KERNELS = ("fm_fwd", "fm_bwd_kernel", "segments_kernel",
                    "take_bwd")


def split_shards(files, out_dir: str, per_shard: int):
    """Cut TFRecord files into shards of ``per_shard`` whole frames each
    (byte ranges of the originals; the records and their order are
    unchanged). Returns the shard paths, in order."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for path in sorted(files):
        with open(path, "rb") as f:
            buf = f.read()
        offsets, lengths = tfr_loader.split_frames(buf, verify_crc=False)
        starts = [int(o) - 12 for o in offsets[::per_shard]] + [len(buf)]
        for i in range(len(starts) - 1):
            name = os.path.basename(path)[:-len(".tfrecords")]
            dst = os.path.join(out_dir, f"{name}_{i:02d}.tfrecords")
            with open(dst, "wb") as f:
                f.write(buf[starts[i]:starts[i + 1]])
            out.append(dst)
    return out


def _publish_checks(pdir: str, versions, final: int, cfg: Config,
                    dev) -> None:
    """No staging dir left; LATEST names the newest version; every version
    loads and answers finite probabilities."""
    names = os.listdir(pdir)
    assert not [n for n in names if n.startswith(".staging-")], names
    latest = export_lib.read_latest(pdir)
    assert latest is not None and os.path.basename(latest) == str(final), (
        latest, final)
    assert versions and versions[-1] == final, versions
    assert sorted(int(n) for n in names if n.isdigit()) == sorted(versions)
    probe = (np.zeros((2, cfg.field_size), np.int32),
             np.ones((2, cfg.field_size), np.float32))
    for v in versions:
        probs = export_lib.load_serving(os.path.join(pdir, str(v)),
                                        device=dev)(*probe)
        assert probs.shape == (2,) and np.all(np.isfinite(probs)), v
    hist = [e["version"] for e in export_lib.pointer_history(pdir)]
    assert hist == [str(v) for v in versions], (hist, versions)


class _Clients:
    """Client threads submitting requests of 1-256 rows until stopped;
    records each response's latency."""

    def __init__(self, engine, cfg: Config, n: int, seed: int):
        self.engine, self.cfg = engine, cfg
        self.stop = threading.Event()
        self.lat: list = []
        self.errors: list = []
        self.rows = 0
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._run,
                                          args=(seed + c,), daemon=True)
                         for c in range(n)]

    def _run(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        try:
            while not self.stop.is_set():
                n = int(rng.integers(1, cfg.serve_max_batch + 1))
                ids = rng.integers(0, cfg.feature_size,
                                   (n, cfg.field_size)).astype(np.int32)
                vals = rng.random((n, cfg.field_size), dtype=np.float32)
                fut = self.engine.submit(ids, vals)
                probs = fut.result(timeout=120)
                assert probs.shape == (n,) and np.all(np.isfinite(probs))
                with self._lock:
                    self.lat.append(fut.latency_ms)
                    self.rows += n
        except BaseException as e:  # re-raised on the main thread
            self.errors.append(e)

    def start(self) -> "_Clients":
        self.t0 = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def finish(self) -> dict:
        self.stop.set()
        for t in self._threads:
            t.join(timeout=120)
        wall = time.perf_counter() - self.t0
        if self.errors:
            raise self.errors[0]
        lat = np.asarray(self.lat)
        return {"requests": len(lat), "rows": self.rows, "wall_s": wall,
                "rps": len(lat) / wall,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99))}


def _no_eval_dir(workdir: str) -> str:
    """An empty eval directory (an empty one would fall back to the train
    directory's files)."""
    d = os.path.join(workdir, "no_eval")
    os.makedirs(d, exist_ok=True)
    return d


def online_phase(workdir: str, data: dict, cfg: Config, dev: torch.device,
                 per_shard: int = ONLINE_PER_SHARD,
                 arrival_s: float = ONLINE_ARRIVAL_S,
                 idle_s: float = 3.0):
    """The online trainer on the dense layout while ``serve_latest`` serves
    its versions on the same card: shards arrive in a directory during the
    run (temp name, then rename), a version is published every 8 steps,
    and client threads send requests the whole time. Checks the steps, the
    publish directory, the swaps, the final answer against the final
    version's artifact bit for bit, and the exact kernel launches of the
    training and the serving. Returns (train launches, serve launches)."""
    src = os.path.join(workdir, "online_src")
    shards = split_shards(_train_files(data), src, per_shard)
    assert len(shards) * per_shard == data["train"], len(shards)
    live = os.path.join(workdir, "online_data")
    os.makedirs(live)
    pdir = os.path.join(workdir, "online_publish")
    run = cfg.replace(task_type="train", data_dir=live,
                      val_data_dir=_no_eval_dir(workdir),
                      model_dir=os.path.join(workdir, "online_ckpt"),
                      pipe_mode=1, online_mode=True, num_epochs=1,
                      publish_every_steps=ONLINE_PUBLISH_EVERY,
                      publish_dir=pdir, stream_poll_secs=0.1,
                      stream_idle_timeout_secs=idle_s)
    steps = data["train"] // cfg.batch_size

    def arrive(path: str) -> None:
        tmp = os.path.join(live, "." + os.path.basename(path) + ".tmp")
        shutil.copy(path, tmp)
        os.replace(tmp, os.path.join(live, os.path.basename(path)))

    for path in shards[:ONLINE_AT_START]:
        arrive(path)
    errors: list = []
    box: dict = {}
    stop = threading.Event()

    def writer() -> None:
        try:
            for path in shards[ONLINE_AT_START:]:
                if stop.wait(arrival_s):
                    return
                arrive(path)
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    buckets = export_lib.serving_buckets(cfg.serve_max_batch)
    loader = (lambda path: export_lib.load_serving(path, buckets=buckets,
                                                   device=dev))

    def server() -> None:
        try:
            while export_lib.read_latest(pdir) is None:
                if stop.wait(0.02):
                    return
            engine = ServingEngine.serve_latest(
                pdir, poll_secs=0.1, max_batch=cfg.serve_max_batch,
                max_delay_ms=cfg.serve_max_delay_ms,
                inflight=cfg.serve_inflight, buckets=buckets,
                watcher_kw={"loader": loader})
            box["engine"] = engine
            box["clients"] = _Clients(engine, cfg, ONLINE_CLIENTS,
                                      SEED + 50).start()
        except BaseException as e:  # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=writer, daemon=True),
               threading.Thread(target=server, daemon=True)]
    _zero_counts()
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    try:
        res = tasks.run(run, device=dev)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    engine, clients = box["engine"], box["clients"]
    try:
        watcher = engine.watcher
        final = int(res["steps"])
        final_path = os.path.join(pdir, str(final))
        deadline = time.time() + 60
        while watcher.current_path != final_path:
            assert time.time() < deadline, (watcher.current_path, final_path)
            time.sleep(0.05)
        during = clients.finish()
        time.sleep(0.2)  # the last flush's stats land after its futures
        launches = _counts()
        flushes, warmed = engine.stats.flushes, watcher.prewarmed_buckets
        swaps = watcher.swap_count - 1  # the first load is not a swap
        serve_launches = flushes + warmed
        # The bit-for-bit check: one request alone in its flush, against
        # the final version's artifact loaded on its own, at one bucket.
        rng = np.random.default_rng(SEED + 60)
        n = 37
        ids = rng.integers(0, cfg.feature_size,
                           (n, cfg.field_size)).astype(np.int32)
        vals = rng.random((n, cfg.field_size), dtype=np.float32)
        served = engine.submit(ids, vals).result(timeout=60)
        want = export_lib.load_serving(final_path, buckets=buckets,
                                       device=dev)(ids, vals)
        bit_equal = bool(np.array_equal(served, want))
        assert bit_equal, float(np.abs(served - want).max())
        # The same server with no training on the card.
        idle = _Clients(engine, cfg, ONLINE_CLIENTS, SEED + 70).start()
        time.sleep(ONLINE_BASELINE_S)
        alone = idle.finish()
    finally:
        engine.close(timeout=60)
    assert res["steps"] == steps, res
    versions = res["published_versions"]
    _publish_checks(pdir, versions, final, cfg, dev)
    assert res["publish_failures"] == 0, res
    assert swaps >= 2, swaps
    on = int(dev.type == "cuda")
    train = {"fused_fm": on * steps, "fused_fm_bwd": on * steps,
             "plan_build": 0, "take_fwd": 0,
             "take_bwd": on * EMB_PARAMS * steps, "segments": on * steps,
             "install": 0}
    assert launches == {**train, "fused_fm": train["fused_fm"]
                        + on * serve_launches}, (launches, serve_launches)
    lat = res["publish_latencies_s"]
    print(f"online train-while-serve (dense, {len(shards)} shards x "
          f"{per_shard}, {ONLINE_AT_START} at start, one every "
          f"{arrival_s}s): steps={res['steps']:.0f} wall_s={wall:.2f} "
          f"examples_per_sec={res['examples_per_sec']:.1f} (fit's rate, "
          f"waits for arrivals included) published={versions} "
          f"skipped_busy={res['publish_skipped_inflight']} "
          f"publish_latency_p50_s={np.percentile(lat, 50):.4f} "
          f"publish_latency_max_s={max(lat):.4f} staleness_steps_max="
          f"{res['publish_staleness_steps_max']} swaps={swaps} "
          f"prewarmed_buckets={warmed}")
    print(f"online serve during training: requests={during['requests']} "
          f"rows={during['rows']} clients={ONLINE_CLIENTS} "
          f"rps={during['rps']:.1f} p50_ms={during['p50_ms']:.3f} "
          f"p99_ms={during['p99_ms']:.3f} flushes={flushes}; same server "
          f"with no training for {ONLINE_BASELINE_S}s: requests="
          f"{alone['requests']} rps={alone['rps']:.1f} p50_ms="
          f"{alone['p50_ms']:.3f} p99_ms={alone['p99_ms']:.3f}; final "
          f"answer bit-equal to load_serving({final}): {bit_equal}; "
          f"launches train={train} serve fused_fm={serve_launches}")
    return train, on * serve_launches


def _online_run(workdir: str, name: str, live: str, cfg: Config) -> Config:
    return cfg.replace(task_type="train", data_dir=live,
                       val_data_dir=_no_eval_dir(workdir),
                       model_dir=os.path.join(workdir, name), pipe_mode=1,
                       online_mode=True, num_epochs=1, publish_every_steps=4,
                       stream_poll_secs=0.05, stream_idle_timeout_secs=0.5)


def online_resume_phase(workdir: str, data: dict, cfg: Config,
                        dev: torch.device,
                        per_shard: int = RESUME_PER_SHARD) -> dict:
    """The online trainer preempted in process
    (``DEEPFM_TPU_TORCH_PREEMPT_AFTER_STEPS``) with half the shards not yet
    arrived, then resumed after they arrive: tables bit-identical to a
    clean online run over the final shard set. Then one online run on the
    hashed layout, so the plan and take kernels run on an online path.
    Returns the hashed run's launches."""
    src = os.path.join(workdir, "resume_src")
    shards = split_shards(_train_files(data)[:2], src, per_shard)
    steps = len(shards) * per_shard // cfg.batch_size
    half = len(shards) // 2
    live = os.path.join(workdir, "resume_data")
    clean_dir = os.path.join(workdir, "resume_clean_data")
    os.makedirs(live)
    os.makedirs(clean_dir)
    for path in shards:
        shutil.copy(path, clean_dir)
    for path in shards[:half]:
        shutil.copy(path, live)
    cut = _online_run(workdir, "resume_cut", live, cfg)
    os.environ[tasks.PREEMPT_AFTER_ENV] = str(RESUME_PREEMPT_AFTER)
    try:
        tasks.run(cut, device=dev)
        raise AssertionError("the preempted online run did not stop")
    except preempt_lib.Preempted as p:
        cut_step = p.step
    finally:
        del os.environ[tasks.PREEMPT_AFTER_ENV]
        preempt_lib.get_listener().clear()
    for path in shards[half:]:
        shutil.copy(path, live)
    res = tasks.run(cut, device=dev)
    clean = _online_run(workdir, "resume_clean", clean_dir, cfg)
    tasks.run(clean, device=dev)
    a, b = _final_tables(cut, dev), _final_tables(clean, dev)
    same = (a[0] == b[0] == steps == res["steps"]
            and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
            and torch.equal(a[2], b[2]))
    assert same, (a[0], b[0], res["steps"])
    print(f"online preempt/resume: preempted at step {cut_step} with "
          f"{half} of {len(shards)} shards arrived, resumed "
          f"to step {a[0]} after the rest arrived; tables and generator "
          f"bit-identical to a clean online run over the final shards: "
          f"{same}")

    hashed = _online_run(workdir, "resume_hashed", clean_dir,
                         cfg.replace(**SPARSE_LAYOUTS["sparse_hashed"]))
    _zero_counts()
    res = tasks.run(hashed, device=dev)
    launches = _counts()
    on = int(dev.type == "cuda")
    want = {"fused_fm": on * steps, "fused_fm_bwd": on * steps,
            "plan_build": on * steps,
            "take_fwd": on * EMB_PARAMS * steps,
            "take_bwd": on * EMB_PARAMS * steps, "segments": on * steps,
            "install": 0}
    assert res["steps"] == steps and launches == want, (res, launches)
    print(f"online hashed: steps={res['steps']:.0f} published="
          f"{res['published_versions']} launches={launches}")
    return launches


def pipe_phase(workdir: str, data: dict, cfg: Config, dev: torch.device,
               file_eps: float) -> dict:
    """A dense ``--pipe_mode 1`` task, two epochs over the train files
    replayed by the producer, one eval at the end: steps and exact
    launches, and its rate beside the file-mode dense task's."""
    run = cfg.replace(task_type="train", data_dir=data["dir"],
                      val_data_dir=data["dir"], pipe_mode=1,
                      num_epochs=TRAIN_EPOCHS,
                      model_dir=os.path.join(workdir, "pipe_ckpt"))
    steps = TRAIN_EPOCHS * (data["train"] // cfg.batch_size)
    eval_batches = -(-data["eval"] // cfg.batch_size)
    _zero_counts()
    res = tasks.run(run, device=dev)
    launches = _counts()
    on = int(dev.type == "cuda")
    want = {"fused_fm": on * (steps + eval_batches),
            "fused_fm_bwd": on * steps, "plan_build": 0, "take_fwd": 0,
            "take_bwd": on * EMB_PARAMS * steps, "segments": on * steps,
            "install": 0}
    assert res["steps"] == steps and launches == want, (res, launches)
    assert res["auc"] > 0.5, res
    print(f"train pipe_mode (dense, {TRAIN_EPOCHS} epochs in one stream): "
          f"steps={res['steps']:.0f} examples_per_sec="
          f"{res['examples_per_sec']:.1f} (file mode, the dense task "
          f"above: {file_eps:.1f}) auc={res['auc']:.5f} launches={launches}")
    return launches


def input_service_phase(workdir: str, data: dict, cfg: Config,
                        dev: torch.device) -> dict:
    """A dense task with ``--input_workers 2`` against ``--input_workers
    0`` on the same files (one epoch, no eval): tables bit-identical,
    launches equal, the rates of both; then a run whose input workers each
    crash (``os._exit``) after two slabs under the ``respawn`` policy, also
    bit-identical."""
    base = cfg.replace(task_type="train", data_dir=data["dir"],
                       val_data_dir=_no_eval_dir(workdir), num_epochs=1)
    steps = data["train"] // cfg.batch_size
    runs = {}
    orig = tasks.make_pipeline

    def crashing(*a, **k):
        pipe = orig(*a, **k)
        pipe.input_worker_death = "respawn"
        pipe.input_worker_fault_die_after = 2
        return pipe

    for name, workers, make in (("inproc", 0, orig),
                                ("workers", INPUT_WORKERS, orig),
                                ("respawn", INPUT_WORKERS, crashing)):
        run = base.replace(input_workers=workers,
                           model_dir=os.path.join(workdir, "svc_" + name))
        _zero_counts()
        tasks.make_pipeline = make
        try:
            res = tasks.run(run, device=dev)
        finally:
            tasks.make_pipeline = orig
        runs[name] = (res, _counts(), _final_tables(run, dev))
        assert res["steps"] == steps, res
    ref = runs["inproc"]
    for name in ("workers", "respawn"):
        res, launches, tables = runs[name]
        same = (tables[0] == ref[2][0]
                and all(torch.equal(tables[1][k], ref[2][1][k])
                        for k in tables[1]))
        assert same and launches == ref[1], (name, launches, ref[1])
    print(f"input service: examples_per_sec in-process="
          f"{ref[0]['examples_per_sec']:.1f} input_workers={INPUT_WORKERS}: "
          f"{runs['workers'][0]['examples_per_sec']:.1f} with a worker "
          f"crash per worker under respawn: "
          f"{runs['respawn'][0]['examples_per_sec']:.1f}; tables "
          f"bit-identical and launches equal ({ref[1]}) on all three")
    return runs["workers"][1]


def profiler_phase(workdir: str, data: dict, cfg: Config,
                   dev: torch.device) -> None:
    """A short dense task with ``--profile_dir`` (and ``--tensorboard_dir``):
    the Chrome trace of its step window holds the port's CUDA kernels."""
    prof = os.path.join(workdir, "profile")
    tb = os.path.join(workdir, "tb")
    run = cfg.replace(task_type="train", data_dir=data["dir"],
                      val_data_dir=data["dir"], num_epochs=1,
                      profile_dir=prof, profile_steps=PROFILE_STEPS,
                      tensorboard_dir=tb, log_steps=16,
                      model_dir=os.path.join(workdir, "prof_ckpt"))
    tasks.run(run, device=dev)
    traces = [f for f in os.listdir(prof) if f.endswith(".json")]
    assert len(traces) == 1, traces
    with open(os.path.join(prof, traces[0]), encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    found = {k: sum(k in n for n in kernels) for k in PROFILED_KERNELS}
    if dev.type == "cuda":
        assert all(found.values()), (found, sorted(kernels)[:40])
    tb_files = (os.listdir(tb) if os.path.isdir(tb) else [])
    # One step under the span tracer: each layer span of the step, timed
    # on the card.
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    batch = trainer.put_batch(random_batches(cfg, 1, SEED)[0])
    trace_lib.configure("full", export_env=False)
    try:
        trainer.train_step(state, batch)
        spans_path = trace_lib.export(os.path.join(workdir, "spans.json"))
    finally:
        trace_lib.reset()
    with open(spans_path, encoding="utf-8") as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    dev_ms = {}
    for e in spans:
        if dev.type == "cuda":
            assert "dev_dur" in e["args"], e
            dev_ms[e["name"]] = (dev_ms.get(e["name"], 0.0)
                                 + e["args"]["dev_dur"] / 1e3)
    assert set(STEP_SPANS) <= {e["name"] for e in spans}, spans
    print(f"profiler: {traces[0]} holds {len(events)} events, "
          f"{len(kernels)} distinct kernels; the port's: {found}; "
          f"TensorBoard summaries: "
          f"{'written' if tb_files else 'disabled (tensorboard not importable)'}"
          f" ({len(tb_files)} event files); step spans (device ms): "
          + ", ".join(f"{n} {dev_ms.get(n, float('nan')):.3f}"
                      for n in STEP_SPANS))


# ---------------------------------------------------------------------------
# The model zoo
# ---------------------------------------------------------------------------

# Every model of the registry beside DeepFM and the three multi-task heads,
# at the reference width (Config() defaults: V=117,581, F=39, K=32, tower
# 128-64-32, bfloat16 tower math): DCN-v2 with its default 3 full-rank
# cross layers over D = 39 * 32 = 1,248; DLRM with a top input of 1,248 +
# 741 pairwise dots = 1,989; MMoE with 4 experts; DIN and BST over 20
# history positions (the JAX pipeline's default length).
ZOO = {
    "widedeep": dict(model="widedeep"),
    "dcnv2": dict(model="dcnv2"),
    "dlrm": dict(model="dlrm"),
    "shared_bottom": dict(tasks="ctr,cvr", multitask="shared_bottom"),
    "mmoe": dict(tasks="ctr,cvr", multitask="mmoe", mmoe_experts=4),
    "esmm": dict(tasks="ctr,cvr", multitask="esmm"),
    "din": dict(model="din", history_max_len=20),
    "bst": dict(model="bst", history_max_len=20),
}
# Records of the sequence models carry 0..30 history ids: some none, some
# more than the 20 columns (truncated).
ZOO_HISTORY_IDS = 30
# Each input kind at the train phases' size: 64 Ki train records (two
# epochs of 64 steps at B = 1,024, an eval after each) and 8 Ki eval
# records; the plain kind is the train phases' own data. (After 32 steps
# the eval AUC lies too close to 0.5 to tell a model that learns from one
# that does not; a larger lr on fewer records makes the models memorise.)
ZOO_FILES, ZOO_PER_FILE, ZOO_EVAL = TRAIN_FILES, TRAIN_PER_FILE, EVAL_RECORDS
ZOO_EPOCHS = TRAIN_EPOCHS
# The multi-task head that also trains on the tier.
ZOO_TIERED = "mmoe"
# Card against CPU: 16 steps at B = 256 from one init on the same batches,
# dropout off, float32 tower math (bfloat16 rounds the tower's GEMM
# outputs, whose sum order differs between cuBLAS and the CPU's BLAS, into
# ulp flips that Adam's normalized step carries). Left are float32 sums in
# another order (the FM kernel against the plain formula, cuBLAS against
# the CPU's GEMMs): the losses within 1e-4. The embedding tables are held
# by the norm of their difference against the norm of their movement from
# the init, within 10%, and their max |difference| is printed: Adam moves
# an element whose gradient is near zero by up to lr a step in the
# direction of its sign, so a float32 reassociation flips such elements.
# DIN has many: on the CPU alone, float32-rounding noise on one tower
# matrix moves a few percent of its fm_v elements by more than lr / 5,
# where Wide&Deep's stay within 1e-5 of their movement; DIN on an H100
# 80GB HBM3 (700 W) against the CPU: 6.9% of the movement's norm.
ZOO_PARITY_STEPS, ZOO_PARITY_BATCH = 16, 256
ZOO_PARITY_LOSS_ATOL, ZOO_PARITY_TABLE_REL = 1e-4, 0.1
ZOO_REQUESTS, ZOO_CLIENTS = 48, 4


def _zoo_kind(cfg: Config) -> str:
    if cfg.num_tasks > 1:
        return "two_label"
    return "history" if cfg.history_max_len > 0 else "plain"


def make_zoo_data(workdir: str, cfg: Config, kind: str) -> dict:
    """One input kind's TFRecords (the port's generator, byte-identical to
    the JAX package's): plain records, records with ``label2``, or records
    with a ragged history of 0..ZOO_HISTORY_IDS ids."""
    data = os.path.join(workdir, f"zoo_{kind}")
    kw = {"two_label": dict(num_labels=2),
          "history": dict(history=ZOO_HISTORY_IDS)}.get(kind, {})
    t0 = time.perf_counter()
    libsvm.generate_synthetic_ctr(
        data, num_files=ZOO_FILES, examples_per_file=ZOO_PER_FILE,
        feature_size=cfg.feature_size, field_size=cfg.field_size,
        seed=SEED, **kw)
    libsvm.generate_synthetic_ctr(
        data, num_files=1, examples_per_file=ZOO_EVAL,
        feature_size=cfg.feature_size, field_size=cfg.field_size,
        seed=SEED + 1, prefix="va", **kw)
    shutil.copy(os.path.join(data, "va_0000.tfrecords"),
                os.path.join(data, "te_0000.tfrecords"))
    extra = ""
    if kind == "history":
        with open(os.path.join(data, "va_0000.tfrecords"), "rb") as f:
            buf = f.read()
        offs, lens = tfr_loader.split_frames(buf)
        n_hist = tfr_loader.decode_spans_hist(
            buf, offs, lens, cfg.field_size, ZOO_HISTORY_IDS)[5]
        empty, over = int((n_hist == 0).sum()), int((n_hist > 20).sum())
        assert empty and over, (empty, over)
        extra = (f"; eval histories: {empty} empty, {over} longer than 20 "
                 f"ids, {int(n_hist.max())} at most")
    print(f"zoo data {kind}: {ZOO_FILES * ZOO_PER_FILE} train + {ZOO_EVAL} "
          f"eval records written in {time.perf_counter() - t0:.1f}s{extra}")
    return {"dir": data, "train": ZOO_FILES * ZOO_PER_FILE,
            "eval": ZOO_EVAL}


def zoo_batches(cfg: Config, n: int, seed: int):
    """``random_batches`` with a ``label2`` column (multi-task) or ragged
    ``hist_ids``/``hist_mask`` columns (0..L real positions, some empty)."""
    out = random_batches(cfg, n, seed)
    rng = np.random.default_rng(seed + 1)
    for b in out:
        bs = b["label"].shape[0]
        if cfg.num_tasks > 1:
            b["label2"] = b["label"] * (rng.random((bs, 1)) < 0.3).astype(
                np.float32)
        if cfg.history_max_len > 0:
            ln = cfg.history_max_len
            real = rng.integers(0, ln + 1, bs)
            mask = (np.arange(ln)[None, :] < real[:, None]).astype(np.float32)
            b["hist_mask"] = mask
            b["hist_ids"] = (rng.integers(0, cfg.feature_size, (bs, ln))
                             * mask).astype(np.int32)
    return out


def _zoo_expected(cfg: Config, steps: int, eval_batches: int, epochs: int,
                  plans: int) -> dict:
    """Each kernel's launches over a zoo train task on the card. The FM
    kernels run only where the graph has the FM block (DeepFM's path: DIN
    and BST), once per step and eval batch. The dense lookups sum one take
    backward per looked-up name (DCN-v2 never reads fm_w) and DIN/BST's
    history lookup one more, over segments built once per index (the
    features' and the history's); the hashed update plans once a step and
    takes once per looked-up name; the tier's fused leg sums all names in
    one take backward and installs once per plan."""
    fm = int(cfg.model in ("deepfm", "din", "bst") and cfg.num_tasks == 1)
    hist = int(cfg.model in ("din", "bst") and cfg.num_tasks == 1)
    looked_up = 1 if (cfg.model == "dcnv2" and cfg.num_tasks == 1) \
        else EMB_PARAMS
    want = {"fused_fm": fm * (steps + epochs * eval_batches),
            "fused_fm_bwd": fm * steps, "plan_build": 0, "take_fwd": 0,
            "take_bwd": (looked_up + hist) * steps,
            "segments": (1 + hist) * steps, "install": 0}
    if cfg.embedding_update == "sparse" and cfg.embedding_bucket_sizes:
        want.update(plan_build=steps, take_fwd=looked_up * steps,
                    take_bwd=looked_up * steps, segments=steps)
    elif cfg.embedding_update == "sparse":
        want.update(take_bwd=steps, segments=steps, install=plans)
    return want


def _zoo_inputs(cfg: Config, n: int, rng):
    """Serving inputs: F columns, or F + L packed ones (ids feat_ids ||
    hist_ids, vals feat_vals || hist_mask) with ragged histories."""
    ids = rng.integers(0, cfg.feature_size, (n, cfg.field_size)
                       ).astype(np.int32)
    vals = rng.random((n, cfg.field_size), dtype=np.float32)
    ln = cfg.history_max_len if cfg.model in ("din", "bst") else 0
    if ln:
        real = rng.integers(0, ln + 1, n)
        mask = (np.arange(ln)[None, :] < real[:, None]).astype(np.float32)
        hist = (rng.integers(0, cfg.feature_size, (n, ln)) * mask
                ).astype(np.int32)
        ids, vals = np.hstack([ids, hist]), np.hstack([vals, mask])
    return ids, vals


def _zoo_plain_probs(model, cfg: Config, ids, vals, dev):
    """The plain forward (``use_pallas=False``) of an artifact's model on
    packed inputs: [n] or {task: [n]}."""
    i = torch.from_numpy(ids).to(dev)
    v = torch.from_numpy(vals).to(dev)
    kw = {}
    f = cfg.field_size
    if i.shape[1] > f:
        kw = {"hist_ids": i[:, f:], "hist_mask": v[:, f:]}
        i, v = i[:, :f], v[:, :f]
    with torch.inference_mode():
        p = torch.sigmoid(model(i, v, **kw)).cpu().numpy()
    if p.ndim == 2:
        return {t: p[:, j] for j, t in enumerate(model.task_names)}
    return p


def _zoo_serve(servable: str, step: int, cfg: Config, dev: torch.device,
               name: str) -> dict:
    """Publish the exported version behind ``LATEST``, serve requests of
    1-256 rows from several clients through ``serve_latest`` and hold every
    response against the artifact's plain forward; the FM kernel launches
    once per flush where the graph has it."""
    export_lib.write_latest(servable, str(step))
    artifact = os.path.join(servable, str(step))
    buckets = export_lib.serving_buckets(cfg.serve_max_batch)
    engine = ServingEngine.serve_latest(
        servable, max_batch=cfg.serve_max_batch,
        max_delay_ms=cfg.serve_max_delay_ms, inflight=cfg.serve_inflight,
        buckets=buckets, watcher_kw={"loader": lambda path: (
            export_lib.load_serving(path, buckets=buckets, device=dev))})
    rng = np.random.default_rng(SEED + 21)
    requests = [_zoo_inputs(cfg, int(n), rng)
                for n in rng.choice(REQUEST_SIZES, size=ZOO_REQUESTS)]
    results = [None] * len(requests)
    errors = []
    try:
        fused_fm.launches = 0  # the watcher's warm-up ran already

        def client(c):
            try:
                for j in range(c, len(requests), ZOO_CLIENTS):
                    fut = engine.submit(*requests[j])
                    results[j] = (fut.result(timeout=300), fut.latency_ms)
            except BaseException as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(ZOO_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches, flushes = fused_fm.launches, engine.stats.flushes
    finally:
        engine.close(timeout=60)
    if errors:
        raise errors[0]
    plain = export_lib.load_model(artifact, device=dev, use_pallas=False)[0]
    err = 0.0
    for (ids, vals), (got, _) in zip(requests, results):
        want = _zoo_plain_probs(plain, cfg, ids, vals, dev)
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), (name, sorted(got))
            pairs = [(got[t], want[t]) for t in want]
        else:
            pairs = [(got, want)]
        for g, w in pairs:
            assert g.shape == (ids.shape[0],) and np.all(np.isfinite(g))
            err = max(err, float(np.abs(g - w).max()))
    assert err <= SERVE_ATOL, (name, err)
    fm = cfg.model in ("din", "bst") and cfg.num_tasks == 1
    assert launches == (flushes if fm and dev.type == "cuda" else 0), (
        name, launches, flushes)
    lat = np.array([r[1] for r in results])
    print(f"zoo {name} serve (serve_latest): {len(requests)} requests "
          f"{sum(int(r[0].shape[0]) for r in requests)} rows, input width "
          f"{requests[0][0].shape[1]}, {flushes} flushes, fused_fm launches "
          f"{launches}, p50_ms={np.percentile(lat, 50):.3f} "
          f"p99_ms={np.percentile(lat, 99):.3f} wall_s={wall:.3f} "
          f"max_abs_err_vs_plain={err:.3e} (atol {SERVE_ATOL})")
    return artifact


# DIN/BST's history lookup at B = 1,024 and L = 20: 20,480 positions of
# fm_v (padded positions at id 0, a long run), a second index beside the
# features' 39,936.
HISTORY_N = 1024 * 20


def history_kernels_phase() -> dict:
    """The history lookup's kernels at their main-path shape: the segments
    build of its ids (bit-equal to the plain version and the numpy oracle;
    time, events, bound) and ``ek.segment_sum`` at fm_v's width (the
    lookup's backward: one segments launch and one take backward, bit-equal
    to the oracle; time beside ``index_add_``)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 70)
    real = rng.integers(0, 21, 1024)
    mask = np.arange(20)[None, :] < real[:, None]
    ids_np = (rng.integers(0, MONO_ROWS - 51, (1024, 20)) * mask).reshape(
        1, HISTORY_N).astype(np.int64)
    _check_segments("din_history", ids_np, [MONO_ROWS], None)
    ids = torch.from_numpy(ids_np).to(dev)
    out = {"segments": segments_time("din_history", ids, [MONO_ROWS], None)}
    out["segment_sum"] = segment_sum_phase(
        n=HISTORY_N, cases=(("din_history_fm_v", 32, MONO_ROWS),),
        ids=ids[0], long_runs=True)
    return out


def zoo_task_phase(workdir: str, data: dict, cfg: Config, dev: torch.device,
                   name: str, full: bool = True):
    """One zoo model through the launcher: train (an eval after each
    epoch), and with ``full`` eval, infer, export and serving. Returns
    ({kernel: launches in the train task}, the artifact or None)."""
    run_dir = os.path.join(workdir, "zoo_" + name)
    cfg = cfg.replace(data_dir=data["dir"], val_data_dir=data["dir"],
                      model_dir=os.path.join(run_dir, "ckpt"),
                      servable_model_dir="", num_epochs=ZOO_EPOCHS)
    steps = ZOO_EPOCHS * (data["train"] // cfg.batch_size)
    eval_batches = -(-data["eval"] // cfg.batch_size)
    on = int(dev.type == "cuda")
    loss_log = _LossLog()
    loop_log = logging.getLogger("deepfm_tpu_torch.train.loop")
    loop_log.addHandler(loss_log)
    loop_log.setLevel(logging.INFO)
    _zero_counts()
    t0 = time.perf_counter()
    try:
        res = launch_task(cfg, "train", dev)
    finally:
        loop_log.removeHandler(loss_log)
    wall = time.perf_counter() - t0
    launches = _counts()
    plans = int(res.get("hotcold_plans", 0))
    want = {k: on * v for k, v in _zoo_expected(
        cfg, steps, eval_batches, ZOO_EPOCHS, plans).items()}
    aucs = {k: round(v, 5) for k, v in res.items() if k.startswith("auc")}
    print(f"zoo {name} train (launcher): steps={res['steps']:.0f} "
          f"wall_s={wall:.2f} examples_per_sec="
          f"{res.get('examples_per_sec', 0):.1f} final_loss="
          f"{res['loss']:.5f} {aucs} eval_loss={res['eval_loss']:.5f} "
          f"launches={launches} logged losses: " + " ".join(
              f"{s}:{l:.4f}" for s, l in loss_log.losses))
    assert res["steps"] == steps and np.isfinite(res["loss"]), res
    assert all(np.isfinite(l) for _, l in loss_log.losses)
    assert res["auc"] > 0.5, res
    if cfg.num_tasks > 1:
        assert set(aucs) == {"auc", "auc_ctr", "auc_cvr"}, aucs
    if cfg.embedding_tiering == "hot_cold":
        assert plans == steps and res["hotcold_installs"] > 0, res
    assert launches == want, (name, launches, want)
    if not full:
        return launches, None

    _zero_counts()
    ev = launch_task(cfg, "eval", dev)
    assert abs(ev["auc"] - res["auc"]) < 1e-3, (ev, res)
    assert _counts() == {**{k: 0 for k in want}, "fused_fm": (
        want["fused_fm"] - want["fused_fm_bwd"]) // ZOO_EPOCHS}, _counts()
    inf = launch_task(cfg, "infer", dev)
    assert inf["num_predictions"] == data["eval"], inf
    preds = np.loadtxt(os.path.join(data["dir"], "pred.txt"))
    assert preds.shape == ((data["eval"], 2) if cfg.num_tasks > 1
                           else (data["eval"],)), preds.shape
    assert np.all((preds > 0) & (preds < 1))
    servable = os.path.join(run_dir, "servable")
    out = launch_task(cfg.replace(servable_model_dir=servable), "export",
                      dev)
    assert out["step"] == steps, out
    with open(os.path.join(servable, str(steps), "model_config.json")) as f:
        meta = json.load(f)
    hist = cfg.history_max_len if cfg.model in ("din", "bst") else 0
    assert meta["history_len"] == hist and meta["signature"]["inputs"][
        "feat_ids"][1] == cfg.field_size + hist, meta["signature"]
    assert list(meta["signature"]["outputs"]) == (
        list(cfg.task_names) if cfg.num_tasks > 1 else ["prob"])
    print(f"zoo {name} eval (launcher): auc={ev['auc']:.5f} loss="
          f"{ev['loss']:.5f}; infer: {inf['num_predictions']:.0f} "
          f"predictions of shape {preds.shape[1:] or '()'}; export step "
          f"{out['step']:.0f}: outputs {list(meta['signature']['outputs'])},"
          f" history_len {meta['history_len']}")
    artifact = _zoo_serve(servable, steps, cfg, dev, name)
    return launches, artifact


def zoo_parity_phase(cfg: Config, dev: torch.device, name: str,
                     steps: int = ZOO_PARITY_STEPS) -> None:
    """The card against the CPU (the plain versions) from one init on the
    same batches: per-step losses and the final embedding tables."""
    pcfg = cfg.replace(dropout="1.0,1.0,1.0", compute_dtype="float32",
                       batch_size=ZOO_PARITY_BATCH)
    batches = zoo_batches(pcfg, steps, SEED + 13)
    cpu = Trainer(pcfg, device="cpu")
    sc = cpu.init_state(SEED)
    init = {k: v.detach().clone() for k, v in sc.params.items()}
    card = Trainer(pcfg, device=dev)
    sd = card.load_weights(card.init_state(SEED),
                           {k: v.detach() for k, v in sc.params.items()},
                           dict(sc.model_state))
    lc, ld = [], []
    t0 = time.perf_counter()
    for b in batches:
        sc, mc = cpu.train_step(sc, cpu.put_batch(b))
        sd, md = card.train_step(sd, card.put_batch(b))
        lc.append(float(mc["loss"]))
        ld.append(float(md["loss"]))
    dl = float(np.abs(np.array(lc) - np.array(ld)).max())
    tables = [k for k in sc.params if k.split(".")[0] in ("fm_w", "fm_v")]
    diff = [sc.params[k].detach() - sd.params[k].detach().cpu()
            for k in tables]
    moved = [sc.params[k].detach() - init[k] for k in tables]
    dt = max(float(d.abs().max()) for d in diff)
    rel = float(torch.sqrt(sum((d * d).sum() for d in diff))
                / torch.sqrt(sum((m * m).sum() for m in moved)))
    flipped = sum(int((d.abs() > pcfg.learning_rate / 5).sum())
                  for d in diff)
    print(f"zoo {name} card vs cpu: {steps} steps B={pcfg.batch_size} "
          f"float32 tower, dropout off: max |loss diff| {dl:.3e} (atol "
          f"{ZOO_PARITY_LOSS_ATOL}); tables: max |diff| {dt:.3e}, "
          f"|diff| / |movement| {rel:.3e} (at most "
          f"{ZOO_PARITY_TABLE_REL}), {flipped} elements past lr / 5; loss "
          f"{ld[0]:.5f} -> {ld[-1]:.5f}; {time.perf_counter() - t0:.1f}s")
    assert np.all(np.isfinite(ld)) and dl <= ZOO_PARITY_LOSS_ATOL, (
        name, lc, ld)
    assert rel <= ZOO_PARITY_TABLE_REL, (name, rel, dt)


def zoo_timing(cfg: Config, name: str, artifact: str) -> None:
    """One line per model: the B = 1,024 train step (CUDA events over
    back-to-back steps, device busy time from the profiler) and the
    B = 256 forward of its artifact, beside the card's name and limit."""
    dev = torch.device("cuda")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(SEED)
    batch = trainer.put_batch(zoo_batches(cfg, 1, SEED + 11)[0])
    step = lambda: trainer.train_step(state, batch)  # noqa: E731
    step_ms = cuda_ms(step, iters=30, warmup=5)
    step_busy = profiled_ms(step, iters=10)
    model = export_lib.load_model(artifact, device=dev)[0]
    ids, vals = _zoo_inputs(cfg, cfg.serve_max_batch,
                            np.random.default_rng(SEED + 1))
    i = torch.from_numpy(ids).to(dev)
    v = torch.from_numpy(vals).to(dev)
    f = cfg.field_size
    kw = {}
    if i.shape[1] > f:
        kw = {"hist_ids": i[:, f:].contiguous(),
              "hist_mask": v[:, f:].contiguous()}
        i, v = i[:, :f].contiguous(), v[:, :f].contiguous()
    with torch.inference_mode():
        fwd = lambda: model(i, v, **kw)  # noqa: E731
        fwd_ms = cuda_ms(fwd, iters=100)
        fwd_busy = profiled_ms(fwd, iters=20)
    print(f"zoo timing {name}: train step B={cfg.batch_size} step_ms="
          f"{step_ms:.4f} device_busy_ms={ms(step_busy)}; forward "
          f"B={cfg.serve_max_batch} call_ms={fwd_ms:.4f} device_busy_ms="
          f"{ms(fwd_busy)} ({card_line()})")


def zoo_phase(workdir: str, cfg: Config, dev: torch.device,
              plain: dict = None) -> dict:
    """Every zoo model at the reference width: its tasks through the
    launcher and serving; the non-history ones once more on the sparse
    hashed layout and one multi-task head on the tier; each held on the
    card against the CPU; then the per-model timings. ``plain``: the train
    phases' data, reused for the single-label models. Returns {path:
    {kernel: launches}}."""
    data = {} if plain is None else {"plain": plain}
    paths = {}
    artifacts = {}
    for name, kw in ZOO.items():
        zcfg = cfg.replace(**kw)
        kind = _zoo_kind(zcfg)
        if kind not in data:
            data[kind] = make_zoo_data(workdir, cfg, kind)
        paths["zoo_" + name], artifacts[name] = zoo_task_phase(
            workdir, data[kind], zcfg, dev, name)
        if kind != "history":
            paths[f"zoo_{name}_sparse_hashed"] = zoo_task_phase(
                workdir, data[kind], zcfg.replace(
                    **SPARSE_LAYOUTS["sparse_hashed"]), dev,
                name + "_sparse_hashed", full=False)[0]
        if name == ZOO_TIERED:
            paths[f"zoo_{name}_sparse_tiered"] = zoo_task_phase(
                workdir, data[kind], zcfg.replace(**TIERED), dev,
                name + "_sparse_tiered", full=False)[0]
        zoo_parity_phase(zcfg, dev, name)
    if dev.type == "cuda":
        for name, kw in ZOO.items():
            zoo_timing(cfg.replace(**kw), name, artifacts[name])
    return paths, artifacts, data


# ---------------------------------------------------------------------------
# Retrieval: twin tower, candidate index, the retrieve→rank cascade
# ---------------------------------------------------------------------------

# The bench's cascade series (bench.py:1448, :1503): 50 candidates ranked
# to 10; the ANN at its default P = floor(sqrt(V)) = 342, nprobe = P // 4 =
# 85, and at P = 32, nprobe = 16.
RETRIEVE_K, RANK_K = 50, 10
ANN_SMALL = (32, 16)
# The bench's engine (bench.py:1530-1531): flushes of up to 64 rows, a
# 1 ms batching deadline.
CASCADE_MAX_BATCH, CASCADE_DELAY_MS = 64, 1.0
# The card's staged answers against the CPU's on a float32 ranker.
CASCADE_CPU_ATOL = 1e-5
RECALL_QUERIES = 256
CASCADE_REQUESTS = 32    # fused against staged, bit for bit
CASCADE_TIMED = 200      # sequential recommend calls timed per path
CASCADE_BATCH = 64       # recommend_batch users
CASCADE_CPU_REQUESTS = 16
# A swapped-in v2 ranker: the v1 weights with fm_b moved by this much, so
# every answer after the swap differs from v1's.
V2_BIAS = 0.25


def _history_pipe(cfg: Config, files, epochs: int, batch: int):
    return pipe_lib.CtrPipeline(
        files, field_size=cfg.field_size, batch_size=batch,
        num_epochs=epochs, shuffle=False, history=True,
        history_max_len=cfg.history_max_len)


def _cascade_requests(batch: dict, n: int):
    """Single-user requests from eval records (every fourth with its
    history emptied): (hist_ids [L], hist_mask [L], feat_ids [F],
    feat_vals [F])."""
    out = []
    for i in range(n):
        mask = batch["hist_mask"][i].copy()
        ids = batch["hist_ids"][i].copy()
        if i % 4 == 3:
            mask[:] = 0.0
            ids[:] = 0
        out.append((ids, mask, batch["feat_ids"][i].copy(),
                    batch["feat_vals"][i].copy()))
    assert any(not r[1].any() for r in out)
    return out


def _cascade_engine(publish_dir: str, dev, **kw) -> CascadeEngine:
    return CascadeEngine(publish_dir, retrieve_k=RETRIEVE_K,
                         max_batch=CASCADE_MAX_BATCH,
                         max_delay_ms=CASCADE_DELAY_MS,
                         watcher_kw={"poll_secs": 3600, "start": False},
                         device=dev, **kw)


def _check_answers(answers, k: int) -> None:
    for items, probs in answers:
        assert items.shape == (k,) and probs.shape == (k,)
        assert len(set(map(int, items))) == k
        assert np.all(np.isfinite(probs)) and np.all(
            (probs >= 0) & (probs <= 1)), probs
        assert np.all(np.diff(probs) <= 0)


def _same_answers(a, b) -> bool:
    return all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))


def _timed_recommend(engine: CascadeEngine, reqs, n: int):
    """(p50 ms, p99 ms, requests/s) of ``n`` sequential recommend calls."""
    for r in reqs[:4]:
        engine.recommend(*r, k=RANK_K)
    lat = []
    t0 = time.perf_counter()
    for i in range(n):
        t = time.perf_counter()
        engine.recommend(*reqs[i % len(reqs)], k=RANK_K)
        lat.append(1000.0 * (time.perf_counter() - t))
    wall = time.perf_counter() - t0
    return (float(np.percentile(lat, 50)), float(np.percentile(lat, 99)),
            n / wall)


def twin_tower_phase(cfg: Config, dev: torch.device, files) -> tuple:
    """``train_twin_tower`` over the zoo's history records (two epochs at
    B = 1,024) with exact launch counts: a segments launch and a take
    backward per lookup (the history's and the positive items') per step.
    Then one step's call and device time, and the take backward at the
    history lookup's shape beside its bound and ``index_add_``. Returns
    (tower, launches, timing)."""
    t0 = time.perf_counter()
    batches = list(_history_pipe(cfg, files, ZOO_EPOCHS, cfg.batch_size))
    decode_s = time.perf_counter() - t0
    steps = len(batches)
    _zero_counts()
    t0 = time.perf_counter()
    tower, stats = train_twin_tower(cfg, batches, item_slot=ITEM_SLOT,
                                    seed=SEED, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    on = int(dev.type == "cuda")
    want = {k: 0 for k in launches}
    want.update(take_bwd=2 * steps * on, segments=2 * steps * on)
    assert launches == want, (launches, want)
    assert stats["steps"] == steps and stats["positive_rows"] > 0, stats
    assert np.isfinite(stats["first_loss"]) and np.isfinite(stats["loss"])
    rate = steps * cfg.batch_size / wall
    timing = {"steps": steps, "examples_per_sec": rate,
              "first_loss": stats["first_loss"], "loss": stats["loss"]}
    line = (f"retrieval twin tower: train_twin_tower {steps} steps "
            f"B={cfg.batch_size} D={cfg.embedding_size} MLPs "
            f"{cfg.embedding_size}->{2 * cfg.embedding_size}->"
            f"{cfg.embedding_size} wall_s={wall:.3f} examples_per_sec="
            f"{rate:.1f} (batches decoded beforehand in {decode_s:.2f}s) "
            f"loss {stats['first_loss']:.5f} -> {stats['loss']:.5f}, "
            f"positive rows {stats['positive_rows']:.0f}; launches "
            f"{launches}")
    if dev.type != "cuda":
        print(line)
        return tower, launches, timing
    # One step's time on a tower of its own (the trained one is the
    # index's): the loop's own sync included (float(loss)).
    probe = TwinTower(cfg, device=dev)
    opt = Adam(cfg.learning_rate)
    opt_state = opt.init(dict(probe.named_parameters()))
    inputs, _ = tower_batch(batches[0], ITEM_SLOT, dev)
    step = lambda: float(twin_tower_step(  # noqa: E731
        probe, opt, opt_state, inputs))
    step_ms = cuda_ms(step, iters=30, warmup=5)
    busy = profiled_ms(step, iters=10)
    idle = None if busy is None else 1.0 - busy / step_ms
    timing.update(step_ms=step_ms, device_ms=busy, idle=idle)
    print(f"{line}; one step call_ms={step_ms:.4f} device_busy_ms="
          f"{ms(busy)} idle_share="
          f"{'n/a' if idle is None else f'{idle:.3f}'} ({card_line()})")

    # The history lookup's take backward (B*L positions of the padded
    # vocabulary at D = K, a run at id 0 for every padded position) with
    # its segments given, and the segments build, against the bounds.
    ids = inputs[0].reshape(-1).long()
    n, u, d = ids.shape[0], tower.padded_vocab, cfg.embedding_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    g = torch.randn(n, d, device=dev, generator=gen)
    seg = ek.position_segments(ids, u)
    got = ek.segment_sum(g, ids, u, segments=seg)
    assert np.array_equal(got.cpu().numpy(), take_bwd_oracle(g, ids, None,
                                                             u))
    run0 = int((ids == 0).sum())
    kern = timed(lambda: ek.segment_sum(g, ids, u, segments=seg), iters=50)
    both = timed(lambda: ek.segment_sum(g, ids, u), iters=50)
    lib = timed(lambda: torch.zeros(u, d, device=dev).index_add_(0, ids, g),
                iters=50)
    tb = take_bwd_bound(d, [n], [u])
    sb = segments_bound(ids.reshape(1, -1), [u], None)
    timing.update(take_bwd_ms=kern[0], segment_sum_ms=both[0],
                  index_add_ms=lib[0], take_bwd_bound_ms=tb[0],
                  segments_bound_ms=sb[0], n=n, run0=run0)
    print(f"retrieval take_bwd history N=B*L={n} U={u} D={d} run at id 0 "
          f"{run0}: bit-equal to the numpy ascending-p oracle; take "
          f"backward (segments given) device_ms={ms(kern[0])} call_ms="
          f"{kern[1]:.6f} bound_ms={tb[0]:.6f} ({tb[1]}: {tb[2]} B); "
          f"segments + take backward device_ms={ms(both[0])} bound_ms="
          f"{tb[0] + sb[0]:.6f}; library index_add_ device_ms={ms(lib[0])} "
          f"({kern[2]}) ({card_line()})")
    return tower, launches, timing


def index_phase(cfg: Config, dev: torch.device, tower: TwinTower,
                eval_batch: dict) -> tuple:
    """The item matrix over the whole vocabulary, the brute index on the
    card and the ANN at its default and at P = 32 / nprobe = 16: build
    times, recall@50 against brute force (brute must read 1.0), and the
    search time per query. Returns (brute index, index meta)."""
    t0 = time.perf_counter()
    vecs = tower.all_item_embeddings(cfg.feature_size)
    emb_s = time.perf_counter() - t0
    assert vecs.shape == (cfg.feature_size, cfg.embedding_size)
    norms = np.linalg.norm(vecs, axis=1)
    assert np.all(np.abs(norms - 1.0) < 1e-4), norms
    brute = CandidateIndex(vecs, device=dev)
    t0 = time.perf_counter()
    ann = CandidateIndex(vecs, kind="ann", seed=SEED, device=dev)
    ann_s = time.perf_counter() - t0
    small = CandidateIndex(vecs, kind="ann", num_partitions=ANN_SMALL[0],
                           nprobe=ANN_SMALL[1], seed=SEED, device=dev)
    with torch.inference_mode():
        users = tower.user_embed(
            torch.from_numpy(eval_batch["hist_ids"]).to(dev),
            torch.from_numpy(eval_batch["hist_mask"]).to(dev))
    queries = users.cpu().numpy()
    r_brute = brute.recall_at_k(queries, RETRIEVE_K)
    r_ann = ann.recall_at_k(queries, RETRIEVE_K)
    r_small = small.recall_at_k(queries, RETRIEVE_K)
    assert r_brute == 1.0, r_brute
    t0 = time.perf_counter()
    ann.search(queries, RETRIEVE_K)
    ann_ms = 1000.0 * (time.perf_counter() - t0) / len(queries)
    t0 = time.perf_counter()
    small.search(queries, RETRIEVE_K)
    small_ms = 1000.0 * (time.perf_counter() - t0) / len(queries)
    meta = {"recall_at_50": r_brute, "ann_recall_at_50": r_ann,
            "ann_small_recall_at_50": r_small}
    timing = {"item_embeddings_s": emb_s, "ann_build_s": ann_s,
              "ann_ms_per_query": ann_ms, "ann_small_ms_per_query": small_ms,
              **meta}
    print(f"retrieval index: all_item_embeddings {cfg.feature_size} items "
          f"in {emb_s:.3f}s; ANN build (P={ann.num_partitions}, nprobe="
          f"{ann.nprobe}) {ann_s:.3f}s; recall@{RETRIEVE_K} over "
          f"{len(queries)} eval users: brute {r_brute}, ANN default "
          f"{r_ann:.4f}, ANN P={ANN_SMALL[0]} nprobe={ANN_SMALL[1]} "
          f"{r_small:.4f}; ANN search host ms/query {ann_ms:.4f} (default), "
          f"{small_ms:.4f} (P={ANN_SMALL[0]})")
    if dev.type == "cuda":
        for b in (1, RECALL_QUERIES):
            q = users[:b].contiguous()
            t = timed(lambda: brute.topk_rows(q, RETRIEVE_K), iters=50)
            host = cuda_ms(lambda: brute.search(queries[:b], RETRIEVE_K),
                           iters=20, warmup=3)
            timing[f"brute_B{b}"] = (t[0], t[1], host)
            print(f"retrieval brute search B={b} V={cfg.feature_size} "
                  f"D={cfg.embedding_size} k={RETRIEVE_K}: device_ms="
                  f"{ms(t[0])} call_ms={t[1]:.6f} per query "
                  f"{t[1] / b:.6f}; search() from numpy call_ms="
                  f"{host:.6f} ({t[2]}) ({card_line()})")
    return brute, meta, timing


def cascade_phase(workdir: str, dev: torch.device, din_artifact: str,
                  tower: TwinTower, brute: CandidateIndex, meta: dict,
                  eval_batch: dict) -> dict:
    """``export_cascade`` of the zoo's DIN ranker with the towers and the
    brute index behind ``LATEST``; a staged and a fused ``CascadeEngine``
    over it: fused equals staged bit for bit over single users (empty
    histories included), the ranker's FM kernel launches on both paths,
    their sequential latency, ``recommend_batch`` at 64 users; the card's
    staged answers against the CPU's on a float32 copy of the ranker; a
    v2 published by ``Publisher(extra_export=cascade_extra_export(...))``
    swapped in and answering as a fresh v2 engine does; a torn v3 that
    defers the swap. Returns {path: launches}."""
    ranker, rcfg, _ = export_lib.load_model(din_artifact, device=dev)
    pub = os.path.join(workdir, "cascade_pub")
    export_cascade(ranker, rcfg, os.path.join(pub, "1"), tower=tower,
                   index=brute, index_meta=meta, step=1)
    export_lib.write_latest(pub, "1")
    reqs = _cascade_requests(eval_batch, CASCADE_REQUESTS)
    on = int(dev.type == "cuda")
    paths = {}
    staged = _cascade_engine(pub, dev)
    fused = _cascade_engine(pub, dev, fused=True)
    try:
        assert fused.current().supports_fused
        _zero_counts()
        s_ans = [staged.recommend(*r, k=RANK_K) for r in reqs]
        paths["cascade_staged"] = _counts()
        _zero_counts()
        f_ans = [fused.recommend(*r, k=RANK_K) for r in reqs]
        paths["cascade_fused"] = _counts()
        assert fused.fused_calls == len(reqs) and staged.fused_calls == 0
        _check_answers(s_ans, RANK_K)
        assert _same_answers(f_ans, s_ans), "fused != staged"
        for p in ("cascade_staged", "cascade_fused"):
            want = {k: 0 for k in paths[p]}
            want["fused_fm"] = on * len(reqs)
            assert paths[p] == want, (p, paths[p])
        print(f"retrieval cascade fused vs staged: {len(reqs)} single-user "
              f"requests ({sum(not r[1].any() for r in reqs)} with empty "
              f"histories), retrieve_k={RETRIEVE_K} k={RANK_K}: items and "
              f"probabilities bit-identical; launches staged "
              f"{paths['cascade_staged']} fused {paths['cascade_fused']}")
        timing = {}
        for name, eng in (("staged", staged), ("fused", fused)):
            timing[name] = _timed_recommend(eng, reqs, CASCADE_TIMED)
            p50, p99, qps = timing[name]
            print(f"retrieval cascade {name} recommend: {CASCADE_TIMED} "
                  f"sequential requests p50_ms={p50:.4f} p99_ms={p99:.4f} "
                  f"qps={qps:.1f} ({card_line() if on else 'cpu'})")
        rng = np.random.default_rng(SEED + 90)
        pick = rng.integers(0, len(eval_batch["label"]), CASCADE_BATCH)
        cols = [eval_batch[c][pick] for c in ("hist_ids", "hist_mask",
                                              "feat_ids", "feat_vals")]
        b_items, b_probs = fused.recommend_batch(*cols, k=RANK_K)
        t0 = time.perf_counter()
        reps = 10
        for _ in range(reps):
            fused.recommend_batch(*cols, k=RANK_K)
        batch_ms = 1000.0 * (time.perf_counter() - t0) / reps
        gap, same = 0.0, 0
        for i in range(CASCADE_BATCH):
            items, probs = staged.recommend(*(c[i] for c in cols), k=RANK_K)
            same += int(np.array_equal(items, b_items[i]))
            common = {int(t): p for t, p in zip(items, probs)}
            for t, p in zip(b_items[i], b_probs[i]):
                if int(t) in common:
                    gap = max(gap, abs(float(p) - common[int(t)]))
        assert np.all(np.isfinite(b_probs)) and gap <= SERVE_ATOL, gap
        timing["batch"] = (batch_ms, CASCADE_BATCH * 1000.0 / batch_ms)
        print(f"retrieval cascade fused recommend_batch B={CASCADE_BATCH}: "
              f"call_ms={batch_ms:.4f} users_per_s="
              f"{timing['batch'][1]:.1f}; against per-user staged: "
              f"{same}/{CASCADE_BATCH} identical top-{RANK_K} lists, max "
              f"|prob diff| on shared items {gap:.3e} (atol {SERVE_ATOL}; "
              f"bf16 tower GEMMs at other row counts) "
              f"({card_line() if on else 'cpu'})")

        # v2 through the publisher's hook, swapped into both engines.
        v2 = export_lib.load_model(din_artifact, device=dev)[0]
        with torch.no_grad():
            v2.fm_b.add_(V2_BIAS)
        publisher = Publisher(rcfg, pub, extra_export=cascade_extra_export(
            rcfg, tower, brute, index_meta=meta))
        publisher.publish_now(types.SimpleNamespace(
            params=dict(v2.named_parameters()),
            model_state=dict(v2.named_buffers())), 2)
        assert publisher.drain(timeout=300)
        publisher.close()
        assert publisher.published == [2], publisher.stats()
        for name in (TOWERS_FILE, INDEX_FILE, export_lib.COMPLETE_MARKER):
            assert os.path.exists(os.path.join(pub, "2", name)), name
        assert staged.watcher.check_once() and fused.watcher.check_once()
        assert staged.current().path.endswith("2")
        s2 = [staged.recommend(*r, k=RANK_K) for r in reqs]
        f2 = [fused.recommend(*r, k=RANK_K) for r in reqs]
        fresh = _cascade_engine(pub, dev)
        try:
            fresh_ans = [fresh.recommend(*r, k=RANK_K) for r in reqs]
        finally:
            fresh.close()
        assert _same_answers(s2, fresh_ans) and _same_answers(f2, s2)
        assert not any(np.array_equal(a[1], b[1])
                       for a, b in zip(s2, s_ans))
        # A torn v3 (no marker) defers the swap; serving stays on v2.
        os.makedirs(os.path.join(pub, "3"))
        export_lib.write_latest(pub, "3")
        assert not staged.watcher.check_once()
        assert staged.watcher.swap_failures == 1
        assert staged.current().path.endswith("2")
        _check_answers([staged.recommend(*reqs[0], k=RANK_K)], RANK_K)
        export_lib.write_latest(pub, "2")
        print(f"retrieval cascade hot swap: v2 (fm_b + {V2_BIAS}) published "
              f"by Publisher(extra_export=cascade_extra_export(...)) "
              f"with towers and index; swapped into both engines, answers "
              f"equal a fresh v2 engine's (staged and fused); torn v3 "
              f"deferred (swap_failures 1), still serving v2; serving "
              f"failures {staged.stats.summary()['serving_failed']}")
        assert staged.stats.summary()["serving_failed"] == 0
    finally:
        staged.close()
        fused.close()

    # The card against the CPU on a float32 copy of the ranker: all 50
    # candidates ranked, the same items, each probability within 1e-5.
    r32, c32, _ = export_lib.load_model(din_artifact, device=dev,
                                        compute_dtype="float32")
    pub32 = os.path.join(workdir, "cascade_pub_f32")
    export_cascade(r32, c32, os.path.join(pub32, "1"), tower=tower,
                   index=brute, step=1)
    export_lib.write_latest(pub32, "1")
    card = _cascade_engine(pub32, dev)
    cpu = _cascade_engine(pub32, "cpu")
    gap = 0.0
    try:
        for r in reqs[:CASCADE_CPU_REQUESTS]:
            a_items, a_probs = card.recommend(*r, k=RETRIEVE_K)
            b_items, b_probs = cpu.recommend(*r, k=RETRIEVE_K)
            assert sorted(map(int, a_items)) == sorted(map(int, b_items))
            want = dict(zip(map(int, b_items), b_probs))
            gap = max(gap, max(abs(float(p) - float(want[int(t)]))
                               for t, p in zip(a_items, a_probs)))
    finally:
        card.close()
        cpu.close()
    assert gap <= CASCADE_CPU_ATOL, gap
    print(f"retrieval cascade card vs cpu (float32 ranker, staged): "
          f"{CASCADE_CPU_REQUESTS} requests, all {RETRIEVE_K} candidates "
          f"ranked: the same items, max |prob diff| {gap:.3e} (atol "
          f"{CASCADE_CPU_ATOL})")
    paths["timing"] = timing
    return paths


def retrieval_phase(workdir: str, cfg: Config, dev: torch.device,
                    data: dict, din_artifact: str) -> tuple:
    """The retrieval slice at the reference width on the zoo's history
    records and DIN artifact: the twin tower, the indexes, the cascade.
    Returns ({path: launches}, timings)."""
    files = sorted(os.path.join(data["dir"], f)
                   for f in os.listdir(data["dir"]) if f.startswith("tr_"))
    evals = [os.path.join(data["dir"], "va_0000.tfrecords")]
    eval_batch = next(iter(_history_pipe(cfg, evals, 1, RECALL_QUERIES)))
    t0 = time.perf_counter()
    tower, tower_launches, tower_t = twin_tower_phase(cfg, dev, files)
    brute, meta, index_t = index_phase(cfg, dev, tower, eval_batch)
    paths = cascade_phase(workdir, dev, din_artifact, tower, brute, meta,
                          eval_batch)
    cascade_t = paths.pop("timing")
    paths["train_twin_tower"] = tower_launches
    print(f"retrieval phase: {time.perf_counter() - t0:.1f}s")
    return paths, {"tower": tower_t, "index": index_t, "cascade": cascade_t}


# ---------------------------------------------------------------------------
# Data parallelism (torch.distributed): gloo ranks on one card, NCCL
# through fanout
# ---------------------------------------------------------------------------

DP_WORLD_GLOO = 2
# The DP phase's task: DeepFM at the reference width (the Config()
# defaults), dropout off (each rank draws its own dropout, so a run with
# dropout cannot be held against one device), one epoch of the train
# phases' 64 Ki records at the global batch of 1,024. The runs held against
# one device compute the tower in float32: in bfloat16 each rank rounds its
# partial weight gradient (a sum over its B/N rows) to bfloat16 before the
# average, one device its sum over B rows, and Adam carries those rounding
# differences (the zoo phase's card-against-CPU parity is float32 for the
# same reason). The world-1 run (bit-equal to one device) and the rate runs
# keep the bfloat16 tower.
# Two steps a dispatch: the run at 1,024 rows a card has 16 steps, and the
# rate leaves out the first two dispatches.
DP_CFG = dict(dropout="1.0,1.0,1.0", num_epochs=1, log_steps=8,
              steps_per_loop=2)
DP_HELD = dict(compute_dtype="float32")
DP_LOSS_ATOL = 1e-4
DP_TABLE_REL = 0.10
DP_AUC_ATOL = 5e-3
DP_PRED_ATOL = 1e-5
DP_RANK_TIMEOUT_S = 420
# NVLink of an H100 SXM: 900 GB/s to the other cards of the host, 450 GB/s
# each way (NVIDIA's data sheet).
NVLINK_BYTES_PER_S = 450e9
DP_TASKS = ("train", "eval", "infer", "export")
DP_WEAK_EPOCHS = 3
# The all_reduce alone: back-to-back calls on the training payload.
DP_ALLREDUCE_WARMUP, DP_ALLREDUCE_ITERS = 5, 50


def _dp_cfg(workdir: str, data: dict, cfg: Config, name: str) -> Config:
    run = os.path.join(workdir, name)
    return cfg.replace(data_dir=data["dir"], val_data_dir=data["dir"],
                       model_dir=os.path.join(run, "ckpt"),
                       servable_model_dir=os.path.join(run, "servable"),
                       **DP_CFG)


def dp_rank_main(spec_path: str, rank: int) -> int:
    """One gloo rank of the one-card DP run (a child process of
    ``dp_phase``): train, eval, infer and export through the launcher on
    the spec's device (``cuda``: card 0 for every rank), each task's result
    line and kernel launches written to ``<out>.<rank>.json``."""
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for task in DP_TASKS:
        argv = spec["argv"][task] + [
            "--dist_mode", "1", "--num_processes", str(spec["world"]),
            "--process_id", str(rank), "--worker_per_host",
            str(spec["world"]), "--coordinator_address",
            f"file://{spec['store']}.{task}"]
        _zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch.main(argv, device=spec["device"], backend="gloo")
        if rc != 0:
            raise RuntimeError(f"rank {rank} task {task}: exit {rc}")
        out[task] = {"result": json.loads(
            buf.getvalue().strip().splitlines()[-1]), "launches": _counts()}
    with open(f"{spec['out']}.{rank}.json", "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def dp_allreduce_main(spec_path: str, rank: int) -> int:
    """One rank of the isolated all_reduce timing (a child process of
    ``dp_nccl_phase``, one card each): ``DP_ALLREDUCE_ITERS`` back-to-back
    all_reduces of the training payload after a barrier, each between two
    CUDA events; the median ms written to ``<out>.<rank>.json``."""
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    bootstrap.initialize(Config(
        dist_mode=1, num_processes=spec["world"], process_id=rank,
        worker_per_host=spec["world"],
        coordinator_address=f"file://{spec['store']}"), device=dev)
    buf = torch.ones(spec["bytes"] // 4, dtype=torch.float32, device=dev)
    for _ in range(DP_ALLREDUCE_WARMUP):
        torch.distributed.all_reduce(buf)
    marks = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    bootstrap.barrier()
    for _ in range(DP_ALLREDUCE_ITERS):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            torch.distributed.all_reduce(buf)
            b.record()
        else:
            a = time.perf_counter()
            torch.distributed.all_reduce(buf)
            b = time.perf_counter()
        marks.append((a, b))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) if dev.type == "cuda" else (b - a) * 1e3
          for a, b in marks]
    with open(f"{spec['out']}.{rank}.json", "w", encoding="utf-8") as f:
        json.dump({"median_ms": float(np.median(ms))}, f)
    bootstrap.destroy()
    return 0


def _run_children(cmds, env, log_paths, timeout_s: float) -> None:
    """Start every command, wait for all under one deadline; one failure or
    the deadline ends the others and raises with the logs' tails. ``env``
    is one environment for all, or a list of one per command."""
    envs = env if isinstance(env, list) else [env] * len(cmds)
    procs = []
    try:
        for cmd, path, e in zip(cmds, log_paths, envs):
            with open(path, "w", encoding="utf-8") as log:
                procs.append(subprocess.Popen(
                    cmd, cwd=HERE, env=e, stdout=log,
                    stderr=subprocess.STDOUT, text=True))
        deadline = time.time() + timeout_s
        while any(p.poll() is None for p in procs):
            if (time.time() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        tails = []
        for p, path in zip(procs, log_paths):
            with open(path, encoding="utf-8") as f:
                tails.append(f"--- {path} rc={p.returncode}\n"
                             + f.read()[-4000:])
        raise RuntimeError("DP child failed:\n" + "\n".join(tails))


def _dp_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env["DEEPFM_LOG_ALL_RANKS"] = "1"
    env.update(extra)
    return env


def _global_batches(cfg: Config, files, world: int):
    """The global batches ``world`` ranks of ``cfg`` read in its first
    epoch: batch t of every rank's shard, end to end in rank order."""
    pipes = [tasks.make_pipeline(cfg, files, epochs=1, rank=r, world=world)
             for r in range(world)]
    return [{k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
            for bs in zip(*pipes)]


def _dp_oracle(cfg: Config, dev: torch.device, files, world: int):
    """The single-device run over the ranks' global batches at the ranks'
    learning rate (scaled by the world under ``scale_lr_by_world``):
    (trainer, initial tables, final state, fit result)."""
    lr = cfg.learning_rate * (world if cfg.scale_lr_by_world else 1)
    tr = Trainer(cfg.replace(learning_rate=lr, model_dir="",
                             servable_model_dir=""), device=dev)
    state = tr.init_state()
    init = {k: v.detach().clone() for k, v in state.params.items()
            if k.split(".")[0] in ("fm_w", "fm_v")}
    state, res = tr.fit(state, _global_batches(cfg, files, world))
    return tr, init, state, res


def _table_rel(got, want, init) -> float:
    """||got - want|| over ||want - init||, over the embedding tables."""
    diff = sum(float(((got.params[k].detach() - want.params[k].detach())
                      .double() ** 2).sum()) for k in init)
    move = sum(float(((want.params[k].detach() - init[k]).double() ** 2)
                     .sum()) for k in init)
    return (diff / max(move, 1e-300)) ** 0.5


def _dp_hold(name: str, cfg: Config, dev: torch.device, files, world: int,
             loss: float) -> dict:
    """The N-rank checkpoint against the single-device oracle: the last
    logged loss within 1e-4, the tables by the norm of their difference
    against their movement (at most 10%), eval AUC and loss on the
    oracle's state."""
    tr, init, want, res = _dp_oracle(cfg, dev, files, world)
    got = ckpt_lib.CheckpointManager(cfg.model_dir).restore(
        Trainer(cfg, device=dev).init_state())
    rel = _table_rel(got, want, init)
    dl = abs(loss - res["loss"])
    print(f"dp {name}: {world} ranks vs one device on the same global "
          f"batches: steps {got.step}/{want.step}, last logged loss "
          f"{loss:.6f} vs {res['loss']:.6f} (|diff| {dl:.3e}, atol "
          f"{DP_LOSS_ATOL}), tables |diff|/|movement| {rel:.3e} (at most "
          f"{DP_TABLE_REL})")
    assert got.step == want.step, (got.step, want.step)
    assert dl <= DP_LOSS_ATOL, (loss, res["loss"])
    assert rel <= DP_TABLE_REL, rel
    return {"trainer": tr, "state": want, "dp_state": got}


def _worker_results(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line.startswith("[worker ") and '{"task"' in line:
            rank = int(line[len("[worker "):line.index("]")])
            out[rank] = json.loads(line[line.index("{"):])
    return out


def dp_gloo_phase(workdir: str, data: dict, cfg: Config,
                  dev: torch.device) -> dict:
    """(a) Two gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one
    card) through the launcher: train (one epoch, its eval), eval, infer
    and export at the global batch of 1,024 (512 a rank). Held against the
    single-device oracle over the same global batches; only rank 0 writes;
    each rank's launches equal a single-device run at B = 512 over rank
    0's shard. Returns rank 0's train-task launches."""
    world = DP_WORLD_GLOO
    dcfg = _dp_cfg(workdir, data, cfg, "dp_gloo").replace(**DP_HELD)
    export_dir = os.path.join(workdir, "dp_gloo", "exported")
    argv = {t: _launch_argv(dcfg.replace(servable_model_dir=export_dir)
                            if t == "export" else dcfg, t)
            for t in DP_TASKS}
    spec = {"world": world, "argv": argv, "device": str(dev),
            "store": os.path.join(workdir, "dp_gloo_store"),
            "out": os.path.join(workdir, "dp_gloo_out")}
    spec_path = os.path.join(workdir, "dp_gloo_spec.json")
    with open(spec_path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    logs = [os.path.join(workdir, f"dp_gloo_rank{r}.log")
            for r in range(world)]
    cmds = [[sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.dp_rank_main("
             f"{spec_path!r}, {r}))"] for r in range(world)]
    t0 = time.perf_counter()
    _run_children(cmds, _dp_env(), logs, DP_RANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(f"{spec['out']}.{r}.json", encoding="utf-8") as f:
            ranks.append(json.load(f))
    text = [open(p, encoding="utf-8").read() for p in logs]
    train = [rk["train"]["result"] for rk in ranks]
    print(f"dp gloo: {world} ranks on cuda:0 (gloo, CUDA tensors), "
          f"B={dcfg.batch_size} global ({dcfg.batch_size // world} a rank), "
          f"4 launcher tasks in {wall:.1f}s; per rank: " + "; ".join(
              f"rank {r} examples_per_sec={t['examples_per_sec']:.1f} "
              f"step_ms_p50={t['step_ms_p50']:.3f} (host clock) "
              f"collective_applies={t['collective_applies']:.0f} "
              f"collective_bytes={t['collective_bytes']:.0f}"
              for r, t in enumerate(train)))
    # Only the chief writes: its log holds the saves and the exports, the
    # other rank's (every rank logs here) none.
    for what in ("checkpoint saved", "exported servable", "wrote "):
        assert what in text[0], what
        assert what not in text[1], what
    assert sorted(os.listdir(dcfg.servable_model_dir)) == [
        str(int(train[0]["steps"]))]
    assert sorted(os.listdir(export_dir)) == [str(int(train[0]["steps"]))]
    files = tasks.resolve_files(data["dir"], "tr")
    held = _dp_hold("gloo", dcfg, dev, files, world, train[0]["loss"])
    tr, state = held["trainer"], held["state"]
    # The eval and infer tasks of the 2-rank checkpoint against the same
    # tasks of that checkpoint on one device (the oracle's state, trained
    # apart, also evaluated for the record).
    ev = tr.evaluate(held["dp_state"], tasks._eval_pipeline(
        tr.cfg, tasks.resolve_files(data["dir"], "va")))
    ev_oracle = tr.evaluate(state, tasks._eval_pipeline(
        tr.cfg, tasks.resolve_files(data["dir"], "va")))
    for r, rk in enumerate(ranks):
        e = rk["eval"]["result"]
        assert e["examples"] == ev["examples"] == data["eval"], (e, ev)
        assert abs(e["auc"] - ev["auc"]) <= DP_AUC_ATOL, (e, ev)
        assert abs(e["loss"] - ev["loss"]) <= DP_LOSS_ATOL, (e, ev)
        assert abs(e["auc"] - ev_oracle["auc"]) <= DP_AUC_ATOL, (
            e, ev_oracle)
    preds = np.loadtxt(os.path.join(data["dir"], "pred.txt"))
    te = tasks.make_pipeline(tr.cfg, tasks.resolve_files(data["dir"], "te"),
                             shuffle=False, drop_remainder=False)
    want = np.concatenate(list(tr.predict(held["dp_state"], te)))
    perr = float(np.abs(preds - want).max())
    e0 = ranks[0]["eval"]["result"]
    print(f"dp gloo eval task: auc={e0['auc']:.6f} loss={e0['loss']:.6f} "
          f"over {e0['examples']:.0f} examples; the same checkpoint on one "
          f"device: auc={ev['auc']:.6f} loss={ev['loss']:.6f} over "
          f"{ev['examples']:.0f}; the one-device trajectory's state: "
          f"auc={ev_oracle['auc']:.6f} loss={ev_oracle['loss']:.6f}; "
          f"pred.txt {len(preds)} lines in global record order, max |diff| "
          f"to one device {perr:.3e} (atol {DP_PRED_ATOL})")
    assert preds.shape == want.shape and perr <= DP_PRED_ATOL, perr
    # Per-rank kernel launches: those of a single-device run at B = 512
    # over rank 0's shard (fit, then the eval of its eval shard).
    local = dcfg.replace(batch_size=dcfg.batch_size // world,
                         learning_rate=dcfg.learning_rate * world,
                         model_dir="", servable_model_dir="")
    one = Trainer(local, device=dev)
    _zero_counts()
    s1, _ = one.fit(one.init_state(), tasks.make_pipeline(
        dcfg, files, epochs=1, rank=0, world=world))
    one.evaluate(s1, tasks.make_pipeline(
        dcfg, tasks.resolve_files(data["dir"], "va"), shuffle=False,
        drop_remainder=False, rank=0, world=world))
    single = _counts()
    for r, rk in enumerate(ranks):
        assert rk["train"]["launches"] == single, (r, rk["train"], single)
    print(f"dp gloo launches per rank (train task) = single device at "
          f"B={local.batch_size}: {single}")
    return ranks[0]["train"]["launches"]


def _fanout_train(workdir: str, name: str, cfg: Config, n: int,
                  env: dict) -> dict:
    """``python -m deepfm_tpu_torch.fanout --worker_per_host n`` training
    ``cfg`` (NCCL, one card a rank): {rank: result line}."""
    log = os.path.join(workdir, f"{name}.log")
    cmd = [sys.executable, "-m", "deepfm_tpu_torch.fanout",
           "--worker_per_host", str(n),
           *_launch_argv(cfg, "train")]
    t0 = time.perf_counter()
    _run_children([cmd], env, [log], DP_RANK_TIMEOUT_S)
    with open(log, encoding="utf-8") as f:
        res = _worker_results(f.read())
    assert sorted(res) == list(range(n)), sorted(res)
    print(f"dp {name}: fanout --worker_per_host {n} in "
          f"{time.perf_counter() - t0:.1f}s")
    return res


def _dp_rank_lines(name: str, res: dict, world: int) -> None:
    for r, t in sorted(res.items()):
        print(f"dp {name} rank {r}: examples_per_sec={t['examples_per_sec']:.1f}"
              f" (all ranks' examples) step_ms_p50={t['step_ms_p50']:.3f} "
              f"(host clock) dispatch_device_ms (median)="
              f"{t.get('dispatch_device_ms', float('nan')):.4f} "
              f"collective_device_ms={t.get('collective_device_ms', 0.0):.4f}"
              f" (median) per apply over "
              f"{t.get('collective_bytes', 0) / max(t.get('collective_applies', 1), 1):.0f}"
              f" bytes (bound {_allreduce_bound_ms(t, world):.4f} ms over "
              f"NVLink) {card_line()}")


def _allreduce_bound_ms(t: dict, world: int) -> float:
    """A ring all_reduce's least time: each card sends and receives
    2 (N - 1) / N of the payload over NVLink's 450 GB/s each way."""
    if world <= 1 or not t.get("collective_applies"):
        return 0.0
    payload = t["collective_bytes"] / t["collective_applies"]
    return 2 * (world - 1) / world * payload / NVLINK_BYTES_PER_S * 1e3


def dp_allreduce_timing(workdir: str, n: int, nbytes: int,
                        dev: torch.device) -> float:
    """The all_reduce of ``nbytes`` over ``n`` ranks alone (NCCL, one card
    each): rank 0's median device ms of back-to-back calls."""
    spec = {"world": n, "bytes": nbytes, "device": str(dev),
            "store": os.path.join(workdir, "dp_allreduce_store"),
            "out": os.path.join(workdir, "dp_allreduce_out")}
    path = os.path.join(workdir, "dp_allreduce_spec.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    cmds = [[sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.dp_allreduce_main("
             f"{path!r}, {r}))"] for r in range(n)]
    envs = [_dp_env(CUDA_VISIBLE_DEVICES=str(r)) for r in range(n)]
    logs = [os.path.join(workdir, f"dp_allreduce_rank{r}.log")
            for r in range(n)]
    _run_children(cmds, envs, logs, DP_RANK_TIMEOUT_S)
    with open(f"{spec['out']}.0.json", encoding="utf-8") as f:
        return json.load(f)["median_ms"]


def dp_nccl_phase(workdir: str, data: dict, cfg: Config,
                  dev: torch.device) -> None:
    """(b) NCCL, world 1, through ``fanout`` (bfloat16 tower): its tables
    bit-equal to the single-device task's. (c) With two or more cards:
    ``fanout --worker_per_host min(count, 4)`` over NCCL at the global
    batch of 1,024 (float32 tower), held against the single-device oracle
    as (a), with per-rank rates, dispatch and all_reduce device times; then
    the same ranks at 1,024 a rank (bfloat16 tower; the global batch times
    the ranks) beside the one-card rate of (b)."""
    env = _dp_env(**{loop_lib.TIME_COLLECTIVES_ENV: "1"})
    one = _dp_cfg(workdir, data, cfg, "dp_nccl1")
    res1 = _fanout_train(workdir, "nccl_world1", one, 1, env)[0]
    ref = _dp_cfg(workdir, data, cfg, "dp_single")
    tasks.run(ref.replace(task_type="train"), device=dev)
    a = ckpt_lib.CheckpointManager(one.model_dir).restore(
        Trainer(one, device=dev).init_state())
    b = ckpt_lib.CheckpointManager(ref.model_dir).restore(
        Trainer(ref, device=dev).init_state())
    same = all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    print(f"dp nccl world 1 (fanout, launcher): steps={res1['steps']:.0f} "
          f"examples_per_sec={res1['examples_per_sec']:.1f} step_ms_p50="
          f"{res1['step_ms_p50']:.3f} dispatch_device_ms="
          f"{res1.get('dispatch_device_ms', float('nan')):.4f}; tables "
          f"bit-equal to the single-device task: {same}")
    assert same
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        print(f"dp nccl multi-card: {torch.cuda.device_count()} card "
              "visible; the N-card run needs two or more")
        return
    cn = _dp_cfg(workdir, data, cfg, f"dp_nccl{n}").replace(**DP_HELD)
    res = _fanout_train(workdir, f"nccl_world{n}", cn, n, env)
    _dp_rank_lines(f"nccl world {n} B={cn.batch_size}", res, n)
    _dp_hold(f"nccl world {n}", cn, dev, tasks.resolve_files(
        data["dir"], "tr"), n, res[0]["loss"])
    payload = int(res[0]["collective_bytes"] / res[0]["collective_applies"])
    alone = dp_allreduce_timing(workdir, n, payload, dev)
    bound = _allreduce_bound_ms(res[0], n)
    print(f"dp nccl world {n} all_reduce alone: {payload} bytes, median "
          f"{alone:.4f} ms of {DP_ALLREDUCE_ITERS} back-to-back calls "
          f"(device, CUDA events), bound {bound:.4f} ms over NVLink, bus "
          f"{2 * (n - 1) / n * payload / alone / 1e6:.1f} GB/s; in training "
          f"(which waits for the slowest rank to arrive) "
          f"{res[0]['collective_device_ms']:.4f} ms on rank 0 "
          f"({card_line()})")
    # 1,024 rows a card leaves 64 Ki / (1,024 N) steps an epoch (16 on
    # four cards): three epochs, the rate read from the last (warm) one.
    weak = _dp_cfg(workdir, data, cfg, f"dp_nccl{n}_weak").replace(
        batch_size=cfg.batch_size * n, num_epochs=DP_WEAK_EPOCHS)
    resw = _fanout_train(workdir, f"nccl_world{n}_weak", weak, n, env)
    _dp_rank_lines(f"nccl world {n} B={weak.batch_size}", resw, n)
    print(f"dp scaling: {n} cards at B={weak.batch_size} global "
          f"({cfg.batch_size} a card, epoch {DP_WEAK_EPOCHS} of "
          f"{DP_WEAK_EPOCHS}): {resw[0]['examples_per_sec']:.1f} "
          f"examples/s; at "
          f"B={cn.batch_size} global: {res[0]['examples_per_sec']:.1f}; one "
          f"card (fanout world 1) at B={one.batch_size}: "
          f"{res1['examples_per_sec']:.1f} ({card_line()})")


def dp_phase(workdir: str, data: dict, cfg: Config,
             dev: torch.device) -> dict:
    """Data parallelism over ``torch.distributed``: (a) gloo ranks on one
    card, (b) NCCL world 1, (c) NCCL on every card up to four. Returns
    {"train_dp_gloo": rank 0's launches}."""
    t0 = time.perf_counter()
    launches = dp_gloo_phase(workdir, data, cfg, dev)
    dp_nccl_phase(workdir, data, cfg, dev)
    print(f"dp phase: {time.perf_counter() - t0:.1f}s")
    return {"train_dp_gloo": launches}


# ---------------------------------------------------------------------------
# The model axis: tables row-sharded over --mesh_model ranks
# ---------------------------------------------------------------------------

MP_ROWS = dict(embedding_update="sparse", embedding_shard="rows")
# leg -> (mesh_data, mesh_model, config overrides); the model-only legs are
# held bit-equal to one device, the data-only row plane (leg iii) within
# the DP phase's tolerances.
MP_LEGS = {
    "train_mp_dense": (1, 2, {}),
    "train_mp_allgather": (1, 2, dict(embedding_lookup="allgather_table")),
    "train_mp_rows": (1, 2, MP_ROWS),
    "train_mp_rows_hashed": (1, 2, dict(
        MP_ROWS, **{k: v for k, v in SPARSE_LAYOUTS["sparse_hashed"].items()
                    if k != "embedding_update"})),
    "train_dp_rows": (0, 1, MP_ROWS),
}
# The legs whose artifact is served against the one-device artifact.
MP_SERVED = ("train_mp_dense", "train_mp_rows")
MP_SERVE_REQUESTS = 24
MP_RANK_TIMEOUT_S = 420
# Four cards (--phase mp): the row plane at 1x4 and 2x2, and one large
# hashed table, 4 x 4,194,304 buckets (fm_v 2.15 GB, its m and v 4.3 GB).
MP_BIG_BUCKETS = "4194304,4194304,4194304,4194304"


def _mp_leg_cfg(cfg: Config, run_dir: str, data: dict, leg: str) -> Config:
    """The leg's task config: the DP phase's (one epoch, dropout off, a
    float32 tower) with the leg's mesh and layout, in ``run_dir``."""
    d, m, over = MP_LEGS[leg]
    return cfg.replace(data_dir=data["dir"], val_data_dir=data["dir"],
                       model_dir=os.path.join(run_dir, "ckpt"),
                       servable_model_dir=os.path.join(run_dir, "srv"),
                       mesh_data=d, mesh_model=m, **DP_CFG, **DP_HELD,
                       **over)


def placement_bytes(cfg: Config, dev: torch.device) -> dict:
    """A Trainer's state of ``cfg`` placed on ``dev``: the allocator's bytes
    before and after ``init_state`` (the card's ``memory_allocated``; 0 on
    the CPU) and the embedding tables' and their optimizer slots' bytes
    counted from the tensors this rank holds."""
    tr = Trainer(cfg, device=dev)

    def allocated():
        # Collect earlier phases' cyclic garbage first: freed during the
        # init, it would read as negative placement.
        gc.collect()
        if dev.type != "cuda":
            return 0
        torch.cuda.synchronize(dev)
        return int(torch.cuda.memory_allocated(dev))

    before = allocated()
    state = tr.init_state()
    after = allocated()
    keys = {p for ks in tr._embed_keys.values() for p in ks.values()}

    def emb_bytes(tree, path):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            tree = tree._asdict()
        if isinstance(tree, dict):
            return sum(emb_bytes(v, path + (k,)) for k, v in tree.items())
        if isinstance(tree, torch.Tensor) and (
                set(path) & keys or path[:2] == ("opt", "embed")):
            return tree.numel() * tree.element_size()
        return 0

    emb = emb_bytes({"params": state.params, "opt": state.opt_state}, ())
    del state, tr
    return {"allocated": after - before, "embedding_bytes": int(emb)}


def mp_rank_main(spec_path: str, rank: int) -> int:
    """One gloo rank of the one-card model-axis runs (a child process of
    ``mp_phase``): each leg's train task through the launcher (its kernel
    launches and result line), then each leg's placement bytes on one
    process group; written to ``<out>.<rank>.json``."""
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(spec["device"])
    dist = ["--dist_mode", "1", "--num_processes", str(spec["world"]),
            "--process_id", str(rank), "--worker_per_host",
            str(spec["world"])]
    out = {}
    for leg, argv in spec["argv"].items():
        _zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch.main(argv + dist + [
                "--coordinator_address", f"file://{spec['store']}.{leg}"],
                device=dev, backend="gloo")
        if rc != 0:
            raise RuntimeError(f"rank {rank} leg {leg}: exit {rc}")
        out[leg] = {"result": json.loads(
            buf.getvalue().strip().splitlines()[-1]), "launches": _counts()}
    bootstrap.initialize(config_lib.parse_args(dist + [
        "--coordinator_address", f"file://{spec['store']}.placement"]),
        device=dev, backend="gloo")
    for leg, argv in spec["argv"].items():
        out[leg]["placement"] = placement_bytes(
            config_lib.parse_args(argv + dist), dev)
        out[leg]["transport"] = emb_ops.exchange_transport(
            emb_ops.ModelAxis(0, 2), dev)
    bootstrap.barrier()
    bootstrap.destroy()
    with open(f"{spec['out']}.{rank}.json", "w", encoding="utf-8") as f:
        json.dump(out, f)
    return 0


def _restored(cfg: Config, dev: torch.device):
    """The latest checkpoint of ``cfg.model_dir`` restored on one device."""
    one = cfg.replace(mesh_data=0, mesh_model=1)
    return ckpt_lib.CheckpointManager(cfg.model_dir).restore(
        Trainer(one, device=dev).init_state())


def _state_tensors(state) -> dict:
    """{path: tensor} of a state's params, model state and optimizer
    slots."""
    out = {f"p.{k}": v.detach() for k, v in state.params.items()}
    out.update({f"s.{k}": v for k, v in state.model_state.items()})

    def walk(tree, path):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            tree = tree._asdict()
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}.{k}")
        elif isinstance(tree, torch.Tensor):
            out[path] = tree

    walk(state.opt_state, "o")
    return out


def _serve_answers(servable: str, step: int, requests, dev) -> list:
    """``serve_latest`` of ``servable``'s version ``step``, one request at a
    time (so every flush holds one request, the same on every engine)."""
    export_lib.write_latest(servable, str(step))
    buckets = export_lib.serving_buckets(256)
    engine = ServingEngine.serve_latest(
        servable, max_batch=256, max_delay_ms=1.0, inflight=1,
        buckets=buckets, watcher_kw={"loader": lambda path: (
            export_lib.load_serving(path, buckets=buckets, device=dev))})
    try:
        return [engine.submit(ids, vals).result(timeout=300)
                for ids, vals in requests]
    finally:
        engine.close(timeout=60)


def mp_phase(workdir: str, data: dict, cfg: Config,
             dev: torch.device) -> dict:
    """The model axis on one card: two gloo ranks on ``dev`` (NCCL takes
    one rank a card), the launcher's train task for every leg of
    ``MP_LEGS`` at the reference width, one epoch at a global B of 1,024.
    The model-only legs (1x2: the dense update over masked_psum and
    allgather_table, the row plane monolithic and hashed) must end with
    checkpoints (the gathered full state) equal bit for bit to one
    device's run of the same task, each rank's kernel launches must equal
    the one-device run's (dense legs) or one plan, one segments build, two
    takes forward and two backward a step (row legs), each rank must hold
    half of one device's embedding bytes, and two artifacts exported from
    1x2 states must answer ``serve_latest``'s requests as the one-device
    artifacts do, bit for bit. The data-only row plane (2x1, leg iii) is
    held against one device on the same global batches as the DP phase
    holds its runs. Returns {leg: rank 0's train-task launches}."""
    t0 = time.perf_counter()
    world = 2
    cfgs = {leg: _mp_leg_cfg(cfg, os.path.join(workdir, leg), data, leg)
            for leg in MP_LEGS}
    spec = {"world": world, "device": str(dev),
            "argv": {leg: _launch_argv(c, "train") for leg, c in cfgs.items()},
            "store": os.path.join(workdir, "mp_store"),
            "out": os.path.join(workdir, "mp_out")}
    spec_path = os.path.join(workdir, "mp_spec.json")
    with open(spec_path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    logs = [os.path.join(workdir, f"mp_rank{r}.log") for r in range(world)]
    cmds = [[sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.mp_rank_main("
             f"{spec_path!r}, {r}))"] for r in range(world)]
    env = _dp_env(**{loop_lib.TIME_COLLECTIVES_ENV: "1"})
    _run_children(cmds, env, logs, MP_RANK_TIMEOUT_S)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(f"{spec['out']}.{r}.json", encoding="utf-8") as f:
            ranks.append(json.load(f))
    text = [open(p, encoding="utf-8").read() for p in logs]
    for what in ("checkpoint saved", "exported servable"):
        assert what in text[0], what
        assert what not in text[1], what
    print(f"mp: {world} gloo ranks on {dev} ({len(MP_LEGS)} train tasks in "
          f"{wall:.1f}s), exchange transport "
          f"{ranks[0]['train_mp_rows']['transport']} ({card_line()})")
    launches = {}
    files = tasks.resolve_files(data["dir"], "tr")
    rng = np.random.default_rng(SEED)
    requests = [(rng.integers(0, cfg.feature_size, (n, cfg.field_size)
                              ).astype(np.int32),
                 rng.random((n, cfg.field_size), dtype=np.float32))
                for n in rng.choice(REQUEST_SIZES, size=MP_SERVE_REQUESTS)]
    for leg, (d, m, _) in MP_LEGS.items():
        c = cfgs[leg]
        res = [rk[leg]["result"] for rk in ranks]
        counts = [rk[leg]["launches"] for rk in ranks]
        place = [rk[leg]["placement"] for rk in ranks]
        steps = int(res[0]["steps"])
        launches[leg] = counts[0]
        assert counts[0] == counts[1], (leg, counts)
        print(f"mp {leg} ({d or world}x{m}): steps={steps} loss="
              f"{res[0]['loss']:.6f} examples_per_sec (all ranks)="
              f"{res[0]['examples_per_sec']:.1f} step_ms_p50="
              f"{res[0]['step_ms_p50']:.3f} (host clock) dispatch_device_ms="
              f"{res[0].get('dispatch_device_ms', float('nan')):.4f} "
              f"exchange_bytes={res[0].get('exchange_bytes', 0):.0f} "
              f"exchange_ms (median a step)="
              f"{res[0].get('exchange_device_ms', float('nan')):.4f} "
              f"collective_device_ms="
              f"{res[0].get('collective_device_ms', float('nan')):.4f}; "
              f"rank launches {counts[0]}")
        one_place = placement_bytes(c.replace(mesh_data=0, mesh_model=1),
                                    dev)
        print(f"mp {leg} embedding bytes per rank: "
              f"{[p['embedding_bytes'] for p in place]} counted, "
              f"{[p['allocated'] for p in place]} allocated by placement; "
              f"one device {one_place['embedding_bytes']} counted, "
              f"{one_place['allocated']} allocated")
        if m > 1:
            # Half the embedding state a rank; the rest of the state (the
            # tower and its slots) is replicated, allocated alike.
            for p in place:
                assert 2 * p["embedding_bytes"] == \
                    one_place["embedding_bytes"], (leg, p, one_place)
                if dev.type == "cuda":
                    rest = p["allocated"] - p["embedding_bytes"]
                    one_rest = (one_place["allocated"]
                                - one_place["embedding_bytes"])
                    assert abs(rest - one_rest) <= 0.01 * \
                        one_place["allocated"], (leg, p, one_place)
        if d == 0:  # leg iii: the data axis only
            _dp_hold("dp rows", c, dev, files, world, res[0]["loss"])
            assert dev.type != "cuda" or counts[0]["plan_build"] == steps, \
                counts[0]
            continue
        # The same task on one device: its checkpoint, its launches.
        one = c.replace(mesh_model=1, model_dir=os.path.join(
            workdir, leg + "_one", "ckpt"), servable_model_dir=os.path.join(
            workdir, leg + "_one", "srv"))
        _zero_counts()
        launch_task(one, "train", dev)
        single = _counts()
        a = _state_tensors(_restored(c, dev))
        b = _state_tensors(_restored(one, dev))
        assert set(a) == set(b), (sorted(a), sorted(b))
        same = all(torch.equal(a[k], b[k]) for k in b)
        print(f"mp {leg}: the 1x2 checkpoint (gathered tables, optimizer "
              f"slots, BN) restored on one device equals one device's run "
              f"bit for bit: {same}; one-device launches {single}")
        assert same, [k for k in b if not torch.equal(a[k], b[k])]
        # On the CPU (a rehearsal) the wrappers launch nothing.
        if c.embedding_shard == "rows" and dev.type == "cuda":
            want = dict(single, plan_build=steps, take_fwd=2 * steps,
                        take_bwd=2 * steps, segments=steps)
            assert counts[0] == want, (counts[0], want)
        else:
            assert counts[0] == single, (counts[0], single)
        if leg in MP_SERVED:
            got = _serve_answers(c.servable_model_dir, steps, requests, dev)
            want = _serve_answers(one.servable_model_dir, steps, requests,
                                  dev)
            equal = all(np.array_equal(x, y) for x, y in zip(got, want))
            print(f"mp {leg}: the 1x2 artifact served by serve_latest "
                  f"answers {len(requests)} requests as the one-device "
                  f"artifact does, bit for bit: {equal}")
            assert equal
    print(f"mp phase: {time.perf_counter() - t0:.1f}s")
    return launches


def mp_child_main(argv, device: str = "cuda") -> int:
    """One NCCL rank of a four-card model-axis run (a ``fanout`` child, one
    card; gloo on the CPU in a rehearsal): the placement bytes of its state
    on the task's process group as a ``{"task": "placement", ...}`` line,
    then the launcher's task on the same group."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_lib.parse_args(argv)
    dev = torch.device(device)
    bootstrap.initialize(cfg, device=dev)
    print(json.dumps({"task": "placement", **placement_bytes(cfg, dev)}),
          flush=True)
    return launch.main(argv, device=dev)


def _fanout_mp(workdir: str, name: str, cfg: Config, n: int,
               env: dict, dev: torch.device) -> dict:
    """``fanout --worker_per_host n`` of ``cfg``'s train task with
    :func:`mp_child_main` children: {task: {rank: line}}."""
    log = os.path.join(workdir, f"{name}.log")
    argv = ["--worker_per_host", str(n), "--coordinator_address",
            f"file://{os.path.join(workdir, name + '_store')}",
            *_launch_argv(cfg, "train")]
    child = [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.mp_child_main(sys.argv[1:], "
             f"{dev.type!r}))"]
    cmd = [sys.executable, "-c", "import sys, json; from deepfm_tpu_torch "
           "import fanout; sys.exit(fanout.main(json.loads(sys.argv[1]), "
           "child=json.loads(sys.argv[2])))", json.dumps(argv),
           json.dumps(child)]
    t0 = time.perf_counter()
    _run_children([cmd], env, [log], MP_RANK_TIMEOUT_S)
    out: dict = {}
    with open(log, encoding="utf-8") as f:
        for line in f:
            if line.startswith("[worker ") and '{"task"' in line:
                rank = int(line[len("[worker "):line.index("]")])
                res = json.loads(line[line.index("{"):])
                out.setdefault(res["task"], {})[rank] = res
    assert sorted(out.get("train", {})) == list(range(n)), out.keys()
    print(f"mp {name}: fanout --worker_per_host {n} in "
          f"{time.perf_counter() - t0:.1f}s")
    return out


def _mp_rank_lines(name: str, out: dict, d: int, m: int) -> None:
    for r, t in sorted(out["train"].items()):
        xb = t.get("exchange_bytes", 0.0)
        print(f"mp {name} rank {r} ({d}x{m}, NCCL): examples_per_sec (all "
              f"ranks)={t['examples_per_sec']:.1f} step_ms_p50="
              f"{t['step_ms_p50']:.3f} (host clock) dispatch_device_ms="
              f"{t.get('dispatch_device_ms', float('nan')):.4f} exchange: "
              f"{xb:.0f} bytes a step, device ms (median) "
              f"{t.get('exchange_device_ms', float('nan')):.4f} against "
              f"{xb / NVLINK_BYTES_PER_S * 1e3:.4f} over NVLink; gradient "
              f"all_reduce device ms (median) "
              f"{t.get('collective_device_ms', float('nan')):.4f} over "
              f"{t.get('collective_bytes', 0) / max(t.get('collective_applies', 1), 1):.0f}"
              f" bytes; placement {out['placement'][r]} ({card_line()})")


def mp_nccl_phase(workdir: str, data: dict, cfg: Config,
                  dev: torch.device) -> None:
    """The model axis on four cards over NCCL (``--phase mp``): the row
    plane, monolithic and hashed, at 1x4 (its checkpoint bit-equal to one
    device's run) and 2x2 (held against one device on the global batches
    as the DP phase holds its runs), with per-rank rates, the exchange's
    device ms against its NVLink bound and the gradient all_reduce's; then
    the 4 x 4,194,304 hashed table at 1x4 with each card's embedding bytes
    against one device's."""
    n = torch.cuda.device_count()
    if n < 4:
        print(f"mp nccl: {n} card(s) visible; the 1x4 and 2x2 runs need "
              "four")
        return
    env = _dp_env(**{loop_lib.TIME_COLLECTIVES_ENV: "1"})
    files = tasks.resolve_files(data["dir"], "tr")
    for leg in ("train_mp_rows", "train_mp_rows_hashed"):
        for d, m in ((1, 4), (2, 2)):
            name = f"{leg}_{d}x{m}"
            c = _mp_leg_cfg(cfg, os.path.join(workdir, name), data,
                            leg).replace(mesh_data=d, mesh_model=m)
            out = _fanout_mp(workdir, name, c, n, env, dev)
            _mp_rank_lines(name, out, d, m)
            one = c.replace(mesh_data=0, mesh_model=1)
            if d == 1:
                ref = one.replace(model_dir=os.path.join(
                    workdir, name + "_one", "ckpt"), servable_model_dir="")
                launch_task(ref, "train", dev)
                a = _state_tensors(_restored(c, dev))
                b = _state_tensors(_restored(ref, dev))
                same = all(torch.equal(a[k], b[k]) for k in b)
                print(f"mp {name}: checkpoint equal to one device's run bit "
                      f"for bit: {same}")
                assert same
            else:
                _dp_hold(name, one, dev, files, d,
                         out["train"][0]["loss"])
    big = _mp_leg_cfg(cfg, os.path.join(workdir, "mp_big"), data,
                      "train_mp_rows_hashed").replace(
        mesh_model=4, embedding_buckets=MP_BIG_BUCKETS,
        servable_model_dir="")
    out = _fanout_mp(workdir, "mp_big_1x4", big, n, env, dev)
    _mp_rank_lines("big_1x4", out, 1, 4)
    one = placement_bytes(big.replace(mesh_model=1, model_dir=""), dev)
    for r, p in sorted(out["placement"].items()):
        print(f"mp big table (4 x 4,194,304 buckets) rank {r}: embedding "
              f"bytes {p['embedding_bytes']} counted, {p['allocated']} "
              f"allocated by placement; one device "
              f"{one['embedding_bytes']} counted, {one['allocated']} "
              f"allocated ({card_line()})")
        assert 4 * p["embedding_bytes"] == one["embedding_bytes"]


# The production phase (serving scale-out and the production loop) at the
# reference width. The full production drill's trainer is a launcher
# subprocess; its kernels' launches stay in that process.
PROD_FRONTEND_CLIENTS = 4
PROD_TRAIN_BATCHES = (16, 32)  # the loop's and the serving drill's trainers
PROD_SEED = 2026            # the production drill's default seed
EXPERIMENT_SEED = 7         # the seed the experiment drill's gates hold at
TRAIN_PATH_KERNELS = ("fused_fm", "fused_fm_bwd", "take_bwd", "segments")
NOT_COUNTED = {"production_full_trainer": (
    "the full production drill's trainer is a deepfm_tpu_torch.launch "
    "subprocess; its launches stay in that process (not counted)"),
    "drill_subprocesses": (
    "the preemption and online drills' held and supervised trainers are "
    "deepfm_tpu_torch.launch subprocesses; drill_preempt and drill_online "
    "count the drill process's own runs, restores and audits")}


def _lat(x) -> str:
    return "none" if x is None else f"{x:.3f}"


def frontend_phase(publish_dir: str, model: dict, dev: torch.device) -> dict:
    """``PROD_FRONTEND_CLIENTS`` spawned clients behind a FrontendServer
    over a fleet like the serving drill's (2 replicas, inflight 2, small
    rows 4) on its last artifact; the clients' gates raise."""
    cfg = serving_drill.drill_cfg(model)
    fleet = ReplicatedEngine.serve_latest(
        publish_dir, replicas=2, poll_secs=0.05,
        max_batch=cfg.serve_max_batch, max_delay_ms=cfg.serve_max_delay_ms,
        inflight=2, small_rows=4, device=dev)
    try:
        deadline = time.monotonic() + 120
        while min(e.watcher.swap_count for e in fleet.engines) < 1:
            assert time.monotonic() < deadline, "fleet never loaded"
            time.sleep(0.02)
        _zero_counts()
        f = serving_drill.run_frontend(fleet, cfg, PROD_FRONTEND_CLIENTS,
                                       serving_drill.FRONTEND_REQUESTS)
    finally:
        fleet.close()
    n = PROD_FRONTEND_CLIENTS
    assert f["exit_codes"] == [0] * n, f
    assert f["responses"] == n * serving_drill.FRONTEND_REQUESTS \
        and f["errors"] == f["timeouts"] == f["dropped_dead_client"] == 0, f
    return f


def print_experiment(exp: dict, card: str) -> None:
    decisions = {s["kind"]: [d[0] + ":" + ",".join(d[2])
                             for d in s["decisions"]]
                 for s in exp["scenarios"]}
    windows = [(w["challenger_n"], w["challenger_auc"], w["control_n"],
                w["control_auc"])
               for w in exp["shadow_validation"] + exp["canary_windows"]]
    pr = exp["primary"]
    print(f"experiment drill (seed {exp['seed']}, model {exp['model']}, "
          f"train_steps {exp['params']['train_steps']}): stable_version="
          f"{exp['stable_version']} promotions="
          f"{exp['promotion']['promotions']} quarantined="
          f"{exp['promotion']['quarantined_versions']} {decisions} "
          f"gate windows (challenger n, auc, control n, auc)={windows} "
          f"shadow={exp['shadow_summary']} primary requests="
          f"{pr['requests']} failed={pr['failed']} p50_ms={_lat(pr['p50_ms'])}"
          f" p99_ms={_lat(pr['p99_ms'])} hot_swaps={pr['hot_swaps']} "
          f"offline_match={exp['arm_health_offline_match']} elapsed_s="
          f"{exp['elapsed_s']} ({card})")


EXPERIMENT_SWEEP_SEEDS = (7, 9, 11, 13, 2026)


def experiment_sweep(workdir: str, dev: torch.device) -> None:
    """The experiment drill at the reference width over
    ``EXPERIMENT_SWEEP_SEEDS``: at the drill's overrides for that width,
    where every seed must pass, then at the JAX drill's parameters
    (``params={}``), where a seed whose gates fail prints the failure."""
    model = serving_drill.reference_model()
    card = card_line()
    for seed in EXPERIMENT_SWEEP_SEEDS:
        print_experiment(prod_drill.run_experiment_drill(
            os.path.join(workdir, f"wide_{seed}"), seed=seed, model=model,
            device=dev), card)
    for seed in EXPERIMENT_SWEEP_SEEDS:
        try:
            exp = prod_drill.run_experiment_drill(
                os.path.join(workdir, f"jax_{seed}"), seed=seed,
                params={}, model=model, device=dev)
        except AssertionError as exc:
            print(f"experiment drill (seed {seed}, model {model}, JAX "
                  f"parameters): failed: {exc} ({card})")
        else:
            print_experiment(exp, card)


def production_phase(workdir: str, cfg: Config, dev: torch.device) -> dict:
    """The port's serving scale-out and production loop at the reference
    width, through the drills a user runs (``deepfm_tpu_torch.drills``);
    every gate of a drill raises. Returns ``launches_by_path`` entries:
    ``serve_replicas`` (the fleet's closed-loop phase beside its live
    publisher's train steps), ``serve_frontend`` (the spawned clients),
    ``serve_single`` (one engine at the same load), ``production_smoke``
    (the in-process loop), ``production_serve`` (the full loop's drill
    process: its trainer is a subprocess), ``experiment`` (at ``cfg``'s
    width, with the drill's overrides for it) and ``cascade_drills``
    (overload and cache, at their own small DIN cascade). On the CPU (a
    rehearsal at a small ``cfg``) no kernel launches and none is required
    to."""
    model = serving_drill.model_of(cfg)
    card = card_line()
    paths = {}

    def read(name, kernels):
        c = _counts()
        if dev.type == "cuda":
            missing = [k for k in kernels if c[k] == 0]
            assert not missing, f"{name}: {missing} never launched"
        paths[name] = c

    print(f"production phase: model {model} on {dev} ({card})")
    _zero_counts()
    fleet_dir = os.path.join(workdir, "serving_fleet")
    fleet = serving_drill.run_drill(
        fleet_dir, verbose=False, replicas=2, inflight=2, small_rows=4,
        model=model, device=dev)
    read("serve_replicas", TRAIN_PATH_KERNELS)
    f = frontend_phase(os.path.join(fleet_dir, "publish"), model, dev)
    read("serve_frontend", ("fused_fm",))
    _zero_counts()
    single = serving_drill.run_drill(
        os.path.join(workdir, "serving_single"), verbose=False, replicas=1,
        inflight=2, small_rows=4, model=model, device=dev)
    read("serve_single", TRAIN_PATH_KERNELS)
    for name, r in (("fleet (2 replicas)", fleet), ("single engine", single)):
        print(f"serving drill {name}: requests={r['serving_requests']} "
              f"p50_ms={_lat(r['serving_p50_ms'])} "
              f"p99_ms={_lat(r['serving_p99_ms'])} "
              f"qps={r['serving_qps']} small_p99_ms="
              f"{_lat(r['serving_small_p99_ms'])} occupancy_pct="
              f"{r['batch_occupancy_pct']} hot_swaps={r['hot_swaps']} "
              f"blackout_ms_per_replica={r['swap_blackout_ms_per_replica']} "
              f"failed={r['serving_failed']} versions="
              f"{r['versions_published']} elapsed_s={r['elapsed_s']} "
              f"({card})")
    print(f"serving drill frontend: {f['clients']} spawned clients, "
          f"{f['responses']} responses, errors={f['errors']} "
          f"timeouts={f['timeouts']} exit_codes={f['exit_codes']} "
          f"requests_per_s={f['requests_per_s']} serving_s="
          f"{f['serving_s']} spawn_s={f['spawn_s']} wall_s={f['wall_s']}; "
          f"padded==unpadded bit for bit at n=1,3,5,16,23,64 ({card})")

    _zero_counts()
    smoke = prod_drill.run_smoke(os.path.join(workdir, "production_smoke"),
                                 model=model, device=dev)
    read("production_smoke", TRAIN_PATH_KERNELS)
    _zero_counts()
    full = prod_drill.run_full(os.path.join(workdir, "production_full"),
                               seed=PROD_SEED, model=model, device=dev)
    read("production_serve", ("fused_fm",))
    for r in (smoke, full):
        st, sv, rl = r["staleness"], r["serving"], r["request_loss"]
        lat = [x for t in ([r["publish"]["trainer"]]
                           if isinstance(r["publish"]["trainer"], dict)
                           else r["publish"]["trainer"])
               for x in (t or {}).get("publish_latencies_s", [])]
        print(f"production {r['mode']}: chaos {r['chaos']['fingerprint']} "
              f"(crash fired {r['chaos']['publish_crash_fired']}, "
              f"SIGTERMs at {r['chaos']['preemptions_sent_at_logical_s']}, "
              f"supervised restarts {r['chaos']['supervised_restarts']}) "
              f"audit {r['determinism']['audit_fingerprint']} rows="
              f"{r['traffic']['rows']} lost={rl['failed']} "
              f"overloads={rl['overloads']} hot_swaps={rl['hot_swaps']} "
              f"versions={r['publish']['versions']} skew_audited="
              f"{r['skew']['records_audited']} mismatches="
              f"{r['skew']['mismatches']} staleness_p50_s="
              f"{st['staleness_p50_s']} p95_s={st['staleness_p95_s']} "
              f"(bound {st['bound_s']}) publish_latency_p50_s="
              f"{_lat(float(np.percentile(lat, 50)) if lat else None)} "
              f"max_s={_lat(max(lat) if lat else None)} serve_p50_ms="
              f"{_lat(sv['serving_p50_ms'])} p99_ms="
              f"{_lat(sv['serving_p99_ms'])} qps={sv['serving_qps']} "
              f"elapsed_s={r['elapsed_s']} "
              f"({card})")

    _zero_counts()
    exp = prod_drill.run_experiment_drill(
        os.path.join(workdir, "experiment"), seed=EXPERIMENT_SEED,
        model=model, device=dev)
    read("experiment", TRAIN_PATH_KERNELS)
    print_experiment(exp, card)

    _zero_counts()
    pub = prod_drill.build_cascade_artifact(
        os.path.join(workdir, "cascade", "publish"), device=dev)
    over = prod_drill.run_overload_drill(
        os.path.join(workdir, "overload"), seed=7, publish_dir=pub,
        device=dev)
    cache = prod_drill.run_cache_drill(
        os.path.join(workdir, "cache"), seed=7, publish_dir=pub, device=dev)
    read("cascade_drills", ("fused_fm",))
    on = cache["on"]
    print(f"overload drill: max_rung={over['max_rung']} "
          f"({over['rung_names'][over['max_rung']]}) counters="
          f"{over['counters']} sheds={over['sheds']} recovered="
          f"{over['recovered']} recovery_s={over['recovery_s']} audit "
          f"{over['audit_fingerprint']}; cache drill: bit_identical="
          f"{cache['bit_identical']} hits={on['cache_hits']}/"
          f"{on['requests']} hit_rate={on['cache_hits'] / on['requests']:.3f}"
          f" user_hits={on['user_cache_hits']} ({card})")
    return paths


# ---------------------------------------------------------------------------
# The fault, preemption and online drills; the remote seam; the MFU basis
# ---------------------------------------------------------------------------

REMOTE_ROOT = "mock://chip-smoke"
REMOTE_RECORDS = 512      # LibSVM lines through the converter
REMOTE_SHARDS = 2
REMOTE_SERVE_ROWS = 256   # one served batch: a full serving flush


def drills_phase(workdir: str, cfg: Config, dev: torch.device) -> dict:
    """The port's fault, preemption and online drills at ``cfg``'s width,
    each at its own record counts (every bit-identity assertion raises).
    Returns ``launches_by_path`` entries ``drill_fault``, ``drill_preempt``
    and ``drill_online``: the launches of each drill's own process (its
    in-process runs, restores and audits); the launcher subprocesses'
    launches stay in those processes."""
    model = serving_drill.model_of(cfg)
    card = card_line()
    paths = {}

    def read(name):
        c = _counts()
        if dev.type == "cuda":
            missing = [k for k in TRAIN_PATH_KERNELS if c[k] == 0]
            assert not missing, f"{name}: {missing} never launched"
        paths[name] = c

    print(f"drills phase: model {model} on {dev} ({card})")
    _zero_counts()
    f = fault_drill.run_drill(os.path.join(workdir, "drill_fault"),
                              model=model, device=dev, verbose=False)
    read("drill_fault")
    print(f"drill fault: seconds={f['seconds']} runs={f['runs']} "
          f"subprocesses=0 restarts=0 steps={f['steps']} read_faults "
          f"injected={f['read_faults_injected']} healed="
          f"{f['read_faults_healed']} bad_records_skipped="
          f"{f['bad_records']} save_faults injected="
          f"{f['save_faults_injected']} healed="
          f"{f['save_faults_injected']} raise_policy names {f['victim'][0]} "
          f"at byte {f['victim'][1]}; params bit-identical to the clean "
          f"run on the staged, decoded_cache and device_dataset paths "
          f"({card})")
    _zero_counts()
    p = preempt_drill.run_drill(os.path.join(workdir, "drill_preempt"),
                                model=model, device=dev, verbose=False)
    read("drill_preempt")
    sub = sum(p[k]["subprocesses"] for k, _ in preempt_drill.PATHS)
    print(f"drill preempt: seconds={p['seconds']} subprocesses={sub} "
          + " ".join(f"{k}: steps={p[k]['steps']} restarts="
                     f"{p[k]['restarts']} sigterm_and_self_preempts="
                     f"{p[k]['exit_42']} exit_42={p[k]['exit_42']} "
                     f"resumed={p[k]['exit_42']}"
                     for k, _ in preempt_drill.PATHS)
          + f"; params bit-identical to the uninterrupted baseline on both "
          f"paths ({card})")
    _zero_counts()
    o = online_drill.run_drill(os.path.join(workdir, "drill_online"),
                               model=model, device=dev, verbose=False)
    read("drill_online")
    print(f"drill online: seconds={o['seconds']} subprocesses="
          f"{o['subprocesses']} restarts={o['restarts']} steps={o['steps']} "
          f"preemptions injected={o['exit_42']} healed={o['exit_42']} "
          f"(read faults every {online_drill.READ_FAULT_EVERY}th read in "
          f"the held child) shards_admitted={o['shards_admitted']} "
          f"versions={o['versions_live']} bit-equal to a clean replay: "
          f"{o['versions_bit_equal']} ({card})")
    return paths


class LocalStore:
    """``tf.io.gfile``'s duck type over a local directory, for the remote
    seam: ``scheme://rest`` is ``<root>/rest``. Counts its calls by op."""

    def __init__(self, root: str):
        self.root = root
        self.ops = {}

    def _local(self, path: str, op: str = "") -> str:
        if op:
            self.ops[op] = self.ops.get(op, 0) + 1
        return os.path.join(self.root, *path.split("://", 1)[1].split("/"))

    def GFile(self, path, mode="r"):  # noqa: N802 (gfile's name)
        local = self._local(path, "GFile")
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(local), exist_ok=True)
        return open(local, mode)

    def glob(self, pattern):
        scheme = pattern.split("://", 1)[0]
        return [f"{scheme}://"
                + os.path.relpath(p, self.root).replace(os.sep, "/")
                for p in glob.glob(self._local(pattern, "glob"))]

    def isdir(self, path):
        return os.path.isdir(self._local(path, "isdir"))

    def exists(self, path):
        return os.path.exists(self._local(path, "exists"))

    def stat(self, path):
        return types.SimpleNamespace(
            length=os.path.getsize(self._local(path, "stat")))

    def makedirs(self, path):
        os.makedirs(self._local(path, "makedirs"), exist_ok=True)

    def rmtree(self, path):
        shutil.rmtree(self._local(path, "rmtree"))

    def remove(self, path):
        os.remove(self._local(path, "remove"))

    def rename(self, src, dst, overwrite=False):
        s, d = self._local(src, "rename"), self._local(dst)
        if os.path.exists(d) and overwrite:
            shutil.rmtree(d)
        os.rename(s, d)


def _libsvm_lines(cfg: Config, n: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.feature_size, (n, cfg.field_size))
    vals = rng.random((n, cfg.field_size), dtype=np.float32)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    return [libsvm.format_libsvm_line(float(labels[i]), ids[i], vals[i])
            for i in range(n)]


def remote_phase(workdir: str, cfg: Config, dev: torch.device) -> dict:
    """The fileio seam over :class:`LocalStore` at ``cfg``'s width: a
    checkpoint saved and restored bit for bit, an artifact exported and
    published on the store and one batch served from it bit-equal to the
    same weights exported locally, and a TFRecord round trip through the
    converter. Returns the ``launches_by_path`` entry ``remote_seam``."""
    store = LocalStore(os.path.join(workdir, "store"))
    prev = fileio.set_remote_fs(store)
    t0 = time.time()
    try:
        _zero_counts()
        trainer = Trainer(cfg, device=dev)
        state = trainer.init_state(SEED)
        for b in random_batches(cfg, 2, SEED + 1):
            state, _ = trainer.train_step(state, trainer.put_batch(b))
        step = int(state.step)
        mgr = ckpt_lib.CheckpointManager(f"{REMOTE_ROOT}/ckpt")
        mgr.save(step, state, force=True)
        back = mgr.restore(trainer.init_state(SEED + 7))
        mgr.close()
        assert back.step == step
        for k in state.params:
            assert torch.equal(back.params[k], state.params[k]), k
        assert torch.equal(back.rng.get_state(), state.rng.get_state())

        model = trainer.servable_model(state)
        remote = export_lib.export_serving(
            model, cfg, f"{REMOTE_ROOT}/servable/{step}", step=step)
        local = export_lib.export_serving(
            model, cfg, os.path.join(workdir, "servable_local", str(step)),
            step=step)
        pub = Publisher(cfg, f"{REMOTE_ROOT}/publish")
        pub.publish_now(state, step)
        pub.close()
        latest = export_lib.read_latest(f"{REMOTE_ROOT}/publish")
        assert latest == f"{REMOTE_ROOT}/publish/{step}", latest
        batch = random_batches(cfg.replace(batch_size=REMOTE_SERVE_ROWS), 1,
                               SEED + 2)[0]
        want = export_lib.load_serving(local, device=dev)(
            batch["feat_ids"], batch["feat_vals"])
        for path in (remote, latest):
            got = export_lib.load_serving(path, device=dev)(
                batch["feat_ids"], batch["feat_vals"])
            assert np.array_equal(got, want), (path, np.abs(got - want).max())
        counts = _counts()
        if dev.type == "cuda":
            missing = [k for k in TRAIN_PATH_KERNELS if counts[k] == 0]
            assert not missing, f"remote_seam: {missing} never launched"

        text = os.path.join(workdir, "remote.libsvm")
        lines = _libsvm_lines(cfg, REMOTE_RECORDS, SEED + 3)
        with open(text, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        out = f"{REMOTE_ROOT}/data/tr.tfrecords"
        assert libsvm_to_tfrecord.main(
            ["--input", text, "--output", out, "--field-size",
             str(cfg.field_size), "--num-shards", str(REMOTE_SHARDS)]) == 0
        loc = os.path.join(workdir, "remote_local", "tr.tfrecords")
        libsvm.convert_libsvm_file(text, loc, field_size=cfg.field_size,
                                   num_shards=REMOTE_SHARDS)
        shards = fileio.glob(f"{REMOTE_ROOT}/data/tr.tfrecords-*")
        assert len(shards) == REMOTE_SHARDS, shards
        back_lines = []
        for i, shard in enumerate(shards):
            suffix = f"-{i:05d}-of-{REMOTE_SHARDS:05d}"
            assert shard.endswith(suffix)
            with open(loc + suffix, "rb") as f:
                assert fileio.read_bytes(shard) == f.read(), shard
            txt = os.path.join(workdir, f"remote_back{i}.libsvm")
            n = libsvm.tfrecord_to_libsvm(shard, txt, cfg.field_size)
            assert n == len(tfrecord.read_all_records(shard))
            with open(txt, encoding="utf-8") as f:
                back_lines.append(f.read().splitlines())
        # Round-robin shards: record i is line i // shards of shard i % k.
        assert [back_lines[i % REMOTE_SHARDS][i // REMOTE_SHARDS]
                for i in range(REMOTE_RECORDS)] == lines
    finally:
        fileio.set_remote_fs(prev)
    assert not os.path.exists(os.path.join(HERE, "mock:"))
    print(f"remote seam: {REMOTE_ROOT} over a local stand-in; checkpoint "
          f"step {step} saved and restored bit for bit; artifact exported, "
          f"published (LATEST -> {latest.rsplit('/', 1)[-1]}) and "
          f"{REMOTE_SERVE_ROWS} rows served bit-equal to the local export; "
          f"{REMOTE_RECORDS} records converted into {REMOTE_SHARDS} shards "
          f"byte-identical to a local conversion and read back; ops "
          f"{dict(sorted(store.ops.items()))}; "
          f"{time.time() - t0:.2f}s ({card_line()})")
    return {"remote_seam": counts}


class PhaseClock:
    """Wall seconds of the smoke's phases, one line as each ends: where the
    script's time limit goes."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f}s (total "
              f"{now - self.t0:.1f}s)", flush=True)
        self.t = now


def mfu_line() -> None:
    peak, name, basis = mfu_lib.device_peak_flops("cuda")
    print(f"mfu: device_peak_flops={peak!r} name={name!r} basis={basis} "
          f"(utils/mfu.py: NVIDIA H100 Tensor Core GPU datasheet, dense "
          f"BF16) ({card_line()})")
    assert basis == mfu_lib.BASIS_MEASURED, (name, basis)


def drills_seam_phases(workdir: str, cfg: Config, dev: torch.device) -> dict:
    """Phases 16 and 17 (``--phase drills``)."""
    paths = drills_phase(workdir, cfg, dev)
    paths.update(remote_phase(workdir, cfg, dev))
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # The native decoder (g++) builds beside the kernels (nvcc).
    decoder = {}

    def build_decoder():
        try:
            decoder["s"] = tfr_loader.build()
        except Exception as exc:  # noqa: BLE001 (re-raised below)
            decoder["error"] = exc

    builder = threading.Thread(target=build_decoder)
    builder.start()
    build_s = _native.build()
    builder.join()
    if "error" in decoder:
        raise decoder["error"]
    print(f"kernel build: {build_s:.2f}s (nvcc {' '.join(_native.NVCC_FLAGS)})")
    print(f"decoder build: {decoder['s']:.2f}s (g++ "
          f"{' '.join(tfr_loader.GXX_FLAGS)}), in parallel with the kernels")
    if sys.argv[1:] in (["--phase", "mp"], ["--phase", "mp_gloo"]):
        # The model axis alone: mp_gloo, the default smoke's one-card phase
        # (two gloo ranks on card 0); mp, the NCCL runs on four cards. No
        # result lines.
        workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
        try:
            cfg = Config()
            data = make_train_data(workdir, cfg)
            if sys.argv[2] == "mp_gloo":
                mp_phase(workdir, data, cfg, torch.device("cuda"))
            else:
                mp_nccl_phase(workdir, data, cfg, torch.device("cuda"))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["--phase", "production"]:
        # The production phase alone (a quick check of that path); no
        # result lines.
        workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
        try:
            production_phase(workdir, Config(), torch.device("cuda"))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["--phase", "drills"]:
        # Phases 16 and 17 alone: the fault, preemption and online drills,
        # the remote seam and the MFU line; no result lines.
        mfu_line()
        workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
        try:
            drills_seam_phases(workdir, Config(), torch.device("cuda"))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["--phase", "experiment"]:
        # The experiment drill's seed sweep at the reference width; no
        # result lines.
        workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
        try:
            experiment_sweep(workdir, torch.device("cuda"))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0
    if sys.argv[1:] == ["--phase", "take_bwd"]:
        # Every take-backward check of the kernel phases (one table a
        # launch, the hashed step's four tables, segment_sum, the
        # accumulation group's and the history lookup's shapes) and the
        # long-run path at the benchmark cell's shape; no result lines.
        take_phase()
        segment_sum_phase()
        accum_kernels_phase()
        history_kernels_phase()
        take_bwd_long_phase()
        return 0
    if sys.argv[1:] == ["--phase", "dp"]:
        # The data-parallel phase alone (a quick check of that path); no
        # result lines.
        workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
        try:
            cfg = Config()
            dp_phase(workdir, make_train_data(workdir, cfg), cfg,
                     torch.device("cuda"))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        return 0

    clock = PhaseClock()
    mfu_line()
    fm_err, fm_t = kernel_phase()
    kern_ms, plain_ms, bound_ms, bound_by, ms_source = fm_t[TIMED_SHAPE]
    bwd_err, (bwd_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by,
              bwd_source) = kernel_bwd_phase()
    plan_t = plan_phase()
    seg_kernel_t = segments_kernel_phase()
    take_err, take_t, seg_t = take_phase()
    segment_sum_phase()
    for b in PROD_TRAIN_BATCHES:  # the production trainers' dense lookups
        segment_sum_phase(n=b * 39, cases=SEGMENT_SUM_CASES[:2])
    install_t = install_phase()
    accum_t = accum_kernels_phase()
    hist_t = history_kernels_phase()
    take_bwd_long_phase()
    clock.lap("kernels")

    cfg = Config()
    dev = torch.device("cuda")
    determinism_phase(cfg, dev)
    train_parity_phase(cfg, dev)
    tiered_parity_phase(cfg, dev)
    accum_parity_phase(cfg, dev)
    staging_phase(cfg, dev)
    guard_phase(cfg, dev)
    watchdog_phase(cfg, dev)
    clock.lap("parity and runtime")
    workdir = tempfile.mkdtemp(prefix=".chip_smoke_", dir=HERE)
    try:
        data = make_train_data(workdir, cfg)
        decoder_phase(data, cfg)
        golden_phase(workdir)
        clock.lap("data and decoder")
        paths = {}
        paths["train"], dense_res = train_phase(workdir, data, cfg, dev)
        # One epoch: the per-record path's rate is the point, and a
        # second epoch costs ~8 s.
        paths["train_per_record"] = train_phase(
            workdir, data, cfg.replace(use_native_decoder=False), dev,
            name="dense_per_record", epochs=1)[0]
        for name, kw in {**SPARSE_LAYOUTS, "sparse_tiered": TIERED}.items():
            paths["train_" + name] = train_phase(
                workdir, data, cfg.replace(**kw), dev, name=name)[0]
        clock.lap("train tasks")
        paths.update(cache_phase(workdir, data, cfg, dev))
        paths.update(dd_phase(workdir, data, cfg, dev))
        clock.lap("cache and device-resident")
        bad_records_phase(workdir, data, cfg, dev)
        clock.lap("bad records")
        paths["train_pipe"] = pipe_phase(workdir, data, cfg, dev,
                                         dense_res["examples_per_sec"])
        paths["train_input_workers"] = input_service_phase(workdir, data,
                                                           cfg, dev)
        paths["train_online"], serve_online = online_phase(workdir, data,
                                                           cfg, dev)
        paths["serve_online"] = {**{k: 0 for k in paths["train_online"]},
                                 "fused_fm": serve_online}
        paths["train_online_hashed"] = online_resume_phase(workdir, data,
                                                           cfg, dev)
        profiler_phase(workdir, data, cfg, dev)
        clock.lap("pipe, input service, online, profiler")
        for name, kw in ACCUM_LAYOUTS.items():
            paths["train_accum_" + name] = train_phase(
                workdir, data, cfg.replace(grad_accum_steps=ACCUM,
                                           steps_per_loop=8, **kw),
                dev, name="accum_" + name, epochs=1)[0]
        rollback_preempt_phase(workdir, cfg, dev)
        clock.lap("accumulation tasks, rollback and preemption")
        zoo_paths, zoo_artifacts, zoo_data = zoo_phase(workdir, cfg, dev,
                                                       data)
        paths.update(zoo_paths)
        clock.lap("zoo")
        retrieval_paths, retrieval_t = retrieval_phase(
            workdir, cfg.replace(**ZOO["din"]), dev, zoo_data["history"],
            zoo_artifacts["din"])
        paths.update(retrieval_paths)
        clock.lap("retrieval")
        paths.update(dp_phase(workdir, data, cfg, dev))
        clock.lap("data parallelism")
        paths.update(mp_phase(workdir, data, cfg, dev))
        clock.lap("model axis")
        train_step_timing(cfg)
        accum_step_timing(cfg)
        serve_launches, artifact = serve_phase(workdir, cfg, dev)
        forward_timing(artifact, cfg)
        clock.lap("step timings and serve")
        paths.update(production_phase(workdir, cfg, dev))
        clock.lap("production")
        paths.update(drills_seam_phases(workdir, cfg, dev))
        clock.lap("drills and remote seam")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    def by_path(kernel):
        return {p: c[kernel] for p, c in paths.items()}

    hashed = paths["train_sparse_hashed"]
    # The main path's shapes: the hashed step's four-table plan launch, its
    # four-table take forward and backward, at D = 32.
    (pk, pp, pl, pb, pby, psrc) = plan_t[HASHED_TABLES]
    ak, ap, al, ab = accum_t["plan"]
    plan = {
        "ms": pk, "plain_ms": pp, "library_ms": pl,
        "library_call": "torch.unique over the four tables' ids at once",
        "bound_ms": pb, "bound_by": pby, "ms_source": psrc,
        "floor_ms": plan_t["floor"],
        "by_tables": {str(t): {"ms": v[0], "plain_ms": v[1],
                               "library_ms": v[2], "bound_ms": v[3]}
                      for t, v in plan_t.items() if t != "floor"},
        "accum_group": {"n": ACCUM_N, "ms": ak[0], "plain_ms": ap[0],
                        "library_ms": al[0], "bound_ms": ab[0]}}
    take = {}
    for name in ("take_fwd", "take_bwd"):
        (k, _, src), (p, _, _), (lb, _, _), (bd, by) = take_t[
            (name, HASHED_TABLES, 32)]
        take[name] = {
            "ms": k, "plain_ms": p, "library_ms": lb, "bound_ms": bd,
            "bound_by": by, "ms_source": src,
            "by_shape": {f"T{t}_D{d}": {
                "ms": v[0][0], "plain_ms": v[1][0], "library_ms": v[2][0],
                "bound_ms": v[3][0]}
                for (n, t, d), v in take_t.items() if n == name}}
        take[name]["by_shape"].update({f"T{t}_D{d}_accum_group": {
            "ms": v[0][0], "plain_ms": v[1][0], "library_ms": v[2][0],
            "bound_ms": v[3][0]}
            for (n, t, d), v in accum_t["take"].items() if n == name})
    take["take_fwd"]["library_call"] = (
        "embedding_bag(mode='sum', per_sample_weights=masks) over the "
        "tables concatenated")
    take["take_bwd"]["library_call"] = (
        "one index_add_ over the tables' outputs end to end")
    take["take_bwd"]["segments_build"] = {
        k: {"device_ms": v[0], "device_events": v[1], "call_ms": v[2]}
        for k, v in seg_t.items()}
    (sk_, _, _), (sl_, _, _) = accum_t["segment_sum"]["fused_leg"]
    take["take_bwd"]["segment_sum_accum_fused_leg"] = {
        "n": ACCUM_N, "ms": sk_, "library_index_add_ms": sl_}
    (hk_, _, _), (hl_, _, _) = hist_t["segment_sum"]["din_history_fm_v"]
    # The history lookup's bounds: its take backward alone (each kept
    # position's cotangent row and order entry read, the [U, 32] gradient
    # written) and with its int64 ids' segments build.
    hist_tb = take_bwd_bound(32, [HISTORY_N], [MONO_ROWS])[0]
    hist_sb = segments_bound(torch.empty((1, HISTORY_N), dtype=torch.int64),
                             [MONO_ROWS], None)[0]
    take["take_bwd"]["segment_sum_din_history"] = {
        "n": HISTORY_N, "ms": hk_, "library_index_add_ms": hl_,
        "bound_ms": hist_tb + hist_sb, "take_bwd_bound_ms": hist_tb}
    tw = retrieval_t["tower"]
    take["take_bwd"]["twin_tower_history"] = {
        "n": tw["n"], "run_at_id_0": tw["run0"], "ms": tw["take_bwd_ms"],
        "bound_ms": tw["take_bwd_bound_ms"],
        "segment_sum_ms": tw["segment_sum_ms"],
        "segment_sum_bound_ms": tw["take_bwd_bound_ms"]
        + tw["segments_bound_ms"],
        "library_index_add_ms": tw["index_add_ms"],
        "step_call_ms": tw["step_ms"], "step_device_ms": tw["device_ms"]}
    # The segments kernel at the hashed step's shape (the main path's
    # launch), and at the dense and fused-leg shapes.
    (sk, _, ssrc), (sp, _, _), (sl, _, _), (sb, sby, _), _ = seg_kernel_t[
        "hashed"]
    segments = {
        "ms": sk, "plain_ms": sp, "library_ms": sl,
        "library_call": "torch.sort(stable=True) + searchsorted over "
                        "precomputed composite keys",
        "bound_ms": sb, "bound_by": sby, "ms_source": ssrc,
        "by_shape": {k: {"ms": v[0][0], "plain_ms": v[1][0],
                         "library_ms": v[2][0], "bound_ms": v[3][0],
                         "device_events": v[4]}
                     for k, v in {**seg_kernel_t, **accum_t["segments"],
                                  "din_history": hist_t["segments"]}.items()}}
    (ik, _, isrc), (ip, _, _), (il, _, _), (ib, iby) = install_t["two"]
    install = {
        "ms": ik, "plain_ms": ip, "library_ms": il,
        "library_call": "8x index_copy_ on the real slots",
        "bound_ms": ib, "bound_by": iby, "ms_source": isrc,
        "by_width": {str(d): {"ms": v[0][0], "plain_ms": v[1][0],
                              "library_ms": v[2][0], "bound_ms": v[3][0]}
                     for d, v in install_t.items()}}
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_fm", "route": "cuda",
        "launches_not_counted": NOT_COUNTED,
        "source": "deepfm_tpu_torch/csrc/fused_fm.cu",
        "replaces": "deepfm_tpu/ops/pallas_fm.py:79",
        "launches": paths["train"]["fused_fm"],
        "launches_by_path": {**by_path("fused_fm"), "serve": serve_launches},
        "max_abs_err": fm_err,
        "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "ms_source": ms_source,
        "by_batch": {str(b): {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2]}
                     for (b, _, _), v in fm_t.items()}}, {
        "name": "fused_fm_bwd", "route": "cuda",
        "launches_not_counted": NOT_COUNTED,
        "source": "deepfm_tpu_torch/csrc/fused_fm.cu",
        "replaces": "deepfm_tpu/ops/pallas_fm.py:92",
        "launches": paths["train"]["fused_fm_bwd"],
        "launches_by_path": by_path("fused_fm_bwd"),
        "max_abs_err": bwd_err,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by, "library_ms": None,
        "ms_source": bwd_source}, {
        "name": "plan_build", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:121",
        "launches": hashed["plan_build"],
        "launches_by_path": by_path("plan_build"),
        "max_abs_err": 0.0, **plan}, {
        "name": "take_fwd", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:216",
        "launches": hashed["take_fwd"],
        "launches_by_path": by_path("take_fwd"),
        "max_abs_err": 0.0, **take["take_fwd"]}, {
        "name": "take_bwd", "route": "cuda",
        "launches_not_counted": NOT_COUNTED,
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:226",
        "launches": hashed["take_bwd"],
        "launches_by_path": by_path("take_bwd"),
        "max_abs_err": take_err, **take["take_bwd"]}, {
        "name": "segments", "route": "cuda",
        "launches_not_counted": NOT_COUNTED,
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:226",
        "launches": hashed["segments"],
        "launches_by_path": by_path("segments"),
        "max_abs_err": 0.0, **segments}, {
        "name": "install", "route": "cuda",
        "source": "deepfm_tpu_torch/csrc/embedding.cu",
        "replaces": "deepfm_tpu/ops/pallas_embedding.py:302",
        "launches": paths["train_sparse_tiered"]["install"],
        "launches_by_path": by_path("install"),
        "max_abs_err": 0.0, **install}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
