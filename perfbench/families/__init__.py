"""Model families: everything the harness needs that depends on the model.

A configuration's ``flags["model"]`` names its family, the module
``perfbench/families/<model>.py``, which ``core/registry.family`` loads by
file; a model with no such file is refused with ``no reference for
model``. Adding a model to the benchmark is adding its family file (with
its configuration, traffic, limits and, where its kernels are new, kernel
counts and metrics), never editing a file the harness has.

A family module defines six functions. ``cell`` is the run's cell as
``Registry.cell`` builds it (``cell["config"]["flags"]``, the
configuration's flags as the program's ``Config`` takes them;
``cell["traffic"]``, the traffic mix), ``seed`` the run's ``--seed`` (any
whole number), ``device`` a ``torch.device``. Every tensor that a weight
or a row stands for is float32 unless said otherwise.

``columns(cell, seed, device) -> {"label", "ids", "vals"}``
    The run's rows, made from ``seed`` on ``device``:
    ``label`` [n] float32, ``ids`` [n, F] int32, ``vals`` [n, F] float32,
    with n the traffic's ``records_per_card``. The harness hands them to
    the program's resident feed as its decoded columns (``CacheColumns``)
    and takes the reference's batches from them. The same seed gives the
    same rows.

``weights(cell, shapes, seed, device) -> {leaf: tensor}``
    The initial weights from ``seed``, on ``device``: one tensor for
    every leaf of the program's state, ``shapes`` (leaf name -> shape,
    the tables with their padded rows) as ``Trainer.init_state`` made
    them. The harness loads them into the program. The same seed gives
    the same weights.

``hold(w0, cell, seed) -> Mapping[str, tensor]``
    What the run keeps of the initial weights ``w0`` (``weights``'
    result) until the reference has run: a mapping from leaf name to that
    leaf's initial tensor at the program's shape, on any device. The
    harness reads one leaf at a time (each leaf's change after the
    checked steps) and hands the mapping to ``reference``. A family whose
    weights fit twice keeps a host copy; one whose tables do not may
    return a mapping that makes a leaf again from ``cell`` and ``seed``
    when it is read, since ``weights`` is deterministic.

``step_shapes(flags, batch, shapes) -> dict``
    The shapes of one training step at ``batch`` rows a card, for the
    kernel counts (``perfbench/kernels/<kernel>.py``'s ``need``) and the
    per-layer metrics to read; ``shapes`` as for ``weights``. Must hold
    ``"flops_per_example"``: the model's operations per example of a
    training step (forward and backward), which ``train_mfu_pct`` reads.
    Other keys are the family's, named as the kernel counts it should
    feed read them (``batch``, ``fields``, ``dim``, ``rows``, ``tower``,
    ``compute_bytes`` for DeepFM's).

``first_grad_norms(opt_state) -> {leaf: float}``
    The float64 norm of each leaf's first gradient as the program's
    optimizer got it, read from the optimizer's state after step 1 (Adam:
    its first moment over ``1 - b1``). Called once, inside the program's
    hook after the first checked step.

``reference(cell, held, batches, device, *, quant=False, rows=None)
-> {"losses": [float], "grad1": {leaf: float}, "change": {leaf: float}}``
    The plain reference (``perfbench/reference/``, plain ``torch`` in
    float32 with TF32 off, nothing of the program) over ``batches``, the
    checked steps' rows (dicts of ``label``, ``ids``, ``vals`` on
    ``device``, in the order the program met them), from the initial
    weights in ``held`` (``hold``'s result): each step's loss, the float64
    norm of every leaf's first gradient and of its change after the last
    step, named as the program's leaves. ``quant`` computes it one
    precision below the configuration's (the control); ``rows`` keeps
    only those rows of every batch (a fault: part of the batch left out,
    the mean over the rest). ``core/compare.gaps`` compares the result
    with the program's.
"""
