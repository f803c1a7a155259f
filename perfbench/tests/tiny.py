"""Tiny sizes of the benchmark's cells for the CPU tests, and the faults
the tests plant in the program's timed path."""

from typing import Dict

#: The cells' widths cut to what a CPU test holds; float32 compute, so the
#: program and the reference agree to rounding at this size.
FLAGS = {"feature_size": 3000, "field_size": 10, "embedding_size": 8,
         "deep_layers": "16,8", "dropout": "1.0,1.0",
         "compute_dtype": "float32"}
TRAFFIC = {"batch_per_card": 256, "records_per_card": 4096,
           "integer_fields": 3, "steps_per_call": 16, "trace_steps": 8}
#: Limits for the tiny float32 runs: far above what sound runs read here,
#: far below what each fault and the control read.
LIMITS = {"loss_gap": 1e-4, "grad_gap": 2e-3, "change_gap": 2e-2}


def shrink(cell: Dict, *, bf16: bool = False) -> Dict:
    cell["config"]["flags"].update(FLAGS)
    if bf16:
        cell["config"]["flags"]["compute_dtype"] = "bfloat16"
    cell["traffic"].update(TRAFFIC)
    cell["limits"] = dict(LIMITS)
    return cell


def plant(fault: str) -> None:
    """Break the program's timed path underneath the harness:

    * ``unchanged``: every step returns its state unchanged;
    * ``half_batch``: every step trains on the first half of its batch,
      the mean taken over those rows.
    """
    from deepfm_tpu_torch.train import loop
    trainer = loop.Trainer
    if fault == "unchanged":
        def train_step(self, state, batch):
            xent, l2, _ = self._loss_terms(state, batch)
            state.step += 1
            return state, {"loss": xent + l2, "xent": xent}
        trainer.train_step = train_step
    elif fault == "half_batch":
        step = trainer.train_step

        def train_step(self, state, batch):
            n = int(batch["label"].shape[0]) // 2
            return step(self, state, {k: v[:n] for k, v in batch.items()})
        trainer.train_step = train_step
    else:
        raise ValueError(f"unknown fault {fault!r}")
