"""DeepFM (``--model deepfm``) with Adam: the rows of the Criteo feature map
(``perfbench/gen/traffic.py``), its weights, its step shapes, the first
gradient from Adam's first moment, and the plain reference
(``perfbench/reference/models.py``). The functions are the ones
``perfbench/families/__init__.py`` names."""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from perfbench.core import compare
from perfbench.gen import traffic as gen
from perfbench.reference import models as ref

#: The program's Adam first-moment decay (``train/optimizers.py``).
B1 = 0.9
#: The tables: their rows past the vocabulary are the program's padding.
TABLES = ("fm_w", "fm_v")


def _vocab(cell: Dict) -> int:
    return int(cell["config"]["flags"]["feature_size"])


def columns(cell: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    t, flags = cell["traffic"], cell["config"]["flags"]
    return gen.make_columns(t, vocab=_vocab(cell),
                            fields=int(flags["field_size"]),
                            records=int(t["records_per_card"]), seed=seed,
                            device=device)


def weights(cell: Dict, shapes: Dict, seed: int,
            device) -> Dict[str, torch.Tensor]:
    v = _vocab(cell)
    return gen.make_weights(shapes, seed=seed, device=device,
                            real_rows={k: v for k in TABLES})


def hold(w0: Dict[str, torch.Tensor], cell: Dict,
         seed: int) -> Dict[str, torch.Tensor]:
    """A host copy: the tables are ~15 MB at the reference widths."""
    return {k: x.cpu() for k, x in w0.items()}


def step_shapes(flags: Dict, batch: int, shapes: Dict) -> Dict:
    layers = [int(x) for x in str(flags["deep_layers"]).split(",") if x]
    f, k = int(flags["field_size"]), int(flags["embedding_size"])
    tower = [f * k] + layers
    # The tower's multiply-adds an example, the [d, 1] head included;
    # forward and backward are three times the forward's, two operations
    # a multiply-add.
    macs = sum(a * b for a, b in zip(tower[:-1], tower[1:])) + tower[-1]
    return {"batch": batch, "fields": f, "dim": k,
            "rows": int(shapes["fm_w"][0]), "tower": tower,
            "compute_bytes": 2 if flags["compute_dtype"] == "bfloat16" else 4,
            "flops_per_example": 6 * macs}


def first_grad_norms(opt_state: Dict) -> Dict[str, float]:
    mu = opt_state["mu"]
    return {k: float(torch.linalg.vector_norm(mu[k].double() / (1.0 - B1)))
            for k in mu}


def reference(cell: Dict, held: Mapping[str, torch.Tensor],
              batches: List[Dict[str, torch.Tensor]], device, *,
              quant: bool = False, rows=None) -> Dict:
    flags, v = cell["config"]["flags"], _vocab(cell)
    params = {k: (x[:v] if k in TABLES else x).to(device)
              for k, x in held.items()}
    out = ref.train_steps(params, batches,
                          lr=float(flags["learning_rate"]),
                          l2=float(flags["l2_reg"]), quant=quant, rows=rows)
    return {"losses": out["losses"], "grad1": compare.norms(out["grad1"]),
            "change": compare.norms(out["change"])}
