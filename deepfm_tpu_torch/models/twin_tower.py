"""Twin-tower (dual-encoder) retrieval model with in-batch-softmax training
(port of ``deepfm_tpu.models.twin_tower``).

The retrieval stage of the cascade (:mod:`deepfm_tpu_torch.rec.cascade`).
Not a ``--model`` zoo member (``get_model`` does not build it): the zoo
ranks one candidate per example, while this model embeds USERS (their
click history) and ITEMS (candidate ids) into one space, so that a
:class:`~deepfm_tpu_torch.rec.index.CandidateIndex` over all item vectors
answers "top-N items for this user" without scoring the whole corpus
through the ranker.

Training follows the sampled-softmax dual-encoder recipe (Covington et al.,
RecSys'16; Yi et al., RecSys'19): each batch's (user, clicked-item) pairs
score against each other, every other row's item serving as an in-batch
negative: logits ``U @ I.T / temperature``, labels the diagonal. Rows
without a click or without history carry zero weight; their items still
serve as negatives.

Item ids share the :class:`~deepfm_tpu_torch.models.common.EmbeddingSchema`
id space with the ranker (same hash bucketing), so an item id means the
same row in both stages of the cascade. The lookups are the schema's dense
lookups, whose gradients sum in position order (on the card: one segments
launch and one take backward per lookup).

State names follow the JAX param tree ``{"emb": entry, "user": [{"w",
"b"}, ...], "item": [...]}`` flattened with dots: ``emb`` (``emb.t0``, ...
when hashed), ``user.<i>.{w,b}``, ``item.<i>.{w,b}``; ``w`` is ``[d_in,
d_out]`` applied as ``x @ w``, so a JAX tree carries over with
``utils.params.tower_params_from_jax``. Math is float32 throughout.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import Config
from ..train.optimizers import Adam
from ..utils import device as device_lib
from . import common


class _Linear(nn.Module):
    """One MLP layer: ``w`` [d_in, d_out] (glorot uniform), ``b`` [d_out]."""

    def __init__(self, d_in: int, d_out: int, *, generator, device):
        super().__init__()
        self.w = nn.Parameter(common.glorot_uniform(
            (d_in, d_out), generator=generator, device=device))
        self.b = nn.Parameter(torch.zeros(d_out, device=device))


def _mlp(dims: Sequence[int], *, generator, device) -> nn.ModuleList:
    return nn.ModuleList(_Linear(a, b, generator=generator, device=device)
                         for a, b in zip(dims[:-1], dims[1:]))


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer.w + layer.b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # sqrt(sum + eps), not max(norm, eps) (``F.normalize``): the norm's
    # gradient at x == 0 is NaN (0/0), and even a zero-weighted row's NaN
    # poisons the whole in-batch logit matrix. The smoothed form is finite
    # everywhere.
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


class TwinTower(nn.Module):
    """User tower over the history, item tower over candidate ids.

    Both towers project into a shared ``embedding_size``-dim unit sphere;
    retrieval scores are dot products (= cosine), so the candidate index
    needs nothing but the item matrix. Weights are drawn from ``generator``
    (default: one on ``device`` seeded with ``cfg.seed``) in the order
    emb, user, item; on the ``meta`` device nothing is drawn (load weights
    with ``load_state_dict(..., assign=True)``)."""

    #: in-batch softmax temperature (fixed; unit-norm embeddings)
    TEMPERATURE = 0.1

    def __init__(self, cfg: Config, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.schema = common.EmbeddingSchema(cfg)
        self.dim = cfg.embedding_size
        self.padded_vocab = self.schema.padded_vocab
        dev = device_lib.resolve(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        k = self.dim
        entry = self.schema.init_entry((k,), generator=generator, device=dev)
        self.emb = (nn.ParameterDict({n: nn.Parameter(t)
                                      for n, t in entry.items()})
                    if isinstance(entry, dict) else nn.Parameter(entry))
        self.user = _mlp([k, 2 * k, k], generator=generator, device=dev)
        self.item = _mlp([k, 2 * k, k], generator=generator, device=dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _entry(self) -> common.Entry:
        if isinstance(self.emb, nn.ParameterDict):
            return dict(self.emb.items())
        return self.emb

    # ------------------------------------------------------------ encoders
    def user_embed(self, hist_ids: torch.Tensor,
                   hist_mask: torch.Tensor) -> torch.Tensor:
        """[B, L] history -> [B, D] unit vectors. Mask-weighted mean pool
        over ``hist_mask > 0`` (the count clamped to >= 1); an empty
        history pools to zeros and normalizes to zeros/eps: finite, and
        weighted out of the loss."""
        emb = self.schema.lookup(self._entry(), hist_ids)       # [B, L, K]
        m = (hist_mask > 0).float()[..., None]
        pooled = torch.sum(emb * m, dim=1) / torch.clamp(
            torch.sum(m, dim=1), min=1.0)
        return _l2_normalize(_mlp_apply(self.user, pooled))

    def item_embed(self, item_ids: torch.Tensor) -> torch.Tensor:
        """[B] item ids -> [B, D] unit vectors."""
        emb = self.schema.lookup(self._entry(), item_ids)       # [B, K]
        return _l2_normalize(_mlp_apply(self.item, emb))

    @torch.inference_mode()
    def all_item_embeddings(self, num_items: int,
                            batch: int = 4096) -> np.ndarray:
        """[num_items, D] float32 numpy matrix for the candidate index,
        computed in batches of ``batch`` ids so a big vocabulary never
        materializes one giant activation."""
        dev = self.device
        out = np.empty((num_items, self.dim), np.float32)
        for lo in range(0, num_items, batch):
            hi = min(lo + batch, num_items)
            ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
            out[lo:hi] = self.item_embed(ids).cpu().numpy()
        return out

    # ---------------------------------------------------------------- loss
    def loss(self, hist_ids: torch.Tensor, hist_mask: torch.Tensor,
             item_ids: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """Weighted in-batch softmax: row b's positive is item b, the other
        B-1 items are its negatives. ``weights`` zeroes non-click /
        empty-history rows (their columns still serve as negatives)."""
        u = self.user_embed(hist_ids, hist_mask)                # [B, D]
        v = self.item_embed(item_ids)                           # [B, D]
        logits = (u @ v.T) / self.TEMPERATURE                   # [B, B]
        logp = torch.log_softmax(logits, dim=1)
        nll = -torch.diagonal(logp)                             # [B]
        denom = torch.clamp(torch.sum(weights), min=1.0)
        return torch.sum(nll * weights) / denom


def tower_batch(batch: Dict[str, np.ndarray], item_slot: int,
                device: torch.device) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """One pipeline batch as the loss's device inputs ``(hist_ids,
    hist_mask, item_ids, weights)`` and its count of weighted rows. The
    positive item is the id in field ``item_slot``; the weight is
    ``(label > 0) & (any history)``, computed on the host."""
    if "hist_ids" not in batch:
        raise ValueError(
            "train_twin_tower needs history batches "
            "(CtrPipeline(history=True)); got keys "
            f"{sorted(batch)}")
    w = (np.asarray(batch["label"]).reshape(-1) > 0) \
        & (np.asarray(batch["hist_mask"]).sum(axis=1) > 0)

    def put(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return (put(batch["hist_ids"], np.int32),
            put(batch["hist_mask"], np.float32),
            put(np.asarray(batch["feat_ids"])[:, item_slot], np.int32),
            put(w, np.float32)), int(w.sum())


def twin_tower_step(model: TwinTower, opt: Adam, opt_state: dict,
                    inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """One Adam step on the in-batch softmax loss; returns the loss (a
    device scalar, before the step)."""
    params = dict(model.named_parameters())
    loss = model.loss(*inputs)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt.apply(params, dict(zip(params, grads)), opt_state)
    return loss.detach()


def train_twin_tower(
    cfg: Config,
    batches: Iterable[Dict[str, np.ndarray]],
    *,
    item_slot: int = 0,
    learning_rate: Optional[float] = None,
    seed: Optional[int] = None,
    device="cuda",
) -> Tuple[TwinTower, Dict[str, float]]:
    """Fit a :class:`TwinTower` over history batches on ``device``; returns
    ``(model, stats)``.

    ``batches`` is any iterable of pipeline batches carrying ``hist_ids`` /
    ``hist_mask`` (``CtrPipeline(history=True)`` output). The positive item
    of each example is its id in field ``item_slot``, the cascade's
    convention for "which field is the candidate item". Rows with no click
    or no history get zero loss weight. The optimizer is Adam with optax's
    arithmetic (``train.optimizers.Adam``); the init draws from a generator
    seeded with ``seed`` (default ``cfg.seed``)."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(
        cfg.seed if seed is None else seed)
    model = TwinTower(cfg, device=dev, generator=gen)
    opt = Adam(cfg.learning_rate if learning_rate is None else learning_rate)
    opt_state = opt.init(dict(model.named_parameters()))
    steps, first_loss, last_loss, used_rows = 0, float("nan"), float("nan"), 0
    for batch in batches:
        inputs, used = tower_batch(batch, item_slot, dev)
        last_loss = float(twin_tower_step(model, opt, opt_state, inputs))
        if steps == 0:
            first_loss = last_loss
        steps += 1
        used_rows += used
    return model, {"steps": float(steps), "loss": last_loss,
                   "first_loss": first_loss,
                   "positive_rows": float(used_rows)}
