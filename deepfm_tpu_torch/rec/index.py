"""Candidate index over twin-tower item embeddings: brute force on the
card, and the int8 ANN on the host (port of ``deepfm_tpu.rec.index``).

``CandidateIndex`` answers "top-k items for this user vector" for the
retrieval stage of the cascade. Two structures behind one interface:

  * ``brute``: the exact baseline. The ``[V, D]`` float32 item matrix lives
    on the device; a search is one ``q @ V.T`` (``torch.matmul``) and a
    top-k (:func:`topk_lowest_first`) over it. The JAX package computes
    this outside any Pallas kernel too. At CTR vocabulary scale one
    ``[V, D]`` product per query batch is a single GEMM, so brute force is
    the correct default until the corpus outgrows a device.
  * ``ann``: a quantized partition scan (IVF-flat shape), on the host with
    numpy, as the JAX package has it: spherical k-means partitions the
    items; a query probes at least ``nprobe`` of the nearest partitions
    (and until ~4k candidates have accumulated) and scans only their
    members, dequantizing int8 rows (per-row scale) on the fly. Given the
    same vectors its partitions, int8 rows, scales and answers are the JAX
    package's bit for bit (the same numpy code). Approximate, so its
    recall@k is MEASURED against brute force on sample queries and stamped
    into the saved artifact.

Ties break lowest row first, as ``lax.top_k`` breaks them;
``torch.topk`` on the card promises no order among equal values, so
:func:`topk_lowest_first` resolves them itself. The staged and the fused
cascade both search through :meth:`CandidateIndex.topk_rows`.

``save``/``load`` round-trip the index as ``index.npz`` + ``index_meta.json``
inside a servable artifact dir, the JAX package's files and schema.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils import device as device_lib

INDEX_FILE = "index.npz"
INDEX_META_FILE = "index_meta.json"


def _spherical_kmeans(vectors: np.ndarray, num_partitions: int, *,
                      iters: int = 8, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(centroids [P, D] unit-norm, assignment [V]) by cosine k-means.
    Deterministic (seeded init); empty clusters re-seed from the farthest
    points so every partition stays non-empty. (The JAX package's numpy
    code, kept verbatim so both builds agree bit for bit.)"""
    v = vectors.shape[0]
    rng = np.random.default_rng(seed)
    centroids = vectors[rng.choice(v, size=num_partitions, replace=False)]
    centroids = centroids / np.maximum(
        np.linalg.norm(centroids, axis=1, keepdims=True), 1e-8)
    assign = np.zeros((v,), np.int64)
    for _ in range(iters):
        sims = vectors @ centroids.T                     # [V, P]
        assign = np.argmax(sims, axis=1)
        for p in range(num_partitions):
            members = vectors[assign == p]
            if members.shape[0] == 0:
                # re-seed from the point worst-served by its centroid
                worst = int(np.argmin(sims[np.arange(v), assign]))
                centroids[p] = vectors[worst]
                assign[worst] = p
            else:
                centroids[p] = members.mean(axis=0)
            centroids[p] /= max(float(np.linalg.norm(centroids[p])), 1e-8)
    return centroids.astype(np.float32), assign


def topk_lowest_first(scores: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k], rows [B, k] int64) of the k largest ``scores``
    [B, V] per row, best first, equal values lowest row first: the order
    of ``lax.top_k`` (and of a stable descending sort), on any device.

    ``torch.topk`` gives the k-th largest value exactly but no order among
    equal values. So: every row strictly above the k-th value is taken
    (fewer than k of them), then the lowest rows equal to it; a second
    top-k over the distinct integer key ``2V - row`` (above) / ``V - row``
    (equal) / 0 (below) picks exactly those, in ascending row within each
    group; a stable descending sort of their k values then orders them
    with ties kept in ascending row."""
    v = scores.shape[1]
    kth = torch.topk(scores, k, dim=1).values[:, k - 1:k]
    idx = torch.arange(v, dtype=torch.int64, device=scores.device)
    zero = torch.zeros((), dtype=torch.int64, device=scores.device)
    key = torch.where(scores > kth, 2 * v - idx,
                      torch.where(scores == kth, v - idx, zero))
    rows = torch.topk(key, k, dim=1).indices
    vals = torch.gather(scores, 1, rows)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    return vals, torch.gather(rows, 1, order)


class CandidateIndex:
    """Top-k retrieval over an item-embedding matrix.

    ``vectors`` [V, D] float32 (unit-norm from the item tower); ``ids`` [V]
    maps matrix rows to item ids (default ``arange(V)``). ``device`` holds
    the brute-force matrix (the ANN's structure stays on the host; its
    recall is measured against brute force on ``device``)."""

    def __init__(self, vectors: np.ndarray, *,
                 ids: Optional[np.ndarray] = None,
                 kind: str = "brute",
                 num_partitions: int = 0,
                 nprobe: int = 0,
                 seed: int = 0,
                 device="cuda"):
        vectors = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vectors.ndim != 2 or vectors.shape[0] < 1:
            raise ValueError(f"vectors must be [V, D], got {vectors.shape}")
        if kind not in ("brute", "ann"):
            raise ValueError(f"kind must be brute|ann, got {kind!r}")
        self.device = device_lib.resolve(device)
        self.vectors = vectors
        self.num_items, self.dim = vectors.shape
        self.ids = (np.arange(self.num_items, dtype=np.int64)
                    if ids is None else np.asarray(ids, np.int64))
        if self.ids.shape != (self.num_items,):
            raise ValueError(
                f"ids must be [V]={self.num_items}, got {self.ids.shape}")
        self.kind = kind
        self._mat: Optional[torch.Tensor] = None
        self._ids_dev: Optional[torch.Tensor] = None
        if kind == "ann":
            self.num_partitions = int(num_partitions) or max(
                1, int(np.sqrt(self.num_items)))
            self.num_partitions = min(self.num_partitions, self.num_items)
            self.nprobe = int(nprobe) or max(1, self.num_partitions // 4)
            self.nprobe = min(self.nprobe, self.num_partitions)
            self.centroids, self._assign = _spherical_kmeans(
                vectors, self.num_partitions, seed=seed)
            # Partition member lists + int8 rows with per-row dequant scale.
            order = np.argsort(self._assign, kind="stable")
            self._members = order.astype(np.int64)       # rows by partition
            counts = np.bincount(self._assign, minlength=self.num_partitions)
            self._part_offsets = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int64)
            self._scales = np.maximum(
                np.abs(vectors).max(axis=1), 1e-8).astype(np.float32) / 127.0
            self._q = np.clip(
                np.round(vectors / self._scales[:, None]),
                -127, 127).astype(np.int8)
        else:
            self.num_partitions = 0
            self.nprobe = 0
            self._device_matrix()

    def _device_matrix(self) -> torch.Tensor:
        """The [V, D] matrix on ``device`` (built once; at construction for
        ``brute``, at the first recall measurement for ``ann``)."""
        if self._mat is None:
            self._mat = torch.from_numpy(self.vectors).to(self.device)
        return self._mat

    @property
    def ids_on_device(self) -> torch.Tensor:
        """``ids`` as an int64 tensor on ``device`` (the fused cascade maps
        rows to item ids there)."""
        if self._ids_dev is None:
            self._ids_dev = torch.from_numpy(self.ids).to(self.device)
        return self._ids_dev

    # -------------------------------------------------------------- search
    def topk_rows(self, queries: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Brute force on the device: (scores [B, k], rows [B, k] int64) of
        ``queries`` [B, D] float32 on ``device``, best first, ties lowest
        row first. The one search the staged and the fused cascade share."""
        with torch.inference_mode():
            scores = torch.matmul(queries, self._device_matrix().T)
            return topk_lowest_first(scores, k)

    def _brute_topk(self, queries: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        scores, rows = self.topk_rows(q.to(self.device), k)
        return scores.cpu().numpy(), rows.cpu().numpy()

    def _ann_topk(self, queries: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
        b = queries.shape[0]
        order = np.argsort(-(queries @ self.centroids.T), axis=1)  # [B, P]
        scores = np.full((b, k), -np.inf, np.float32)
        rows = np.zeros((b, k), np.int64)
        # Probe at least nprobe partitions AND until ~4k candidates have
        # accumulated: a fixed nprobe can hold fewer members than k when k
        # approaches the corpus size, which caps recall structurally.
        target = max(4 * k, 1)
        for i in range(b):
            segs, count, probes = [], 0, 0
            for p in order[i]:
                seg = self._members[
                    self._part_offsets[p]:self._part_offsets[p + 1]]
                segs.append(seg)
                count += seg.shape[0]
                probes += 1
                if probes >= self.nprobe and count >= target:
                    break
            cand = np.concatenate(segs)
            # quantized scan: dequantize only the probed rows
            deq = self._q[cand].astype(np.float32) * \
                self._scales[cand, None]
            s = deq @ queries[i]
            take = min(k, cand.shape[0])
            top = np.argpartition(-s, take - 1)[:take]
            top = top[np.argsort(-s[top], kind="stable")]
            scores[i, :take] = s[top]
            rows[i, :take] = cand[top]
        return scores, rows

    def search(self, queries: np.ndarray, k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """(item_ids [B, k] int64, scores [B, k] f32), best first. ``k`` is
        clamped to the corpus size."""
        queries = np.asarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        if queries.shape[1] != self.dim:
            raise ValueError(
                f"query dim {queries.shape[1]} != index dim {self.dim}")
        k = min(int(k), self.num_items)
        if k < 1:
            raise ValueError("k must be >= 1")
        if self.kind == "brute":
            scores, rows = self._brute_topk(queries, k)
        else:
            scores, rows = self._ann_topk(queries, k)
        return self.ids[rows], scores

    def recall_at_k(self, queries: np.ndarray, k: int) -> float:
        """Fraction of brute-force top-k recovered by this index's search
        (averaged over queries). ``brute`` measures 1.0 by construction —
        measured anyway, never hardcoded."""
        got_ids, _ = self.search(queries, k)
        _, true_rows = self._brute_topk(
            np.atleast_2d(np.asarray(queries, np.float32)),
            min(int(k), self.num_items))
        true_ids = self.ids[true_rows]
        hits = sum(
            len(set(map(int, got_ids[i])) & set(map(int, true_ids[i])))
            for i in range(true_ids.shape[0]))
        return hits / float(true_ids.size)

    # ------------------------------------------------------------ artifact
    def save(self, out_dir: str, *,
             extra_meta: Optional[Dict] = None) -> Dict:
        """Write ``index.npz`` + ``index_meta.json`` under ``out_dir``;
        returns the meta dict (recall stamp included via ``extra_meta``)."""
        os.makedirs(out_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(out_dir, INDEX_FILE),
            vectors=self.vectors, ids=self.ids)
        meta = {
            "kind": self.kind,
            "num_items": int(self.num_items),
            "dim": int(self.dim),
            "num_partitions": int(self.num_partitions),
            "nprobe": int(self.nprobe),
        }
        meta.update(extra_meta or {})
        tmp = os.path.join(out_dir, INDEX_META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(out_dir, INDEX_META_FILE))
        return meta

    @classmethod
    def load(cls, in_dir: str, *, device="cuda"
             ) -> Tuple["CandidateIndex", Dict]:
        """(index, meta) from a dir written by :meth:`save`. The structure
        is rebuilt deterministically from the stored exact vectors."""
        with open(os.path.join(in_dir, INDEX_META_FILE)) as f:
            meta = json.load(f)
        data = np.load(os.path.join(in_dir, INDEX_FILE))
        idx = cls(data["vectors"], ids=data["ids"], kind=meta["kind"],
                  num_partitions=meta.get("num_partitions", 0),
                  nprobe=meta.get("nprobe", 0), device=device)
        return idx, meta
