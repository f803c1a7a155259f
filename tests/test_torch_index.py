"""The port's candidate index (``rec.index``) against the JAX package's, on
the CPU: the int8 ANN (spherical k-means centroids and assignment, member
lists, int8 rows, scales, search results) bit-equal to JAX for the same
vectors; brute force with the same ids as JAX and scores within 1e-6; ties
broken lowest row first (``lax.top_k``'s order) on corpora of duplicated
vectors; recall, k clamping, custom ids, validation; and ``save``/``load``
both ways with the JAX package's files.

The vectors are unit rows made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfm_tpu.rec import index as jax_index
from deepfm_tpu_torch.rec import CandidateIndex
from deepfm_tpu_torch.rec import index as index_lib

torch.set_num_threads(1)

V, D = 500, 8
SCORE_ATOL = 1e-6
ANN_CASES = [(0, 0, 0), (16, 4, 1), (40, 40, 2), (V, 3, 0)]


def _unit(rng, n, d=D):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    return _unit(rng, V), _unit(rng, 24)


def _port(vectors, **kw):
    return CandidateIndex(vectors, device="cpu", **kw)


@pytest.mark.parametrize("parts,nprobe,seed", ANN_CASES)
def test_ann_structure_and_search_bit_equal_jax(corpus, parts, nprobe, seed):
    vectors, queries = corpus
    kw = dict(kind="ann", num_partitions=parts, nprobe=nprobe, seed=seed)
    j = jax_index.CandidateIndex(vectors, **kw)
    p = _port(vectors, **kw)
    assert (p.num_partitions, p.nprobe) == (j.num_partitions, j.nprobe)
    for name in ("centroids", "_assign", "_members", "_part_offsets",
                 "_scales", "_q"):
        a, b = getattr(p, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for k in (1, 10, 50):
        pi, ps = p.search(queries, k)
        ji, js = j.search(queries, k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(ps, js)


def test_ann_default_partitions_resolve_as_jax(corpus):
    vectors, _ = corpus
    p = _port(vectors, kind="ann")
    assert (p.num_partitions, p.nprobe) == (int(np.sqrt(V)),
                                            int(np.sqrt(V)) // 4)


@pytest.mark.parametrize("k", [1, 5, 50, V])
def test_brute_matches_jax(corpus, k):
    vectors, queries = corpus
    pi, ps = _port(vectors).search(queries, k)
    ji, js = jax_index.CandidateIndex(vectors).search(queries, k)
    assert pi.dtype == np.int64 and ps.dtype == np.float32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=0, atol=SCORE_ATOL)
    assert np.all(np.diff(ps, axis=1) <= 0)   # best first


@pytest.mark.parametrize("k", [1, 3, 7, 8, 9, 20])
def test_duplicated_corpus_breaks_ties_lowest_row_first(k):
    """Four distinct vectors, each repeated: every score ties with its
    copies, and k cuts through a tie group for most k. The order is
    lax.top_k's: best first, equal scores lowest row first."""
    rng = np.random.default_rng(3)
    base = _unit(rng, 4)
    vectors = base[rng.integers(0, 4, 30)]
    queries = _unit(rng, 6)
    pi, ps = _port(vectors).search(queries, k)
    ji, js = jax_index.CandidateIndex(vectors).search(queries, k)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, np.argsort(
        -(queries @ vectors.T), axis=1, kind="stable")[:, :k])
    np.testing.assert_allclose(ps, js, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_topk_lowest_first_matches_lax_top_k(seed):
    """Integer-valued scores with many ties, k across the whole range."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-3, 4, (5, 64)).astype(np.float32)
    for k in (1, 2, 17, 63, 64):
        vals, rows = index_lib.topk_lowest_first(torch.from_numpy(scores), k)
        jv, jr = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        assert rows.dtype == torch.int64


def test_brute_matrix_lives_on_the_device(corpus):
    vectors, queries = corpus
    idx = _port(vectors)
    assert idx._mat.device.type == "cpu" and idx._mat.shape == (V, D)
    scores, rows = idx.topk_rows(torch.from_numpy(queries), 5)
    ids, want = idx.search(queries, 5)
    np.testing.assert_array_equal(idx.ids_on_device[rows].numpy(), ids)
    np.testing.assert_array_equal(scores.numpy(), want)


def test_index_defaults_to_the_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CandidateIndex(corpus[0])


def test_recall(corpus):
    vectors, queries = corpus
    assert _port(vectors).recall_at_k(queries, 10) == 1.0
    assert _port(vectors).recall_at_k(queries, 50) == 1.0
    kw = dict(kind="ann", num_partitions=32, nprobe=2)
    got = _port(vectors, **kw).recall_at_k(queries, 50)
    want = jax_index.CandidateIndex(vectors, **kw).recall_at_k(queries, 50)
    assert got == want and 0.0 < got < 1.0


def test_k_clamped_to_corpus(corpus):
    vectors, queries = corpus
    for kind in ("brute", "ann"):
        ids, _ = _port(vectors, kind=kind).search(queries[:1], 10 * V)
        assert ids.shape == (1, V) and len(set(map(int, ids[0]))) == V


def test_custom_ids_mapping(corpus):
    vectors, queries = corpus
    offset = np.arange(V) + 1000
    for kind in ("brute", "ann"):
        p = _port(vectors, kind=kind, ids=offset).search(queries[:2], 3)
        j = jax_index.CandidateIndex(vectors, kind=kind, ids=offset).search(
            queries[:2], 3)
        np.testing.assert_array_equal(p[0], j[0])
        assert np.all(p[0] >= 1000)


def test_validation_errors(corpus):
    vectors, _ = corpus
    with pytest.raises(ValueError, match="brute\\|ann"):
        _port(vectors, kind="faiss")
    with pytest.raises(ValueError, match="\\[V, D\\]"):
        _port(vectors[0])
    with pytest.raises(ValueError, match="ids must be"):
        _port(vectors, ids=np.arange(V - 1))
    idx = _port(vectors)
    with pytest.raises(ValueError, match="query dim"):
        idx.search(np.zeros((1, D + 1), np.float32), 5)
    with pytest.raises(ValueError, match="k must be"):
        idx.search(np.zeros((1, D), np.float32), 0)
    # a single query vector is one row
    assert idx.search(np.ones(D, np.float32), 2)[0].shape == (1, 2)


@pytest.mark.parametrize("kind", ["brute", "ann"])
def test_save_load_round_trips_with_jax(corpus, kind, tmp_path):
    vectors, queries = corpus
    ids = np.arange(V) * 3
    stamp = {"recall_at_50": 0.97}
    p = _port(vectors, kind=kind, ids=ids)
    meta = p.save(str(tmp_path / "port"), extra_meta=stamp)
    assert meta["recall_at_50"] == 0.97 and meta["kind"] == kind
    # port-written -> JAX
    j2, jmeta = jax_index.CandidateIndex.load(str(tmp_path / "port"))
    assert jmeta == meta
    np.testing.assert_array_equal(j2.search(queries, 10)[0],
                                  p.search(queries, 10)[0])
    # JAX-written -> port
    j = jax_index.CandidateIndex(vectors, kind=kind, ids=ids)
    jm = j.save(str(tmp_path / "jax"), extra_meta=stamp)
    p2, pmeta = CandidateIndex.load(str(tmp_path / "jax"), device="cpu")
    assert pmeta == jm
    np.testing.assert_array_equal(p2.vectors, vectors)
    np.testing.assert_array_equal(p2.ids, ids)
    np.testing.assert_array_equal(p2.search(queries, 10)[0],
                                  j.search(queries, 10)[0])
    # and the port's own round trip
    p3, _ = CandidateIndex.load(str(tmp_path / "port"), device="cpu")
    for a, b in zip(p3.search(queries, 10), p.search(queries, 10)):
        np.testing.assert_array_equal(a, b)
