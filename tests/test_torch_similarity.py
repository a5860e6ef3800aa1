"""The port's SimilarityRecommender against the JAX package's.

Both are the same host numpy code over an embeddings index: given the
same index answers (the same forest, or brute force with no near-tie
among the neighbors) and float64 host math, the recommendation lists are
equal, id for id. The indexes are built by each package from the same
numpy embeddings; tests/test_recommender.py's clustered index and its
cases run against the port as well.
"""

import numpy as np
import pytest
from scipy.sparse import csr_matrix

import recoder_tpu.embedding as jax_embedding
import recoder_tpu.recommender as jax_recommender
import recoder_tpu_torch.embedding as embedding
from recoder_tpu.data import UsersInteractions as JaxUsers
from recoder_tpu_torch.data import UsersInteractions
from recoder_tpu_torch.recommender import SimilarityRecommender


def _clustered():
  """tests/test_recommender.py's three tight item clusters."""
  rng = np.random.default_rng(0)
  centers = np.eye(3, 12) * 10
  return np.vstack([centers[i // 20] + rng.normal(scale=0.1, size=12)
                    for i in range(60)]).astype(np.float32)


def _random_histories(num_users, num_items, seed, most=8):
  rng = np.random.default_rng(seed)
  rows, cols = [], []
  for u in range(num_users):
    hist = rng.choice(num_items, size=rng.integers(0, most), replace=False)
    rows += [u] * len(hist)
    cols += list(hist)
  return csr_matrix((np.ones(len(rows)), (rows, cols)),
                    shape=(num_users, num_items))


def _indexes(kind, emb):
  if kind == 'brute':
    port = embedding.BruteForceEmbeddingsIndex(emb, device='cpu')
    ref = jax_embedding.BruteForceEmbeddingsIndex(emb)
  else:
    port = embedding.AnnEmbeddingsIndex(emb, n_trees=6)
    ref = jax_embedding.AnnEmbeddingsIndex(emb, n_trees=6)
  port.build()
  ref.build()
  return port, ref


def _both(port_index, jax_index, m, **kw):
  got = SimilarityRecommender(port_index, **kw).recommend(
      UsersInteractions(np.arange(m.shape[0]), m))
  want = jax_recommender.SimilarityRecommender(jax_index, **kw).recommend(
      JaxUsers(np.arange(m.shape[0]), m))
  return got, want


def assert_equal_lists(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('n,scale,k', [(5, 1, 10), (10, 3, 5), (1, 1, 3),
                                       (20, 2, 60)])
def test_clustered_index_lists_equal_jax(n, scale, k):
  port, ref = _indexes('brute', _clustered())
  m = _random_histories(40, 60, seed=3)
  got, want = _both(port, ref, m, num_recommendations=k, n=n, scale=scale)
  assert_equal_lists(got, want)


@pytest.mark.parametrize('kind', ['brute', 'ann'])
@pytest.mark.parametrize('n,scale,k', [(10, 1, 20), (20, 2, 100)])
def test_random_histories_equal_jax(kind, n, scale, k):
  emb = np.random.default_rng(11).normal(size=(400, 16)).astype(np.float32)
  port, ref = _indexes(kind, emb)
  m = _random_histories(120, 400, seed=12, most=15)
  got, want = _both(port, ref, m, num_recommendations=k, n=n, scale=scale)
  assert_equal_lists(got, want)
  assert any(len(r) == 0 for r in got)  # the empty histories
  assert sum(len(r) for r in got) > 0


def test_host_math_equals_jax_over_one_index():
  """The port's recommender over the JAX package's own index: only the
  host math differs, and it is the same code."""
  ref = jax_embedding.AnnEmbeddingsIndex(_clustered(), n_trees=4)
  ref.build()
  m = _random_histories(50, 60, seed=5)
  got, want = _both(ref, ref, m, num_recommendations=7, n=8, scale=1.5)
  assert_equal_lists(got, want)


def test_empty_batch_and_no_candidates():
  port, ref = _indexes('brute', _clustered())
  m = csr_matrix((3, 60))
  got, want = _both(port, ref, m, num_recommendations=5)
  assert [len(r) for r in got] == [len(r) for r in want] == [0, 0, 0]
  # n=1: every item's only neighbor is itself, so every pool is empty
  m = _random_histories(10, 60, seed=6)
  got, want = _both(port, ref, m, num_recommendations=5, n=1)
  assert_equal_lists(got, want)


# -- tests/test_recommender.py's cases against the port ------------------

@pytest.fixture
def clustered_index():
  index = embedding.BruteForceEmbeddingsIndex(_clustered(), device='cpu')
  index.build()
  return index


def test_similarity_recommender_stays_in_cluster(clustered_index):
  rec = SimilarityRecommender(clustered_index, num_recommendations=5,
                              n=10, scale=1)
  hist = csr_matrix((np.ones(3), ([0, 0, 0], [1, 5, 9])), shape=(1, 60))
  out = rec.recommend(UsersInteractions(np.array([0]), hist))
  assert len(out) == 1
  items = np.asarray(out[0])
  assert len(items) == 5
  assert np.all(items < 20)
  assert not np.any(np.isin(items, [1, 5, 9]))


def test_similarity_recommender_multiple_users(clustered_index):
  rec = SimilarityRecommender(clustered_index, num_recommendations=4,
                              n=8, scale=2)
  hist = csr_matrix((np.ones(4), ([0, 0, 1, 1], [2, 3, 25, 30])),
                    shape=(2, 60))
  out = rec.recommend(UsersInteractions(np.arange(2), hist))
  assert len(out) == 2
  assert np.all(np.asarray(out[0]) < 20)
  assert np.all((np.asarray(out[1]) >= 20) & (np.asarray(out[1]) < 40))


def test_batch_nns_match_single_queries(clustered_index):
  ids = np.array([0, 7, 25, 41, 59])
  batch = clustered_index.get_nns_by_ids(ids, 6)
  for i, lst in zip(ids, batch):
    np.testing.assert_array_equal(lst, clustered_index.get_nns_by_id(int(i),
                                                                     6))


def test_similarity_recommender_many_users(clustered_index):
  rng = np.random.default_rng(4)
  num_users, num_items = 5000, 60
  rows = np.repeat(np.arange(num_users), 5)
  cols = rng.integers(0, num_items, num_users * 5)
  m = csr_matrix((np.ones(len(rows)), (rows, cols)),
                 shape=(num_users, num_items))
  m.sum_duplicates()
  rec = SimilarityRecommender(clustered_index, num_recommendations=10,
                              n=5, scale=1)
  out = rec.recommend(UsersInteractions(np.arange(num_users), m))
  assert len(out) == num_users
  assert all(len(r) <= 10 for r in out)
