"""The port's host-side copies against the JAX package's originals:
``dataframe_to_csr_matrix``, ``RecommendationDataset``, the ranking
metrics and evaluator, and the npz checkpoint format in both
directions. Exact equality: the same numpy arithmetic on both sides."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu import checkpoint as jax_checkpoint
from recoder_tpu import metrics as jax_metrics
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.utils import dataframe_to_csr_matrix as jax_to_csr
from recoder_tpu_torch import checkpoint, metrics
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.utils import dataframe_to_csr_matrix


def _frame(seed=0):
  rng = np.random.default_rng(seed)
  n = 400
  return pd.DataFrame({'uid': rng.integers(1000, 1050, n),
                       'sid': rng.integers(5, 300, n),
                       'watched': np.ones(n, np.int64)})


@pytest.mark.parametrize('as_dict', [False, True])
def test_dataframe_to_csr_matches_jax(as_dict):
  df = _frame()
  ref, ref_items, ref_users = jax_to_csr(df, 'uid', 'sid', 'watched')
  table = {c: df[c].to_numpy() for c in df.columns} if as_dict else df
  got, items, users = dataframe_to_csr_matrix(table, 'uid', 'sid', 'watched')
  assert items == ref_items and users == ref_users
  assert (got != ref).nnz == 0
  with pytest.raises(KeyError):
    dataframe_to_csr_matrix({'uid': np.array([1]), 'sid': np.array([-7]),
                             'watched': np.array([1])}, 'uid', 'sid',
                            'watched', item_id_map=items)


def test_dataset_rows_match_jax():
  m, _, _ = dataframe_to_csr_matrix(_frame(1), 'uid', 'sid', 'watched')
  t = m.copy()
  t.data = t.data * 2
  ours, theirs = RecommendationDataset(m, t), JaxDataset(m, t)
  assert len(ours) == len(theirs)
  for index in ([3, 0, 7], np.arange(10), [-1]):
    (a_in, a_tg), (b_in, b_tg) = ours[index], theirs[index]
    np.testing.assert_array_equal(a_in.users, b_in.users)
    for a, b in ((a_in, b_in), (a_tg, b_tg)):
      assert (a.interactions_matrix != b.interactions_matrix).nnz == 0


class _FixedRecommender:
  """Recommends a seeded random ranking per user."""

  def __init__(self, k, num_items):
    self.k, self.num_items = k, num_items

  def recommend(self, users_hist):
    out = []
    for u in users_hist.users:
      rng = np.random.default_rng(int(u))
      out.append(rng.permutation(self.num_items)[:self.k].tolist())
    return out


def test_metrics_and_evaluator_match_jax():
  rng = np.random.default_rng(2)
  dense = (rng.random((30, 40)) < 0.2).astype(np.float32)
  dense[5] = 0  # an empty target row: skipped by both evaluators
  m = sp.csr_matrix(dense)
  ds_ours = RecommendationDataset(m, m)
  ds_theirs = JaxDataset(m, m)
  ours = [metrics.Recall(10), metrics.NDCG(10),
          metrics.AveragePrecision(10), metrics.Recall(5, normalize=False)]
  theirs = [jax_metrics.Recall(10), jax_metrics.NDCG(10),
            jax_metrics.AveragePrecision(10),
            jax_metrics.Recall(5, normalize=False)]
  rec = _FixedRecommender(12, 40)
  got = metrics.RecommenderEvaluator(rec, ours).evaluate(ds_ours,
                                                         batch_size=7)
  ref = jax_metrics.RecommenderEvaluator(rec, theirs).evaluate(ds_theirs,
                                                               batch_size=7)
  for a, b in zip(ours, theirs):
    assert len(got[a]) == 29
    np.testing.assert_array_equal(got[a], ref[b])
  x, y = rng.permutation(40)[:10], rng.permutation(40)[:6]
  for fn in ('average_precision', 'recall'):
    assert getattr(metrics, fn)(x, y, 10) == getattr(jax_metrics, fn)(x, y,
                                                                        10)
  assert metrics.ndcg(x, y, 10) == jax_metrics.ndcg(x, y, 10)


def test_checkpoint_format_both_directions(tmp_path):
  tree = {'model': {'en_embedding': torch.randn(6, 3),
                    'de_bias': torch.randn(6).to(torch.bfloat16)},
          'optimizer': {'step': np.asarray(4, np.int32),
                        'm': {'en_embedding': np.ones((6, 3), np.float32)}},
          'items': np.arange(6)}
  meta = {'last_epoch': 3, 'model_params': {'hidden_layers': [3]}}
  ours = str(tmp_path / 'ours.model')
  checkpoint.save_checkpoint(ours, tree, meta)
  arrays, got_meta = jax_checkpoint.load_checkpoint(ours)
  assert got_meta == meta
  np.testing.assert_array_equal(arrays['model']['en_embedding'],
                                tree['model']['en_embedding'].numpy())
  np.testing.assert_array_equal(arrays['model']['de_bias'],
                                tree['model']['de_bias'].float().numpy())
  assert int(arrays['optimizer']['step']) == 4

  theirs = str(tmp_path / 'theirs.model')
  jax_checkpoint.save_checkpoint(theirs, arrays, meta)
  back, back_meta = checkpoint.load_checkpoint(theirs)
  assert back_meta == meta
  assert checkpoint.flatten_tree(back).keys() == \
      checkpoint.flatten_tree(arrays).keys()
  for k, v in checkpoint.flatten_tree(arrays).items():
    np.testing.assert_array_equal(checkpoint.flatten_tree(back)[k], v)
  assert not list(tmp_path.glob('*.tmp-save-*'))
  with pytest.raises(ValueError):
    checkpoint.flatten_tree({'a/b': np.zeros(1)})


@pytest.mark.parametrize('shape', [(300, 120, 9, 0, 0.683),
                                   (1000, 77, 30, 5, 0.68)])
def test_synthetic_matches_bench(shape):
  """``data/synthetic.py`` is bench.py's generator: the same CSR, bit for
  bit, at two small shapes, and the same shape constants."""
  import bench
  from recoder_tpu_torch.data import synthetic
  users, items, mean, seed, factor = shape
  ref = bench.synthesize(users, items, mean, seed=seed, mean_factor=factor)
  got = synthetic.synthesize(users, items, mean, seed=seed,
                             mean_factor=factor)
  assert got.shape == ref.shape and got.dtype == ref.dtype
  for a in ('indptr', 'indices', 'data'):
    np.testing.assert_array_equal(getattr(got, a), getattr(ref, a))
  for name in ('NUM_USERS', 'NUM_ITEMS', 'MEAN_ITEMS_PER_USER', 'BATCH_SIZE',
               'MSD_USERS', 'MSD_ITEMS', 'MSD_MEAN_ITEMS_PER_USER'):
    assert getattr(synthetic, name) == getattr(bench, name), name
