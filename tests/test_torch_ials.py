"""The port's iALS (``recoder_tpu_torch/models/ials.py``) against the JAX
package's (``recoder_tpu/models/ials.py``) on the CPU, plus the port's
own copies of the checks in ``tests/test_ials.py``.

The same numpy matrices and seeds go through both packages (the item
init is numpy in both, so both fits start from the same factors).
Tolerances, all float32 against float32 in another summation order:

- chunk plans: equal, array for array (integer ids and copied values);
- one half-sweep on the same factors: within 1e-5 of max |factor|;
- a 3-sweep fit: within 5e-5 of max |factor| (rounding differences
  grow a little through the sweeps), the objective within rtol 1e-6;
- against the per-row float64 numpy reference: atol 2e-5, as in
  ``tests/test_ials.py``;
- fold-in, the chunk-ladder and checkpoint round trips: bitwise.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from recoder_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from recoder_tpu.data import UsersInteractions as JaxUsersInteractions
from recoder_tpu.models import IALS as JaxIALS
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset, UsersInteractions
from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
from recoder_tpu_torch.models import IALS
from recoder_tpu_torch.models import ials as ials_lib
from recoder_tpu_torch.ops import spd
from recoder_tpu_torch.parallel import MeshConfig, make_mesh
from recoder_tpu_torch.recommender import InferenceRecommender


#: chunk budget of the fits: small, so the tiny-d test fits do not pad
#: each chunk to 2**18 rows (fold-in keeps the default budget, so its
#: chunks have other shapes than the fit's)
CE = 1 << 12


def _binary_matrix(users=40, items=25, density=0.2, seed=0):
  rng = np.random.default_rng(seed)
  m = (rng.random((users, items)) < density).astype(np.float32)
  return csr_matrix(m)


def _count_matrix(users=50, items=30, seed=0):
  """Heavy-tailed counts: rows of very different nnz, values 1..4."""
  rng = np.random.default_rng(seed)
  md = (rng.random((users, items)) < 0.1) * rng.integers(1, 5, (users, items))
  md[:3, :] = (rng.random((3, items)) < 0.9) * rng.integers(1, 5, (3, items))
  return csr_matrix(md.astype(np.float32))


def _ui(m, users=None):
  users = np.arange(m.shape[0]) if users is None else users
  return UsersInteractions(users=users, interactions_matrix=m[users])


def _numpy_user_solve(m, v, alpha, lam, reg_scaling='frequency'):
  """Per-row reference: exact HKV normal equations in float64."""
  md = np.asarray(m.todense(), np.float64)
  v = np.asarray(v, np.float64)
  d = v.shape[1]
  g = v.T @ v
  out = np.zeros((md.shape[0], d))
  for u in range(md.shape[0]):
    idx = np.flatnonzero(md[u])
    c = 1.0 + alpha * md[u, idx]
    reg = lam * (len(idx) + 1.0) if reg_scaling == 'frequency' else lam
    a = g + (v[idx].T * (c - 1.0)) @ v[idx] + reg * np.eye(d)
    out[u] = np.linalg.solve(a, v[idx].T @ c)
  return out


def _same_recommendations(m, got, ref):
  """Equal top-k lists for every user with a history. An empty user's
  factor is zero and every score ties; ``lax.top_k`` breaks ties by
  index and ``torch.topk`` does not promise an order, so those users
  are only checked for length."""
  nnz = np.diff(m.indptr)
  assert len(got) == len(ref)
  for u, (a, b) in enumerate(zip(got, ref)):
    if nnz[u]:
      np.testing.assert_array_equal(a, np.asarray(b))
    else:
      assert len(a) == len(b)


def _close(got, ref, frac):
  ref = np.asarray(ref)
  np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                             atol=frac * np.abs(ref).max())


# -- against the JAX package ------------------------------------------------


@pytest.mark.parametrize('reg_scaling', ['frequency', 'none'])
@pytest.mark.parametrize('chunk_elems', [64, 1 << 10, 1 << 21])
def test_chunk_plans_equal_jax(chunk_elems, reg_scaling):
  m = _count_matrix(seed=1)
  kw = dict(embedding_size=8, lam=0.02, reg_scaling=reg_scaling)
  for csr in (m, m.T.tocsr()):
    ref = JaxIALS(**kw)._chunk_plan(csr, chunk_elems)
    got = IALS(**kw, device='cpu')._chunk_plan(csr, chunk_elems)
    assert got['n_rows'] == ref['n_rows']
    assert len(got['chunks']) == len(ref['chunks'])
    for c_got, c_ref in zip(got['chunks'], ref['chunks']):
      for key in ('rows', 'cols', 'vals', 'reg'):
        np.testing.assert_array_equal(c_got[key].numpy(),
                                      np.asarray(c_ref[key]))


@pytest.mark.parametrize('reg_scaling', ['frequency', 'none'])
def test_solve_side_matches_jax(reg_scaling):
  m = _count_matrix(seed=2)
  kw = dict(embedding_size=6, alpha=10.0, lam=0.05, sweeps=2, seed=1,
            reg_scaling=reg_scaling)
  ref_model = JaxIALS(**kw).fit(m, chunk_elems=CE)
  v = np.asarray(ref_model.item_factors)
  ref = np.asarray(ref_model._solve_side(m, ref_model.item_factors))
  got = IALS(**kw, device='cpu')._solve_side(m, torch.from_numpy(v.copy()))
  _close(got, ref, 1e-5)
  u = np.asarray(ref_model.user_factors)
  ref_items = np.asarray(ref_model._solve_side(m.T.tocsr(),
                                               ref_model.user_factors))
  got_items = IALS(**kw, device='cpu')._solve_side(
      m.T.tocsr(), torch.from_numpy(u.copy()))
  _close(got_items, ref_items, 1e-5)


@pytest.mark.parametrize('kw', [
    dict(embedding_size=6, alpha=10.0, lam=0.05, seed=1),
    dict(embedding_size=16, alpha=30.0, lam=0.01, seed=0,
         reg_scaling='none', init_scale=0.5),
])
def test_fit_matches_jax(kw):
  m = _binary_matrix(users=60, items=30, seed=4)
  ref = JaxIALS(sweeps=3, **kw).fit(m, chunk_elems=CE)
  got = IALS(sweeps=3, **kw, device='cpu').fit(m, chunk_elems=CE)
  _close(got.item_factors, ref.item_factors, 5e-5)
  _close(got.user_factors, ref.user_factors, 5e-5)
  assert np.isclose(got.objective(m), ref.objective(m), rtol=1e-6, atol=0)


def test_fit_callback_and_objective_track_jax():
  m = _count_matrix(seed=3)
  kw = dict(embedding_size=8, alpha=5.0, lam=0.02, sweeps=4, seed=2)
  objs = {'jax': [], 'port': []}
  ref, got = JaxIALS(**kw), IALS(**kw, device='cpu')
  ref.fit(m, chunk_elems=CE,
          callback=lambda s: objs['jax'].append(ref.objective(m)))
  got.fit(m, chunk_elems=CE,
          callback=lambda s: objs['port'].append(got.objective(m)))
  assert len(objs['port']) == 4
  np.testing.assert_allclose(objs['port'], objs['jax'], rtol=1e-6)


def test_jax_factors_serve_the_same_recommendations():
  """The weights bridge: a JAX fit's factors in the port give the JAX
  model's fold-in (1e-5 of max) and top-k (equal)."""
  m = _count_matrix(seed=4)
  ref = JaxIALS(embedding_size=6, alpha=10.0, lam=0.05, sweeps=3,
                seed=1).fit(m, chunk_elems=CE)
  got = convert.ials_factors_from_numpy(
      IALS(alpha=10.0, lam=0.05, device='cpu'),
      {'user_factors': ref.user_factors, 'item_factors': ref.item_factors})
  assert got.embedding_size == 6 and got.num_items == m.shape[1]
  users = np.arange(m.shape[0])
  jui = JaxUsersInteractions(users=users, interactions_matrix=m)
  _close(got.fold_in(_ui(m)), ref.fold_in(jui), 1e-5)
  _same_recommendations(m, got.recommend(_ui(m), 5), ref.recommend(jui, 5))
  back = convert.ials_factors_to_numpy(got)
  np.testing.assert_array_equal(back['user_factors'],
                                np.asarray(ref.user_factors))


def test_evaluator_matches_jax():
  """RecommenderEvaluator(InferenceRecommender(model, k)) on the same
  factors gives the same metrics in both packages. The dataset's first
  matrix is what the model folds in; every user of it has a history, so
  no scores tie (see :func:`_same_recommendations`)."""
  from recoder_tpu.data import RecommendationDataset as JaxDataset
  from recoder_tpu.metrics import NDCG as JaxNDCG
  from recoder_tpu.metrics import Recall as JaxRecall
  from recoder_tpu.metrics import RecommenderEvaluator as JaxEvaluator
  from recoder_tpu.recommender import InferenceRecommender as JaxInference

  train = _binary_matrix(users=80, items=40, density=0.15, seed=5)
  val = _binary_matrix(users=80, items=40, density=0.05, seed=6)
  val = val - val.multiply(train)
  val.eliminate_zeros()
  assert np.diff(train.indptr).min() > 0
  ref = JaxIALS(embedding_size=4, alpha=30.0, lam=0.01, sweeps=3,
                seed=0).fit(train, chunk_elems=CE)
  got = convert.ials_factors_from_numpy(
      IALS(alpha=30.0, lam=0.01, device='cpu'),
      {'user_factors': ref.user_factors, 'item_factors': ref.item_factors})
  ev = RecommenderEvaluator(InferenceRecommender(got, 10),
                            [Recall(k=5), NDCG(k=10)])
  res = ev.evaluate(RecommendationDataset(train, val), batch_size=80)
  jev = JaxEvaluator(JaxInference(ref, 10), [JaxRecall(k=5), JaxNDCG(k=10)])
  jres = jev.evaluate(JaxDataset(train, val), batch_size=80)
  got_means = {str(k): float(np.mean(v)) for k, v in res.items()}
  ref_means = {str(k): float(np.mean(v)) for k, v in jres.items()}
  assert got_means == ref_means


# -- the port's copies of tests/test_ials.py --------------------------------


@pytest.mark.parametrize('reg_scaling', ['frequency', 'none'])
def test_batched_solve_matches_numpy(reg_scaling):
  m = _binary_matrix(seed=3)
  model = IALS(embedding_size=6, alpha=10.0, lam=0.05, sweeps=2, seed=1,
               reg_scaling=reg_scaling, device='cpu').fit(m, chunk_elems=CE)
  ref = _numpy_user_solve(m, model.item_factors.numpy(), model.alpha,
                          model.lam, reg_scaling)
  got = model._solve_side(m, model.item_factors).numpy()
  np.testing.assert_allclose(got, ref, atol=2e-5)


def test_objective_decreases_monotonically():
  m = _binary_matrix(users=60, items=30, seed=4)
  objs = []
  model = IALS(embedding_size=8, alpha=10.0, lam=0.01, sweeps=5, seed=0,
               device='cpu')
  model.fit(m, chunk_elems=CE,
            callback=lambda s: objs.append(model.objective(m)))
  assert len(objs) == 5
  for a, b in zip(objs, objs[1:]):
    assert b <= a + 1e-8, objs


def test_fold_in_reproduces_trained_users():
  """fit() ends with a user half-sweep against the final item factors,
  so fold-in of a training history is the same solve: bit-exact, for
  all the users and for a subset (other chunk shapes)."""
  m = _count_matrix(seed=5)
  model = IALS(embedding_size=6, alpha=10.0, lam=0.05, sweeps=3,
               seed=1, device='cpu').fit(m, chunk_elems=CE)
  np.testing.assert_array_equal(model.fold_in(_ui(m)).numpy(),
                                model.user_factors.numpy())
  sub = np.arange(3, m.shape[0], 7)
  np.testing.assert_array_equal(model.fold_in(_ui(m, sub)).numpy(),
                                model.user_factors[sub].numpy())


def test_recommend_excludes_seen_and_trims():
  m = _binary_matrix(seed=6)
  # user 0 has seen every item but two: a top-5 request must trim to
  # the two unseen instead of recommending watched items
  md = np.asarray(m.todense())
  md[0, :] = 1.0
  md[0, [3, 7]] = 0.0
  m = csr_matrix(md)
  model = IALS(embedding_size=6, alpha=10.0, lam=0.05, sweeps=3,
               seed=1, device='cpu').fit(m, chunk_elems=CE)
  recs = model.recommend(_ui(m), 5)
  assert sorted(int(i) for i in recs[0]) == [3, 7]
  for u, r in enumerate(recs):
    assert not md[u, list(map(int, r))].any(), (u, r)
    assert len(set(map(int, r))) == len(r)
  for a, b in zip(recs, model.recommend_async(_ui(m), 5)):
    np.testing.assert_array_equal(a, b)


def test_empty_user_gets_zero_factor():
  md = np.asarray(_binary_matrix(seed=7).todense())
  md[2, :] = 0.0
  m = csr_matrix(md)
  model = IALS(embedding_size=6, alpha=10.0, lam=0.05, sweeps=2,
               seed=1, device='cpu').fit(m, chunk_elems=CE)
  np.testing.assert_array_equal(model.user_factors[2].numpy(), 0.0)
  assert len(model.recommend(_ui(m), 5)[2]) == 5


def test_chunk_ladder_is_shape_invariant():
  """Any element budget gives the same factors, here bit for bit (the
  corrections and the halving sums do not depend on the chunk shape)."""
  m = _count_matrix(seed=8)
  model = IALS(embedding_size=4, alpha=10.0, lam=0.05, sweeps=1,
               seed=1, device='cpu').fit(m, chunk_elems=CE)
  big = model._solve_side(m, model.item_factors, chunk_elems=1 << 20)
  small = model._solve_side(m, model.item_factors, chunk_elems=64)
  np.testing.assert_array_equal(big.numpy(), small.numpy())


def test_objective_ignores_explicit_zeros():
  noisy = _binary_matrix(seed=11)
  noisy.data = noisy.data.copy()
  noisy.data[0] = 0.0  # first stored entry becomes an explicit zero
  clean = noisy.copy()
  clean.eliminate_zeros()
  assert clean.nnz == noisy.nnz - 1
  kw = dict(embedding_size=4, sweeps=2, seed=2)
  a = IALS(**kw, device='cpu').fit(clean, chunk_elems=CE)
  b = IALS(**kw, device='cpu').fit(noisy, chunk_elems=CE)
  np.testing.assert_array_equal(a.item_factors.numpy(),
                                b.item_factors.numpy())
  assert np.isclose(a.objective(noisy), a.objective(clean), rtol=1e-12)


def test_rejects_negative_values():
  m = _binary_matrix()
  bad = m[:3].astype(np.float32).copy()
  bad.data = bad.data.copy()
  bad.data[0] = -1.0
  with pytest.raises(ValueError, match='non-negative'):
    IALS(embedding_size=4, sweeps=1, device='cpu').fit(bad, chunk_elems=CE)
  model = IALS(embedding_size=4, sweeps=1, device='cpu').fit(m, chunk_elems=CE)
  with pytest.raises(ValueError, match='non-negative'):
    model.fold_in(UsersInteractions(np.arange(3), bad))


def test_rejects_oversized_row():
  m = _binary_matrix(users=4, items=20, density=1.0)
  with pytest.raises(ValueError, match='chunk_elems'):
    IALS(embedding_size=4, sweeps=1, device='cpu').fit(m, chunk_elems=16)


def test_rejects_unknown_reg_scaling():
  with pytest.raises(ValueError, match='reg_scaling'):
    IALS(reg_scaling='bogus', device='cpu')


def test_predict_rejects_wrong_width():
  m = _binary_matrix()
  model = IALS(embedding_size=4, sweeps=1, device='cpu').fit(m, chunk_elems=CE)
  bad = UsersInteractions(np.arange(2), _binary_matrix(2, 7))
  with pytest.raises(ValueError, match='items'):
    model.predict(bad)


def test_refuses_mesh_and_factor_sharding():
  """The JAX fit's ValueErrors (``factor_sharding='users'`` without a
  mesh, an unknown layout); on a (1, 1) mesh both layouts fit bitwise
  what the fit without one fits."""
  m = _binary_matrix()
  with pytest.raises(ValueError, match='requires a mesh'):
    IALS(embedding_size=4, device='cpu').fit(m, factor_sharding='users')
  with pytest.raises(ValueError, match='unknown factor_sharding'):
    IALS(embedding_size=4, device='cpu').fit(m, factor_sharding='items')
  ref = IALS(embedding_size=4, sweeps=2, device='cpu').fit(m, chunk_elems=CE)
  mesh = make_mesh(MeshConfig(1, 1), devices='cpu')
  try:
    for layout in (None, 'users'):
      got = IALS(embedding_size=4, sweeps=2, device='cpu').fit(
          m, chunk_elems=CE, mesh=mesh, factor_sharding=layout)
      assert torch.equal(got.item_factors, ref.item_factors)
      assert torch.equal(got._whole_user_factors(), ref.user_factors)
  finally:
    torch.distributed.destroy_process_group()


def test_solve_goes_through_spd_solve():
  """On CPU tensors the half-sweep's solve is the blocked recursion: no
  kernel launch is counted."""
  before = dict(spd.LAUNCHES)
  IALS(embedding_size=4, sweeps=1, device='cpu').fit(_binary_matrix())
  assert spd.LAUNCHES == before


def test_halving_sum_ignores_trailing_zeros():
  rng = np.random.default_rng(0)
  g = torch.from_numpy(rng.standard_normal((3, 5, 4)).astype(np.float32))
  s = ials_lib._halving_sum(g)
  torch.testing.assert_close(s, g.sum(1), rtol=1e-6, atol=1e-6)
  padded = torch.cat([g, torch.zeros(3, 27, 4)], 1)
  np.testing.assert_array_equal(ials_lib._halving_sum(padded).numpy(),
                                s.numpy())


# -- checkpoints --------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
  m = _binary_matrix(seed=9)
  model = IALS(embedding_size=6, alpha=7.0, lam=0.02, sweeps=2,
               reg_scaling='none', init_scale=0.5,
               seed=3, device='cpu').fit(m, chunk_elems=CE)
  path = model.save(str(tmp_path / 'ials.model'))
  loaded = IALS(device='cpu').load(path)
  assert (loaded.embedding_size, loaded.alpha, loaded.lam, loaded.sweeps,
          loaded.reg_scaling, loaded.init_scale, loaded.seed) == (
              6, 7.0, 0.02, 2, 'none', 0.5, 3)
  np.testing.assert_array_equal(loaded.user_factors.numpy(),
                                model.user_factors.numpy())
  for a, b in zip(model.recommend(_ui(m), 5), loaded.recommend(_ui(m), 5)):
    np.testing.assert_array_equal(a, b)

  from recoder_tpu_torch.checkpoint import save_checkpoint
  other = str(tmp_path / 'other.model')
  save_checkpoint(other, {'x': np.arange(3)}, {'model': 'ease'})
  with pytest.raises(ValueError, match='not an iALS checkpoint'):
    IALS(device='cpu').load(other)


def test_jax_checkpoint_loads_into_the_port(tmp_path):
  """A JAX file lacks init_scale and seed: they default to 1.0 and 0,
  and the port serves the JAX model's recommendations."""
  m = _count_matrix(seed=10)
  ref = JaxIALS(embedding_size=6, alpha=7.0, lam=0.02, sweeps=2,
                init_scale=0.5, seed=3).fit(m, chunk_elems=CE)
  path = ref.save(str(tmp_path / 'jax.model'))
  got = IALS(init_scale=0.25, seed=9, device='cpu').load(path)
  assert (got.init_scale, got.seed) == (1.0, 0)
  assert (got.embedding_size, got.alpha, got.lam) == (6, 7.0, 0.02)
  np.testing.assert_array_equal(got.item_factors.numpy(),
                                np.asarray(ref.item_factors))
  jui = JaxUsersInteractions(users=np.arange(m.shape[0]),
                             interactions_matrix=m)
  _same_recommendations(m, got.recommend(_ui(m), 5), ref.recommend(jui, 5))


def test_port_checkpoint_loads_into_jax(tmp_path):
  m = _count_matrix(seed=11)
  model = IALS(embedding_size=6, alpha=7.0, lam=0.02, sweeps=2,
               init_scale=0.5, seed=3, device='cpu').fit(m, chunk_elems=CE)
  path = model.save(str(tmp_path / 'port.model'))
  ref = JaxIALS().load(path)
  np.testing.assert_array_equal(np.asarray(ref.user_factors),
                                model.user_factors.numpy())
  assert (ref.embedding_size, ref.alpha, ref.reg_scaling) == (
      6, 7.0, 'frequency')
  jui = JaxUsersInteractions(users=np.arange(m.shape[0]),
                             interactions_matrix=m)
  _same_recommendations(m, model.recommend(_ui(m), 5),
                        ref.recommend(jui, 5))
  # the JAX reader ignores the extra keys; a JAX-only file still loads
  jax_save_checkpoint(str(tmp_path / 'plain.model'),
                      {'user_factors': np.zeros((2, 3), np.float32),
                       'item_factors': np.zeros((4, 3), np.float32)},
                      {'model': 'ials', 'embedding_size': 3, 'alpha': 1.0,
                       'lam': 0.1, 'sweeps': 1, 'reg_scaling': 'none',
                       'num_items': 4})
  assert IALS(device='cpu').load(str(tmp_path / 'plain.model')).num_users == 2


# -- quality ------------------------------------------------------------------


@pytest.mark.slow
def test_fixture_quality():
  """The tests/test_ials.py protocol on the fixture through the port
  (blocked recursion on the CPU): d=4, alpha 30, lam 0.01, 8 sweeps,
  seed 0 must reach Recall@20 > 0.080 and NDCG@100 > 0.120. Slow: the
  fit and evaluation take about 45 s on the CPU."""
  import pandas as pd

  from recoder_tpu_torch.utils import dataframe_to_csr_matrix

  train_df = pd.read_csv('tests/data/train.csv.gz')
  val_df = pd.read_csv('tests/data/val.csv.gz')
  train_m, imap, umap = dataframe_to_csr_matrix(train_df, 'uid', 'sid',
                                                'watched')
  val_m, _, _ = dataframe_to_csr_matrix(val_df, 'uid', 'sid', 'watched',
                                        item_id_map=imap, user_id_map=umap)
  model = IALS(embedding_size=4, alpha=30.0, lam=0.01, sweeps=8,
               seed=0, device='cpu').fit(train_m)
  ev = RecommenderEvaluator(InferenceRecommender(model, 100),
                            [Recall(k=20), NDCG(k=100)])
  res = ev.evaluate(RecommendationDataset(val_m, train_m), batch_size=500)
  means = {str(k): float(np.mean(v)) for k, v in res.items()}
  assert means['Recall@20'] > 0.080, means
  assert means['NDCG@100'] > 0.120, means
