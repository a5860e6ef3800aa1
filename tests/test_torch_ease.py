"""EASE in the port against the JAX package's, on the CPU.

* ``fit`` (both Gram modes: the chunked device product and the host
  sparse product) against the JAX ``fit(gram='host', solve='cholesky')``
  on the same matrices: B within 1e-4 of max |B| (measured: at most
  4.5e-07 of it on these matrices; both packages' float32 Cholesky
  against the float64 inverse within 4e-07), the diagonal exactly zero.
* The chunked Gram against scipy's ``X.T @ X``, exactly, for binary and
  for weighted values over ragged chunks.
* ``recommend`` against the JAX ``recommend``, seen items masked and
  short lists trimmed; ``predict`` masks nothing.
* Checkpoints both ways; the guards (``max_items``, ``solve='newton'``
  without a mesh), and a fit on a (1, 1) mesh, which runs the JAX mesh
  path's Newton-Schulz solve (its B within the JAX mesh test's rtol 5e-4
  / atol 5e-5 of the Cholesky B).
"""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from recoder_tpu.data import UsersInteractions as JaxUsers
from recoder_tpu.models import EASE as JaxEASE
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import (RecommendationDataset,
                                    UsersInteractions)
from recoder_tpu_torch.metrics import Recall, RecommenderEvaluator
from recoder_tpu_torch.models import EASE
from recoder_tpu_torch.parallel import MeshConfig, make_mesh
from recoder_tpu_torch.recommender import InferenceRecommender

B_TOL = 1e-4  # of max |B|


def _binary_matrix(users=60, items=35, density=0.15, seed=0):
  rng = np.random.default_rng(seed)
  m = (rng.random((users, items)) < density).astype(np.float32)
  m[:, 0] = 1.0  # no empty columns (keeps the Gram well conditioned)
  return csr_matrix(m)


def _weighted(seed=3):
  m = _binary_matrix(seed=seed)
  m.data = np.random.default_rng(seed).integers(
      1, 5, size=m.nnz).astype(np.float32)
  return m


@pytest.mark.parametrize('gram', ['host', 'device'])
@pytest.mark.parametrize('seed,weighted', [(0, False), (1, False),
                                           (3, True)])
def test_fit_matches_jax(seed, weighted, gram):
  m = _weighted(seed) if weighted else _binary_matrix(seed=seed)
  want = np.asarray(JaxEASE(lam=7.5).fit(m, gram='host',
                                         solve='cholesky').item_weights)
  model = EASE(lam=7.5, device='cpu').fit(m, gram=gram)
  got = model.item_weights.numpy()
  assert got.dtype == np.float32 and got.shape == (35, 35)
  np.testing.assert_array_equal(np.diag(got), 0.0)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=B_TOL * np.abs(want).max())


def test_fit_matches_the_float64_closed_form():
  m = _binary_matrix()
  model = EASE(lam=7.5, device='cpu').fit(m)
  x = np.asarray(m.todense(), np.float64)
  p = np.linalg.inv(x.T @ x + 7.5 * np.eye(x.shape[1]))
  b = -p / np.diag(p)[None, :]
  np.fill_diagonal(b, 0.0)
  np.testing.assert_allclose(model.item_weights.numpy(), b, rtol=0,
                             atol=B_TOL * np.abs(b).max())


@pytest.mark.parametrize('weighted', [False, True])
def test_chunked_gram_is_exact(weighted):
  m = _weighted() if weighted else _binary_matrix(seed=4)
  g = EASE(device='cpu')._device_gram(m, chunk_users=17)
  np.testing.assert_array_equal(g.numpy(),
                                np.asarray((m.T @ m).todense(), np.float32))


def test_recommend_matches_jax_and_trims():
  m = _binary_matrix(users=20, items=12, density=0.6, seed=1)
  model = EASE(lam=5.0, device='cpu').fit(m)
  jmodel = JaxEASE(lam=5.0).fit(m)
  recs = model.recommend(UsersInteractions(np.arange(20), m), 8)
  jrecs = jmodel.recommend(JaxUsers(np.arange(20), m), 8)
  dense = np.asarray(m.todense())
  for u, (r, jr) in enumerate(zip(recs, jrecs)):
    seen = set(np.flatnonzero(dense[u]))
    assert not set(r.tolist()) & seen
    assert len(r) == min(8, 12 - len(seen))
    np.testing.assert_array_equal(r, np.asarray(jr))
  scores = model.predict(UsersInteractions(np.arange(3), m[:3]))
  np.testing.assert_allclose(scores.numpy(), np.asarray(
      jmodel.predict(JaxUsers(np.arange(3), m[:3]))), rtol=1e-4, atol=1e-5)
  # predict masks nothing: a seen item keeps its score
  x = np.asarray(m[:3].todense(), np.float32)
  np.testing.assert_allclose(scores.numpy(), x @ model.item_weights.numpy(),
                             rtol=1e-6, atol=1e-6)


def test_predict_shape_validation():
  model = EASE(lam=5.0, device='cpu').fit(_binary_matrix())
  wrong = _binary_matrix(items=17)
  with pytest.raises(ValueError, match='items'):
    model.predict(UsersInteractions(np.arange(wrong.shape[0]), wrong))


def test_checkpoints_both_ways(tmp_path):
  m = _binary_matrix(seed=3)
  ui = UsersInteractions(np.arange(5), m[:5])
  model = EASE(lam=42.0, device='cpu').fit(m)
  path = model.save(str(tmp_path / 'port.model'))
  jloaded = JaxEASE().load(path)
  assert jloaded.lam == 42.0 and jloaded.num_items == 35
  np.testing.assert_array_equal(np.asarray(jloaded.item_weights),
                                model.item_weights.numpy())

  jmodel = JaxEASE(lam=9.0).fit(m)
  jpath = jmodel.save(str(tmp_path / 'jax.model'))
  loaded = EASE(device='cpu').load(jpath)
  assert loaded.lam == 9.0 and loaded.num_items == 35
  np.testing.assert_array_equal(loaded.item_weights.numpy(),
                                np.asarray(jmodel.item_weights))
  for a, b in zip(loaded.recommend(ui, 5),
                  jmodel.recommend(JaxUsers(np.arange(5), m[:5]), 5)):
    np.testing.assert_array_equal(a, np.asarray(b))
  # the weights bridge, both ways
  bridged = convert.ease_weights_from_numpy(
      EASE(device='cpu'), {'item_weights': np.asarray(jmodel.item_weights)})
  np.testing.assert_array_equal(
      convert.ease_weights_to_numpy(bridged)['item_weights'],
      np.asarray(jmodel.item_weights))

  from recoder_tpu_torch.checkpoint import save_checkpoint
  other = str(tmp_path / 'other.model')
  save_checkpoint(other, {'x': np.arange(3)}, {'model': 'autoencoder'})
  with pytest.raises(ValueError, match='not an EASE checkpoint'):
    EASE(device='cpu').load(other)


def test_evaluates_through_the_recommender_stack():
  m = _binary_matrix(users=80, items=40, density=0.2, seed=7)
  fold_in = m.multiply(np.arange(40) % 2 == 0).tocsr()
  fold_out = m.multiply(np.arange(40) % 2 == 1).tocsr()
  model = EASE(lam=2.0, device='cpu').fit(m)
  res = RecommenderEvaluator(InferenceRecommender(model, 10),
                             [Recall(k=10)]).evaluate(
      RecommendationDataset(fold_in, fold_out), batch_size=32,
      num_workers=2)
  assert len(res[Recall(k=10)]) > 0
  assert np.isfinite(np.mean(res[Recall(k=10)]))


def test_guards():
  m = _binary_matrix()
  with pytest.raises(ValueError, match='max_items'):
    EASE(device='cpu').fit(m, max_items=20)
  with pytest.raises(NotImplementedError, match='TPU-only workarounds'):
    EASE(device='cpu').fit(m, solve='newton')
  # (a mesh fit runs, as the JAX fit on a mesh does)
  mesh = make_mesh(MeshConfig(1, 1), devices='cpu')
  try:
    got = EASE(device='cpu').fit(m, mesh=mesh)
  finally:
    torch.distributed.destroy_process_group()
  np.testing.assert_allclose(got.item_weights.numpy(),
                             EASE(device='cpu').fit(m).item_weights.numpy(),
                             rtol=5e-4, atol=5e-5)
  with pytest.raises(RuntimeError, match='fit'):
    EASE(device='cpu').predict(UsersInteractions(np.arange(2), m[:2]))
