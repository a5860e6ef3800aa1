"""Large-catalog evaluation in the port against the JAX package's, on the
CPU, from the same numpy parameters (``convert.load_params``).

* ``encode_coo`` / ``decode_slice`` against the JAX models' for
  DynamicAutoencoder (untied, tied, a hidden stack), MatrixFactorization
  and MultVAE, float32 and bf16, on a COO batch with pad slots.
* Chunked ``recommend`` (``eval_item_chunk``) against the JAX chunked
  ``recommend`` for the three models, at chunks of 64 and of 192 (which
  does not divide the padded catalog), in every ``eval_topk`` mode; an
  all-zero decoder (every score tied); users with fewer unseen items
  than k; ``chunk < k`` refused; the auto threshold. Chunked equals
  monolithic in the port too.
* The chunked validation loss against the JAX ``_chunked_val_loss`` for
  'mse', 'logistic' and 'logloss', with and without a target matrix; a
  custom ``Loss`` stays on the dense path.
* The evaluator's ``recommend_async`` pipeline gives the synchronous
  results, and the JAX evaluator's.
* Three full-catalog sparse steps (negative sampling off: whole tables
  as leaves, row-sparse Adam over every row) against the JAX step math,
  for the three models; and ``train`` takes that step.

Tolerances: float32 rtol 1e-5 with an absolute floor of 1e-5 of the
largest value (sums in another order), the sparse steps' losses rtol
1e-5 and their parameters rtol 1e-4 with an absolute 1e-5 (as the other
step tests); bf16 rtol 1e-2 with a floor of 2^-7 of the largest;
validation losses rtol 2e-5; ids equal, except
where two ids' scores lie within 1e-5 of the largest score (a swap
that a reduction order may make).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data import UsersInteractions as JaxUsers
from recoder_tpu.data.loader import \
    RecommendationDataLoader as JaxLoader
from recoder_tpu.metrics import NDCG as JaxNDCG
from recoder_tpu.metrics import Recall as JaxRecall
from recoder_tpu.metrics import RecommenderEvaluator as JaxEvaluator
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxAE
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu.models import MultVAE as JaxMultVAE
from recoder_tpu.recommender import InferenceRecommender as JaxInference
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset, UsersInteractions
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.data.loader import RecommendationDataLoader
from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import (DynamicAutoencoder, MatrixFactorization,
                                      MultVAE)
from recoder_tpu_torch.ops import losses as losses_lib
from recoder_tpu_torch.optim import set_lr
from recoder_tpu_torch.recommender import InferenceRecommender

N_USERS, N_ITEMS, BATCH, LR = 60, 700, 20, 1e-2
#: the sparse steps' learning rate (msd-big's) and the parameters' absolute
#: tolerance after them: Adam moves an element whose float32 gradient sums
#: leave near zero by up to lr times their relative error
STEP_LR, PARAM_ATOL = 1e-3, 1e-5
BF = 'bfloat16'
EPS = np.random.default_rng(11).standard_normal((BATCH, 8)).astype(np.float32)


def _matrix(seed=7, num_users=N_USERS, num_items=N_ITEMS):
  rng = np.random.RandomState(seed)
  rows, cols = [], []
  for u in range(num_users):
    items = rng.choice(num_items, size=rng.randint(5, 40), replace=False)
    rows.extend([u] * len(items))
    cols.extend(items)
  return sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                       shape=(num_users, num_items))


def _kw(kind, **kw):
  base = {'ae': dict(hidden_layers=[32], activation_type='tanh'),
          'ae_tied': dict(hidden_layers=[32], activation_type='tanh',
                          is_constrained=True),
          'ae_deep': dict(hidden_layers=[32, 16], activation_type='tanh'),
          'mf': dict(embedding_size=32, activation_type='tanh'),
          'vae': dict(hidden_dim=32, latent_dim=8, dropout_prob=0.0,
                      total_anneal_steps=0)}[kind]
  return dict(base, **kw)


def _classes(kind):
  if kind.startswith('ae'):
    return JaxAE, DynamicAutoencoder
  return {'mf': (JaxMF, MatrixFactorization),
          'vae': (JaxMultVAE, MultVAE)}[kind]


def _pair(kind, m=None, loss=None, seed=3, **kw):
  """A JAX trainer and a port trainer with the same parameters: the JAX
  init with random biases (scores then differ by item)."""
  m = _matrix() if m is None else m
  loss = loss or ('logloss' if kind == 'vae' else 'mse')
  jcls, pcls = _classes(kind)
  jtr = JaxRecoder(jcls(**_kw(kind, **kw)), optimizer_type='adam',
                   loss=loss, seed=seed)
  jtr._init_training(JaxDataset(m), weight_decay=0.0)
  rng = np.random.default_rng(seed)
  params = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  for name in params:
    if 'bias' in name:
      params[name] = (0.3 * rng.standard_normal(params[name].shape)) \
          .astype(np.float32)
  jtr.model.params = {k: jnp.asarray(v) for k, v in params.items()}
  ptr = Recoder(pcls(**_kw(kind, **kw)), optimizer_type='adam', loss=loss,
                seed=seed, device='cpu')
  ptr._init_training(RecommendationDataset(m), LR, 0.0)
  convert.load_params(ptr.model, params)
  return jtr, ptr


def _close(got, want, rtol=1e-5, floor=1e-5, err_msg=''):
  got = got.detach().float().numpy() if torch.is_tensor(got) else got
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=rtol,
                             atol=floor * np.abs(want).max(),
                             err_msg=err_msg)


def _coo(m, users, pad=5):
  """The users' interactions as COO with ``pad`` pad slots (row B)."""
  sub = m[users].tocoo()
  B = len(users)
  rows = np.concatenate([sub.row, np.full(pad, B)]).astype(np.int64)
  cols = np.concatenate([sub.col, np.zeros(pad)]).astype(np.int64)
  vals = np.concatenate([sub.data, np.zeros(pad)]).astype(np.float32)
  return rows, cols, vals


@pytest.mark.parametrize('cd', [None, BF])
@pytest.mark.parametrize('kind', ['ae', 'ae_tied', 'ae_deep', 'mf', 'vae'])
def test_encode_coo_and_decode_slice_match_jax(kind, cd):
  m = _matrix()
  jtr, ptr = _pair(kind, m, compute_dtype=cd)
  users = np.array([4, 0, 17, 33, 59, 8])
  rows, cols, vals = _coo(m, users)
  jh = jtr.model.encode_coo(jtr.model.params, jnp.asarray(rows, jnp.int32),
                            jnp.asarray(cols, jnp.int32), jnp.asarray(vals),
                            len(users), input_users=jnp.asarray(users))
  with torch.no_grad():
    h = ptr.model.encode_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                             torch.from_numpy(vals), len(users),
                             input_users=torch.from_numpy(users))
  rtol, floor = (1e-5, 1e-5) if cd is None else (1e-2, 2.0 ** -7)
  _close(h, jh, rtol, floor, 'h')
  W = ptr.model.num_items_padded
  for start, width in ((0, 64), (192, 192), (W - 192, 192)):
    want = jtr.model.decode_slice(jtr.model.params, jh, start, width)
    with torch.no_grad():
      got = ptr.model.decode_slice(torch.tensor(np.asarray(jh)), start,
                                   width)
    assert got.dtype == torch.float32 and got.shape == (len(users), width)
    _close(got, want, rtol, floor, f'slice at {start}')


def _jax_recommend(jtr, m, users, k, chunk, mode='exact'):
  jtr.eval_item_chunk, jtr.eval_topk = chunk, mode
  return np.asarray(jtr.recommend(JaxUsers(users, m[users]), k)).tolist()


def _port_recommend(ptr, m, users, k, chunk, mode='exact'):
  ptr.eval_item_chunk, ptr.eval_topk = chunk, mode
  return ptr.recommend(UsersInteractions(users, m[users]), k)


def _same_ids(got, want, scores, what):
  """Equal id lists, except a swap of two ids whose scores are within
  1e-5 of the largest score."""
  tol = 1e-5 * np.abs(scores[np.isfinite(scores)]).max()
  for u, (g, w) in enumerate(zip(got, want)):
    assert len(g) == len(w) == len(set(g)), f'{what}, user {u}: {g}'
    for a, b in zip(g, w):
      assert a == b or abs(scores[u, a] - scores[u, b]) <= tol, \
          f'{what}, user {u}: {g} != {w}'


@pytest.mark.parametrize('mode', ['exact', 'sort', 'approx'])
@pytest.mark.parametrize('chunk', [64, 192])
@pytest.mark.parametrize('kind', ['ae', 'mf', 'vae'])
def test_chunked_recommend_matches_jax(kind, chunk, mode):
  m = _matrix()
  jtr, ptr = _pair(kind, m)
  users = np.arange(0, N_USERS, 3)
  scores = ptr.predict(UsersInteractions(users, m[users]))
  k = 20
  got = _port_recommend(ptr, m, users, k, chunk, mode)
  want = _jax_recommend(jtr, m, users, k, chunk, mode)
  _same_ids(got, want, scores, f'{kind}, chunk {chunk}, {mode}')
  _same_ids(got, _port_recommend(ptr, m, users, k, 0), scores,
            'chunked vs monolithic')
  seen = m[users]
  for u, rec in enumerate(got):
    assert max(rec) < N_ITEMS
    assert not set(rec) & set(seen[u].indices)


@pytest.mark.parametrize('chunk', [64, 192])
def test_chunked_ties_of_a_zero_decoder(chunk):
  """Every score 0: lowest unseen ids, in JAX's order, through the
  running merge of every chunk."""
  m = _matrix(seed=13)
  jtr, ptr = _pair('ae', m)
  jtr.model.params = {**jtr.model.params, **{
      k: jnp.zeros_like(jtr.model.params[k])
      for k in ('de_embedding', 'de_bias')}}
  with torch.no_grad():
    ptr.model.de_embedding.zero_()
    ptr.model.de_bias.zero_()
  users = np.array([0, 5, 9])
  got = _port_recommend(ptr, m, users, 12, chunk)
  assert got == _jax_recommend(jtr, m, users, 12, chunk)
  for u, rec in zip(users, got):
    seen = set(m[u].indices)
    assert rec == [i for i in range(N_ITEMS) if i not in seen][:12]


@pytest.mark.parametrize('kind', ['ae', 'mf'])
def test_chunked_fewer_unseen_items_than_k(kind):
  """A user who has seen all but 5 items still gets k distinct real ids:
  the 5, then the lowest seen ones (the sentinels of index W lose every
  tie), as JAX's chunked and monolithic paths give them."""
  n_items = 300
  seen = np.setdiff1d(np.arange(n_items), [3, 50, 142, 260, 299])
  m = sp.csr_matrix((np.ones(len(seen), np.float32),
                     (np.zeros(len(seen), np.int64), seen)),
                    shape=(4, n_items))
  jtr, ptr = _pair(kind, m)
  users = np.array([0])
  got = _port_recommend(ptr, m, users, 10, 64)
  assert got == _jax_recommend(jtr, m, users, 10, 64)
  assert got == _port_recommend(ptr, m, users, 10, None)
  assert len(set(got[0])) == 10 and max(got[0]) < n_items


def test_chunk_smaller_than_k_refused():
  m = _matrix(seed=3)
  jtr, ptr = _pair('mf', m)
  users = np.array([0, 1])
  with pytest.raises(ValueError, match='eval_item_chunk'):
    _jax_recommend(jtr, m, users, 16, 8)
  with pytest.raises(ValueError, match='eval_item_chunk'):
    _port_recommend(ptr, m, users, 16, 8)


def test_auto_chunk_threshold():
  """Past AUTO_CHUNK_ITEMS padded items chunks of AUTO_CHUNK_WIDTH; 0
  disables; a chunk is capped at the padded width (the JAX rule)."""
  model = DynamicAutoencoder(hidden_layers=[8])
  trainer = Recoder(model, num_items=N_ITEMS, device='cpu')
  trainer._init_model()
  assert Recoder.AUTO_CHUNK_ITEMS == JaxRecoder.AUTO_CHUNK_ITEMS == 2 ** 21
  assert Recoder.AUTO_CHUNK_WIDTH == JaxRecoder.AUTO_CHUNK_WIDTH == 2 ** 18
  assert trainer._resolve_eval_chunk() is None
  trainer.eval_item_chunk = 64
  assert trainer._resolve_eval_chunk() == 64
  trainer.eval_item_chunk = 10 ** 6
  assert trainer._resolve_eval_chunk() == model.num_items_padded
  model.num_items_padded = Recoder.AUTO_CHUNK_ITEMS * 2
  trainer.eval_item_chunk = None
  assert trainer._resolve_eval_chunk() == Recoder.AUTO_CHUNK_WIDTH
  trainer.eval_item_chunk = 0
  assert trainer._resolve_eval_chunk() is None


@pytest.mark.parametrize('chunk', [256, 192])
@pytest.mark.parametrize('kind,loss', [('ae', 'mse'), ('ae', 'logistic'),
                                       ('ae', 'logloss'), ('mf', 'mse'),
                                       ('vae', 'logloss')])
def test_chunked_val_loss_matches_jax(kind, loss, chunk):
  m = _matrix(seed=21)
  jtr, ptr = _pair(kind, m, loss=loss)
  ds = RecommendationDataset(m)
  dense = ptr._validate(RecommendationDataLoader(ds, batch_size=BATCH))
  ptr.eval_item_chunk = jtr.eval_item_chunk = chunk
  got = ptr._validate(RecommendationDataLoader(ds, batch_size=BATCH))
  want = jtr._validate(JaxLoader(JaxDataset(m), batch_size=BATCH,
                                 negative_sampling=False))
  np.testing.assert_allclose(got, want, rtol=2e-5)
  np.testing.assert_allclose(got, dense, rtol=2e-5)


@pytest.mark.parametrize('loss', ['mse', 'logloss'])
def test_chunked_val_loss_with_a_target_matrix(loss):
  in_m, tg_m = _matrix(seed=31), _matrix(seed=32)
  jtr, ptr = _pair('ae', in_m, loss=loss)
  ptr.eval_item_chunk = jtr.eval_item_chunk = 128
  got = ptr._validate(RecommendationDataLoader(
      RecommendationDataset(tg_m, in_m), batch_size=BATCH))
  want = jtr._validate(JaxLoader(JaxDataset(tg_m, in_m), batch_size=BATCH,
                                 negative_sampling=False))
  np.testing.assert_allclose(got, want, rtol=2e-5)
  ptr.eval_item_chunk = 0
  dense = ptr._validate(RecommendationDataLoader(
      RecommendationDataset(tg_m, in_m), batch_size=BATCH))
  np.testing.assert_allclose(got, dense, rtol=2e-5)


def test_custom_loss_stays_dense(monkeypatch):
  m = _matrix(seed=41)
  _, ptr = _pair('ae', m)
  ptr.loss = losses_lib.MSELoss(reduction='sum')
  ptr._init_loss_module()
  def loader():
    return RecommendationDataLoader(RecommendationDataset(m),
                                    batch_size=BATCH)
  dense = ptr._validate(loader())
  ptr.eval_item_chunk = 128
  monkeypatch.setattr(Recoder, '_chunked_val_loss', lambda *a: 1 / 0)
  assert ptr._validate(loader()) == dense
  # (and union batches stay dense whatever the loss)
  _, named = _pair('ae', m, loss='mse')
  named.eval_item_chunk = 128
  union = RecommendationDataLoader(RecommendationDataset(m),
                                   batch_size=BATCH, negative_sampling=True)
  assert np.isfinite(named._validate(union))


class _Sync:
  """A recommender without ``recommend_async``."""

  def __init__(self, inner):
    self.inner = inner

  def recommend(self, users):
    return self.inner.recommend(users)


@pytest.mark.parametrize('chunk', [None, 128])
def test_async_evaluator_gives_the_sync_results(chunk):
  train, val = _matrix(seed=51), _matrix(seed=52)
  jtr, ptr = _pair('ae', train)
  ptr.eval_item_chunk = jtr.eval_item_chunk = chunk
  metrics = [Recall(k=5), NDCG(k=10)]
  ds = RecommendationDataset(train, val)
  rec = InferenceRecommender(ptr, 10)
  got = RecommenderEvaluator(rec, metrics).evaluate(ds, batch_size=7,
                                                    num_users=45)
  want = RecommenderEvaluator(_Sync(rec), metrics).evaluate(
      ds, batch_size=7, num_users=45)
  assert {str(k): v for k, v in got.items()} == \
      {str(k): v for k, v in want.items()}
  assert len(got[metrics[0]]) == 49
  jres = JaxEvaluator(JaxInference(jtr, 10), [JaxRecall(k=5),
                                              JaxNDCG(k=10)]).evaluate(
      JaxDataset(train, val), batch_size=7, num_users=45)
  for mine, theirs in zip(metrics, jres):
    np.testing.assert_allclose(got[mine], jres[theirs], atol=1e-9)


def _fd_batches(m, ptr, steps=3):
  src = DeviceDataSource(m, BATCH, BATCH, m.shape[1], shuffle='users',
                         seed=1, device='cpu')
  src.maybe_cache_slabs(ptr.model.num_items_padded, request=True)
  perm = src.epoch_permutation(1)
  out = []
  for s in range(steps):
    b = src.build_fd_batch(perm, s)
    out.append((b, {
        'in_slab': jnp.asarray(b['slab'].float().numpy()),
        'in_users': jnp.asarray(b['users'].numpy(), jnp.int32),
        'in_items': None, 'in_valid_users': jnp.float32(b['num_users']),
        'in_valid_width': jnp.int32(0)}))
  return out


def _vae_eps(ptr, monkeypatch):
  """Both Mult-VAEs draw the test's eps."""
  monkeypatch.setattr(jax.random, 'normal', lambda key, shape, dtype:
                      jnp.asarray(EPS[:shape[0]], dtype))
  fn = MultVAE.apply_gathered

  def fed(*a, **k):
    return fn(ptr.model, *a, eps=torch.from_numpy(EPS[:a[1].shape[0]]), **k)
  monkeypatch.setattr(ptr.model, 'apply_gathered', fed)


@pytest.mark.parametrize('kind', ['ae', 'ae_tied', 'mf', 'vae'])
def test_full_catalog_sparse_steps_match_jax(kind, monkeypatch):
  """Three steps of the last batches of a 'users' epoch (pad users in
  the last), negative sampling off: losses, tables, moments."""
  m = _matrix(seed=61, num_users=50)
  jtr, ptr = _pair(kind, m, sparse=True)
  ptr._lr = STEP_LR
  set_lr(ptr.optimizer, STEP_LR)
  if kind == 'vae':
    _vae_eps(ptr, monkeypatch)
  params, opt_state, states = (jtr.model.params, jtr.opt_state,
                               jtr.sparse_states)
  rng = jax.random.PRNGKey(0)
  batches = _fd_batches(m, ptr)
  assert batches[-1][0]['num_users'] < BATCH
  for step, (b, staged) in enumerate(batches):
    ptr._global_step = step
    params, opt_state, states, jloss = jtr._sparse_step_math(
        params, opt_state, states, staged, jnp.float32(STEP_LR), rng,
        step=jnp.int32(step))
    got = ptr._sparse_step_math(b, negative_sampling=False)
    np.testing.assert_allclose(float(got), float(jloss), rtol=1e-5)
  for name, p in ptr.model.params().items():
    want = np.asarray(params[name])
    if p.dim() == 2:
      want = want[:, :p.shape[1]]
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                               atol=PARAM_ATOL, err_msg=name)
  for table, st in ptr.sparse_states.items():
    assert st['step'] == int(states[table]['step']) == 3
    for key in ('m', 'v'):
      _close(st[key], np.asarray(states[table][key])[:, :st[key].shape[1]],
             rtol=1e-4, floor=1e-5, err_msg=f'{table}/{key}')


def test_train_takes_the_full_catalog_sparse_step(monkeypatch):
  """``train(negative_sampling=False)`` on a sparse model: every step
  updates every row (``update_rows(ids=None)``), no row scatter."""
  from recoder_tpu_torch import optim
  monkeypatch.setattr(optim, 'row_scatter_', lambda *a: 1 / 0)
  m = _matrix(seed=71)
  tr = Recoder(DynamicAutoencoder([16], 'tanh', sparse=True),
               optimizer_type='adam', loss='logloss', device='cpu')
  tr.train(RecommendationDataset(m), batch_size=BATCH, num_epochs=2,
           negative_sampling=False, slab_cache=False)
  assert len(tr.last_epoch_losses) == 3
  assert np.all(np.isfinite(tr.last_epoch_losses))
  for st in tr.sparse_states.values():
    assert st['step'] == 6
  # (every decoder row has a gradient in every full-catalog step)
  assert (tr.sparse_states['de_embedding']['v'][:N_ITEMS] > 0).all()
