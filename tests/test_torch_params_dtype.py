"""bf16 parameter storage (``params_dtype='bfloat16'``) and bf16 moments
of sparse tables in the port, against the JAX package on the CPU, from
the same numpy inputs.

* The dense optimizer over bf16 parameters ('adam' with float32 and bf16
  moments, 'sgd', 'adagrad', 'rmsprop'), 6 steps against the JAX
  ``Optimizer.update``: the parameters within one bf16 ulp (both do the
  same float32 arithmetic and round once; a value on a rounding boundary
  may round the other way after float32 operations in another order),
  dtypes kept, moments float32 unless ``state_dtype`` says bf16.
* ``SparseRowAdam`` over a bf16 table with float32 and bf16 moments, in
  ``tests/test_optim.py``'s setting: within one bf16 ulp, untouched rows
  bitwise.
* The row scatter's plain version on bf16 tables (and a bf16 table beside
  float32 moments) against the TPU kernel ``apply_block_scatter`` in
  interpret mode: bitwise (a copy).
* The fused decode-loss plain version with bf16 rows (and MF's bf16 h):
  bitwise the same values passed as float32; gradients in bf16.
* One dense DynamicAutoencoder step and 20 steps at bf16 compute, moments
  and parameters against the JAX step math on the same batches (the
  port's 'users' epoch order, noise off): one step within one bf16 ulp,
  20 steps within 1e-2 in relative Frobenius norm, losses rtol 1e-2 (the
  port's fused kernel rounds the cotangent before the upstream gradient,
  JAX after; bf16 sums in other orders). Adam's first step is lr *
  sign(g), so one element in a thousand may have a gradient next to zero
  that takes the other sign: it may be 2 lr away. The same for a sparse
  model's union steps, whose bf16 table moments (the step's gradients,
  scaled) are held within 2e-2 in relative Frobenius norm, as
  ``tests/test_torch_bf16.py`` holds gradients.
* MatrixFactorization trains with bf16 parameters and reloads them
  bitwise (``tests/test_params_dtype.py``'s counterpart); float16 is
  refused at ``train`` with the JAX message.
* Checkpoints: a JAX bf16-parameter checkpoint loads into the port
  bitwise (weights and moments), the port's into JAX bitwise, and a
  float32 checkpoint loaded into a ``params_dtype='bfloat16'`` model is
  bitwise JAX's ``init_from_model_file`` and recommends the same items on
  the fixture (up to swaps among scores within 2^-7 of the k-th).
"""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from jax.experimental import pallas as pl

import recoder_tpu.experiments.block_scatter as bs
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.dataset import UsersInteractions as JaxUsers
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu.optim import Optimizer as JaxOptimizer
from recoder_tpu.optim import SparseRowAdam as JaxSparseRowAdam
from recoder_tpu.optim import make_weight_decay_tree
from recoder_tpu.utils import dataframe_to_csr_matrix
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.dataset import UsersInteractions
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
from recoder_tpu_torch.ops import fused_decode_loss as fdl
from recoder_tpu_torch.ops import row_scatter as rs
from recoder_tpu_torch.optim import (Bf16Adam, Float32AnchoredOptimizer,
                                     SparseRowAdam, make_optimizer)

BF = 'bfloat16'
N_USERS, N_ITEMS, BATCH, LR, WD = 48, 300, 12, 1e-3, 2e-5
DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')


def _f32(x):
  if torch.is_tensor(x):
    return x.detach().float().numpy()
  return np.array(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulps(got, ref):
  """max |got - ref| in bf16 ulps of ref (the spacing of bf16 at |ref|)."""
  got, ref = _f32(got).astype(np.float64), _f32(ref).astype(np.float64)
  mag = np.abs(ref)
  spacing = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
      mag > 0, mag, 1.0))) - 7), 2.0 ** -133)
  return float(np.max(np.abs(got - ref) / spacing)) if ref.size else 0.0


def _rel_fro(got, ref):
  got, ref = _f32(got), _f32(ref)
  return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _matrix(seed=0, users=N_USERS, items=N_ITEMS, density=0.05):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix((rng.random((users, items)) < density)
                       .astype(np.float32))


# -- the dense optimizer ------------------------------------------------------

@pytest.mark.parametrize('kind,state', [('adam', None), ('adam', BF),
                                        ('sgd', None), ('adagrad', None),
                                        ('rmsprop', None)])
def test_dense_optimizer_over_bf16_params_matches_jax(kind, state):
  rng = np.random.default_rng(7)
  w = rng.normal(scale=0.1, size=(8, 6)).astype(np.float32)
  bias = rng.normal(scale=0.1, size=(6,)).astype(np.float32)
  grads = [(rng.normal(scale=0.01, size=w.shape).astype(np.float32),
            rng.normal(scale=0.01, size=bias.shape).astype(np.float32))
           for _ in range(6)]
  lr = 0.01
  jparams = {'weight': jnp.asarray(w, jnp.bfloat16),
             'de_bias': jnp.asarray(bias, jnp.bfloat16)}
  jopt = JaxOptimizer(kind, weight_decay=make_weight_decay_tree(jparams, WD),
                      state_dtype=state)
  jstate = jopt.init(jparams)
  named = {k: torch.nn.Parameter(torch.from_numpy(_f32(v)).bfloat16())
           for k, v in jparams.items()}
  opt = make_optimizer(kind, named, lr, WD, state_dtype=state)
  assert isinstance(opt, Bf16Adam if kind == 'adam'
                    else Float32AnchoredOptimizer)
  for gw, gb in grads:
    jg = {'weight': jnp.asarray(gw, jnp.bfloat16),
          'de_bias': jnp.asarray(gb, jnp.bfloat16)}
    jparams, jstate = jopt.update(jg, jstate, jparams, jnp.float32(lr))
    for name, p in named.items():
      p.grad = torch.from_numpy(_f32(jg[name])).bfloat16()
    opt.step()
  for name, p in named.items():
    assert p.dtype == torch.bfloat16 and jparams[name].dtype == jnp.bfloat16
    assert _bf16_ulps(p, jparams[name]) <= 1, name
    moments = {k: v for k, v in opt.state[p].items()
               if torch.is_tensor(v) and v.shape == p.shape}
    assert moments
    for v in moments.values():
      assert v.dtype == (torch.bfloat16 if state else torch.float32)


# -- row-sparse Adam ----------------------------------------------------------

@pytest.mark.parametrize('state', [None, BF])
def test_sparse_row_adam_over_a_bf16_table_matches_jax(state):
  """tests/test_optim.py's setting: N 16, d 4, 4 steps of 5 ids, lr
  0.05, bf16 gradients."""
  rng = np.random.default_rng(11)
  N, d = 16, 4
  t16 = jnp.asarray(rng.normal(scale=0.1, size=(N, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
  jopt = JaxSparseRowAdam(state_dtype=state)
  jst = jopt.init(t16)
  table = torch.from_numpy(_f32(t16)).bfloat16()
  init = table.clone()
  opt = SparseRowAdam(state_dtype=state)
  st = opt.init(table)
  touched = set()
  for _ in range(4):
    ids = np.sort(rng.choice(N, size=5, replace=False))
    touched.update(ids.tolist())
    g = jnp.asarray(rng.normal(scale=0.01, size=(5, d)).astype(np.float32),
                    jnp.bfloat16)
    t16, jst = jopt.update_rows(t16, jst, jnp.asarray(ids), g,
                                jnp.float32(0.05))
    opt.update_rows(table, st, torch.from_numpy(ids.astype(np.int64)),
                    torch.from_numpy(_f32(g)).bfloat16(), 0.05)
  want = torch.bfloat16 if state else torch.float32
  assert table.dtype == torch.bfloat16
  assert st['m'].dtype == st['v'].dtype == want
  assert _bf16_ulps(table, t16) <= 1
  for k in ('m', 'v'):
    assert _bf16_ulps(st[k], jst[k]) <= 1
  untouched = sorted(set(range(N)) - touched)
  assert untouched and torch.equal(table[untouched], init[untouched])


# -- the row scatter on bf16 tables -----------------------------------------

@pytest.mark.parametrize('dtypes', [(BF, BF, BF), (BF, 'float32', 'float32')])
def test_row_scatter_plain_on_bf16_tables_matches_the_tpu_kernel(dtypes):
  orig = pl.pallas_call

  def interpreted(*a, **k):
    k['interpret'] = True
    return orig(*a, **k)

  rng = np.random.default_rng(3)
  N, d, W = 1024, 128, 96
  ids = np.sort(rng.choice(N - 8, W, False)).astype(np.int32)
  ids = np.concatenate([ids, np.full(16, N - 1, np.int32)])
  tables, rows, want = [], [], []
  for dt in dtypes:
    table = jnp.asarray(rng.normal(size=(N, d)).astype(np.float32), dt)
    new = rng.normal(size=(len(ids), d)).astype(np.float32)
    new[W:] = new[W]
    new = jnp.asarray(new, dt)
    with mock.patch.object(pl, 'pallas_call', interpreted):
      plan = bs.plan_block_scatter(jnp.asarray(ids), N, width=len(ids))
      out = bs.apply_block_scatter(table, plan, new)
    assert out.dtype == table.dtype
    want.append(_f32(out))
    tdt = getattr(torch, dt)
    tables.append(torch.from_numpy(_f32(table)).to(tdt))
    rows.append(torch.from_numpy(_f32(new)).to(tdt))
  rs.row_scatter_(tables, torch.from_numpy(ids.astype(np.int64)), rows)
  for got, ref, dt in zip(tables, want, dtypes):
    assert got.dtype == getattr(torch, dt)
    np.testing.assert_array_equal(got.float().numpy(), ref)


# -- the fused decode-loss plain version with bf16 rows -----------------------

@pytest.mark.parametrize('h_bf16', [False, True])
@pytest.mark.parametrize('cd', [None, BF])
@pytest.mark.parametrize('kind', ['mse', 'logistic'])
def test_decode_loss_plain_with_bf16_rows_is_the_float32_values(kind, cd,
                                                                h_bf16):
  rng = np.random.default_rng(4)
  B, d, W = 9, 16, 70
  h = torch.from_numpy(np.tanh(rng.normal(size=(B, d))).astype(np.float32))
  rows = torch.from_numpy(rng.normal(scale=0.3, size=(W, d))
                          .astype(np.float32)).bfloat16()
  bias = torch.from_numpy(rng.normal(scale=0.1, size=W).astype(np.float32)
                          ).bfloat16()
  target = torch.from_numpy((rng.random((B, W)) < 0.2).astype(np.float32))
  rm = (torch.arange(B) < B - 2).float()
  cm = torch.from_numpy((rng.random(W) < 0.8).astype(np.float32))
  if h_bf16:
    h = h.bfloat16()

  def run(h, rows, bias):
    leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]
    loss = fdl.fused_decode_loss(*leaves, target, rm, cm, kind, 3.0, cd)
    loss.backward()
    return loss, [x.grad for x in leaves]

  loss, grads = run(h, rows, bias)
  ref_loss, ref = run(h.float(), rows.float(), bias.float())
  assert torch.equal(loss, ref_loss)
  for g, r, x in zip(grads, ref, (h, rows, bias)):
    assert g.dtype == x.dtype
    # one rounding of the float32 gradient (of the bf16 variant's already
    # bf16 values: exact)
    assert torch.equal(g, r.to(x.dtype))


# -- training steps against JAX -------------------------------------------------

def _jax_trainer(sparse, state=BF):
  tr = JaxRecoder(JaxDynAE([16], 'tanh', noise_prob=0.0, sparse=sparse,
                           params_dtype=BF),
                  optimizer_type='adam', loss='mse',
                  loss_params={'confidence': 3}, seed=3,
                  opt_state_dtype=state)
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  return tr


def _port_trainer(sparse, jparams, state=BF):
  tr = Recoder(DynamicAutoencoder([16], 'tanh', noise_prob=0.0,
                                  sparse=sparse, params_dtype=BF),
               optimizer_type='adam', loss='mse',
               loss_params={'confidence': 3}, seed=3, opt_state_dtype=state,
               device='cpu')
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  tr._init_model()
  convert.load_params(tr.model, {k: np.asarray(v) for k, v in
                                 jparams.items()})
  return tr


def _union_jax_batch(batch, width=384):
  items = batch['items'].numpy()
  pad = np.full(width - len(items), N_ITEMS)
  return {'in_rows': jnp.asarray(batch['rows'].numpy(), jnp.int32),
          'in_cols': jnp.asarray(batch['cols'].numpy(), jnp.int32),
          'in_vals': jnp.asarray(batch['vals'].numpy()),
          'in_users': jnp.asarray(batch['users'].numpy(), jnp.int32),
          'in_items': jnp.asarray(np.concatenate([items, pad]), jnp.int32),
          'in_valid_users': jnp.float32(batch['num_users']),
          'in_valid_width': jnp.int32(len(items))}


def _run_pair(sparse, steps):
  """``steps`` steps of the JAX and the port step math on the same
  batches (the port's 'users' epochs): the trainers and both losses."""
  m = _matrix()
  jtr = _jax_trainer(sparse)
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  assert jtr.model.params['en_embedding'].dtype == jnp.bfloat16
  ptr = _port_trainer(sparse, jtr.model.params)
  ptr._init_training(RecommendationDataset(m), LR, WD)
  source = DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle='users',
                            seed=3, device='cpu')
  if not sparse:
    source.maybe_cache_slabs(ptr.model.num_items_padded, request=True)
  params, opt_state, sparse_states = (jtr.model.params, jtr.opt_state,
                                      jtr.sparse_states)
  jl, pl_ = [], []
  per_epoch = source.steps_per_epoch
  for step in range(steps):
    perm = source.epoch_permutation(1 + step // per_epoch)
    if sparse:
      b = source.build_union_batch(perm, step % per_epoch)
      params, opt_state, sparse_states, loss = jtr._sparse_step_math(
          params, opt_state, sparse_states, _union_jax_batch(b),
          jnp.float32(LR), None)
      pl_.append(float(ptr._sparse_step_math(b)))
    else:
      b = source.build_fd_batch(perm, step % per_epoch)
      batch = {'in_slab': jnp.asarray(b['slab'].float().numpy()),
               'in_users': jnp.arange(BATCH), 'in_items': None,
               'in_valid_users': jnp.float32(b['num_users']),
               'in_valid_width': jnp.int32(0), 'fd': True,
               'fd_mask_from_slab': True}
      params, opt_state, loss = jtr._dense_step_math(
          params, opt_state, batch, jnp.float32(LR), None)
      pl_.append(float(ptr._dense_step_math(b)))
    jl.append(float(loss))
  return ptr, (params, opt_state, sparse_states), jl, pl_


def _table(port_value, jax_value):
  """The JAX array cut to the port's width (a sparse table's pad)."""
  want = _f32(jax_value)
  if want.ndim == 2 and want.shape[1] > port_value.shape[1]:
    assert not np.any(want[:, port_value.shape[1]:])
    want = want[:, :port_value.shape[1]]
  return want


def _within_an_ulp_but_sign_flips(got, want, lr):
  """Every element within one bf16 ulp of JAX's, but at most one in a
  thousand, which may be up to 2 lr plus an ulp away: Adam's first step
  is lr * sign(g), and a gradient whose bf16 sums land next to zero may
  take the other sign in another summation order."""
  got, want = _f32(got), _f32(want)
  off = []
  for g, w in zip(got.ravel(), want.ravel()):
    if _bf16_ulps(np.float32(g), np.float32(w)) > 1:
      off.append(abs(float(g) - float(w)) - 2 * lr)
  assert len(off) <= max(1, got.size // 1000), len(off)
  for extra in off:
    assert extra <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize('sparse', [False, True])
def test_one_step_matches_jax_within_a_bf16_ulp(sparse):
  ptr, (params, opt_state, sparse_states), jl, pl_ = _run_pair(sparse, 1)
  np.testing.assert_allclose(pl_, jl, rtol=1e-2)
  for name, p in ptr.model.params().items():
    assert p.dtype == torch.bfloat16
    _within_an_ulp_but_sign_flips(p, _table(p, params[name]), LR)
  # the moments are the step's gradients scaled: bf16 sums in another
  # order, held as test_torch_bf16.py holds gradients
  for path, st in ptr.sparse_states.items():
    assert st['m'].dtype == torch.bfloat16
    for k in ('m', 'v'):
      assert _rel_fro(st[k], _table(st[k], sparse_states[path][k])) <= 2e-2


@pytest.mark.parametrize('sparse', [False, True])
def test_twenty_steps_match_jax(sparse):
  ptr, (params, _, _), jl, pl_ = _run_pair(sparse, 20)
  np.testing.assert_allclose(pl_, jl, rtol=1e-2)
  for name, p in ptr.model.params().items():
    assert p.dtype == torch.bfloat16
    assert _rel_fro(p, _table(p, params[name])) <= 1e-2, name
  opt = ptr.optimizer
  assert isinstance(opt, Bf16Adam) and opt.state_dtype == torch.bfloat16


# -- MatrixFactorization, float16 ---------------------------------------------

def test_mf_trains_with_bf16_params(tmp_path):
  ds = RecommendationDataset(_matrix(seed=22))
  tr = Recoder(MatrixFactorization(16, params_dtype=BF),
               optimizer_type='adam', loss='mse', device='cpu')
  tr.train(ds, batch_size=20, num_epochs=2, lr=0.01, negative_sampling=True)
  assert np.all(np.isfinite(tr.last_epoch_losses))
  assert all(p.dtype == torch.bfloat16 for p in tr.model.parameters())
  path = tr.save_state(str(tmp_path / 'ck'))
  tr2 = Recoder(MatrixFactorization(16, params_dtype=BF),
                optimizer_type='adam', loss='mse', device='cpu')
  tr2.init_from_model_file(path)
  for name, p in tr.model.params().items():
    q = tr2.model.params()[name]
    assert q.dtype == p.dtype and torch.equal(q, p), name


def test_float16_is_refused_with_the_jax_message():
  m = _matrix(seed=22)
  jtr = JaxRecoder(JaxMF(16, params_dtype='float16'), optimizer_type='adam')
  with pytest.raises(ValueError) as jax_err:
    jtr.train(JaxDataset(m), batch_size=20, num_epochs=1)
  tr = Recoder(MatrixFactorization(16, params_dtype='float16'),
               optimizer_type='adam', device='cpu')
  with pytest.raises(ValueError) as port_err:
    tr.train(RecommendationDataset(m), batch_size=20, num_epochs=1)
  assert str(port_err.value) == str(jax_err.value)
  assert 'float32 or bfloat16' in str(port_err.value)


# -- checkpoints ------------------------------------------------------------

def _trained_jax(tmp_path):
  m = _matrix(seed=5)
  jtr = _jax_trainer(False, state=None)
  jtr.train(JaxDataset(m), batch_size=BATCH, lr=LR, weight_decay=WD,
            num_epochs=1, negative_sampling=True)
  return m, jtr, jtr.save_state(str(tmp_path / 'jax'))


def test_checkpoints_both_ways_bitwise(tmp_path):
  m, jtr, path = _trained_jax(tmp_path)
  ptr = Recoder(DynamicAutoencoder(params_dtype=BF), optimizer_type='adam',
                device='cpu')
  ptr.init_from_model_file(path)
  ptr._init_optimizer(LR, WD)
  named, _ = ptr._split_params()
  for name, p in ptr.model.params().items():
    assert p.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(p), _f32(jtr.model.params[name]))
  for name, p in named.items():
    st = ptr.optimizer.state[p]
    assert st['exp_avg'].dtype == torch.float32  # the JAX default
    np.testing.assert_array_equal(_f32(st['exp_avg']),
                                  _f32(jtr.opt_state['m'][name]))
    np.testing.assert_array_equal(_f32(st['exp_avg_sq']),
                                  _f32(jtr.opt_state['v'][name]))
  # the port trains on and saves; JAX loads it bitwise
  ptr.train(RecommendationDataset(m), batch_size=BATCH, lr=LR,
            weight_decay=WD, num_epochs=2, negative_sampling=True)
  back = JaxRecoder(JaxDynAE(params_dtype=BF), optimizer_type='adam')
  back.init_from_model_file(ptr.save_state(str(tmp_path / 'port')))
  back._init_optimizer(weight_decay=WD)
  for name, p in ptr.model.params().items():
    assert back.model.params[name].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(back.model.params[name]), _f32(p))
  for name, p in named.items():
    np.testing.assert_array_equal(_f32(back.opt_state['m'][name]),
                                  _f32(ptr.optimizer.state[p]['exp_avg']))


def _fixture():
  train_df = pd.read_csv(os.path.join(DATA_DIR, 'train.csv.gz'))
  matrix, _, _ = dataframe_to_csr_matrix(train_df, user_col='uid',
                                         item_col='sid',
                                         inter_col='watched')
  return matrix


def test_float32_checkpoint_serves_from_bf16_tables(tmp_path):
  """A float32 checkpoint into ``params_dtype='bfloat16'``: the tables
  rounded to nearest even, bitwise JAX's load; on 300 fixture users the
  same top-20 as JAX's, up to swaps among scores within 2^-7 of the
  20th."""
  matrix = _fixture()
  f32 = Recoder(DynamicAutoencoder([32], 'tanh'), optimizer_type='adam',
                device='cpu')
  f32.train(RecommendationDataset(matrix[:1000]), batch_size=500, lr=1e-2,
            num_epochs=1, negative_sampling=True)
  path = f32.save_state(str(tmp_path / 'f32'))
  port = Recoder(DynamicAutoencoder([32], 'tanh', params_dtype=BF),
                 device='cpu')
  port.init_from_model_file(path)
  jtr = JaxRecoder(JaxDynAE([32], 'tanh', params_dtype=BF))
  jtr.init_from_model_file(path)
  for name, p in port.model.params().items():
    assert p.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(p), _f32(jtr.model.params[name]))
    np.testing.assert_array_equal(
        _f32(p), _f32(f32.model.params()[name].to(torch.bfloat16)))
  users = np.arange(1000, 1300)
  sub = matrix[users]
  k = 20
  got = port.recommend(UsersInteractions(users, sub), k)
  want = jtr.recommend(JaxUsers(users=users, interactions_matrix=sub), k)
  scores = np.asarray(jtr.predict(JaxUsers(users=users,
                                           interactions_matrix=sub)),
                      np.float32)
  same = 0
  for u, (a, b) in enumerate(zip(got, want)):
    same += list(a) == list(b)
    kth = scores[u, b[-1]]
    assert len(set(a)) == k and not set(a) & set(sub[u].indices)
    assert np.all(scores[u, a] >= kth - 2 ** -7 * np.abs(scores[u]).max())
  assert same >= 0.9 * len(users)
