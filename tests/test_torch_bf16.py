"""The port at bench.py's ML-20M numerics -- ``compute_dtype='bfloat16'``
and ``opt_state_dtype='bfloat16'`` -- against the JAX package on the CPU,
from the same numpy inputs.

Rounding points of the bf16 decode the port follows (those of ``jax.vjp``
of ``decode_gather_matmul(..., compute_dtype=bf16).astype(bf16)`` + the
loss): h and the table rounded to bf16, products summed in float32, the
score rounded to bf16, the loss in float32, the cotangent rounded to
bf16, dh and drows rounded to bf16, dbias in float32. One deviation: the
port's fused kernel rounds the cotangent before the upstream gradient g
(1 / valid users) multiplies it, JAX after. The encode's weight gradient
multiplies a bf16-rounded cotangent (XLA:TPU's default-precision dot;
JAX on the CPU keeps it float32).

Tolerances: bf16 forwards within 2^-7 of max |reference| (a score
rounded to bf16 is within 2^-9 of itself, and sums run in other
orders); losses rtol 1e-2 and gradients within 2e-2 in relative
Frobenius norm (one bf16 rounding of an input to a sum can move it by
~2^-8); bf16-state Adam: m and v within 1 bf16 ulp, p within 1e-6
relative (the same float32 operations in the same order); 3 training
steps: losses rtol 1e-2, parameters within 3 lr (Adam moves an element
by at most about lr a step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.experiments.pallas_loss import TILE_U
from recoder_tpu.experiments.pallas_loss import \
    fused_decode_loss as jax_fused_decode_loss
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import base as jax_base
from recoder_tpu.ops import losses as jax_losses
from recoder_tpu.ops.gather_matmul import decode_gather_matmul
from recoder_tpu.optim import Optimizer as JaxOptimizer
from recoder_tpu.optim import make_weight_decay_tree
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.models.base import dropout, l2_normalize_rows, pad_dim
from recoder_tpu_torch.ops import fused_decode_loss as fdl
from recoder_tpu_torch.ops.adam import adam_bf16_step
from recoder_tpu_torch.optim import Bf16Adam, SparseRowAdam, make_optimizer

BF = 'bfloat16'
NUM_ITEMS, B = 300, 12
MODELS = [([16], False), ([16, 8], False), ([16, 8], True)]
LOSSES = [('mse', {'confidence': 3}), ('logistic', {}), ('logloss', {})]


def _rel_fro(got, ref):
  got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
  return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _f32(x):
  return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(hidden, constrained, **kw):
  jm = JaxDynAE(hidden_layers=hidden, activation_type='tanh',
                is_constrained=constrained, compute_dtype=BF, **kw)
  jparams = jm.init_model(NUM_ITEMS, seed=5)
  pm = DynamicAutoencoder(hidden_layers=hidden, activation_type='tanh',
                          is_constrained=constrained, compute_dtype=BF, **kw)
  pm.init_model(NUM_ITEMS)
  with torch.no_grad():
    for name, t in convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}).items():
      pm.params()[name].copy_(t)
  return jm, jparams, pm


def _input(width, seed=0):
  rng = np.random.default_rng(seed)
  x = (rng.random((B, width)) < 0.08).astype(np.float32)
  x[-1] = 0.0  # an empty row: the l2 normalization's eps path
  return x


@pytest.mark.parametrize('hidden,constrained', MODELS)
def test_eval_forward_matches_jax(hidden, constrained):
  jm, jparams, pm = _pair(hidden, constrained)
  x = _input(NUM_ITEMS)
  ref = jm.apply(jparams, jnp.asarray(x, jnp.bfloat16), training=False)
  assert ref.dtype == jnp.bfloat16
  with torch.no_grad():
    got = pm(torch.from_numpy(x).to(torch.bfloat16))
  assert got.dtype == torch.bfloat16 and got.shape == (B, pad_dim(NUM_ITEMS))
  ref = _f32(ref)
  np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                             atol=2 ** -7 * np.abs(ref).max())


def test_l2_normalize_and_dropout_on_bf16():
  """The sum of squares in float32, the output in the input's dtype (JAX
  ``l2_normalize_rows``); dropout keeps a bf16 input bf16."""
  x = _input(40)
  got = l2_normalize_rows(torch.from_numpy(x).to(torch.bfloat16))
  ref = jax_base.l2_normalize_rows(jnp.asarray(x, jnp.bfloat16))
  assert got.dtype == torch.bfloat16
  np.testing.assert_array_equal(got.float().numpy(), _f32(ref))
  keep = torch.from_numpy((np.random.default_rng(1).random(x.shape) < 0.5)
                          .astype(np.float32))
  out = dropout(got, 0.5, keep_mask=keep)
  assert out.dtype == torch.bfloat16
  np.testing.assert_array_equal(
      out.float().numpy(),
      _f32(jnp.where(keep.numpy() > 0, ref / 0.5, 0.0).astype(jnp.bfloat16)))
  drawn = dropout(got, 0.5, torch.Generator().manual_seed(0))
  assert drawn.dtype == torch.bfloat16


def _union_batches(slab, n_valid):
  """The same dense batch as a port union batch and a JAX staged one
  (the union padded with the sentinel item to a static width)."""
  rows, cols = np.nonzero(slab)
  items = np.unique(cols)
  local = np.searchsorted(items, cols)
  port = {'items': torch.from_numpy(items), 'rows': torch.from_numpy(rows),
          'cols': torch.from_numpy(local),
          'vals': torch.from_numpy(slab[rows, cols]),
          'users': torch.arange(B), 'num_users': float(n_valid)}
  width = -(-len(items) // 64) * 64 + 64
  jax_b = {'in_rows': jnp.asarray(rows, jnp.int32),
           'in_cols': jnp.asarray(local, jnp.int32),
           'in_vals': jnp.asarray(slab[rows, cols]),
           'in_users': jnp.arange(B, dtype=jnp.int32),
           'in_items': jnp.asarray(np.concatenate(
               [items, np.full(width - len(items), NUM_ITEMS)]), jnp.int32),
           'in_valid_users': jnp.float32(n_valid),
           'in_valid_width': jnp.int32(len(items))}
  return port, jax_b


@pytest.mark.parametrize('path', ['full_decode', 'dense_union'])
@pytest.mark.parametrize('loss,loss_params', LOSSES)
def test_loss_and_gradients_match_jax(loss, loss_params, path):
  """One training step's loss and every parameter's gradient (noise
  off): 'mse' and 'logistic' through the bf16 fused decode-loss Function,
  'logloss' through the bf16 decode and log-softmax."""
  jm, jparams, pm = _pair([16], False, noise_prob=0.0)
  slab = _input(pad_dim(NUM_ITEMS), seed=1)
  slab[:, NUM_ITEMS:] = 0.0
  n_valid = B - 3
  slab[n_valid:] = 0.0
  if path == 'full_decode':
    port_batch = {'slab': torch.from_numpy(slab).to(torch.bfloat16),
                  'num_users': float(n_valid)}
    jax_batch = {'in_slab': jnp.asarray(slab, jnp.bfloat16),
                 'in_users': jnp.arange(B), 'in_items': None,
                 'in_valid_users': jnp.float32(n_valid),
                 'in_valid_width': jnp.int32(0), 'fd': True,
                 'fd_mask_from_slab': True}
  else:
    port_batch, jax_batch = _union_batches(slab, n_valid)

  jtr = JaxRecoder(jm, optimizer_type='adam', loss=loss,
                   loss_params=dict(loss_params))
  jtr._init_loss_module()
  ref_loss, ref_grads = jax.value_and_grad(
      lambda p: jtr._forward_loss(p, jax_batch, rng=None, training=True))(
          jparams)

  ptr = Recoder(pm, optimizer_type='adam', loss=loss,
                loss_params=dict(loss_params), device='cpu')
  ptr._init_loss_module()
  got = ptr._forward_loss(port_batch, training=True)
  got.backward()
  np.testing.assert_allclose(got.item(), float(ref_loss), rtol=1e-2)
  for name, p in pm.params().items():
    assert p.grad.dtype == torch.float32
    assert _rel_fro(p.grad.numpy(), ref_grads[name]) <= 2e-2, name


def _fdl_problem(Bq, d, W, seed=0):
  rng = np.random.default_rng(seed)
  return dict(h=np.tanh(rng.normal(size=(Bq, d))).astype(np.float32),
              rows=(0.3 * rng.normal(size=(W, d))).astype(np.float32),
              bias=(0.1 * rng.normal(size=(W,))).astype(np.float32),
              target=(rng.random((Bq, W)) < 0.1).astype(np.float32),
              row_mask=(np.arange(Bq) < Bq - 2).astype(np.float32),
              col_mask=(rng.random(W) < 0.8).astype(np.float32))


def _port_fdl(p, kind, confidence, fn=fdl.fused_decode_loss, scale=1.0):
  t = {k: torch.from_numpy(v) for k, v in p.items()}
  leaves = [t[k].clone().requires_grad_(True) for k in ('h', 'rows', 'bias')]
  loss = fn(*leaves, t['target'], t['row_mask'], t['col_mask'], kind,
            confidence, BF) * scale
  loss.backward()
  return loss.item(), [x.grad.numpy() for x in leaves]


def _jax_composed_bf16(p, kind, confidence, scale=1.0):
  """The JAX package's training composition at bf16 compute."""
  def composed(h, rows, bias):
    s = decode_gather_matmul(h, rows, None, bias,
                             compute_dtype=jnp.bfloat16).astype(jnp.bfloat16)
    if kind == 'mse':
      e = jax_losses.mse_loss(s, p['target'], confidence=confidence,
                              row_mask=p['row_mask'], col_mask=p['col_mask'])
    else:
      e = jax_losses.logistic_loss(s, p['target'], row_mask=p['row_mask'],
                                   col_mask=p['col_mask'])
    return jnp.sum(e) * scale
  loss, grads = jax.value_and_grad(composed, argnums=(0, 1, 2))(
      p['h'], p['rows'], p['bias'])
  return float(loss), [np.asarray(g) for g in grads]


def _assert_close(got, ref):
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-2)
  for a, b in zip(got[1], ref[1]):
    assert _rel_fro(a, b) <= 2e-2


CASES = [('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)]


@pytest.mark.parametrize('kind,confidence', CASES)
def test_bf16_plain_matches_pallas_kernel(kind, confidence):
  """The bf16 variant's plain forward and backward against the TPU
  kernel in interpret mode with bf16 h and rows (which keeps the score
  and the cotangent in float32)."""
  p = _fdl_problem(16, 24, 2 * TILE_U)

  def pallas(h, rows, bias):
    return jax_fused_decode_loss(h.astype(jnp.bfloat16),
                                 rows.astype(jnp.bfloat16), bias,
                                 p['target'], p['row_mask'], p['col_mask'],
                                 kind, confidence, True)
  loss, grads = jax.value_and_grad(pallas, argnums=(0, 1, 2))(
      p['h'], p['rows'], p['bias'])
  _assert_close(_port_fdl(p, kind, confidence),
                (float(loss), [np.asarray(g) for g in grads]))


@pytest.mark.parametrize('kind,confidence', CASES)
def test_bf16_plain_matches_jax_composition(kind, confidence):
  """Against jax.value_and_grad of the composition, at the trainer's
  upstream gradient (1 / 7): the loss and gradients within tolerance;
  with g = 1 (the rounding points coincide) dh and drows within one bf16
  rounding, dbias to float32 accuracy; and the autograd composition
  (``fused_decode_loss_plain``) at the same points."""
  p = _fdl_problem(37, 24, 1000, seed=2)
  _assert_close(_port_fdl(p, kind, confidence, scale=1 / 7),
                _jax_composed_bf16(p, kind, confidence, scale=1 / 7))
  got = _port_fdl(p, kind, confidence)
  ref = _jax_composed_bf16(p, kind, confidence)
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
  for a, b in zip(got[1][:2], ref[1][:2]):
    np.testing.assert_allclose(a, b, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(b).max())
    bits = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(a, bits)  # bf16 values
  np.testing.assert_allclose(got[1][2], ref[1][2], rtol=1e-5, atol=1e-6)
  auto = _port_fdl(p, kind, confidence, fn=fdl.fused_decode_loss_plain)
  np.testing.assert_allclose(auto[0], ref[0], rtol=1e-5)
  for a, b in zip(auto[1], ref[1]):
    np.testing.assert_allclose(a, b, rtol=2 ** -7,
                               atol=2 ** -7 * np.abs(b).max())


def test_bf16_stash_is_bf16():
  p = {k: torch.from_numpy(v) for k, v in _fdl_problem(5, 3, 13).items()}
  h = p['h'].clone().requires_grad_(True)
  loss = fdl.fused_decode_loss(h, p['rows'], p['bias'], p['target'],
                               p['row_mask'], p['col_mask'], 'mse', 3.0, BF)
  e0, *_ = loss.grad_fn.saved_tensors
  assert e0.dtype == torch.bfloat16 and e0.shape == (5, 13)
  with pytest.raises(ValueError):
    fdl.fused_decode_loss(h, p['rows'], p['bias'], p['target'],
                          p['row_mask'], p['col_mask'], 'mse', 3.0,
                          'float16')


def _adam_params(seed=0):
  rng = np.random.default_rng(seed)
  return {'en_embedding': rng.normal(size=(37, 6)).astype(np.float32) * 0.2,
          'en_bias': rng.normal(size=(6,)).astype(np.float32) * 0.1,
          'decode_w_1': rng.normal(size=(5, 7)).astype(np.float32) * 0.2,
          'de_bias': rng.normal(size=(37,)).astype(np.float32) * 0.1}


def _bf16_ulp(x):
  """One bf16 ulp at each element of ``x``."""
  x = np.abs(np.asarray(x, np.float32))
  e = np.floor(np.log2(np.maximum(x, np.float32(2 ** -126))))
  return np.float32(2.0) ** (e - 7)


def test_bf16_state_adam_matches_jax():
  """Five steps of bf16-moment Adam (weight decay on the weights, none
  on the biases) against the JAX Optimizer with state_dtype='bfloat16',
  from the same gradients."""
  lr, wd = 1e-2, 1e-2
  init = _adam_params()
  jopt = JaxOptimizer('adam', weight_decay=make_weight_decay_tree(init, wd),
                      state_dtype=BF)
  jp = {k: jnp.asarray(v) for k, v in init.items()}
  jst = jopt.init(jp)
  named = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in init.items()}
  opt = make_optimizer('adam', named, lr, wd, state_dtype=BF)
  assert isinstance(opt, Bf16Adam)
  rng = np.random.default_rng(9)
  for _ in range(5):
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in init.items()}
    jp, jst = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, jst,
                          jp, jnp.float32(lr))
    for k, p in named.items():
      p.grad = torch.from_numpy(grads[k])
    opt.step()
  for k, p in named.items():
    st = opt.state[p]
    assert int(st['step']) == 5 and st['exp_avg'].dtype == torch.bfloat16
    for key, jkey in (('exp_avg', 'm'), ('exp_avg_sq', 'v')):
      ref = _f32(jst[jkey][k])
      assert np.all(np.abs(st[key].float().numpy() - ref) <= _bf16_ulp(ref))
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                               rtol=1e-6, atol=1e-7)


def test_bf16_adam_step_in_place_on_cpu():
  """The functional step on CPU tensors: in place, one step count, and a
  parameter with weight decay 0 moves as without it."""
  p = torch.linspace(-1, 1, 10)
  g = torch.linspace(0.5, -0.5, 10)
  m = torch.zeros(10, dtype=torch.bfloat16)
  v = torch.zeros(10, dtype=torch.bfloat16)
  p2, m2, v2 = p.clone(), m.clone(), v.clone()
  adam_bf16_step([p], [g], [m], [v], [0.0], 1e-3, 1)
  adam_bf16_step([p2], [g], [m2], [v2], [0.5], 1e-3, 1)
  # step 1: m' = (1 - b1) g, v' = (1 - b2) g^2, so p moves by ~lr sign(g)
  np.testing.assert_allclose((p - torch.linspace(-1, 1, 10)).numpy(),
                             -1e-3 * np.sign(g.numpy()), rtol=1e-3)
  assert not torch.equal(p, p2)
  assert torch.equal(m, (0.1 * g).to(torch.bfloat16))


@pytest.mark.parametrize('kind', ['sgd', 'adagrad', 'rmsprop'])
def test_bf16_state_refused_for_ungated_kinds(kind):
  """As the JAX Optimizer (tests/test_optim.py): only adam takes bf16
  state; float32 state stays legal everywhere."""
  named = {'w': torch.nn.Parameter(torch.zeros(3))}
  with pytest.raises(ValueError, match='quality-gated'):
    make_optimizer(kind, named, 0.1, state_dtype=BF)
  with pytest.raises(ValueError, match='quality-gated'):
    Recoder(DynamicAutoencoder([4]), optimizer_type=kind,
            opt_state_dtype=BF, device='cpu')
  with pytest.raises(ValueError, match='quality-gated'):
    JaxOptimizer(kind, state_dtype=BF)
  assert not isinstance(make_optimizer(kind, named, 0.1,
                                       state_dtype='float32'), Bf16Adam)


def _matrix(users, items, seed=0, density=0.1):
  rng = np.random.default_rng(seed)
  return sp.csr_matrix((rng.random((users, items)) < density)
                       .astype(np.float32))


def test_sparse_tables_with_bf16_state_raise():
  """Ported: a sparse model trains with bf16 moments on its tables (and
  float32 ones by default), and bf16 parameters construct; the moment
  dtypes the JAX package refuses still raise."""
  assert SparseRowAdam(state_dtype=BF).init(torch.zeros(3, 2))['m'].dtype \
      == torch.bfloat16
  tr = Recoder(DynamicAutoencoder([4], sparse=True), optimizer_type='adam',
               opt_state_dtype=BF, device='cpu')
  tr.train(RecommendationDataset(_matrix(20, 30)), batch_size=8,
           negative_sampling=True)
  assert np.all(np.isfinite(tr.last_epoch_losses))
  for state in tr.sparse_states.values():
    assert state['m'].dtype == state['v'].dtype == torch.bfloat16
    assert state['step'] == 3 and torch.any(state['v'] != 0)
  model = DynamicAutoencoder([4], params_dtype=BF)
  assert model.params_dtype == model.compute_dtype == torch.bfloat16
  with pytest.raises(ValueError, match='float32 or bfloat16'):
    SparseRowAdam(state_dtype='float16')


N_USERS, N_ITEMS, BATCH, LR, WD = 48, 120, 16, 1e-3, 2e-5


def _jax_bf16_trainer(**kw):
  tr = JaxRecoder(JaxDynAE([16], 'tanh', noise_prob=0.0, compute_dtype=BF),
                  optimizer_type='adam', loss='mse',
                  loss_params={'confidence': 3}, seed=3,
                  opt_state_dtype=BF, **kw)
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  tr._init_model()
  return tr


def _port_bf16_trainer(params, **kw):
  tr = Recoder(DynamicAutoencoder([16], 'tanh', noise_prob=0.0,
                                  compute_dtype=BF),
               optimizer_type='adam', loss='mse',
               loss_params={'confidence': 3}, seed=3, opt_state_dtype=BF,
               device='cpu', **kw)
  tr.num_items, tr.num_users = N_ITEMS, N_USERS
  tr._init_model()
  with torch.no_grad():
    for name, t in convert.params_from_numpy(params).items():
      tr.model.params()[name].copy_(t)
  return tr


_TRAIN = dict(batch_size=BATCH, lr=LR, weight_decay=WD,
              negative_sampling=True, shuffle='users')


def _trained_pair():
  m = _matrix(N_USERS, N_ITEMS)
  jtr = _jax_bf16_trainer()
  init = {k: np.asarray(v) for k, v in jtr.model.params.items()}
  jtr.train(JaxDataset(m), num_epochs=1, full_decode=True, slab_cache=True,
            **_TRAIN)
  ptr = _port_bf16_trainer(init)
  ptr.train(RecommendationDataset(m), num_epochs=1, full_decode=True,
            **_TRAIN)
  return m, jtr, ptr


def test_three_step_training_matches_jax():
  """bench.py's numerics end to end: 3 full-decode steps ('users' order,
  the JAX host permutation) at bf16 compute and bf16 moments."""
  m, jtr, ptr = _trained_pair()
  assert len(ptr.last_epoch_losses) == 3
  for name, p in ptr.model.params().items():
    got, ref = p.detach().numpy(), np.asarray(jtr.model.params[name])
    np.testing.assert_allclose(got, ref, rtol=0, atol=3 * LR, err_msg=name)
    # and the same trajectory, not only the same step size: the elements
    # moved ~2.5 lr each, the two packages part by far less
    assert np.abs(got - ref).mean() <= 0.1 * LR, name
  for p in ptr.optimizer.state.values():
    assert p['exp_avg'].dtype == torch.bfloat16 and int(p['step']) == 3
  # the losses of the same 3 steps through the JAX step math
  np.testing.assert_allclose(ptr.last_epoch_losses,
                             _jax_step_losses(m), rtol=1e-2)


def _init_of(tr):
  return {k: np.asarray(v) for k, v in tr.model.params.items()}


def _jax_step_losses(m):
  """The JAX trainer's per-step losses of one 'users' epoch of ``m``."""
  jtr = _jax_bf16_trainer()
  ptr = _port_bf16_trainer(_init_of(jtr))
  source = ptr._data_source(m, BATCH, BATCH, 'users')
  source.maybe_cache_slabs(ptr.model.num_items_padded, request=True)
  perm = source.epoch_permutation(1)
  jtr._init_training(JaxDataset(m), weight_decay=WD)
  params, opt_state, losses = jtr.model.params, jtr.opt_state, []
  for step in range(source.steps_per_epoch):
    b = source.build_fd_batch(perm, step)
    batch = {'in_slab': jnp.asarray(b['slab'].float().numpy()),
             'in_users': jnp.arange(BATCH),
             'in_items': None, 'in_valid_users': jnp.float32(b['num_users']),
             'in_valid_width': jnp.int32(0), 'fd': True,
             'fd_mask_from_slab': True}
    params, opt_state, loss = jtr._dense_step_math(
        params, opt_state, batch, jnp.float32(LR), None)
    losses.append(float(loss))
  return losses


def test_checkpoints_both_ways(tmp_path):
  """A JAX bf16 checkpoint restores compute_dtype and bf16 moments in the
  port (a model built without compute_dtype comes back bf16), a port
  checkpoint does the same in JAX, and a reload without opt_state_dtype
  gets float32 moments (the constructor wins)."""
  m, jtr, ptr = _trained_pair()

  from_jax = Recoder(DynamicAutoencoder(), optimizer_type='adam',
                     opt_state_dtype=BF, device='cpu')
  from_jax.init_from_model_file(jtr.save_state(str(tmp_path / 'jax')))
  assert from_jax.model.compute_dtype == torch.bfloat16
  from_jax._init_optimizer(LR, WD)
  named, _ = from_jax._split_params()
  for name, p in named.items():
    st = from_jax.optimizer.state[p]
    assert st['exp_avg'].dtype == torch.bfloat16 and int(st['step']) == 3
    np.testing.assert_array_equal(st['exp_avg'].float().numpy(),
                                  _f32(jtr.opt_state['m'][name]))
    np.testing.assert_array_equal(st['exp_avg_sq'].float().numpy(),
                                  _f32(jtr.opt_state['v'][name]))
  users, _ = RecommendationDataset(m)[np.arange(N_USERS)]
  np.testing.assert_allclose(from_jax.predict(users), jtr.predict(users),
                             rtol=0, atol=2 ** -7)

  port_file = ptr.save_state(str(tmp_path / 'port'))
  to_jax = JaxRecoder(JaxDynAE(), optimizer_type='adam',
                      opt_state_dtype=BF)
  to_jax.init_from_model_file(port_file)
  assert to_jax.model.compute_dtype == jnp.bfloat16
  to_jax._init_optimizer(weight_decay=WD)
  named, _ = ptr._split_params()
  for name, p in named.items():
    st = ptr.optimizer.state[p]
    assert to_jax.opt_state['m'][name].dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(to_jax.opt_state['m'][name]),
                                  st['exp_avg'].float().numpy())
    np.testing.assert_array_equal(_f32(to_jax.opt_state['v'][name]),
                                  st['exp_avg_sq'].float().numpy())
  np.testing.assert_allclose(to_jax.predict(users), ptr.predict(users),
                             rtol=0, atol=2 ** -7)

  f32_state = Recoder(DynamicAutoencoder(), optimizer_type='adam',
                      device='cpu')
  f32_state.init_from_model_file(port_file)
  f32_state._init_optimizer(LR, WD)
  assert all(st['exp_avg'].dtype == torch.float32
             for st in f32_state.optimizer.state.values())
  assert f32_state.model.compute_dtype == torch.bfloat16


def test_eval_compute_dtype_matches_jax():
  """A float32 model scored in bf16 (``eval_compute_dtype``), as the JAX
  trainer's predict and recommend do."""
  m = _matrix(N_USERS, N_ITEMS, seed=4)
  jtr = JaxRecoder(JaxDynAE([16], 'tanh'), optimizer_type='adam', seed=3,
                   eval_compute_dtype=BF)
  jtr.num_items, jtr.num_users = N_ITEMS, N_USERS
  jtr._init_model()
  ptr = Recoder(DynamicAutoencoder([16], 'tanh'), optimizer_type='adam',
                seed=3, device='cpu', eval_compute_dtype=BF)
  ptr.num_items, ptr.num_users = N_ITEMS, N_USERS
  ptr._init_model()
  with torch.no_grad():
    for name, t in convert.params_from_numpy(_init_of(jtr)).items():
      ptr.model.params()[name].copy_(t)
  users, _ = RecommendationDataset(m)[np.arange(N_USERS)]
  ref = jtr.predict(users)
  got = ptr.predict(users)
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, ref, rtol=0, atol=2 ** -7 * np.abs(ref).max())
  f32 = Recoder(ptr.model, device='cpu')
  f32._model_initialized, f32.num_items = True, N_ITEMS
  assert not np.array_equal(f32.predict(users), got)  # float32 scoring
