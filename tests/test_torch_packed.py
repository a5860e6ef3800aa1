"""The port's bit-packed slab tier against the JAX package's, on the same
numpy inputs: the packed build bitwise (the JAX uint32 words viewed as
int32), the plain unpack bitwise against ``_unpack_rows``, the packed
tier's step payload equal to the dense tier's and to the JAX packed
fetch in both shuffle modes, pad users included, the tier rule of
``maybe_cache_slabs`` case by case (where JAX declines to its per-step
scatter the port declines with the JAX reason, and its scatter serves
the step), packed trainings bitwise equal to dense ones,
and a packed training against the JAX trainer's.

The small CSR has empty users, set bits at columns with ``c % 32 ==
31``, columns at and past the sentinel ``num_items`` (dropped by both
tiers) and ``n_pad > num_users``.
"""

import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.data.device_pipeline import \
    DeviceDataSource as JaxDeviceDataSource
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu_torch import convert
from recoder_tpu_torch.data import RecommendationDataset
from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder
from recoder_tpu_torch.ops import packed_rows as pr

# 5 blocks of 8 (the last holds 5 users); columns 64..69 lie past the
# catalog of 64 items
N_USERS, N_COLS, N_ITEMS, BATCH, W = 37, 70, 64, 8, 128


def _matrix(values='binary', seed=0):
  rng = np.random.default_rng(seed)
  dense = (rng.random((N_USERS, N_COLS)) < 0.15).astype(np.float32)
  dense[::3, 31] = 1.0  # bit 31 of word 0
  dense[1::4, 63] = 1.0  # bit 31 of word 1
  dense[::2, N_ITEMS] = 1.0  # the sentinel column
  dense[5, N_ITEMS + 3] = 1.0
  dense[[3, 20]] = 0.0  # users with no interactions
  if values == 'ratings':
    dense *= rng.integers(1, 6, size=dense.shape)
  return sp.csr_matrix(dense)


def _ours(m, shuffle='users'):
  return DeviceDataSource(m, BATCH, BATCH, N_ITEMS, shuffle=shuffle,
                          device='cpu')


def _theirs(m, shuffle='users'):
  return JaxDeviceDataSource(m, batch_size=BATCH, num_sampling_users=BATCH,
                             num_items=N_ITEMS, union_width=128,
                             shuffle=shuffle)


def _dense_col_mask(slab):
  """model.py's full-decode loss columns read off dense rows."""
  in_catalog = torch.arange(slab.shape[1]) < N_ITEMS
  return (torch.any(slab != 0, dim=0) & in_catalog).float()


@pytest.mark.parametrize('width', [96, W, 256])
def test_packed_build_matches_jax(width):
  m = _matrix()
  ours = _ours(m)._build_slab_packed(width)
  theirs = np.asarray(_theirs(m)._build_slab_cache_packed(width))
  assert ours.dtype == torch.int32 and theirs.dtype == np.uint32
  assert ours.shape == (40, width // 32)  # n_pad rows
  np.testing.assert_array_equal(ours.numpy(), theirs.view(np.int32))
  assert (ours.numpy() < 0).any()  # bit 31 set somewhere
  assert not ours[N_USERS:].any()  # pad users' rows are zero


@pytest.mark.parametrize('B', [1, 5, 40])
def test_plain_unpack_matches_jax(B):
  rng = np.random.default_rng(B)
  words = rng.integers(0, 2 ** 32, (B, 7), dtype=np.uint64).astype(np.uint32)
  words[:, ::4] |= np.uint32(1 << 31)
  packed = torch.from_numpy(words.view(np.int32))
  theirs = np.asarray(JaxDeviceDataSource._unpack_rows(jnp.asarray(words)))
  for fetch in (dict(start=0, count=B), dict(index=torch.arange(B))):
    rows, col_mask = pr.unpack_rows(packed, 200, **fetch)
    assert rows.dtype == torch.bfloat16 and rows.shape == (B, 224)
    np.testing.assert_array_equal(rows.view(torch.int16).numpy(),
                                  theirs.view(np.int16))
    expect = np.any(theirs != 0, axis=0) & (np.arange(224) < 200)
    np.testing.assert_array_equal(col_mask.numpy(), expect.astype(np.float32))


def test_plain_unpack_gathers_and_clamps():
  words = _ours(_matrix())._build_slab_packed(W)
  index = torch.tensor([5, 39, 500, 0, 5])  # 500: past the slab
  rows, _ = pr.unpack_rows(words, N_ITEMS, index=index)
  ref, _ = pr.unpack_rows(words, N_ITEMS, start=0, count=40)
  assert torch.equal(rows, ref[[5, 39, 39, 0, 5]])
  with pytest.raises(ValueError, match='exactly one'):
    pr.unpack_rows(words, N_ITEMS)
  with pytest.raises(ValueError, match='outside'):
    pr.unpack_rows(words, N_ITEMS, start=38, count=3)


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_packed_batches_equal_dense_and_jax(shuffle):
  """Every step of an epoch: the packed tier's rows bitwise the dense
  tier's, its column mask the one read off the dense rows, the same
  users and valid count; and the rows the JAX packed fetch unpacks."""
  m = _matrix()
  packed, dense = _ours(m, shuffle), _ours(m, shuffle)
  assert packed.maybe_cache_slabs(W, request='packed')
  assert dense.maybe_cache_slabs(W, request=True)
  assert packed._slab_packed and not dense._slab_packed
  theirs = _theirs(m, shuffle)
  assert theirs.maybe_cache_slabs(W, request='packed')
  assert theirs._slab_packed
  perm = packed.epoch_permutation(2)
  jperm = jnp.asarray(perm.numpy(), jnp.int32)
  pad_steps = 0
  for step in range(packed.steps_per_epoch):
    a = packed.build_fd_batch(perm, step)
    b = dense.build_fd_batch(perm, step)
    assert 'col_mask' not in b
    assert a['slab'].dtype == b['slab'].dtype == torch.bfloat16
    assert torch.equal(a['slab'], b['slab'])
    assert torch.equal(a['col_mask'], _dense_col_mask(b['slab']))
    assert torch.equal(a['users'], b['users'])
    assert a['num_users'] == b['num_users']
    pad_steps += int(a['num_users'] < BATCH)
    c = theirs._build_fd_from_cache(jperm, jnp.int32(step))
    np.testing.assert_array_equal(
        a['slab'].float().numpy(), np.asarray(c['slab']).astype(np.float32))
  assert pad_steps == 1  # the step that holds the pad users


# -- the tier rule ------------------------------------------------------------

N_PAD = 40
PACKED_BYTES = N_PAD * (W // 32) * 4  # 640
DENSE_BYTES = N_PAD * W * 2  # 10,240 in bf16
BETWEEN = (PACKED_BYTES + DENSE_BYTES) // 2

# (values, width, budget, [(request, expected tier, or 'decline: ' and the
# start of the JAX reason)])
OVER = 'decline: ' + '{:.2f} GiB exceeds the free-memory budget'
TIER_CASES = {
    'dense fits': ('binary', W, 10 ** 9, [('auto', 'dense')]),
    'dense over budget, packed fits': ('binary', W, BETWEEN,
                                       [('auto', 'packed')]),
    'packed over budget': ('binary', W, PACKED_BYTES - 1,
                           [('auto', OVER.format(DENSE_BYTES / 2**30))]),
    'not binary, over budget': ('ratings', W, BETWEEN,
                                [('auto', OVER.format(DENSE_BYTES / 2**30))]),
    'not binary, packed requested': ('ratings', W, 10 ** 9, [
        ('packed', "decline: slab_cache='packed' requires binary")]),
    'width % 32, packed requested': ('binary', W + 6, 10 ** 9, [
        ('packed', 'decline: packed tier needs width % 32 == 0')]),
    'width % 32, over budget': ('binary', W + 6, BETWEEN, [
        ('auto', OVER.format(N_PAD * (W + 6) * 2 / 2**30))]),
    'tier switch at the same width': ('binary', W, 10 ** 9, [
        ('auto', 'dense'), (True, 'dense, reused'), ('packed', 'packed'),
        ('auto', 'packed, reused'), (True, 'dense'),
        ('packed', 'packed')]),
}


@pytest.mark.parametrize('case', list(TIER_CASES))
def test_tier_choice_matches_jax(case, monkeypatch):
  values, width, budget, steps = TIER_CASES[case]
  m = _matrix(values)
  ours, theirs = _ours(m), _theirs(m)
  monkeypatch.setattr(ours, '_memory_budget', lambda: budget)
  theirs._slab_cache_budget = lambda: budget
  for request, expected in steps:
    before_ours, before_theirs = ours.d_slab, theirs.d_slab
    got_theirs = theirs.maybe_cache_slabs(width, request=request)
    if isinstance(expected, str) and expected.startswith('decline'):
      # JAX declines to its per-step scatter; so does the port, with the
      # JAX reason, and the scatter then serves the step
      assert not got_theirs and theirs.d_slab is None
      assert not ours.maybe_cache_slabs(width, request=request)
      assert ours.d_slab is None and ours._slab_request is None
      assert ours.decline_reason.startswith(expected.split(': ')[1])
      batch = ours.build_fd_batch(torch.arange(ours.n_pad), 0)
      assert batch['slab'].shape == (BATCH, width)
      want = np.zeros((BATCH, width), np.float32)
      want[:, :N_COLS] = m[:BATCH].toarray()  # (raw columns, as JAX's)
      np.testing.assert_array_equal(batch['slab'].float().numpy(), want)
      continue
    assert got_theirs and ours.maybe_cache_slabs(width, request=request)
    tier = expected.split(',')[0]
    assert theirs._slab_packed == ours._slab_packed == (tier == 'packed')
    assert ours._slab_request == request
    reused = expected.endswith('reused')
    assert (ours.d_slab is before_ours) == reused
    assert (theirs.d_slab is before_theirs) == reused
    if tier == 'packed':
      np.testing.assert_array_equal(
          ours.d_slab.numpy(), np.asarray(theirs.d_slab).view(np.int32))
    else:
      assert ours.d_slab.dtype == torch.bfloat16
      np.testing.assert_array_equal(
          ours.d_slab.float().numpy(),
          np.asarray(theirs.d_slab).astype(np.float32))


# -- trainings ----------------------------------------------------------------

def _train(m, slab_cache, compute_dtype, loss, shuffle, steps=5, seed=3):
  tr = Recoder(DynamicAutoencoder([16], 'tanh', noise_prob=0.5,
                                  compute_dtype=compute_dtype),
               optimizer_type='adam', loss=loss, seed=seed, device='cpu',
               opt_state_dtype=compute_dtype,
               loss_params={'confidence': 3} if loss == 'mse' else None)
  tr.train(RecommendationDataset(m), batch_size=BATCH, lr=1e-2,
           weight_decay=2e-5, negative_sampling=True, shuffle=shuffle,
           num_epochs=1, iters_per_epoch=steps, slab_cache=slab_cache,
           full_decode=True)
  return tr


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('compute_dtype,loss', [(None, 'mse'),
                                                ('bfloat16', 'logloss')])
def test_packed_training_is_bitwise_dense(compute_dtype, loss, shuffle):
  """5 steps with noise, from one seed: the packed tier's rows and mask
  equal the dense tier's, so the losses and parameters are bitwise
  equal."""
  m = _matrix()
  a = _train(m, 'packed', compute_dtype, loss, shuffle)
  b = _train(m, True, compute_dtype, loss, shuffle)
  assert a.fused_data_source._slab_packed
  assert not b.fused_data_source._slab_packed
  assert len(a.last_epoch_losses) == 5
  assert a.last_epoch_losses == b.last_epoch_losses
  for name, p in a.model.params().items():
    assert torch.equal(p, b.model.params()[name]), name


def _jax_epoch_loss(caplog):
  msgs = [r.getMessage() for r in caplog.records
          if r.name == 'recoder_tpu' and 'loss=' in r.getMessage()]
  return float(re.search(r'loss=([-0-9.]+)', msgs[-1]).group(1))


@pytest.mark.parametrize('compute_dtype,loss', [(None, 'mse'),
                                                ('bfloat16', 'logloss')])
def test_packed_training_matches_jax_trainer(compute_dtype, loss, caplog):
  """One 'users' epoch of 3 steps on the packed tier, noise off, from
  the JAX trainer's init: the same order, epoch loss and parameters
  (float32: rtol 1e-4 and atol 1e-5 as tests/test_torch_slice.py; bf16:
  rtol 1e-2 and the parameters within 3 lr, 0.1 lr on average, as
  tests/test_torch_bf16.py)."""
  caplog.set_level(logging.INFO, logger='recoder_tpu')
  n_users, lr = 48, 1e-3
  m = sp.csr_matrix(
      (np.random.default_rng(5).random((n_users, 120)) < 0.1)
      .astype(np.float32))
  kw = dict(hidden_layers=[16], activation_type='tanh', noise_prob=0.0,
            compute_dtype=compute_dtype)
  common = dict(optimizer_type='adam', loss=loss, seed=3,
                opt_state_dtype=compute_dtype,
                loss_params={'confidence': 3} if loss == 'mse' else None)
  jtr = JaxRecoder(JaxDynAE(**kw), **common)
  jtr.num_items, jtr.num_users = 120, n_users
  jtr._init_model()
  ptr = Recoder(DynamicAutoencoder(**kw), device='cpu', **common)
  ptr.num_items, ptr.num_users = 120, n_users
  ptr._init_model()
  with torch.no_grad():
    for name, t in convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jtr.model.params.items()}).items():
      ptr.model.params()[name].copy_(t)
  train_kw = dict(batch_size=16, lr=lr, weight_decay=2e-5, num_epochs=1,
                  negative_sampling=True, shuffle='users', full_decode=True,
                  slab_cache='packed')
  jtr.train(JaxDataset(m), **train_kw)
  ptr.train(RecommendationDataset(m), **train_kw)
  assert jtr.fused_data_source._slab_packed
  assert ptr.fused_data_source._slab_packed
  assert len(ptr.last_epoch_losses) == 3
  np.testing.assert_allclose(np.mean(ptr.last_epoch_losses),
                             _jax_epoch_loss(caplog),
                             rtol=1e-4 if compute_dtype is None else 1e-2)
  for name, p in ptr.model.params().items():
    got, ref = p.detach().numpy(), np.asarray(jtr.model.params[name])
    if compute_dtype is None:
      np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
    else:
      np.testing.assert_allclose(got, ref, rtol=0, atol=3 * lr,
                                 err_msg=name)
      assert np.abs(got - ref).mean() <= 0.1 * lr, name
