"""The port's batched SPD solve (``recoder_tpu_torch/ops/spd.py``)
against the JAX package's (``recoder_tpu/ops/spd.py``) on the CPU.

The same numpy systems go through both. Tolerances:

- ``cholesky_blocked`` and ``spd_solve(impl='blocked')``: max abs error
  within 2e-5 of the largest JAX entry. Both are the same float32
  recursion; only LAPACK's and XLA's rounding inside the base blocks
  differ (measured up to 2e-6).
- The port's plain solve against the TPU kernel ``_spd_solve_pallas``
  run in Pallas interpret mode: within 1e-5 of max |x| (measured 1.7e-6
  at d=128, 2.3e-6 at d=256, 5.7e-7 on the iALS-shaped systems at
  d=128, whose condition numbers at the init scale stay below 1.5, and
  1.4e-6 on systems from the item factors of a two-sweep fit on the
  fixture, condition numbers 9-14: the Gram of the trained factors and
  the frequency-scaled ridge keep iALS systems well conditioned), and
  the relative residual max |Ax - b| / max |b| within 1e-4 on both.
"""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental import pallas as pl
from scipy.sparse import csr_matrix

import recoder_tpu.ops.spd as jax_spd
from recoder_tpu_torch.models import IALS
from recoder_tpu_torch.ops import spd


def _spd_batch(b, d, seed):
  rng = np.random.default_rng(seed)
  f = rng.standard_normal((b, d + 8, d)).astype(np.float32) / np.sqrt(d)
  a = np.einsum('blk,blm->bkm', f, f).astype(np.float32)
  a += 0.05 * np.eye(d, dtype=np.float32)
  return a


def _rhs(shape, seed):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


def _residual(a, x, b):
  ax = np.einsum('bij,bj...->bi...', a.astype(np.float64),
                 x.astype(np.float64))
  return np.abs(ax - b).max() / np.abs(b).max()


@pytest.mark.parametrize('d', [4, 16, 24, 64, 128, 130])
def test_cholesky_blocked_matches_jax(d):
  a = _spd_batch(7, d, seed=d)
  ref = np.asarray(jax_spd.cholesky_blocked(a))
  got = spd.cholesky_blocked(torch.from_numpy(a)).numpy()
  assert got.shape == a.shape
  np.testing.assert_allclose(got, ref, rtol=0,
                             atol=2e-5 * np.abs(ref).max())
  assert not np.triu(got, k=1).any()  # upper half exactly zero


@pytest.mark.parametrize('k', [None, 3])
@pytest.mark.parametrize('d', [4, 16, 24, 64, 128, 130])
def test_spd_solve_blocked_matches_jax(d, k):
  a = _spd_batch(5, d, seed=d + 100)
  b = _rhs((5, d) if k is None else (5, d, k), seed=1)
  ref = np.asarray(jax_spd.spd_solve(a, b, impl='blocked'))
  got = spd.spd_solve(torch.from_numpy(a), torch.from_numpy(b),
                      impl='blocked').numpy()
  assert got.shape == b.shape
  np.testing.assert_allclose(got, ref, rtol=0,
                             atol=2e-5 * np.abs(ref).max())
  assert _residual(a, got, b) < 1e-4


def _ials_batch(B, d, seed, n_items=20108, L=64, alpha=10.0, lam=3e-3):
  """Systems as an iALS user half-sweep builds them (chip_smoke's
  ``ials_systems``): the Gram of item factors at the init scale, plus
  alpha-weighted corrections from up to L observed items, plus the
  frequency-scaled ridge; and the confidence-weighted right-hand side."""
  rng = np.random.default_rng(seed)
  items = (rng.standard_normal((n_items, d)) / np.sqrt(d)).astype(np.float32)
  cols = rng.integers(0, n_items, (B, L))
  counts = rng.integers(1, L + 1, B)
  valid = (np.arange(L) < counts[:, None]).astype(np.float32)
  f = items[cols] * valid[..., None]
  w = alpha * valid
  a = items.T @ items + np.einsum('bl,bld,ble->bde', w, f, f)
  a = a + (lam * (counts + 1.0))[:, None, None] * np.eye(d, dtype=np.float32)
  b = np.einsum('bl,bld->bd', w + valid, f)
  return a.astype(np.float32), b.astype(np.float32)


def _trained_ials_batch(B, d, users=2000, sweeps=2, alpha=10.0, lam=3e-3):
  """Systems as the user half-sweep after a short fit solves them: the
  port's iALS fitted on the fixture's first ``users`` users, then B of
  their systems built from the trained item factors."""
  df = pd.read_csv(os.path.join(os.path.dirname(__file__), 'data',
                                'train.csv.gz'))
  _, u = np.unique(df['uid'].to_numpy(), return_inverse=True)
  _, i = np.unique(df['sid'].to_numpy(), return_inverse=True)
  m = csr_matrix((np.ones(len(u), np.float32), (u, i)))[:users]
  model = IALS(embedding_size=d, alpha=alpha, lam=lam, sweeps=sweeps,
               device='cpu').fit(m, chunk_elems=1 << 16)
  items = model.item_factors.numpy()
  gram = items.T @ items
  a, b = [], []
  for row in np.random.default_rng(0).choice(users, B, replace=False):
    f = items[m.indices[m.indptr[row]:m.indptr[row + 1]]]
    a.append(gram + alpha * f.T @ f + lam * (len(f) + 1) * np.eye(d))
    b.append((alpha + 1) * f.sum(0))
  return np.asarray(a, np.float32), np.asarray(b, np.float32)


@pytest.mark.parametrize('d,B,systems', [
    pytest.param(128, 5, 'gram', id='128-5'),
    pytest.param(256, 3, 'gram', id='256-3'),
    pytest.param(128, 5, 'ials', id='ials-128-5'),
    pytest.param(128, 5, 'trained', id='ials-trained-128-5')])
def test_plain_solve_matches_tpu_kernel(d, B, systems):
  """The TPU kernel itself, run by Pallas's interpreter on the CPU, on
  well-conditioned Grams and on the systems an iALS fit solves, at the
  init scale and after two sweeps."""
  orig = pl.pallas_call

  def interpreted(*args, **kwargs):
    kwargs['interpret'] = True
    return orig(*args, **kwargs)

  if systems == 'ials':
    a, b = _ials_batch(B, d, seed=d)
  elif systems == 'trained':
    a, b = _trained_ials_batch(B, d)
  else:
    a = _spd_batch(B, d, seed=d)
    b = _rhs((B, d), seed=2)
  with mock.patch.object(pl, 'pallas_call', interpreted):
    ref = np.asarray(jax_spd._spd_solve_pallas(jnp.asarray(a),
                                               jnp.asarray(b)))
  got = spd.spd_solve(torch.from_numpy(a), torch.from_numpy(b),
                      base=32).numpy()
  np.testing.assert_allclose(got, ref, rtol=0,
                             atol=1e-5 * np.abs(ref).max())
  assert _residual(a, got, b) < 1e-4
  assert _residual(a, ref, b) < 1e-4


def test_auto_takes_the_blocked_route_on_cpu():
  a = torch.from_numpy(_spd_batch(4, 128, seed=0))
  b = torch.from_numpy(_rhs((4, 128), seed=0))
  before = dict(spd.LAUNCHES)
  auto = spd.spd_solve(a, b, base=32)
  assert spd.LAUNCHES == before
  torch.testing.assert_close(auto, spd.spd_solve_blocked(a, b, 32),
                             rtol=0, atol=0)


def test_kernel_route_refuses_cpu_tensors():
  a = torch.from_numpy(_spd_batch(2, 16, seed=0))
  b = torch.from_numpy(_rhs((2, 16), seed=0))
  with pytest.raises(ValueError, match='CUDA'):
    spd.spd_solve(a, b, impl='kernel')
  with pytest.raises(ValueError, match='CUDA'):
    spd.spd_solve_kernel(a, b)
  with pytest.raises(ValueError, match='unknown impl'):
    spd.spd_solve(a, b, impl='pallas')


@pytest.mark.parametrize('d', [0, 257])
def test_kernel_resources_refuses_widths_the_kernel_does_not_take(d):
  with pytest.raises(ValueError, match='width'):
    spd.kernel_resources(d)


def test_indefinite_system_gives_nan():
  """As ``jnp.linalg.cholesky``: NaN, not an exception."""
  a = _spd_batch(3, 40, seed=4)
  a[1] = -a[1]
  b = _rhs((3, 40), seed=4)
  ref = np.asarray(jax_spd.spd_solve(a, b, impl='blocked'))
  got = spd.spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
  assert np.isnan(ref[1]).all() and np.isnan(got[1]).all()
  assert np.isfinite(got[[0, 2]]).all()
  np.testing.assert_allclose(got[[0, 2]], ref[[0, 2]], rtol=0,
                             atol=2e-5 * np.abs(ref[[0, 2]]).max())


def test_leading_batch_dims():
  a = _spd_batch(6, 20, seed=6).reshape(2, 3, 20, 20)
  b = _rhs((2, 3, 20), seed=6)
  ref = np.asarray(jax_spd.spd_solve(a, b))
  got = spd.spd_solve(torch.from_numpy(a), torch.from_numpy(b)).numpy()
  assert got.shape == (2, 3, 20)
  np.testing.assert_allclose(got, ref, rtol=0,
                             atol=2e-5 * np.abs(ref).max())
