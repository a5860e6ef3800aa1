"""The port's batched SPD solve (``recoder_tpu_torch/ops/spd.py``)
against the JAX package's (``recoder_tpu/ops/spd.py``) on the CPU.

The same numpy systems go through both. Tolerances:

- ``cholesky_blocked`` and ``spd_solve(impl='blocked')``: max abs error
  within 2e-5 of the largest JAX entry. Both are the same float32
  recursion; only LAPACK's and XLA's rounding inside the base blocks
  differ (measured up to 2e-6).
- The port's plain solve against the TPU kernel ``_spd_solve_pallas``
  run in Pallas interpret mode: within 1e-5 of max |x| (measured 1.7e-6
  at d=128, 2.3e-6 at d=256), and the relative residual
  max |Ax - b| / max |b| within 1e-4 on both.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import recoder_tpu.ops.spd as jax_spd
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


@pytest.mark.parametrize('d,B', [(128, 5), (256, 3)])
def test_plain_solve_matches_tpu_kernel(d, B):
  """The TPU kernel itself, run by Pallas's interpreter on the CPU."""
  orig = pl.pallas_call

  def interpreted(*args, **kwargs):
    kwargs['interpret'] = True
    return orig(*args, **kwargs)

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
