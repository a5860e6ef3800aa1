"""Tests of the port that need a CUDA card: the fused decode-loss
kernel against its plain PyTorch version at ragged and boundary shapes,
the wrapper's refusals, and the trainer on the card against the trainer
on the CPU.

Every test skips where ``torch.cuda.is_available()`` is False. The file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: loss rtol 1e-4; gradients rtol 1e-3 with an absolute floor
of 1e-4 times the largest reference entry (float32 FMA sums in another
order than cuBLAS).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch.ops import fused_decode_loss as fdl

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


def _problem(B, d, W, device, seed=0):
  gen = torch.Generator().manual_seed(seed)
  h = torch.tanh(torch.randn(B, d, generator=gen))
  rows = 0.2 * torch.randn(W, d, generator=gen)
  bias = 0.1 * torch.randn(W, generator=gen)
  target = (torch.rand(B, W, generator=gen) < 0.1).float()
  row_mask = (torch.arange(B) < max(1, B - 2)).float()
  col_mask = (torch.rand(W, generator=gen) < 0.8).float()
  return [x.to(device) for x in (h, rows, bias, target, row_mask, col_mask)]


def _run(fn, problem, kind, confidence):
  h, rows, bias, target, rm, cm = problem
  leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]
  loss = fn(*leaves, target, rm, cm, kind, confidence)
  loss.backward()
  return loss.item(), [x.grad.cpu().numpy() for x in leaves]


@pytest.mark.parametrize('kind,confidence', [
    ('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)])
@pytest.mark.parametrize('B,d,W', [
    (37, 24, 1000),   # ragged on every axis
    (1, 1, 1),        # one of everything
    (33, 256, 65),    # the widest feature axis; one row past a tile
    (64, 255, 2049),  # odd feature width; one column past a tile
    (500, 200, 333),  # the training batch and width, a short catalog
])
def test_kernel_matches_plain(cuda, B, d, W, kind, confidence):
  problem = _problem(B, d, W, cuda)
  before = dict(fdl.LAUNCHES)
  got = _run(fdl.fused_decode_loss, problem, kind, confidence)
  ref = _run(fdl.fused_decode_loss_plain, problem, kind, confidence)
  assert fdl.LAUNCHES['fused_decode_loss_fwd'] == \
      before['fused_decode_loss_fwd'] + 1
  assert fdl.LAUNCHES['fused_decode_loss_bwd'] == \
      before['fused_decode_loss_bwd'] + 1
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
  for a, b in zip(got[1], ref[1]):
    np.testing.assert_allclose(a, b, rtol=1e-3,
                               atol=1e-4 * max(np.abs(b).max(), 1e-30))


def test_kernel_is_deterministic(cuda):
  problem = _problem(300, 64, 3000, cuda, seed=1)
  a = _run(fdl.fused_decode_loss, problem, 'mse', 3.0)
  b = _run(fdl.fused_decode_loss, problem, 'mse', 3.0)
  assert a[0] == b[0]
  for x, y in zip(a[1], b[1]):
    np.testing.assert_array_equal(x, y)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  h, rows, bias, target, rm, cm = _problem(8, 300, 40, cuda)
  with pytest.raises(ValueError, match='feature width'):
    fdl.fused_decode_loss(h, rows, bias, target, rm, cm, 'mse', 0.0)
  h, rows, bias, target, rm, cm = _problem(8, 16, 40, cuda)
  with pytest.raises(ValueError, match='contiguous'):
    fdl.fused_decode_loss(h, rows, bias, target.t().contiguous().t(), rm,
                          cm, 'mse', 0.0)
  with pytest.raises(ValueError, match='float32'):
    fdl.fused_decode_loss(h, rows, bias, target.half(), rm, cm, 'mse', 0.0)
  with pytest.raises(ValueError, match='is on'):
    fdl.fused_decode_loss(h, rows, bias, target.cpu(), rm, cm, 'mse', 0.0)


def test_trainer_on_cuda_matches_cpu(cuda):
  """Noise off, the same init and permutation: the per-step losses on
  the card (through the kernel) follow the CPU run (plain twin)."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  rng = np.random.default_rng(0)
  m = sp.csr_matrix((rng.random((90, 300)) < 0.05).astype(np.float32))
  losses = {}
  for device in ('cpu', cuda):
    tr = Recoder(DynamicAutoencoder([32], noise_prob=0.0),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=device)
    tr.train(RecommendationDataset(m), batch_size=16, lr=1e-3,
             weight_decay=2e-5, negative_sampling=True, shuffle='users',
             num_epochs=1)
    losses[str(device)] = tr.last_epoch_losses
  assert len(losses['cpu']) == 6
  np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)
