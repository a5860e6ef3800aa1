"""The multinomial loss kernels on the card: against the plain chain
(``multinomial_nll_plain`` and its autograd gradient) at Mult-VAE's ML-20M
width [500, 20,224] and MSD's [500, 41,216] -- the loss sum to 1e-5
relative, a bf16 gradient within one bf16 ulp (but where the float32
difference of its two terms cancels: there within that difference's
rounding), the float32 variant to 1e-5 -- masked rows and columns an
exact 0, the edges (one row, the epoch's last batch of 177, widths of 1,
7 and 1,000,003 (rows split over several blocks), a row stride wider than
the row), empty inputs, two runs bitwise alike, the wrapper's refusals,
and a 16-step captured Mult-VAE run bitwise equal to eager steps.

Every test skips where ``torch.cuda.is_available()`` is False. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_multinomial_loss_cuda.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch.ops import losses
from recoder_tpu_torch.ops import multinomial_loss as mnl

pytestmark = pytest.mark.cuda

WIDTHS = (20224, 41216)  # ML-20M's and MSD's padded catalogs
LOGICAL = {20224: 20108, 41216: 41140}  # their items


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


def _operands(B, W, device, dtype=torch.bfloat16, seed=0, ld=None,
              density=0.004):
  """Scores as a decoder gives them (~N(0, 2)) and a binary target, [B, W]
  views of rows ``ld`` long (W by default)."""
  gen = torch.Generator(device=device).manual_seed(seed)
  ld = ld or W
  s = (2 * torch.randn(B, ld, generator=gen, device=device)).to(dtype)
  t = (torch.rand(B, ld, generator=gen, device=device) < density).to(dtype)
  if B > 2:
    t[1] = 0  # a target row of zeros
  return s[:, :W], t[:, :W]


def _masks(B, W, device, logical=None, masked_rows=(0,)):
  rm = torch.ones(B, device=device)
  for r in masked_rows:
    if r < B:
      rm[r] = 0.0
  cm = (torch.arange(W, device=device) < (logical or W)).float()
  return rm, cm


def _leaf(s):
  """A copy of ``s`` with its strides, needing a gradient."""
  x = torch.empty_strided(s.shape, s.stride(), dtype=s.dtype, device=s.device)
  return x.copy_(s).requires_grad_()


def _both(s, t, rm, cm, go=1.0 / 500):
  """The route's and the plain chain's loss and gradient of the scores."""
  xs, xp = _leaf(s), _leaf(s)
  got = losses.MultinomialNLLLoss(reduction='sum')(xs, t, rm, cm)
  want = mnl.multinomial_nll_plain(xp, t, rm, cm)
  (got * go).backward()
  (want * go).backward()
  torch.cuda.synchronize()
  return got, want, xs.grad, xp.grad


def _terms(s, t, rm, cm, go):
  """|the gradient's two terms| in float64: go rm T p and go rm cm t."""
  s64, t64 = s.double(), t.double()
  valid = cm != 0
  logits = torch.where(valid[None, :], s64, torch.full_like(s64, -torch.inf))
  p = torch.softmax(logits, dim=1)
  T = torch.sum(cm.double()[None, :] * t64, dim=1, keepdim=True)
  c = go * rm.double()[:, None]
  return (c * T * p).abs() + (c * cm.double()[None, :] * t64).abs()


def _bf16_ulp(x):
  """The bf16 spacing at |x| (float64)."""
  e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
  return torch.exp2(e - 7)


def _assert_bf16_grad(got, want, s, t, rm, cm, go):
  """Within one bf16 ulp of the chain, but where the float32 difference
  of the two terms cancels: there within 2^-19 of the terms' size (the
  two float32 evaluations' rounding: exp(s - m - log z) after the
  subtraction of a log z up to ~11) and an ulp."""
  assert got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16
  g, w = got.double(), want.double()
  diff = (g - w).abs()
  ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
  cancel = 2.0 ** -19 * _terms(s, t, rm, cm, go) + ulp
  assert bool((diff <= torch.where(diff <= ulp, ulp, cancel)).all())
  return float((diff > ulp).double().mean())


def _assert_loss(got, want):
  assert got.dtype == torch.float32 and got.shape == ()
  assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)) + 1e-30


@pytest.mark.parametrize('W', WIDTHS)
def test_bf16_kernels_against_the_plain_chain(cuda, W):
  s, t = _operands(500, W, cuda)
  rm, cm = _masks(500, W, cuda, LOGICAL[W], masked_rows=(7, 499))
  before = dict(mnl.LAUNCHES)
  got, want, g, gw = _both(s, t, rm, cm)
  assert mnl.LAUNCHES['mnll_fwd'] == before['mnll_fwd'] + 1
  assert mnl.LAUNCHES['mnll_bwd'] == before['mnll_bwd'] + 1
  _assert_loss(got, want)
  assert g.is_contiguous() and g.shape == s.shape
  share = _assert_bf16_grad(g, gw, s, t, rm, cm, 1.0 / 500)
  assert share < 1e-4  # the cancelling elements are few
  # masked rows and columns: an exact 0
  assert bool((g[rm == 0] == 0).all()) and bool((g[:, cm == 0] == 0).all())


@pytest.mark.parametrize('W', WIDTHS)
def test_float32_kernels_against_the_plain_chain(cuda, W):
  s, t = _operands(500, W, cuda, dtype=torch.float32, seed=1)
  rm, cm = _masks(500, W, cuda, LOGICAL[W])
  got, want, g, gw = _both(s, t, rm, cm)
  _assert_loss(got, want)
  assert g.dtype == torch.float32
  torch.testing.assert_close(g, gw, rtol=1e-5,
                             atol=1e-5 * float(gw.abs().max()))
  assert bool((g[rm == 0] == 0).all()) and bool((g[:, cm == 0] == 0).all())


@pytest.mark.parametrize('B,W,ld', [
    (1, 1, None),            # one column
    (177, 7, None),          # a row of one partial group
    (1, 1_000_003, None),    # one row split over many blocks
    (177, 1_000_003, None),  # the last batch at a large catalog
    (177, 20224, 20232),     # a row stride wider than the row
    (500, 20223, 20224),     # a union's width, its row stride round8(W)
    (2, 20224, None),        # few rows: split
])
def test_edges_give_the_plain_result(cuda, B, W, ld):
  s, t = _operands(B, W, cuda, seed=B + W, ld=ld, density=0.05)
  rm, cm = _masks(B, W, cuda, max(1, W - 5), masked_rows=(3,))
  if ld is not None:
    assert s.stride(0) == ld and mnl.takes(s, t)
  got, want, g, gw = _both(s, t, rm, cm, go=0.5)
  _assert_loss(got, want)
  _assert_bf16_grad(g, gw, s, t, rm, cm, 0.5)
  assert bool((g[rm == 0] == 0).all()) and bool((g[:, cm == 0] == 0).all())


@pytest.mark.parametrize('dtypes', [(torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16)])
def test_mixed_dtypes_and_no_masks(cuda, dtypes):
  s, _ = _operands(64, 1001, cuda, dtype=dtypes[0], seed=3)
  _, t = _operands(64, 1001, cuda, dtype=dtypes[1], seed=4, density=0.05)
  got, want, g, gw = _both(s, t, None, None, go=0.25)
  _assert_loss(got, want)
  assert g.dtype == dtypes[0]
  if dtypes[0] == torch.float32:
    torch.testing.assert_close(g, gw, rtol=1e-5,
                               atol=1e-5 * float(gw.abs().max()))
  else:
    ones = torch.ones(64, device=cuda)
    _assert_bf16_grad(g, gw, s, t, ones, torch.ones(1001, device=cuda), 0.25)


def test_elementwise_mean_and_a_row_without_valid_columns(cuda):
  s, t = _operands(40, 64, cuda, seed=5, density=0.2)
  rm, cm = _masks(40, 64, cuda)
  loss = losses.MultinomialNLLLoss()(s, t, rm, cm)
  want = losses._reduce(losses.multinomial_nll_loss(s, t, rm, cm),
                        'elementwise_mean', rm, cm)
  _assert_loss(loss, want)
  # no valid column at all: the loss 0 and the gradient 0
  x = s.detach().clone().requires_grad_()
  zero = mnl.multinomial_nll_sum(x, t, rm, torch.zeros(64, device=cuda))
  zero.backward()
  assert float(zero) == 0.0 and bool((x.grad == 0).all())


def test_empty_inputs_launch_nothing(cuda):
  before = dict(mnl.LAUNCHES)
  for shape in ((0, 64), (4, 0)):
    s = torch.zeros(shape, dtype=torch.bfloat16, device=cuda,
                    requires_grad=True)
    t = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    loss = losses.MultinomialNLLLoss(reduction='sum')(s, t)
    loss.backward()
    assert float(loss) == 0.0 and s.grad.shape == shape
  assert mnl.LAUNCHES == before


def test_two_runs_are_bitwise_equal(cuda):
  s, t = _operands(500, 20224, cuda, seed=6)
  rm, cm = _masks(500, 20224, cuda, 20108)
  runs = []
  for _ in range(2):
    x = s.detach().clone().requires_grad_()
    loss = mnl.multinomial_nll_sum(x, t, rm, cm)
    loss.backward()
    runs.append((loss.detach(), x.grad))
  assert torch.equal(runs[0][0], runs[1][0])
  assert torch.equal(runs[0][1], runs[1][1])


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
  s, t = _operands(8, 64, cuda)
  with pytest.raises(ValueError, match='bfloat16 or float32'):
    mnl.multinomial_nll_sum(s.half(), t)
  with pytest.raises(ValueError, match='bfloat16 or float32'):
    mnl.multinomial_nll_sum(s[None], t[None])
  with pytest.raises(ValueError, match='stride'):
    mnl.multinomial_nll_sum(s.t(), t.t())
  with pytest.raises(ValueError, match='stride'):
    mnl.multinomial_nll_sum(s[:, ::2], t[:, ::2])
  with pytest.raises(ValueError, match='does not fit'):
    mnl.multinomial_nll_sum(s, t[:, :32])
  with pytest.raises(ValueError, match='no gradient'):
    mnl.multinomial_nll_sum(s, t.float().requires_grad_())
  with pytest.raises(ValueError, match='does not fit'):
    mnl.multinomial_nll_sum(s, t, row_mask=torch.ones(9, device=cuda))
  with pytest.raises(ValueError, match='does not fit'):
    mnl.multinomial_nll_sum(s, t, col_mask=torch.ones(1, 64, device=cuda))
  with pytest.raises(ValueError, match='device'):
    mnl.multinomial_nll_sum(s, t, col_mask=torch.ones(64))
  with pytest.raises(ValueError, match='CUDA'):
    mnl.multinomial_nll_sum(s.cpu(), t.cpu())
  # what takes() refuses takes the plain chain, with no launch
  before = dict(mnl.LAUNCHES)
  loss = losses.MultinomialNLLLoss(reduction='sum')(s.half(), t.half())
  assert loss.dtype == torch.float32 and mnl.LAUNCHES == before


def _ml20m_width_data(users=11000, items=20108, seed=3):
  rng = np.random.default_rng(seed)
  nnz = users * 73  # ML-20M's interactions a user on its training split
  m = sp.csr_matrix((np.ones(nnz, np.float32),
                     (rng.integers(0, users, nnz),
                      rng.zipf(1.3, nnz) % items)), shape=(users, items))
  m.sum_duplicates()
  m.data[:] = 1.0
  from recoder_tpu_torch.data import RecommendationDataset
  return RecommendationDataset(m)


def _multvae_trainer(cuda):
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MultVAE
  return Recoder(MultVAE(600, 200, dropout_prob=0.5,
                         compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='logloss', device=cuda,
                 opt_state_dtype='bfloat16')


def test_captured_multvae_steps_are_bitwise_eager(cuda):
  """The benchmark's Mult-VAE step (batch 500, the padded catalog of
  20,224, the full softmax, bf16, 'users', full decode off the slab): 22
  steps an epoch, 16 to a graph, against one eager step a dispatch -- the
  losses, parameters and moments bit for bit over two epochs, the kernel
  pair once an eager step."""
  data = _ml20m_width_data()
  kw = dict(batch_size=500, lr=1e-3, weight_decay=0.0, num_epochs=2,
            negative_sampling=False, shuffle='users', full_decode=True,
            slab_cache=True)
  before = dict(mnl.LAUNCHES)
  eager = _multvae_trainer(cuda)
  eager.train(data, fused_steps_per_call=1, **kw)
  assert mnl.LAUNCHES['mnll_fwd'] - before['mnll_fwd'] == 2 * 22
  assert mnl.LAUNCHES['mnll_bwd'] - before['mnll_bwd'] == 2 * 22
  captured = _multvae_trainer(cuda)
  captured.train(data, fused_steps_per_call=16, **kw)
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  assert captured.model.num_items_padded == 20224
  assert len(captured.last_epoch_losses) == 22
  assert captured.last_epoch_losses == eager.last_epoch_losses
  theirs = eager.model.params()
  for name, p in captured.model.params().items():
    assert torch.equal(p, theirs[name]), name
    sa, sb = captured.optimizer.state[p], eager.optimizer.state[theirs[name]]
    for key in sa:
      assert torch.equal(torch.as_tensor(sa[key]).cpu().float(),
                         torch.as_tensor(sb[key]).cpu().float()), (name, key)
