"""The ``noised_input`` kernel on the card: against the plain chain
``dropout(l2_normalize_rows(x))`` at the two training widths (ML-20M's
[500, 20,224] and MSD's [500, 41,216]) -- bitwise for rows of zeros and
ones, within one bf16 ulp for random values (the row's sum of squares in
another order) -- the one-byte mask's bits and Philox offset equal to the
bf16 draw's, the edges (a width not a multiple of 8, a row stride, rows
of one vector and of 70,000 elements, a row of zeros, no noise, a given mask
of any dtype), the wrapper's refusals, and a 16-step captured ML-20M-width
step bitwise equal to eager steps.

Every test skips where ``torch.cuda.is_available()`` is False. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_noised_input_cuda.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch.models import base
from recoder_tpu_torch.ops import noised_input as ni

pytestmark = pytest.mark.cuda

WIDTHS = (20224, 41216)  # ML-20M's and MSD's padded catalogs


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


def _binary(B, W, device, seed=0, density=0.01):
  gen = torch.Generator(device=device).manual_seed(seed)
  x = (torch.rand(B, W, generator=gen, device=device) < density)
  x = x.to(torch.bfloat16)
  x[min(3, B - 1)] = 0  # a row of zeros
  return x


def _gen(device, offset=0):
  gen = torch.Generator(device=device).manual_seed(1234 << 32)
  gen.set_offset(offset)
  return gen


def _route_and_plain(x, rate, offset=0):
  """The helper's route and the plain chain from one generator state;
  returns both results and both generators' offsets after."""
  a, b = _gen(x.device, offset), _gen(x.device, offset)
  got = base.noised_input(x, rate, a)
  want = ni.noised_input_plain(x, rate, b)
  torch.cuda.synchronize()
  return got, want, a.get_offset(), b.get_offset()


def _within_one_ulp(got, want):
  """bf16 values equal or neighbours (the same sign, bit patterns one
  apart; zeros exactly)."""
  g = got.view(torch.int16).int()
  w = want.view(torch.int16).int()
  same_sign = (g < 0) == (w < 0)
  return bool(((g - w).abs() <= 1)[same_sign].all() and same_sign.all())


@pytest.mark.parametrize('W', WIDTHS)
def test_binary_rows_bitwise_the_plain_chain(cuda, W):
  x = _binary(500, W, cuda)
  before = ni.LAUNCHES['noised_input']
  got, want, off_got, off_want = _route_and_plain(x, 0.5, offset=4 * 12345)
  assert ni.LAUNCHES['noised_input'] == before + 1
  assert got.dtype == torch.bfloat16 and got.is_contiguous()
  assert torch.equal(got, want)
  assert off_got == off_want
  assert 0.4 < float((got != 0).sum() / (x != 0).sum()) < 0.6


@pytest.mark.parametrize('W', WIDTHS)
def test_random_values_within_one_ulp(cuda, W):
  gen = torch.Generator(device=cuda).manual_seed(5)
  x = torch.randn(500, W, generator=gen, device=cuda).to(torch.bfloat16)
  got, want, off_got, off_want = _route_and_plain(x, 0.5)
  assert off_got == off_want
  assert _within_one_ulp(got, want)
  # and the normalization alone
  got, want, _, _ = _route_and_plain(x, 0.0)
  assert _within_one_ulp(got, want)


@pytest.mark.parametrize('W', WIDTHS)
def test_one_byte_draw_is_the_bf16_draw(cuda, W):
  """The route's mask: the same bits and the same Philox advance as the
  plain chain's bf16 draw, at both training widths."""
  for offset in (0, 8 * 999):
    a, b = _gen(cuda, offset), _gen(cuda, offset)
    small = torch.empty((500, W), dtype=ni.MASK_DTYPE,
                        device=cuda).bernoulli_(0.5, generator=a)
    wide = torch.empty((500, W), dtype=torch.bfloat16,
                       device=cuda).bernoulli_(0.5, generator=b)
    assert a.get_offset() == b.get_offset()
    assert torch.equal(small.bool(), wide.bool())


@pytest.mark.parametrize('B,W,rate', [
    (37, 1001, 0.5),     # width not a multiple of 8: the scalar kernel
    (5, 8, 0.5),         # one vector a row
    (3, 1, 0.3),         # one column
    (16, 70000, 0.5),    # a row wider than the 50 MB L2 holds 500 of
    (500, 20224, 0.3),   # another keep probability (an inexact 1 / keep)
    (500, 20224, 0.0),   # no noise: the normalization alone
])
def test_edges_give_the_plain_result(cuda, B, W, rate):
  x = _binary(B, W, cuda, seed=B + W, density=0.05)
  if B > 1:
    x[0, :W] = 1  # a full row
  got, want, off_got, off_want = _route_and_plain(x, rate)
  assert torch.equal(got, want)
  assert off_got == off_want


@pytest.mark.parametrize('W', [1000, 1001, 20224])
def test_a_row_stride_wider_than_the_row(cuda, W):
  """A union's densified rows: the ``[:B, :W]`` view of a buffer of
  row stride round8(W) (or wider)."""
  buf = _binary(40, W + 24, cuda, seed=W)
  x = buf[:, :W]
  assert not x.is_contiguous() and ni.takes(x)
  got, want, _, _ = _route_and_plain(x, 0.5)
  assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.uint8, torch.bool,
                                   torch.float32])
def test_a_given_mask(cuda, dtype):
  x = _binary(50, 2048, cuda, density=0.2)
  gen = torch.Generator(device=cuda).manual_seed(9)
  mask = torch.rand(x.shape, generator=gen, device=cuda) < 0.5
  if dtype == torch.bfloat16:
    mask = mask.to(dtype) * -1.0  # -1 keeps, -0.0 drops
  else:
    mask = mask.to(dtype)
  got = base.noised_input(x, 0.5, keep_mask=mask)
  want = ni.noised_input_plain(x, 0.5, keep_mask=mask)
  assert torch.equal(got, want)


def test_the_kernel_is_deterministic(cuda):
  gen = torch.Generator(device=cuda).manual_seed(2)
  x = torch.randn(500, 20224, generator=gen, device=cuda).to(torch.bfloat16)
  mask = torch.rand(x.shape, generator=gen, device=cuda) < 0.5
  a = ni.noised_input_kernel(x, 0.5, mask)
  b = ni.noised_input_kernel(x, 0.5, mask)
  assert torch.equal(a, b)


def test_empty_input_launches_nothing(cuda):
  before = ni.LAUNCHES['noised_input']
  for shape in ((0, 64), (4, 0)):
    x = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    got = base.noised_input(x, 0.5, _gen(cuda))
    assert got.shape == shape
  assert ni.LAUNCHES['noised_input'] == before


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  x = _binary(8, 64, cuda)
  mask = torch.ones((8, 64), dtype=torch.bool, device=cuda)
  with pytest.raises(ValueError, match='bfloat16'):
    ni.noised_input_kernel(x.float(), 0.5, mask)
  with pytest.raises(ValueError, match='stride'):
    ni.noised_input_kernel(x.t(), 0.5, mask.t().contiguous())
  with pytest.raises(ValueError, match='stride'):
    ni.noised_input_kernel(x[:, ::2], 0.5, mask[:, ::2].contiguous())
  with pytest.raises(ValueError, match='does not fit'):
    ni.noised_input_kernel(x, 0.5, mask[:, :32])
  with pytest.raises(ValueError, match='bool or uint8'):
    ni.noised_input_kernel(x, 0.5, mask.float())
  with pytest.raises(ValueError, match='contiguous'):
    ni.noised_input_kernel(x, 0.5, torch.ones((64, 8), dtype=torch.bool,
                                              device=cuda).t())
  with pytest.raises(ValueError, match='needs a keep mask'):
    ni.noised_input_kernel(x, 0.5)
  with pytest.raises(ValueError, match='outside'):
    ni.noised_input_kernel(x, 1.5, mask)
  with pytest.raises(ValueError, match='CUDA'):
    ni.noised_input_kernel(x.cpu(), 0.5, mask.cpu())
  # float32 rows are no refusal of the helper: they take the plain chain
  before = ni.LAUNCHES['noised_input']
  z = base.noised_input(x.float(), 0.5, _gen(cuda))
  assert z.dtype == torch.float32
  assert ni.LAUNCHES['noised_input'] == before


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


def _ml20m_trainer(cuda):
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5,
                                    compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='logistic', device=cuda,
                 opt_state_dtype='bfloat16')


def test_captured_ml20m_width_steps_are_bitwise_eager(cuda):
  """The benchmark's ML-20M step (batch 500, the padded catalog of
  20,224, noise 0.5, logistic, bf16, 'blocks', full decode off the slab):
  22 steps an epoch, 16 to a graph, against one eager step a dispatch --
  the losses, parameters and moments bit for bit over two epochs, the
  kernel once an eager step."""
  data = _ml20m_width_data()
  kw = dict(batch_size=500, lr=1e-3, weight_decay=2e-5, num_epochs=2,
            negative_sampling=True, shuffle='blocks', full_decode=True,
            slab_cache=True)
  before = ni.LAUNCHES['noised_input']
  eager = _ml20m_trainer(cuda)
  eager.train(data, fused_steps_per_call=1, **kw)
  # once a step, and once in the noise-offset probe of each train call
  assert ni.LAUNCHES['noised_input'] - before == 2 * 22 + 1
  captured = _ml20m_trainer(cuda)
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
