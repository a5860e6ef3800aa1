"""The bf16 working copies on the card: the weight gradient's bf16-output
GEMMs against today's float32 product rounded to bf16 at the training
shapes (Mult-VAE's and the autoencoders' tables, the decoder's swapped
operands); one Adam launch over a mixed set (tensors with and without a
copy, bf16 and float32 gradients) against a launch of each tensor alone
and the plain twin; and Mult-VAE at ML-20M's widths trained through the
copies against the cast path, bitwise, in eager steps and in 16-step
captured replays, each copy ``p.to(bf16)`` after every eager step.

Every test skips where ``torch.cuda.is_available()`` is False. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_working_copies_cuda.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
ML20M = (20108, 20224)  # the catalog and its padded width


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')


@pytest.mark.parametrize('B,W,d,transposed', [
    (500, 20224, 600, False), (500, 20224, 600, True),
    (500, 20224, 200, False), (500, 41216, 200, False),
    # a mega-batch of 2,000 users, and union widths (the MSD union's
    # 18,117, a rung of 18,120)
    (2000, 20224, 200, False), (2000, 20224, 200, True),
    (500, 18117, 200, False), (500, 18117, 200, True),
    (500, 18120, 200, False), (2000, 18120, 200, True)])
def test_weight_gradient_is_the_rounded_float32_product(cuda, B, W, d,
                                                        transposed):
  """The product's weight gradient, one bf16-output GEMM laid out as the
  weight is, with float32 sums, equals ``mm(a.t(), g,
  out_dtype=float32).to(bf16)`` bit for bit: the encoder's table ``[W,
  d]`` read by ``z [B, W]``, and the decoder's ``table.t()`` read by ``h
  [B, d]`` (the gradient in the table's rows). PyTorch's own setting
  (bf16 reductions of split-K parts allowed) is left as it is around
  the call."""
  from recoder_tpu_torch.ops.gather_matmul import _MatmulF32Out
  gen = torch.Generator(device=cuda)
  for seed in range(3):
    gen.manual_seed(seed)
    if transposed:
      a = torch.randn(B, d, generator=gen, device=cuda).tanh().to(BF)
      table = torch.randn(W, d, generator=gen, device=cuda).to(BF)
      b = table.detach().requires_grad_()
      out = _MatmulF32Out.apply(a, b.t())
      g = 1e-3 * torch.randn(B, W, generator=gen, device=cuda)
      want = torch.mm(a.t(), g.to(BF), out_dtype=torch.float32).to(BF).t()
    else:
      keep = torch.rand(B, W, generator=gen, device=cuda) < 0.004
      a = (torch.randn(B, W, generator=gen, device=cuda) * keep).to(BF)
      b = torch.randn(W, d, generator=gen, device=cuda).to(
          BF).requires_grad_()
      out = _MatmulF32Out.apply(a, b)
      g = 1e-2 * torch.randn(B, d, generator=gen, device=cuda)
      want = torch.mm(a.t(), g.to(BF), out_dtype=torch.float32).to(BF)
    out.backward(g)
    assert b.grad.dtype == BF and b.grad.is_contiguous()
    assert torch.equal(b.grad, want)
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def _mixed_set(device, seed=0):
  """Float32 params, bf16 moments and gradients of Mult-VAE's shapes and
  a few odd ones: (p, g, m, v, copy) per tensor, some copies None, some
  gradients float32."""
  gen = torch.Generator().manual_seed(seed)
  shapes = [(20224, 600), (600,), (600, 200), (200,), (200, 600), (4097,),
            (1,), (20224,), (33, 7)]
  out = []
  for i, shape in enumerate(shapes):
    p = 0.1 * torch.randn(shape, generator=gen)
    g = (0.01 * torch.randn(shape, generator=gen)).to(BF)
    if i % 3 == 2:
      g = g.float()
    m = (0.001 * torch.randn(shape, generator=gen)).to(BF)
    v = (1e-5 * torch.rand(shape, generator=gen)).to(BF)
    w = p.to(BF) if i % 2 == 0 else None
    out.append([None if x is None else x.to(device) for x in (p, g, m, v, w)])
  return [list(x) for x in zip(*out)]


def test_a_mixed_launch_steps_each_tensor_as_a_pure_launch(cuda):
  """One launch over tensors with and without a copy, with bf16 and
  float32 gradients, against a launch of each tensor alone: every buffer
  bitwise; each copy ``p.to(bf16)`` of its stepped parameter; a bf16
  gradient steps as its float32 upcast does; and the plain twin on the
  same set: the moments bitwise, the parameters within 2 float32 ulps
  (as the pure kernel is held)."""
  from recoder_tpu_torch.ops import adam
  wds = [2e-5 if i % 2 == 0 else 0.0 for i in range(9)]
  mixed = _mixed_set(cuda)
  alone = [[None if x is None else x.clone() for x in xs] for xs in mixed]
  upcast = [[None if x is None else x.clone() for x in xs] for xs in mixed]
  plain = [[None if x is None else x.clone() for x in xs] for xs in mixed]
  upcast[1] = [g.float() for g in upcast[1]]
  for step in range(1, 4):
    scalars = adam.step_scalars(1e-3, step, (0.9, 0.999), 1e-8)
    adam.adam_bf16_kernel(*mixed[:4], wds, scalars, copies=mixed[4])
    for i in range(9):
      adam.adam_bf16_kernel(*[[x[i]] for x in alone[:4]], [wds[i]], scalars,
                            copies=[alone[4][i]])
    adam.adam_bf16_kernel(*upcast[:4], wds, scalars, copies=upcast[4])
    adam.adam_bf16_plain(*plain[:4], wds, scalars, copies=plain[4])
  torch.cuda.synchronize()
  for k in (0, 2, 3, 4):
    for a, b, c in zip(mixed[k], alone[k], upcast[k]):
      if a is not None:
        assert torch.equal(a, b) and torch.equal(a, c)
  for p, w in zip(mixed[0], mixed[4]):
    if w is not None:
      assert torch.equal(w, p.to(BF))
  for a, b in zip(mixed[2] + mixed[3], plain[2] + plain[3]):
    assert torch.equal(a, b)
  for a, b in zip(mixed[0], plain[0]):
    assert _f32_ulps(a, b) <= 2


def _f32_ulps(a, b):
  """|a - b| in float32 ulps of b."""
  a, b = a.double(), b.double()
  ulp = torch.finfo(torch.float32).eps * b.abs().clamp(min=1e-30)
  return float(((a - b).abs() / ulp).max())


def _ml20m_matrix(users, seed=0, per_user=73):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(users), per_user)
  cols = (ML20M[0] * rng.random(users * per_user) ** 2.2).astype(np.int64)
  m = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                    shape=(users, ML20M[0]))
  m.data[:] = 1.0
  return m


def _train_multvae(cuda, monkeypatch, route, steps_per_call, users,
                   check_copies=False):
  from recoder_tpu_torch import kernels, optim
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MultVAE
  with monkeypatch.context() as mp:
    if not route:
      mp.setattr(optim.Bf16Adam, 'working_copy', lambda self, p: None)
    if check_copies:
      step = optim.Bf16Adam.step

      def checked(self, closure=None):
        out = step(self, closure)
        if not kernels.capturing():
          for p, w in self._copies.items():
            assert torch.equal(w, p.to(BF))
        return out
      mp.setattr(optim.Bf16Adam, 'step', checked)
    tr = Recoder(MultVAE(600, 200, dropout_prob=0.5,
                         compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='logloss', device=cuda, seed=5,
                 opt_state_dtype='bfloat16')
    tr.train(RecommendationDataset(_ml20m_matrix(users)), batch_size=500,
             lr=1e-3, negative_sampling=False, shuffle='users',
             num_epochs=1, fused_steps_per_call=steps_per_call)
    torch.cuda.synchronize()
  return tr


def _assert_same_state(a, b):
  assert a.last_epoch_losses == b.last_epoch_losses
  for (name, p), q in zip(a.model.params().items(), b.model.params().values()):
    assert torch.equal(p, q), name
    for key in ('exp_avg', 'exp_avg_sq'):
      assert torch.equal(a.optimizer.state[p][key],
                         b.optimizer.state[q][key]), (name, key)


def test_multvae_at_ml20m_widths_is_the_cast_path_bitwise(cuda, monkeypatch):
  """Mult-VAE [600, 200] over ML-20M's padded catalog, bf16, one epoch of
  eager steps through the copies and through the cast path: the same
  losses, parameters and moments, bit for bit; each copy ``p.to(bf16)``
  after every step; every weight but the biases routed."""
  from recoder_tpu_torch.ops import adam
  a = _train_multvae(cuda, monkeypatch, True, 1, 3000, check_copies=True)
  share = adam.COPY_SHARE['adam_bf16']
  b = _train_multvae(cuda, monkeypatch, False, 1, 3000)
  _assert_same_state(a, b)
  assert len(a.optimizer.copies()) == 5 and share > 0.999


def test_multvae_captured_replays_are_the_eager_cast_path(cuda, monkeypatch):
  """The same at 16-step captured replays (3 eager warm-up steps, a
  16-step graph, one-step graphs): bitwise the eager cast path, and each
  copy ``p.to(bf16)`` at the end."""
  a = _train_multvae(cuda, monkeypatch, True, 16, 10_500)
  assert a.captures >= 2
  b = _train_multvae(cuda, monkeypatch, False, 1, 10_500)
  _assert_same_state(a, b)
  for p, w in a.optimizer._copies.items():
    assert torch.equal(w, p.to(BF))
