"""The multinomial loss on the CPU: ``MultinomialNLLLoss`` routes to the
elementwise chain and gives exactly its sum (float32 and bf16, row and
column masks, a fully masked row, a target row of zeros), ``takes`` refuses
what the kernels do not read, 'none' keeps the chain, a float64 model of
the kernels' two passes (segments, running maxima, the combine, the
gradient's formula) equals the chain's loss and autograd gradient, and
Mult-VAE's trainer reaches the loss through the routed call. The kernels
run only on the card (``tests/test_torch_multinomial_loss_cuda.py``)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch.ops import losses
from recoder_tpu_torch.ops import multinomial_loss as mnl


def _operands(dtype, B=6, W=37, seed=0):
  gen = torch.Generator().manual_seed(seed)
  s = (3 * torch.randn(B, W, generator=gen)).to(dtype)
  t = (torch.rand(B, W, generator=gen) < 0.3).float()
  t[1] *= torch.rand(W, generator=gen) * 4  # weights other than 0 and 1
  t[2] = 0.0  # a target row of zeros
  return s, t.to(dtype)


def _masks(which, B, W):
  rm = cm = None
  if which in ('rows', 'both'):
    rm = torch.ones(B)
    rm[3] = 0.0  # a fully masked row
    rm[B - 1] = 0.0
  if which in ('columns', 'both'):
    cm = (torch.arange(W) % 5 != 2).float()
    cm[W - 3:] = 0.0
  return rm, cm


class _OnCard:
  """A CPU tensor as ``takes`` would see it on the card: it reads only the
  tensor's metadata."""

  device = torch.device('cuda', 0)

  def __init__(self, x):
    self.x = x

  def __getattr__(self, name):
    return getattr(self.x, name)


@pytest.mark.parametrize('masks', ['none', 'rows', 'columns', 'both'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_routed_loss_is_the_chain_summed(dtype, masks):
  s, t = _operands(dtype)
  rm, cm = _masks(masks, *s.shape)
  before = dict(mnl.LAUNCHES)
  got = losses.MultinomialNLLLoss(reduction='sum')(s, t, row_mask=rm,
                                                   col_mask=cm)
  chain = losses.multinomial_nll_loss(s, t, row_mask=rm, col_mask=cm)
  assert got.dtype == torch.float32
  assert torch.equal(got, torch.sum(chain))
  assert torch.equal(got, mnl.multinomial_nll_plain(s, t, rm, cm))
  mean = losses.MultinomialNLLLoss()(s, t, row_mask=rm, col_mask=cm)
  assert torch.equal(mean, losses._reduce(chain, 'elementwise_mean', rm, cm))
  assert mnl.LAUNCHES == before  # no kernel on the CPU


def test_reduction_none_keeps_the_chain():
  s, t = _operands(torch.bfloat16)
  rm, cm = _masks('both', *s.shape)
  got = losses.MultinomialNLLLoss(reduction='none')(s, t, row_mask=rm,
                                                    col_mask=cm)
  assert got.shape == s.shape
  assert torch.equal(got, losses.multinomial_nll_loss(s, t, rm, cm))
  with pytest.raises(ValueError, match='No such reduction'):
    losses.MultinomialNLLLoss(reduction='mean')(s, t)


def test_takes_reads_what_the_kernels_take():
  s, t = _operands(torch.bfloat16)
  wide = torch.zeros(6, 48, dtype=torch.bfloat16)[:, :37]
  assert mnl.takes(_OnCard(s), _OnCard(t))
  assert mnl.takes(_OnCard(s.float()), _OnCard(t))  # float32 scores
  assert mnl.takes(_OnCard(wide), _OnCard(t))  # a row stride > W


@pytest.mark.parametrize('case', ['cpu', 'float16', 'column stride', '3-D',
                                  'group', 'shapes', 'target grad'])
def test_takes_refuses(case):
  s, t = _operands(torch.bfloat16)
  group = None
  if case == 'cpu':
    assert not mnl.takes(s, t)
    with pytest.raises(ValueError, match='CUDA'):
      mnl.multinomial_nll_sum(s, t)
    return
  if case == 'float16':
    s = s.half()
  elif case == 'column stride':
    s = torch.zeros(37, 6, dtype=torch.bfloat16).t()
  elif case == '3-D':
    s, t = s[None], t[None]
  elif case == 'group':
    group = object()
  elif case == 'shapes':
    s = s[:, :30]
  elif case == 'target grad':
    t = t.float().requires_grad_()
  assert not mnl.takes(_OnCard(s), _OnCard(t), group)


# -- the kernels' mathematics in float64 -----------------------------------

def _two_pass(s, t, rm, cm, go, segments, threads):
  """The kernels' arithmetic in float64 (numpy): the forward splits each
  row's groups of 8 columns over ``segments`` blocks of ``threads``; each
  thread keeps a running (m, z, A, T) over its groups, rebased where the
  maximum grows; the block combines its threads in order; the finish
  combines each row's segments over a power of two of lanes, each lane's in
  order, then the lanes in a tree. Returns the loss and the gradient."""
  B, W = s.shape
  w = np.ones(W) if cm is None else cm
  r = np.ones(B) if rm is None else rm
  ng = -(-W // 8)
  gps = -(-ng // segments)
  none = (-np.inf, 0.0, 0.0, 0.0)

  def rebase(st, m):
    sm, z, a, tw = st
    if z != 0.0:
      z, a = z * np.exp(sm - m), a - tw * (m - sm)
    return (m, z, a, tw)

  def combine(x, y):
    if y[1] == 0.0:
      return x
    if x[1] == 0.0:
      return y
    m = max(x[0], y[0])
    x, y = rebase(x, m), rebase(y, m)
    return (m, x[1] + y[1], x[2] + y[2], x[3] + y[3])

  def add_group(st, b, c):
    cols = [j for j in range(c, min(c + 8, W)) if w[j] != 0.0]
    if not cols:
      return st
    gm = max(s[b, j] for j in cols)
    if gm > st[0]:
      st = rebase(st, gm)
    m, z, a, tw = st
    for j in cols:
      d = s[b, j] - m
      z, tw, a = z + np.exp(d), tw + w[j] * t[b, j], a + w[j] * t[b, j] * d
    return (m, z, a, tw)

  lanes = 1  # the finish's lanes a row (up to 32; all rows in one pass)
  while lanes < min(segments, 32) and B * lanes * 2 <= 1024:
    lanes *= 2
  total, stats = 0.0, []
  for b in range(B):
    parts = []
    for seg in range(segments):
      g0, g1 = seg * gps, min(seg * gps + gps, ng)
      block = none
      for th in range(threads):
        st = none
        for g in range(g0 + th, g1, threads):
          st = add_group(st, b, 8 * g)
        block = combine(block, st)
      parts.append(block)
    # the finish: lane k combines segments k, k + lanes, ..., then a tree
    lane = [none] * lanes
    for k, part in enumerate(parts):
      lane[k % lanes] = combine(lane[k % lanes], part)
    o = lanes // 2
    while o:
      lane = [combine(lane[i], lane[i ^ o]) for i in range(lanes)]
      o //= 2
    m, z, a, tw = lane[0]
    lz = np.log(z) if z != 0.0 else 0.0
    loss = tw * lz - a if z != 0.0 else 0.0
    total += r[b] * loss
    stats.append((m if z != 0.0 else 0.0, lz, tw))
  grad = np.zeros((B, W))
  for b, (m, lz, tw) in enumerate(stats):
    c = go * r[b]
    for j in range(W):
      if w[j] != 0.0:
        grad[b, j] = c * tw * np.exp(s[b, j] - m - lz) - c * (w[j] * t[b, j])
  return total, grad


def _chain64(scores, target, rm, cm):
  """The plain chain's steps (``ops/losses.multinomial_nll_loss``) in
  float64, summed: masked columns out of the normalizer, then the masks'
  products."""
  logits = scores
  if cm is not None:
    logits = torch.where(cm[None, :].bool(), scores,
                         torch.full_like(scores, losses._NEG_INF))
  shifted = logits - torch.amax(logits, dim=1, keepdim=True)
  log_z = torch.log(torch.sum(torch.exp(shifted), dim=1, keepdim=True))
  loss = -target * (shifted - log_z)
  if rm is not None:
    loss = loss * rm[:, None]
  if cm is not None:
    loss = loss * cm[None, :]
  return torch.sum(loss)


@pytest.mark.parametrize('segments,threads', [(1, 1), (1, 3), (2, 2), (5, 1),
                                               (37, 1)])
@pytest.mark.parametrize('masks', ['none', 'both', 'weighted'])
def test_two_pass_formulas_are_the_chains(masks, segments, threads):
  """At W = 37 (not a multiple of 8) over rows of stride 48: the model's
  loss and gradient equal the chain's steps in float64 to 1e-12; the row mask
  has zero rows, the column mask zero columns (and, 'weighted', weights
  other than 1)."""
  B, W = 6, 37
  gen = torch.Generator().manual_seed(segments * 10 + threads)
  buf = (4 * torch.randn(B, 48, generator=gen, dtype=torch.float64)
         ).requires_grad_()
  scores = buf[:, :W]
  assert scores.stride(0) == 48
  target = (torch.rand(B, W, generator=gen) < 0.3).double()
  target[0] *= 3.0
  target[2] = 0.0
  rm, cm = _masks('none' if masks == 'none' else 'both', B, W)
  rm = None if rm is None else rm.double()
  cm = None if cm is None else cm.double()
  if masks == 'weighted':
    cm[::4] *= 0.5
  go = 0.37
  loss = _chain64(scores, target, rm, cm)
  (loss * go).backward()
  got, grad = _two_pass(scores.detach().numpy(), target.numpy(),
                        None if rm is None else rm.numpy(),
                        None if cm is None else cm.numpy(), go, segments,
                        threads)
  assert loss.dtype == torch.float64
  np.testing.assert_allclose(got, loss.item(), rtol=1e-12, atol=0)
  np.testing.assert_allclose(grad, buf.grad[:, :W].numpy(), rtol=1e-12, atol=1e-12)
  if cm is not None:
    assert np.all(grad[:, cm.numpy() == 0.0] == 0.0)  # masked: exactly 0
  if rm is not None:
    assert np.all(grad[rm.numpy() == 0.0] == 0.0)


# -- Mult-VAE's trainer ----------------------------------------------------

def test_multvae_trainer_reaches_the_routed_loss(monkeypatch):
  """A Mult-VAE step's loss is ``MultinomialNLLLoss.__call__`` at 'sum',
  which asks ``takes`` of the scores and target (here the CPU's: no)."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MultVAE
  asked, takes = [], mnl.takes

  def spy(scores, target, group=None):
    asked.append((tuple(scores.shape), tuple(target.shape),
                  scores.requires_grad, group))
    return takes(scores, target, group)

  monkeypatch.setattr(losses.multinomial_loss, 'takes', spy)
  rng = np.random.default_rng(0)
  matrix = sp.csr_matrix((rng.random((30, 50)) < 0.2).astype(np.float32))
  trainer = Recoder(MultVAE(16, 8, dropout_prob=0.5), optimizer_type='adam',
                    loss='logloss', device='cpu')
  trainer.train(RecommendationDataset(matrix), batch_size=10, num_epochs=1,
                negative_sampling=False)
  assert isinstance(trainer.loss_module, losses.MultinomialNLLLoss)
  assert trainer.loss_module.reduction == 'sum'
  W = trainer.model.num_items_padded
  assert len(asked) == 3 and len(trainer.last_epoch_losses) == 3
  assert all(a == ((10, W), (10, W), True, None) for a in asked)
