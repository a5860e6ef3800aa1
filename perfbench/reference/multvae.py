"""Plain PyTorch reference of Mult-VAE's training steps.

It follows what a ``MultVAE(hidden_dim, latent_dim)`` trained by
``Recoder.train(loss='logloss')`` without negative sampling computes --
from the seed, the matrix and the configuration alone, importing nothing
of the program -- which is the model of Liang, Krishnan, Hoffman and
Jebara, "Variational Autoencoders for Collaborative Filtering" (WWW'18,
arXiv:1802.05814), as their ``VAE_ML20M`` notebook trains it:

* the init: xavier-uniform weights drawn in float32 from a CPU
  ``torch.Generator`` seeded with the trainer's seed, in the order
  ``en_embedding [padded catalog, h]`` (fans h and the logical catalog),
  ``w_mu [h, d]``, ``w_logvar [h, d]``, ``w_dec [d, h]``,
  ``de_embedding [padded catalog, h]`` (fans h and the logical catalog);
  zero biases;
* the batch order of an epoch (:func:`perfbench.reference.autoencoder.
  epoch_order`): 'users' -- numpy ``default_rng([seed + 1, epoch])``'s
  permutation of the users, then the pad ids; 'blocks' likewise;
* the draws of global step ``t``: a keep mask drawn by ``bernoulli_(1 -
  dropout)`` on a tensor of the input's shape (the batch over the padded
  catalog) and dtype, then ``eps``, a float32 ``randn`` of ``[batch,
  d]``, both from a generator seeded with ``seed << 32`` and placed at
  Philox offset ``t x`` the offset one step's two draws take (on the
  card), or seeded with ``(seed << 32) + t`` (on the CPU);
* the step: rows L2-normalized, the input dropout (kept entries scaled by
  ``1 / (1 - dropout)``), ``tanh`` of the encode, the ``mu`` and
  ``logvar`` heads, ``z = mu + exp(logvar / 2) eps``, ``tanh`` of the
  decode's hidden layer, the output layer over the padded catalog; the
  loss ``-sum t log_softmax(s)`` over the logical catalog (the pad
  columns left out of the softmax) plus ``beta(t) KL(q(z|x) || N(0,
  I))``, ``beta(t) = min(anneal_cap, t / total_anneal_steps)``, summed
  over the batch's valid users and divided by their number;
* the update: Adam over all ten leaves (L2 weight decay on the weights,
  none on the biases), the bias corrections on the global step.

Departures from the paper and its notebook, each the program's and none
of them a change of the mathematics but the first:

* the notebook's ``[600, 400]`` encoder output split in halves is two
  ``[600, 200]`` heads here (``w_mu``, ``w_logvar``) with their own
  biases: the same function, another parameter layout, and the xavier
  fans of a ``[600, 200]`` matrix instead of a ``[600, 400]`` one;
* the item tables are stored ``[padded catalog, 600]`` (the encoder's
  transposed against the notebook's ``[20108, 600]``), with 116 pad rows
  that no loss term reaches;
* the KL weight anneals on the global step (``total_anneal_steps``), as
  the notebook's ``update_count`` does, and the notebook's
  ``lam = 0`` regularizer is the Adam weight decay 0;
* the data term sums the batch's users and divides by their number, as
  the notebook's mean over the batch does.

Everything runs in float32 with TF32 off. ``precision`` computes the
products in a lower precision instead (the correctness control), as the
autoencoder's reference does: 'tf32' rounds their operands to TF32;
'fp8' rounds their operands and the scores to e4m3 with one scale a
tensor, and stores Adam's first moment in e4m3 and the second in bf16.
``fault``: 'half' (half the batch left out of the loss) or 'no_kl' (the
KL term left out). ``start`` is a state at the first step of a later
epoch, as :class:`perfbench.reference.autoencoder.Reference` takes it.

Besides the reference, the module holds what the benchmark counts of
this model: :func:`param_count`, :func:`decode_width`,
:func:`step_flops` and :func:`signature`.
"""

import math

import numpy as np
import torch

from perfbench.reference import autoencoder
from perfbench.reference.autoencoder import _operand, epoch_order
from perfbench.roofline import group_stats, pad_dim

#: the leaves in the order the init draws them (the biases are zeros)
WEIGHTS = ('en_embedding', 'w_mu', 'w_logvar', 'w_dec', 'de_embedding')


def _widths(config):
  model = config['model']
  return int(model['hidden_dim']), int(model['latent_dim'])


def init_params(num_items, config, seed):
  """The init of ``MultVAE`` (float32, on the CPU)."""
  h, d = _widths(config)
  rows = pad_dim(num_items)
  gen = torch.Generator().manual_seed(int(seed))
  shapes = {'en_embedding': ((rows, h), h, num_items),
            'w_mu': ((h, d), h, d), 'w_logvar': ((h, d), h, d),
            'w_dec': ((d, h), d, h),
            'de_embedding': ((rows, h), h, num_items)}
  weights = {}
  for name in WEIGHTS:
    shape, fan_in, fan_out = shapes[name]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    weights[name] = torch.empty(shape).uniform_(-limit, limit, generator=gen)
  return {'en_embedding': weights['en_embedding'],
          'en_bias': torch.zeros(h),
          'w_mu': weights['w_mu'], 'mu_bias': torch.zeros(d),
          'w_logvar': weights['w_logvar'], 'logvar_bias': torch.zeros(d),
          'w_dec': weights['w_dec'], 'dec_bias': torch.zeros(h),
          'de_embedding': weights['de_embedding'],
          'de_bias': torch.zeros(rows)}


def decode_width(config):
  """The width the output layer's product contracts over (the hidden
  layer's)."""
  return _widths(config)[0]


def param_count(config, num_items):
  """The model's parameters: two ``[padded catalog, h]`` tables, the
  three ``[h, d]`` / ``[d, h]`` MLP weights and every bias."""
  h, d = _widths(config)
  rows = pad_dim(num_items)
  return 2 * rows * h + h + 3 * h * d + 2 * d + h + rows


def step_flops(matrix, order, batch_size, config, device):
  """Model FLOPs of each step of ``order`` (a 1-D tensor): the encoder
  over the batch's interactions (2 nnz h forward, 2 nnz h for its weight
  gradient), the output layer over the catalog the loss covers (2 B N h
  forward, 4 B N h backward, N the logical catalog), and the three MLP
  products (``w_mu``, ``w_logvar``, ``w_dec``) whole, forward and
  backward (6 B h d each), B the batch's valid users."""
  users, nnz, _ = group_stats(matrix, order, batch_size, device)
  h, d = _widths(config)
  users = users.double()
  return (4.0 * nnz.double() * h + 6.0 * users * matrix.shape[1] * h
          + 18.0 * users * h * d)


def signature(matrix, traffic, seed, epoch, device):
  """None: every epoch's full-decode steps share one shape."""
  return None


class Reference(autoencoder.Reference):
  """Training steps in float32 (or ``precision``): the autoencoder
  reference's Adam and ``run``, Mult-VAE's batch, draws and loss.

  ``matrix``: the scipy CSR both sides train on; ``config``: the
  configuration's ``model`` and ``trainer`` blocks; ``traffic``: the
  cell's ``train`` and ``model`` blocks; ``seed``: the trainer's seed.
  ``start``: None (the init, epoch 1, global step 0) or ``{'epoch',
  'global_step', 'params', 'moments'}`` -- a state at the first step of
  ``epoch``, after ``global_step`` steps: each leaf's parameters and its
  Adam moments ``(m, v)``."""

  def __init__(self, matrix, config, traffic, seed, device,
               precision='float32', fault=None, start=None):
    self.matrix = matrix
    self.device = torch.device(device)
    model, train = config['model'], traffic['train']
    if model['activation_type'] != 'tanh' or config['trainer']['loss'] != (
        'logloss'):
      raise ValueError('the reference covers MultVAE, tanh, logloss')
    if traffic['model'].get('sparse') or train['negative_sampling']:
      raise ValueError('the reference covers the full-catalog step: dense '
                       'tables, no negative sampling')
    if fault not in (None, 'half', 'no_kl'):
      raise ValueError(f'the reference has no fault {fault!r}')
    self.h, self.d = _widths(config)
    self.noise = float(model['dropout_prob'])
    self.anneal_cap = float(model['anneal_cap'])
    self.anneal_steps = int(model['total_anneal_steps'])
    self.batch = train['batch_size']
    self.lr, self.wd = train['lr'], train['weight_decay']
    self.dtype = (torch.bfloat16 if traffic['model'].get('compute_dtype')
                  == 'bfloat16' else torch.float32)
    self.seed = int(seed)
    self.precision = precision
    self.fault = fault
    n, m = matrix.shape
    self.num_users, self.num_items = n, m
    epoch = start['epoch'] if start else 1
    self.global_step = start['global_step'] if start else 0
    self.order = epoch_order(train['shuffle'], self.seed, epoch, n,
                             self.batch)
    self.indptr = torch.as_tensor(matrix.indptr, dtype=torch.int64)
    self.indices = torch.as_tensor(matrix.indices, dtype=torch.int64)
    self.values = torch.as_tensor(matrix.data, dtype=torch.float32)
    if start:
      self.params = {k: v.to(self.device, torch.float32, copy=True)
                     for k, v in start['params'].items()}
      self.state = {k: {'m': m_.to(self.device, torch.float32, copy=True),
                        'v': v_.to(self.device, torch.float32, copy=True)}
                    for k, (m_, v_) in start['moments'].items()}
    else:
      self.params = {k: v.to(self.device)
                     for k, v in init_params(m, config, self.seed).items()}
      self.state = {k: {'m': torch.zeros_like(v), 'v': torch.zeros_like(v)}
                    for k, v in self.params.items()}
    self.rows = self.params['en_embedding'].shape[0]
    self.increment = self._increment() if self.device.type == 'cuda' else 0

  def beta(self, step):
    """The KL weight at global step ``step`` (0-based)."""
    if self.anneal_steps <= 0:
      return self.anneal_cap
    return min(self.anneal_cap, step / self.anneal_steps)

  def _draw(self, gen):
    keep = torch.empty((self.batch, self.rows), dtype=self.dtype,
                       device=self.device).bernoulli_(1 - self.noise,
                                                      generator=gen)
    eps = torch.randn((self.batch, self.d), generator=gen,
                      device=self.device)
    return keep.bool(), eps

  def _increment(self):
    """The Philox offset one step's two draws take (on the card)."""
    gen = torch.Generator(device=self.device)
    gen.manual_seed(self.seed << 32)
    self._draw(gen)
    return gen.get_offset()

  def draws(self, step):
    """Global step ``step``'s keep mask ``[batch, padded catalog]`` and
    ``eps`` ``[batch, d]``."""
    gen = torch.Generator(device=self.device)
    if self.device.type == 'cuda':
      gen.manual_seed(self.seed << 32)
      gen.set_offset(step * self.increment)
    else:
      gen.manual_seed((self.seed << 32) + step)
    return self._draw(gen)

  def _batch(self, step):
    """The step's users' rows over the padded catalog: ``(dense [B,
    padded catalog] float32, valid users)``."""
    users = self.order[step * self.batch:(step + 1) * self.batch]
    real = users < self.num_users
    ids = torch.as_tensor(users[real])
    starts, ends = self.indptr[ids], self.indptr[ids + 1]
    counts = ends - starts
    slot = torch.repeat_interleave(torch.as_tensor(np.nonzero(real)[0]),
                                   counts)
    pos = torch.arange(int(counts.sum())) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    at = torch.repeat_interleave(starts, counts) + pos
    dense = torch.zeros((len(users), self.rows))
    dense[slot, self.indices[at]] = self.values[at]
    return dense.to(self.device), max(len(ids), 1)

  def _loss(self, leaves, dense, keep, eps, valid, beta):
    p = self.precision
    norm = torch.sqrt(torch.sum(dense * dense, 1, keepdim=True))
    x = dense / torch.clamp(norm, min=1e-12)
    x = torch.where(keep, x / (1 - self.noise), torch.zeros_like(x))
    h1 = torch.tanh(_operand(x, p) @ _operand(leaves['en_embedding'], p)
                    + leaves['en_bias'])
    mu = _operand(h1, p) @ _operand(leaves['w_mu'], p) + leaves['mu_bias']
    logvar = (_operand(h1, p) @ _operand(leaves['w_logvar'], p)
              + leaves['logvar_bias'])
    z = mu + torch.exp(0.5 * logvar) * eps
    h = torch.tanh(_operand(z, p) @ _operand(leaves['w_dec'], p)
                   + leaves['dec_bias'])
    scores = (_operand(h, p) @ _operand(leaves['de_embedding'], p).t()
              + leaves['de_bias'])
    if p == 'fp8':  # (as the program's bf16 scores; TF32 writes float32)
      scores = _operand(scores, p)
    n = self.num_items  # (the pad columns: out of the softmax)
    per = -torch.sum(dense[:, :n] * torch.log_softmax(scores[:, :n], dim=1),
                     dim=1)
    if self.fault != 'no_kl':
      kl = -0.5 * torch.sum(1.0 + logvar - mu * mu - torch.exp(logvar), 1)
      per = per + beta * kl
    rows = torch.zeros(dense.shape[0], device=self.device)
    rows[:valid] = 1.0
    if self.fault == 'half':  # the correctness fault: half the batch
      rows[valid // 2:] = 0.0
      valid = max(valid // 2, 1)
    return torch.sum(per * rows) / valid

  def step(self, step):
    """Step ``step`` (0-based) of the epoch; returns ``(loss, {leaf: the
    gradient as the optimizer gets it})``."""
    t = self.global_step + step
    dense, valid = self._batch(step)
    keep, eps = self.draws(t)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in self.params.items()}
    loss = self._loss(leaves, dense, keep, eps, valid, self.beta(t))
    loss.backward()
    got = {}
    with torch.no_grad():
      for name, leaf in leaves.items():
        grad = leaf.grad
        if 'bias' not in name:
          grad = grad + self.wd * self.params[name]
        got[name] = grad
        self._adam(name, grad, t + 1)
    return float(loss.detach()), got
