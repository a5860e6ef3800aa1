"""Plain PyTorch reference of the autoencoder's training steps.

It follows what a ``DynamicAutoencoder([d])`` trained by
``Recoder.train`` computes -- from the seed, the matrix and the
configuration alone, importing nothing of the program:

* the init: xavier-uniform tables of the padded catalog's rows (the
  logical fans), drawn in float32 from a CPU ``torch.Generator`` seeded
  with the trainer's seed, the encoder's table first; zero biases;
* the batch order of an epoch: 'blocks' -- the megas of ``batch_size``
  contiguous users in the order ``torch.randperm`` draws from the seed
  ``((seed + 1) << 32) + epoch`` (the partly filled last mega pinned
  last); 'users' -- numpy ``default_rng([seed + 1, epoch])``'s
  permutation of the users, then the pad ids;
* the noise: a keep mask drawn by ``bernoulli_(1 - noise)`` on a tensor
  of the step's input shape and dtype, from a generator seeded with
  ``seed << 32`` and placed at Philox offset ``global step x`` the offset
  one draw takes (on the card), or seeded with ``(seed << 32) + global
  step`` (on the CPU);
* the step: rows L2-normalized, the noise applied (kept entries scaled
  by ``1 / (1 - noise)``), ``tanh`` of the encode, the decode over the
  columns the loss covers -- the batch's item union --, the loss
  ('logistic': BCE with logits, torch's; 'mse' with confidence ``c``: ``sum (1 +
  c t) (s - t)^2``; 'logloss': ``-sum t log_softmax(s)`` over the union)
  summed over the batch's valid users and divided by their number;
* the update: Adam (L2 weight decay on the tables, none on biases) over
  every parameter, or, for sparse tables, torch ``SparseAdam``'s rule on
  the union's rows of each table (no decay) and Adam on the biases; the
  bias corrections count the global steps.

A static union's width (the noise mask's columns on the 'users' union
path) is the epoch's widest mega union put on the ladder of widths:
aligned up to 128, then the next rung of 128 and ``align128(rung x 26 /
25)``.

:class:`Reference` starts from the init at the first step of the first
epoch, or from a given state (parameters and Adam moments) at the first
step of a later epoch: the program's own state there, which the
reference cannot work out without following every step before it.

Everything runs in float32 with TF32 off. ``precision`` computes the
products in a lower precision instead (the correctness control): 'tf32'
rounds their operands to TF32's 10-bit mantissa; 'fp8' rounds their
operands and the decode's scores (which the program's bf16 compute
rounds to bf16) to e4m3 with one scale a tensor, and stores the dense
Adam first moment (bf16 in the program) in e4m3 likewise, the second in
bf16. The gradient passes through the rounding.

Besides the reference, the module holds what the benchmark counts of
this model: :func:`param_count`, :func:`decode_width`,
:func:`step_flops` and :func:`signature`.
"""

import math

import numpy as np
import torch

from perfbench.roofline import group_stats, pad_dim

BETAS = (0.9, 0.999)
EPS = 1e-8


def _align128(width):
  return (max(int(width), 1) + 127) // 128 * 128


def ladder(width):
  """``width`` on the ladder of static union widths."""
  width, rung = _align128(width), 128
  while rung < width:
    rung = _align128(rung * 26 // 25)
  return rung


def epoch_order(shuffle, seed, epoch, num_users, batch_size):
  """The epoch's user order: ``[steps x batch_size]`` user ids (ids at or
  past ``num_users`` are pad slots)."""
  n_pad = math.ceil(num_users / batch_size) * batch_size
  if shuffle == 'blocks':
    n_blocks = n_pad // batch_size
    gen = torch.Generator().manual_seed(((seed + 1) << 32) + int(epoch))
    if n_pad > num_users and n_blocks > 1:
      blocks = torch.cat([torch.randperm(n_blocks - 1, generator=gen),
                          torch.tensor([n_blocks - 1])])
    else:
      blocks = torch.randperm(n_blocks, generator=gen)
    return (blocks[:, None] * batch_size
            + torch.arange(batch_size)[None, :]).reshape(-1).numpy()
  rng = np.random.default_rng([seed + 1, int(epoch)])
  return np.concatenate([rng.permutation(num_users),
                         np.arange(num_users, n_pad)]).astype(np.int64)


def init_params(num_items, d, seed):
  """The init of ``DynamicAutoencoder([d])`` (float32, on the CPU)."""
  rows = pad_dim(num_items)
  gen = torch.Generator().manual_seed(int(seed))
  limit = math.sqrt(6.0 / (d + num_items))
  en = torch.empty((rows, d)).uniform_(-limit, limit, generator=gen)
  de = torch.empty((rows, d)).uniform_(-limit, limit, generator=gen)
  return {'en_embedding': en, 'en_bias': torch.zeros(d),
          'de_embedding': de, 'de_bias': torch.zeros(rows)}


def _round_tf32(x):
  bits = x.contiguous().view(torch.int32)
  bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
  return bits.view(torch.float32)


def _round_fp8(x):
  scale = x.abs().amax().clamp(min=1e-30) / 448.0
  return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDING = {'float32': None, 'tf32': _round_tf32, 'fp8': _round_fp8}


def _operand(x, precision):
  rnd = ROUNDING[precision]
  if rnd is None:
    return x
  return x + (rnd(x.detach()) - x).detach()


def decode_width(config):
  """The width the decoder's product contracts over (the last hidden
  layer's)."""
  return int(config['model']['hidden_layers'][-1])


def param_count(config, num_items):
  """The model's parameters: two ``[padded catalog, d]`` tables and
  their biases."""
  d, rows = decode_width(config), pad_dim(num_items)
  return 2 * rows * d + d + rows


def step_flops(matrix, order, batch_size, config, device):
  """Model FLOPs of each step of ``order`` (a 1-D tensor): the encoder
  over the batch's interactions (2 nnz d forward, 2 nnz d for its weight
  gradient) and the decoder over the columns the loss covers, the
  batch's item union (2 B W d forward, 4 B W d backward)."""
  users, nnz, union = group_stats(matrix, order, batch_size, device)
  d = decode_width(config)
  return 4.0 * nnz.double() * d + 6.0 * users.double() * union.double() * d


def signature(matrix, traffic, seed, epoch, device):
  """What a captured step of ``epoch`` bakes in of its batches: the
  static union width on the 'users' union path (the sparse tables),
  None where every epoch's steps share one shape."""
  if not traffic['model'].get('sparse', False):
    return None
  batch = traffic['train']['batch_size']
  order = epoch_order(traffic['train']['shuffle'], seed, epoch,
                      matrix.shape[0], batch)
  return ladder(int(group_stats(matrix, order, batch, device)[2].max()))


class Reference:
  """Training steps in float32 (or ``precision``).

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
    model, trainer = config['model'], config['trainer']
    if len(model['hidden_layers']) != 1 or model['activation_type'] != 'tanh':
      raise ValueError('the reference covers DynamicAutoencoder([d]), tanh')
    if model.get('dropout_prob', 0.0):
      raise ValueError('the reference draws no bottleneck dropout')
    self.d = model['hidden_layers'][0]
    self.noise = model['noise_prob']
    self.loss = trainer['loss']
    self.confidence = trainer.get('loss_params', {}).get('confidence', 0.0)
    train = traffic['train']
    self.batch = train['batch_size']
    self.lr, self.wd = train['lr'], train['weight_decay']
    self.shuffle = train['shuffle']
    self.sparse = traffic['model'].get('sparse', False)
    self.union_input = self.sparse  # full decode where the tables are dense
    self.dtype = (torch.bfloat16 if traffic['model'].get('compute_dtype')
                  == 'bfloat16' else torch.float32)
    self.seed = int(seed)
    self.precision = precision
    self.fault = fault
    n, m = matrix.shape
    self.num_users, self.num_items = n, m
    epoch = start['epoch'] if start else 1
    self.global_step = start['global_step'] if start else 0
    self.order = epoch_order(self.shuffle, self.seed, epoch, n, self.batch)
    self.indptr = torch.as_tensor(matrix.indptr, dtype=torch.int64)
    self.indices = torch.as_tensor(matrix.indices, dtype=torch.int64)
    if start:
      self.params = {k: v.to(self.device, torch.float32, copy=True)
                     for k, v in start['params'].items()}
      self.state = {k: {'m': m_.to(self.device, torch.float32, copy=True),
                        'v': v_.to(self.device, torch.float32, copy=True)}
                    for k, (m_, v_) in start['moments'].items()}
    else:
      self.params = {k: v.to(self.device)
                     for k, v in init_params(m, self.d, self.seed).items()}
      self.state = {k: {'m': torch.zeros_like(v), 'v': torch.zeros_like(v)}
                    for k, v in self.params.items()}
    self.rows = self.params['en_embedding'].shape[0]
    self.mask_width = (self._static_width() if self.union_input
                       else self.rows)

  def _static_width(self):
    """The epoch's static union width (the 'users' union path)."""
    _, _, union = group_stats(self.matrix, self.order, self.batch,
                              self.device)
    return ladder(int(union.max()))

  def _users(self, step):
    return self.order[step * self.batch:(step + 1) * self.batch]

  def _batch(self, step):
    """The step's valid users' rows over the batch's item union:
    ``(dense [B, U] float32, union item ids [U], valid users)``."""
    users = self._users(step)
    B = len(users)
    real = torch.as_tensor(users[users < self.num_users])
    starts, ends = self.indptr[real], self.indptr[real + 1]
    counts = ends - starts
    slot = torch.repeat_interleave(
        torch.as_tensor(np.nonzero(users < self.num_users)[0]), counts)
    pos = torch.arange(int(counts.sum())) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    items = self.indices[torch.repeat_interleave(starts, counts) + pos]
    union, col = torch.unique(items, return_inverse=True)
    dense = torch.zeros((B, union.numel()))
    dense[slot, col] = 1.0
    return dense.to(self.device), union.to(self.device), max(len(real), 1)

  def _keep(self, step, union):
    """Global step ``step``'s keep mask over the union's columns."""
    shape = (self.batch, self.mask_width)
    gen = torch.Generator(device=self.device)
    if self.device.type == 'cuda':
      gen.manual_seed(self.seed << 32)
      torch.empty(shape, dtype=self.dtype,
                  device=self.device).bernoulli_(1 - self.noise,
                                                 generator=gen)
      increment = gen.get_offset()  # (what one draw takes)
      gen.manual_seed(self.seed << 32)
      gen.set_offset(step * increment)
    else:
      gen.manual_seed((self.seed << 32) + step)
    keep = torch.empty(shape, dtype=self.dtype,
                       device=self.device).bernoulli_(1 - self.noise,
                                                      generator=gen)
    cols = (torch.arange(union.numel(), device=self.device)
            if self.union_input else union)
    return keep[:, cols].bool()

  def _loss(self, leaves, dense, union, keep, valid):
    p = self.precision
    norm = torch.sqrt(torch.sum(dense * dense, 1, keepdim=True))
    z = dense / torch.clamp(norm, min=1e-12)
    z = torch.where(keep, z / (1 - self.noise), torch.zeros_like(z))
    en_rows = leaves['en_embedding'].index_select(0, union)
    h = torch.tanh(_operand(z, p) @ _operand(en_rows, p)
                   + leaves['en_bias'])
    de_rows = leaves['de_embedding'].index_select(0, union)
    scores = (_operand(h, p) @ _operand(de_rows, p).t()
              + leaves['de_bias'].index_select(0, union))
    if p == 'fp8':  # (as the program's bf16 scores; TF32 writes float32)
      scores = _operand(scores, p)
    rows = torch.zeros(dense.shape[0], device=self.device)
    rows[:valid] = 1.0
    if self.fault == 'half':  # the correctness fault: half the batch
      rows[valid // 2:] = 0.0
      valid = max(valid // 2, 1)
    if self.loss == 'logistic':
      # (a score of exactly 0 -- a row whose input the noise dropped
      # whole, at the init -- must take the gradient sigmoid(0) - t)
      per = torch.nn.functional.binary_cross_entropy_with_logits(
          scores, dense, reduction='none')
    elif self.loss == 'mse':
      per = (1 + self.confidence * dense) * (scores - dense) ** 2
    elif self.loss == 'logloss':
      per = -dense * torch.log_softmax(scores, dim=1)
    else:
      raise ValueError(f'the reference has no loss {self.loss!r}')
    return torch.sum(per * rows[:, None]) / valid

  def _adam(self, name, grad, t):
    p, st = self.params[name], self.state[name]
    b1, b2 = BETAS
    st['m'].mul_(b1).add_(grad, alpha=1 - b1)
    st['v'].mul_(b2).addcmul_(grad, grad, value=1 - b2)
    if self.precision == 'fp8':
      # (the program's bf16 moments one step down; the second moment
      # stays bf16, whose range its squares need)
      st['m'] = _round_fp8(st['m'])
      st['v'] = st['v'].to(torch.bfloat16).float()
    denom = st['v'].sqrt() / math.sqrt(1 - b2 ** t) + EPS
    p.addcdiv_(st['m'], denom, value=-self.lr / (1 - b1 ** t))

  def _sparse_adam(self, name, grad, rows, t):
    p, st = self.params[name], self.state[name]
    b1, b2 = BETAS
    g = grad.index_select(0, rows)
    m = st['m'].index_select(0, rows) * b1 + (1 - b1) * g
    v = st['v'].index_select(0, rows) * b2 + (1 - b2) * g * g
    size = self.lr * math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
    p.index_copy_(0, rows, p.index_select(0, rows)
                  - size * m / (v.sqrt() + EPS))
    st['m'].index_copy_(0, rows, m)
    st['v'].index_copy_(0, rows, v)

  def step(self, step):
    """Step ``step`` (0-based) of the epoch; returns ``(loss, {leaf: the
    gradient as the optimizer gets it})``."""
    t = self.global_step + step
    dense, union, valid = self._batch(step)
    keep = self._keep(t, union)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in self.params.items()}
    loss = self._loss(leaves, dense, union, keep, valid)
    loss.backward()
    got = {}
    with torch.no_grad():
      for name, leaf in leaves.items():
        grad = leaf.grad
        if self.sparse and name.endswith('embedding'):
          got[name] = grad
          self._sparse_adam(name, grad, union, t + 1)
        else:
          if not name.endswith('bias'):
            grad = grad + self.wd * self.params[name]
          got[name] = grad
          self._adam(name, grad, t + 1)
    return float(loss.detach()), got

  def run(self, steps):
    """``steps`` steps from the start: ``{'losses', 'grads'}`` (the first
    step's gradient of each leaf), ``'m1'`` (each leaf's first moment as
    stored after the first step) and ``'change'``, each leaf's change over
    the steps, all on the device."""
    start = {k: v.clone() for k, v in self.params.items()}
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
      losses, grads = [], None
      for t in range(steps):
        loss, got = self.step(t)
        losses.append(loss)
        if grads is None:
          grads = got
          m1 = {k: v['m'].clone() for k, v in self.state.items()}
    finally:
      torch.backends.cuda.matmul.allow_tf32 = matmul
      torch.backends.cudnn.allow_tf32 = cudnn
    change = {k: self.params[k] - start[k] for k in start}
    return {'losses': losses, 'grads': grads, 'm1': m1, 'change': change}
