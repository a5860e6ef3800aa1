"""Optimizers with the JAX package's (torch's) update rules.

Port of ``recoder_tpu/optim.py``'s dense ``Optimizer`` and
``make_weight_decay_tree``. The JAX package re-implemented torch's
update rules and pins them against ``torch.optim`` in
``tests/test_optim.py``, so the port uses ``torch.optim`` itself, with
the same hyper-parameters: SGD(momentum=0.9), Adam(betas=(0.9, 0.999),
eps=1e-8), Adagrad(eps=1e-10), RMSprop(alpha=0.99, eps=1e-8,
momentum=0.9). Weight decay is L2 added to the gradient (torch's
``weight_decay``), and bias parameters are exempt: two parameter
groups, decayed and not.

:class:`SparseRowAdam` is the row-sparse Adam of the sparse embedding
tables (the JAX ``SparseRowAdam``, torch ``SparseAdam``'s rule): it
gathers the touched rows of the table and both moments, updates them in
float32 and writes the three back in place with one launch of the
row-scatter kernel (``ops/row_scatter.py``); with ``ids=None`` (the
full-catalog sparse step) it updates every row in place, without a
scatter.

``state_dtype='bfloat16'`` (the JAX ``Optimizer(state_dtype=...)``,
bench.py's ML-20M default) stores Adam's moments in bf16 and keeps the
update math in float32: :class:`Bf16Adam`, one launch of the fused
kernel ``kernels/adam.cu`` a step on the card (``ops/adam.py``). Only
'adam' takes it; the other kinds refuse it as the JAX package does. The
float32 state stays ``torch.optim``.

bf16 parameters (the models' ``params_dtype='bfloat16'``) follow the JAX
``Optimizer.update``: every buffer is upcast, the math runs in float32
(the weight decay added to the upcast gradient from the upcast
parameter), and each stored buffer is rounded once to nearest even; the
moments stay float32 unless ``state_dtype`` says bf16. Adam over bf16
parameters is :class:`Bf16Adam` for either moment dtype (never
``torch.optim.Adam``, which would keep bf16 state and do bf16 math);
'sgd', 'adagrad' and 'rmsprop' are :class:`Float32AnchoredOptimizer`,
a plain eager update. :class:`SparseRowAdam` takes bf16 tables and bf16
moments the same way.

A float32 parameter that a training step's bf16 product reads whole has
a bf16 working copy under :class:`Bf16Adam` (float32 parameters, bf16
moments): the product reads the copy (``ops/gather_matmul.
working_copies``), its backward leaves the parameter's gradient on it
in bf16, and the kernel reads that gradient and writes the copy from
the parameter it stores. The step is the same arithmetic; the product's
cast of the parameter and the gradient's upcast are gone.

On the card (``capturable=True``) every Adam step is one that a CUDA
graph can record: the float32 state is ``torch.optim.Adam(fused=True,
capturable=True)`` with its learning rate a device scalar
(:func:`set_lr` writes it between epochs) and its step counts on the
device; :class:`Bf16Adam` keeps its step count and its per-step scalars
on the device too. Eager and captured steps run the same optimizer, so
their trajectories are bitwise equal. On the CPU the float32 state is
the plain ``torch.optim.Adam``.

:func:`fold_dual_union` merges the two row sets of a table that one
step uses twice (a tied decoder over a target union that differs from
the input union) into one id set, so that the table takes one
:class:`SparseRowAdam` step, as torch's coalesced sparse gradient does.
"""

import numpy as np
import torch

from recoder_tpu_torch.kernels import capturing
from recoder_tpu_torch.ops import adam as adam_ops
from recoder_tpu_torch.ops.gather_matmul import BF16
from recoder_tpu_torch.ops.row_scatter import row_scatter_

KINDS = ('sgd', 'adam', 'adagrad', 'rmsprop')
#: kinds whose bf16 state passed the JAX package's 30-epoch quality gate
STATE_DTYPE_GATED_KINDS = frozenset({'adam'})


def resolve_state_dtype(kind, dtype):
  """The moments' storage dtype (torch.float32 or torch.bfloat16) for
  ``dtype`` (None, a name or a torch dtype); ``ValueError`` for a
  reduced-precision state of a kind other than 'adam'."""
  if dtype is None or dtype in ('float32', torch.float32):
    return torch.float32
  if dtype not in ('bfloat16', torch.bfloat16):
    raise ValueError(f'state_dtype={dtype!r}: float32 or bfloat16')
  if kind not in STATE_DTYPE_GATED_KINDS:
    raise ValueError(
        f"state_dtype='bfloat16' is only quality-gated for "
        f"{sorted(STATE_DTYPE_GATED_KINDS)} (30-epoch tests/test_model.py "
        f"rows); '{kind}' refuses reduced-precision state rather than run "
        "an ungated numerics mode"
        + (" (adagrad's monotone 'sum' accumulator freezes the effective "
           "LR once increments fall below the bf16 quantum)"
           if kind == 'adagrad' else '') + '.')
  return torch.bfloat16


def make_param_groups(named_params, weight_decay):
  """Two parameter groups: ``weight_decay`` for every parameter except
  biases (any name containing 'bias', the reference's rule), which get
  0."""
  decay, no_decay = [], []
  for name, p in named_params.items():
    (no_decay if 'bias' in name else decay).append(p)
  groups = []
  if decay:
    groups.append({'params': decay, 'weight_decay': float(weight_decay)})
  if no_decay:
    groups.append({'params': no_decay, 'weight_decay': 0.0})
  return groups


def params_storage(named_params):
  """The parameters' storage dtype (float32 or bf16), one for the set."""
  dtypes = {p.dtype for p in named_params.values()}
  if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
    raise ValueError(f'the optimizer steps float32 or bfloat16 parameters '
                     f'of one dtype, got {sorted(map(str, dtypes))}')
  return dtypes.pop()


def make_optimizer(kind, named_params, lr, weight_decay=0.0,
                   state_dtype=None, capturable=False):
  """An optimizer over ``named_params`` ({name: param}) with the JAX
  package's hyper-parameters for ``kind``: ``torch.optim``'s, or
  :class:`Bf16Adam` for bf16 state or bf16 parameters, or
  :class:`Float32AnchoredOptimizer` for the other kinds over bf16
  parameters. ``capturable`` (CUDA parameters): float32 Adam as
  ``torch.optim.Adam(fused=True, capturable=True)`` with a device
  learning rate, so that a CUDA graph can record its step."""
  groups = make_param_groups(named_params, weight_decay)
  state = resolve_state_dtype(kind, state_dtype)
  bf16_params = params_storage(named_params) == torch.bfloat16
  if kind == 'adam' and (state == torch.bfloat16 or bf16_params):
    return Bf16Adam(groups, lr=lr, state_dtype=state)
  if bf16_params and kind in KINDS:
    return Float32AnchoredOptimizer(groups, kind, lr=lr)
  if kind == 'adam' and capturable:
    device = next(iter(named_params.values())).device
    lr_t = torch.tensor(float(lr), dtype=torch.float32, device=device)
    opt = torch.optim.Adam(groups, lr=lr_t, betas=(0.9, 0.999), eps=1e-8,
                           fused=True, capturable=True)
    for group in opt.param_groups:  # one device scalar for every group
      group['lr'] = lr_t
    return opt
  if kind == 'adam':
    return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
  if kind == 'sgd':
    return torch.optim.SGD(groups, lr=lr, momentum=0.9)
  if kind == 'adagrad':
    return torch.optim.Adagrad(groups, lr=lr, eps=1e-10)
  if kind == 'rmsprop':
    return torch.optim.RMSprop(groups, lr=lr, alpha=0.99, eps=1e-8,
                               momentum=0.9)
  raise ValueError(f'Unknown optimizer kind {kind}')


def set_lr(optimizer, lr):
  """Set every group's learning rate: written into the device scalar of
  a capturable optimizer (a graph reads it there), else the float."""
  for group in optimizer.param_groups:
    if torch.is_tensor(group['lr']):
      group['lr'].fill_(float(lr))
    else:
      group['lr'] = lr


def uses_device_steps(optimizer):
  """Whether ``optimizer`` keeps its step counts on the parameters'
  device (capturable or fused ``torch.optim``)."""
  return any(g.get('capturable') or g.get('fused')
             for g in optimizer.param_groups)


class Bf16Adam(torch.optim.Optimizer):
  """Adam over bf16 storage with float32 math (the JAX package's
  ``Optimizer('adam')`` with ``state_dtype='bfloat16'`` moments, bf16
  parameters, or both).

  Per step, for every parameter with a gradient: the weight decay is
  added to the upcast gradient from the upcast parameter (L2, torch
  style; biases sit in a group with 0), the new moments and the
  parameter step are computed in float32 -- the step from the unrounded
  new moments -- and each bf16 buffer is stored rounded to nearest even.
  The moments are ``state_dtype`` (bf16 by default; float32 for bf16
  parameters without a bf16 state). Every parameter steps together: one
  step count, one learning rate. On the card the whole set is one launch
  of the fused kernel (``ops/adam.py``).

  The step count lives on the parameters' device, in ``ctl = [steps
  taken, the step before the scalar table's first row]``; ``state[p]``
  holds ``exp_avg`` and ``exp_avg_sq`` and ``step``, a view of
  ``ctl[0]`` (the keys of ``torch.optim.Adam``, so ``convert.py`` and the
  checkpoints read it the same way; a ``step`` put there from outside,
  as a checkpoint load does, is taken over at the next eager step). Each
  step reads its scalars from a device table that :meth:`schedule`
  writes for the steps to come, so no step reads the host: a CUDA graph
  may record it. An eager step outside the scheduled rows (or after the
  learning rate changed) schedules one row itself, at the cost of one
  host read of the step count.

  Working copies (:meth:`working_copy`): a float32 parameter that a
  training step's bf16 product reads whole gets a bf16 copy at its first
  such read (outside a capture), which the product reads in place of
  ``p.to(bf16)``; the step takes the parameter's gradient from the copy
  (bf16, the product's) and writes the copy from the new parameter. A
  second read of the parameter in one step gets no copy: where a step
  finds a gradient on both the copy and the parameter (read in another
  way too, as a tied table), it adds the copy's into the parameter's, as
  autograd would have (one addition of two values: the same bits). A
  copy is derived state, in no ``state_dict``: :meth:`refresh_copies` writes
  it anew from its parameter, which may have changed outside
  :meth:`step` (a loaded state); :meth:`reset_state` calls it, and the
  trainer at every epoch's start.
  """

  def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=0.0, state_dtype=torch.bfloat16):
    super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                  weight_decay=weight_decay))
    self.state_dtype = state_dtype
    device = self.param_groups[0]['params'][0].device
    self._ctl = torch.zeros(2, dtype=torch.int64, device=device)
    self._step = self._ctl[0]  # the view every state['step'] holds
    self._table = None
    #: (first scheduled step, end, lr) of the table's rows, as the host
    #: wrote them, and the step count the host last knew
    self._span = None
    self._host_step = None
    self._capture = None  # the descriptors of a capture under way
    #: the params stepped here; {param: its bf16 working copy}; the
    #: params read so far in the step under way
    self._own = {p for g in self.param_groups for p in g['params']}
    self._copies = {}
    self._read = set()

  def _hyper(self):
    hyper = {(g['lr'], g['betas'], g['eps']) for g in self.param_groups}
    if len(hyper) != 1:
      raise ValueError('Bf16Adam steps every parameter with one learning '
                       f'rate, betas and eps; got {sorted(hyper)}')
    return hyper.pop()

  def _adopt_steps(self):
    """Point every ``state['step']`` at the device count, taking over a
    count put there from outside (a loaded checkpoint's)."""
    for state in self.state.values():
      step = state.get('step')
      if step is not None and step is not self._step:
        self._step.copy_(step)
        self._host_step = None
        state['step'] = self._step

  def schedule(self, n_steps, capacity=None):
    """Write the scalars of the next ``n_steps`` steps at the groups'
    learning rate (one host read of the step count). ``capacity`` keeps
    the table at least that many rows, so that a graph recorded against
    it stays valid for later schedules."""
    self._adopt_steps()
    lr, betas, eps = self._hyper()
    taken = int(self._step)
    rows = max(int(n_steps), 1)
    size = max(rows, int(capacity or 0))
    if self._table is None or self._table.shape[0] < size:
      self._table = torch.zeros((size, adam_ops.TABLE_COLS),
                                dtype=torch.float32, device=self._ctl.device)
    self._table[:rows].copy_(torch.from_numpy(
        adam_ops.scalar_table(lr, taken + 1, rows, betas, eps)))
    self._ctl[1].fill_(taken)
    self._span = (taken, taken + rows, lr)
    self._host_step = taken

  def begin_capture(self, steps):
    """Reserve, before a CUDA graph capture, the descriptor memory of the
    ``steps`` steps it will record."""
    tensors = sum(len(g['params']) for g in self.param_groups)
    self._capture = adam_ops.CapturedDescriptors(self._ctl.device, steps,
                                                 tensors)

  def end_capture(self):
    """Write the recorded steps' descriptors; returns their memory, which
    must live as long as the graph."""
    captured, self._capture = self._capture, None
    captured.fill()
    return captured

  def note_steps(self, n):
    """Record ``n`` steps that ran outside :meth:`step` (graph
    replays)."""
    if self._host_step is not None:
      self._host_step += n

  def reset_state(self):
    """Zero the moments and the step count in place (tensors a graph
    recorded stay valid), and write the working copies anew."""
    for state in self.state.values():
      for key in ('exp_avg', 'exp_avg_sq'):
        if key in state:
          state[key].zero_()
    self._adopt_steps()
    self._ctl.zero_()
    self._span = self._host_step = None
    self.refresh_copies()

  def working_copy(self, p):
    """The bf16 working copy that a training step's bf16 product reads in
    place of ``p.to(bf16)`` (``ops/gather_matmul.working_copies``), or
    None: ``p`` is no float32 parameter stepped here, takes no gradient
    (no grad mode), was read already in this step, or has no copy yet
    inside a capture."""
    if (p.dtype != torch.float32 or not torch.is_grad_enabled()
        or not p.requires_grad or p in self._read or p not in self._own):
      return None
    copy = self._copies.get(p)
    if copy is None:
      if capturing():
        return None
      copy = self._copies[p] = p.detach().to(
          BF16, memory_format=torch.contiguous_format).requires_grad_()
    self._read.add(p)
    return copy

  def copies(self):
    """The working copies (the tensors a captured step reads)."""
    return list(self._copies.values())

  @torch.no_grad()
  def refresh_copies(self):
    """Write every working copy from its parameter, in place (a graph
    that reads it stays valid): the parameters may have changed outside
    :meth:`step`."""
    for p, copy in self._copies.items():
      copy.copy_(p)

  def zero_grad(self, set_to_none=True):
    super().zero_grad(set_to_none)
    for copy in self._copies.values():
      if set_to_none:
        copy.grad = None
      elif copy.grad is not None:
        copy.grad.zero_()
    self._read.clear()

  @torch.no_grad()
  def step(self, closure=None):
    if closure is not None:
      raise ValueError('Bf16Adam takes no closure')
    tensors = ([], [], [], [], [], [])
    for group in self.param_groups:
      for p in group['params']:
        grad, copy = p.grad, self._copies.get(p)
        if copy is not None and copy.grad is not None:
          # (the product's, bf16; read in another way too, the two added
          # as autograd adds them)
          grad = copy.grad if grad is None else grad.add_(copy.grad)
        if grad is None:
          continue
        state = self.state[p]
        if not state:
          state['step'] = self._step
          state['exp_avg'] = torch.zeros_like(
              p, dtype=self.state_dtype,
              memory_format=torch.contiguous_format)
          state['exp_avg_sq'] = torch.zeros_like(state['exp_avg'])
        for out, x in zip(tensors, (p, grad, state['exp_avg'],
                                    state['exp_avg_sq'],
                                    group['weight_decay'], copy)):
          out.append(x)
    self._read.clear()
    if not tensors[0]:
      return None
    recording = capturing()
    if not recording:
      self._adopt_steps()
      lr = self._hyper()[0]
      span = self._span
      if (span is None or self._host_step is None or span[2] != lr
          or not span[0] <= self._host_step < span[1]):
        self.schedule(1)
    *tensors, copies = tensors
    adam_ops.table_step(*tensors, self._table, self._ctl, self._capture,
                        copies)
    if not recording:
      self._host_step += 1
    return None


class Float32AnchoredOptimizer(torch.optim.Optimizer):
  """'sgd', 'adagrad' or 'rmsprop' over bf16 parameters, as the JAX
  ``Optimizer.update`` runs them: the parameter and its gradient upcast,
  the weight decay added from the upcast parameter, the update in
  float32 against float32 state, and the parameter rounded once (to
  nearest even) on store. An eager plain update, one PyTorch op an
  operation, as these kinds run eagerly over float32 parameters too.

  Hyper-parameters are the JAX package's (torch's): SGD momentum 0.9,
  Adagrad eps 1e-10, RMSprop alpha 0.99, eps 1e-8, momentum 0.9. The
  state keys are ``torch.optim``'s (``momentum_buffer``, ``sum``,
  ``square_avg``; ``step``), so ``convert.py`` moves them as it moves
  theirs.
  """

  def __init__(self, params, kind, lr, momentum=0.9, alpha=0.99, eps=1e-8,
               adagrad_eps=1e-10, weight_decay=0.0):
    if kind not in ('sgd', 'adagrad', 'rmsprop'):
      raise ValueError(f'Float32AnchoredOptimizer runs sgd, adagrad or '
                       f'rmsprop, not {kind!r}')
    super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
    self.kind = kind
    self.momentum, self.alpha = momentum, alpha
    self.eps, self.adagrad_eps = eps, adagrad_eps

  def _buffers(self, p):
    state = self.state[p]
    if not state:
      keys = {'sgd': ('momentum_buffer',), 'adagrad': ('sum',),
              'rmsprop': ('square_avg', 'momentum_buffer')}[self.kind]
      for key in keys:
        state[key] = torch.zeros_like(p, dtype=torch.float32,
                                      memory_format=torch.contiguous_format)
      if self.kind != 'sgd':
        state['step'] = torch.tensor(0.0)
    return state

  @torch.no_grad()
  def step(self, closure=None):
    if closure is not None:
      raise ValueError('Float32AnchoredOptimizer takes no closure')
    for group in self.param_groups:
      lr, wd = group['lr'], group['weight_decay']
      for p in group['params']:
        if p.grad is None:
          continue
        state = self._buffers(p)
        p32 = p.float()
        g = p.grad.float()
        if wd:
          g = g + wd * p32
        if self.kind == 'sgd':
          buf = self.momentum * state['momentum_buffer'] + g
          state['momentum_buffer'].copy_(buf)
          new = p32 - lr * buf
        elif self.kind == 'adagrad':
          total = state['sum'] + g * g
          state['sum'].copy_(total)
          new = p32 - lr * g / (torch.sqrt(total) + self.adagrad_eps)
        else:
          a, mu = self.alpha, self.momentum
          sq = a * state['square_avg'] + (1 - a) * g * g
          buf = (mu * state['momentum_buffer']
                 + g / (torch.sqrt(sq) + self.eps))
          state['square_avg'].copy_(sq)
          state['momentum_buffer'].copy_(buf)
          new = p32 - lr * buf
        if 'step' in state:
          state['step'] += 1
        p.copy_(new)
    return None


def fold_dual_union(ids1, g1, ids2, g2, spare):
  """Coalesce two row-gradient sets over one table into one update set
  (the JAX ``fold_dual_union``).

  torch coalesces every use of a tied parameter into one sparse gradient
  and takes one SparseAdam step; two :meth:`SparseRowAdam.update_rows`
  calls would advance the step count twice and decay the moments of the
  rows both sets hold twice. Where ``ids2`` meets ``ids1``, the second
  set's gradient is added into the first's slot and its own slot is
  pointed at ``spare`` (a padding row, whose gradient and moments stay
  exactly zero), so the real ids of the result are unique.

  Args:
    ids1, ids2: int64 [R1], [R2] row ids, each ascending and unique.
    g1, g2: [R1, d], [R2, d] their gradients.
    spare: the padding row id.

  Returns ``(ids [R1 + R2], grads [R1 + R2, d] float32)`` for one
  ``update_rows`` call. The additions are float32 whatever the gradients'
  dtype, as in JAX.
  """
  g1, g2 = g1.float(), g2.float()
  if ids1.numel() == 0:
    return torch.cat([ids1, ids2]), torch.cat([g1, g2])
  pos = torch.clamp(torch.searchsorted(ids1, ids2), max=ids1.numel() - 1)
  hit = ids1[pos] == ids2
  g1 = g1.index_add(0, pos, torch.where(hit[:, None], g2, 0.0))
  return (torch.cat([ids1, torch.where(hit, spare, ids2)]),
          torch.cat([g1, torch.where(hit[:, None], 0.0, g2)]))


class SparseRowAdam:
  """Row-sparse Adam over a 2-D embedding table (torch ``SparseAdam``).

  Each step updates the first and second moments and the parameters of
  the rows ``ids`` names (the batch's item union, unique but for the
  sentinel tail) and leaves every other row untouched; bias correction
  uses one step counter per table, advanced every step. No weight decay,
  as torch ``SparseAdam``. The cost is O(len(ids) * d), whatever the
  table's size.

  The table may be bf16 (bf16 parameter storage) and the moments bf16
  (``state_dtype='bfloat16'``; float32 by default, whatever the table's
  dtype, as in JAX): the gathered rows are upcast, the math is float32,
  and each new row block is rounded once to its table's dtype before the
  row scatter writes the three.

  No step reads the host, so a CUDA graph can record it: each table's
  step count is a 0-dim int64 tensor beside it (``state['step']``), and
  the step size ``lr * sqrt(1 - b2^t) / (1 - b1^t)`` of step ``t`` is
  read from a device table that :meth:`schedule` writes for the steps to
  come, at the epoch's learning rate, with the JAX package's float32
  scalar arithmetic on the host; row ``t - 1 - base`` serves step ``t``,
  ``base`` a device scalar. An eager step outside the scheduled rows (or
  at another learning rate) schedules its own row first, at the cost of
  one host read of its step count; graph replays report their steps
  with :meth:`note_steps`.
  """

  def __init__(self, betas=(0.9, 0.999), eps=1e-8, state_dtype=None):
    self.betas = betas
    self.eps = eps
    self.state_dtype = resolve_state_dtype('adam', state_dtype)
    self._table = None  # step sizes of the scheduled steps, float32
    self._base = None  # the step count before the table's first row
    #: (first scheduled step count, end, lr) as the host wrote them
    self._span = None
    #: the host's count of each state's steps, by id (eager tracking)
    self._known = {}

  def init(self, table):
    """``{'step': 0, 'm': zeros, 'v': zeros}`` in the state dtype, beside
    ``table`` (the step count a 0-dim int64 tensor there)."""
    return {'step': torch.zeros((), dtype=torch.int64, device=table.device),
            'm': torch.zeros_like(table, dtype=self.state_dtype),
            'v': torch.zeros_like(table, dtype=self.state_dtype)}

  def step_sizes(self, lr, first, n):
    """The float32 step sizes of steps ``first .. first + n - 1`` (the
    JAX package's float32 scalar arithmetic)."""
    b1, b2 = self.betas
    f32 = np.float32
    out = np.empty(n, np.float32)
    for i, step in enumerate(range(first, first + n)):
      # (scalar by scalar: numpy's vector power may round otherwise)
      bc1 = f32(1.0) - f32(b1) ** f32(step)
      bc2 = f32(1.0) - f32(b2) ** f32(step)
      out[i] = f32(lr) * np.sqrt(bc2) / bc1
    return out

  def schedule(self, states, lr, n_steps, capacity=None):
    """Write the step sizes of the next ``n_steps`` steps of every state
    in ``states`` at ``lr`` (one host read of each step count).
    ``capacity`` keeps the table at least that many rows, so that a graph
    recorded against it stays valid for later schedules."""
    states = list(states)
    for state in states:
      _as_device_step(state)
    taken = [int(state['step']) for state in states]
    if not taken:
      return
    lo = min(taken)
    rows = max(taken) - lo + max(int(n_steps), 1)
    device = states[0]['step'].device
    if self._table is None or self._table.shape[0] < max(rows,
                                                         capacity or 0):
      self._table = torch.zeros(max(rows, int(capacity or 0)),
                                dtype=torch.float32, device=device)
      self._base = torch.zeros((), dtype=torch.int64, device=device)
    self._table[:rows].copy_(torch.from_numpy(
        self.step_sizes(lr, lo + 1, rows)))
    self._base.fill_(lo)
    self._span = (lo, lo + rows, float(lr))
    self._known = {id(state): t for state, t in zip(states, taken)}

  def note_steps(self, n):
    """Record ``n`` steps of every tracked state that ran outside
    :meth:`update_rows`' eager calls (graph replays)."""
    for key in self._known:
      self._known[key] += n

  def update_rows(self, table, state, ids, row_grads, lr):
    """One sparse step, in place on ``table`` and ``state``.

    Args:
      table: [N, d] parameter table, float32 or bf16.
      state: moments from :meth:`init`; its 'step' advances by one.
      ids: int64 [R] row ids, unique but for repeats that carry the same
        gradient in every slot (a sentinel tail of zero gradients), or
        None for every row (``row_grads`` is then the whole table's
        gradient [N, d]). A slot of id -1 is left out (on a mesh: a union
        row that another rank holds).
      row_grads: [R, d] gradient of the gathered rows (any float dtype;
        the math upcasts it).
      lr: learning rate.

    The three gathered row blocks are copies, so the write never reads
    a row it overwrites; the whole-table update computes its three
    results before it copies them in. Call under ``torch.no_grad()``,
    after any backward pass that saved ``table``.
    """
    b1, b2 = self.betas
    _as_device_step(state)
    if not capturing():
      span, known = self._span, self._known.get(id(state))
      if (span is None or known is None or span[2] != float(lr)
          or not span[0] <= known < span[1]):
        self.schedule([state], lr, 1)
    step_size = self._table.index_select(0, (state['step']
                                             - self._base).view(1))
    g = row_grads.float()
    if ids is None:
      m_rows, v_rows, p_rows = state['m'], state['v'], table
    else:
      # (a skipped slot reads row 0 and writes nothing)
      at = ids.clamp(min=0)
      m_rows = state['m'].index_select(0, at)
      v_rows = state['v'].index_select(0, at)
      p_rows = table.index_select(0, at)
    new_m = b1 * m_rows.float() + (1 - b1) * g
    new_v = b2 * v_rows.float() + (1 - b2) * g * g
    new_p = p_rows.float() - step_size * new_m / (torch.sqrt(new_v)
                                                  + self.eps)
    dsts = (table, state['m'], state['v'])
    if ids is None:
      for dst, src in zip(dsts, (new_p, new_m, new_v)):
        dst.copy_(src)  # (rounds to the table's dtype)
    else:
      row_scatter_(dsts, ids, tuple(src.to(dst.dtype) for dst, src in
                                    zip(dsts, (new_p, new_m, new_v))))
    state['step'].add_(1)
    if not capturing():
      self._known[id(state)] += 1


def _as_device_step(state):
  """Make ``state['step']`` a 0-dim int64 tensor beside the moments (a
  count put there as a number, as an older caller may)."""
  step = state['step']
  if not torch.is_tensor(step) or step.dtype != torch.int64 \
      or step.device != state['m'].device:
    state['step'] = torch.tensor(int(step), dtype=torch.int64,
                                 device=state['m'].device)
