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
row-scatter kernel (``ops/row_scatter.py``).

``state_dtype='bfloat16'`` (the JAX ``Optimizer(state_dtype=...)``,
bench.py's ML-20M default) stores Adam's moments in bf16 and keeps the
update math in float32: :class:`Bf16Adam`, one launch of the fused
kernel ``kernels/adam.cu`` a step on the card (``ops/adam.py``). Only
'adam' takes it; the other kinds refuse it as the JAX package does. The
float32 state stays ``torch.optim``.

Not ported yet: bf16 state for :class:`SparseRowAdam` (the row scatter
writes float32 tables) and ``fold_dual_union`` (only dual target CSRs
reach it, and those are not ported).
"""

import numpy as np
import torch

from recoder_tpu_torch.ops.adam import adam_bf16_step
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


def make_optimizer(kind, named_params, lr, weight_decay=0.0,
                   state_dtype=None):
  """An optimizer over ``named_params`` ({name: param}) with the JAX
  package's hyper-parameters for ``kind``: ``torch.optim``'s, or
  :class:`Bf16Adam` for bf16 state."""
  groups = make_param_groups(named_params, weight_decay)
  if resolve_state_dtype(kind, state_dtype) == torch.bfloat16:
    return Bf16Adam(groups, lr=lr)
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


class Bf16Adam(torch.optim.Optimizer):
  """Adam with bf16 moments and float32 math (the JAX package's
  ``Optimizer('adam', state_dtype='bfloat16')``).

  Per step, for every parameter with a gradient: the weight decay is
  added to the gradient (L2, torch style; biases sit in a group with 0),
  the new moments and the parameter step are computed in float32 -- the
  step from the unrounded new moments -- and the moments are stored
  rounded to nearest even. ``state[p]`` holds ``exp_avg`` and
  ``exp_avg_sq`` (bf16) and ``step`` (a float32 CPU tensor), the keys of
  ``torch.optim.Adam``, so ``convert.py`` and the checkpoints read it the
  same way. Every parameter steps together: one step count, one learning
  rate. On the card the whole set is one launch of the fused kernel
  (``ops/adam.py``).
  """

  def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
               weight_decay=0.0):
    super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                  weight_decay=weight_decay))

  @torch.no_grad()
  def step(self, closure=None):
    if closure is not None:
      raise ValueError('Bf16Adam takes no closure')
    tensors = ([], [], [], [], [])
    hyper = set()
    for group in self.param_groups:
      for p in group['params']:
        if p.grad is None:
          continue
        state = self.state[p]
        if not state:
          state['step'] = torch.tensor(0.0)
          state['exp_avg'] = torch.zeros_like(
              p, dtype=torch.bfloat16, memory_format=torch.contiguous_format)
          state['exp_avg_sq'] = torch.zeros_like(state['exp_avg'])
        for out, x in zip(tensors, (p, p.grad, state['exp_avg'],
                                    state['exp_avg_sq'],
                                    group['weight_decay'])):
          out.append(x)
        hyper.add((float(state['step']), group['lr'], group['betas'],
                   group['eps']))
    if not tensors[0]:
      return None
    if len(hyper) != 1:
      raise ValueError('Bf16Adam steps every parameter with one step count, '
                       f'learning rate, betas and eps; got {sorted(hyper)}')
    step, lr, betas, eps = hyper.pop()
    adam_bf16_step(*tensors, lr, int(step) + 1, betas, eps)
    for p in tensors[0]:
      self.state[p]['step'] += 1
    return None


class SparseRowAdam:
  """Row-sparse Adam over a 2-D embedding table (torch ``SparseAdam``).

  Each step updates the first and second moments and the parameters of
  the rows ``ids`` names (the batch's item union, unique) and leaves
  every other row untouched; bias correction uses one step counter per
  table, advanced every step. No weight decay, as torch ``SparseAdam``.
  The cost is O(len(ids) * d), whatever the table's size.
  """

  def __init__(self, betas=(0.9, 0.999), eps=1e-8, state_dtype=None):
    if state_dtype not in (None, 'float32', torch.float32):
      raise NotImplementedError(
          f'SparseRowAdam(state_dtype={state_dtype!r}): only float32 '
          'moments are ported (the row scatter writes float32 tables)')
    self.betas = betas
    self.eps = eps

  def init(self, table):
    """``{'step': 0, 'm': zeros, 'v': zeros}`` in float32, beside
    ``table``."""
    return {'step': 0, 'm': torch.zeros_like(table, dtype=torch.float32),
            'v': torch.zeros_like(table, dtype=torch.float32)}

  def update_rows(self, table, state, ids, row_grads, lr):
    """One sparse step, in place on ``table`` and ``state``.

    Args:
      table: [N, d] float32 parameter table.
      state: moments from :meth:`init`; its 'step' advances by one.
      ids: int64 [R] row ids, unique (a repeated id must carry the same
        gradient in every slot).
      row_grads: [R, d] gradient of the gathered rows.
      lr: learning rate.

    The three gathered row blocks are copies, so the write never reads
    a row it overwrites. Call under ``torch.no_grad()``, after any
    backward pass that saved ``table``.
    """
    b1, b2 = self.betas
    step = state['step'] + 1
    # the JAX package's float32 scalar arithmetic, on the host
    f32 = np.float32
    bc1 = f32(1.0) - f32(b1) ** f32(step)
    bc2 = f32(1.0) - f32(b2) ** f32(step)
    step_size = float(f32(lr) * np.sqrt(bc2) / bc1)

    g = row_grads.float()
    m_rows = state['m'].index_select(0, ids)
    v_rows = state['v'].index_select(0, ids)
    p_rows = table.index_select(0, ids)
    new_m = b1 * m_rows + (1 - b1) * g
    new_v = b2 * v_rows + (1 - b2) * g * g
    new_p = p_rows - step_size * new_m / (torch.sqrt(new_v) + self.eps)
    row_scatter_((table, state['m'], state['v']), ids, (new_p, new_m, new_v))
    state['step'] = step
