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

State is float32. Not ported yet: bf16 moment storage
(``state_dtype``) and ``fold_dual_union`` (only dual target CSRs reach
it, and those are not ported).
"""

import numpy as np
import torch

from recoder_tpu_torch.ops.row_scatter import row_scatter_

KINDS = ('sgd', 'adam', 'adagrad', 'rmsprop')


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


def make_optimizer(kind, named_params, lr, weight_decay=0.0):
  """A ``torch.optim`` optimizer over ``named_params`` ({name: param})
  with the JAX package's hyper-parameters for ``kind``."""
  groups = make_param_groups(named_params, weight_decay)
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



class SparseRowAdam:
  """Row-sparse Adam over a 2-D embedding table (torch ``SparseAdam``).

  Each step updates the first and second moments and the parameters of
  the rows ``ids`` names (the batch's item union, unique) and leaves
  every other row untouched; bias correction uses one step counter per
  table, advanced every step. No weight decay, as torch ``SparseAdam``.
  The cost is O(len(ids) * d), whatever the table's size.
  """

  def __init__(self, betas=(0.9, 0.999), eps=1e-8):
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
