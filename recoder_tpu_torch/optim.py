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

State is float32. Not ported yet: bf16 moment storage
(``state_dtype``) and the row-sparse Adam of the sparse tables.
"""

import torch

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

