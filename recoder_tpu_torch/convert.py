"""Weights bridge between the JAX package's arrays and the port's tensors.

Parameters keep the JAX names and the JAX shapes, sentinel rows of the
padded item and user axes included (``models/base.py`` ``pad_dim``), so
one dict converts either way without renaming or reshaping:

  DynamicAutoencoder  ``en_embedding``, ``en_bias``, ``encode_w_i``,
                      ``encode_bias_i``, ``decode_w_i``,
                      ``decode_bias_i``, ``de_embedding``, ``de_bias``
  MatrixFactorization ``user_embedding`` [pad_dim(users), d],
                      ``item_embedding`` [pad_dim(items), d], ``bias``
  MultVAE             ``en_embedding``, ``en_bias``, ``w_mu``,
                      ``mu_bias``, ``w_logvar``, ``logvar_bias``,
                      ``w_dec``, ``dec_bias``, ``de_embedding``,
                      ``de_bias``

:func:`load_params` puts a JAX model's arrays (or a checkpoint's) into a
port model; :func:`params_to_numpy` takes them out, and
:func:`to_jax_table` gives a port table the JAX package's sparse
feature pad.

Optimizer state follows ``recoder_tpu/optim.py``'s tree
(``{'step': int32, 'm': {name: array}, 'v': {name: array}}`` for adam)
on the JAX side and ``torch.optim``'s per-parameter state dicts on the
port's side. The JAX update rules are pinned to torch's
(``tests/test_optim.py``), so the moments carry over as they are. bf16
moments (``opt_state_dtype='bfloat16'``) are written upcast to float32,
which holds every bf16 value (npz has no bf16), and are loaded into the
dtype of the optimizer they go to.

Sparse tables: the JAX package pads a sparse model's embedding tables
and their row-sparse Adam moments to 128 feature lanes ([N, 256] at
d0 = 200; ``models/base.py`` ``pad_features``), the port keeps them
[N, d0]. :func:`fit_table` cuts a padded checkpoint array to the
port's width and raises if a pad column holds anything but zeros; a port
checkpoint's [N, d0] arrays load into JAX through its ``_adapt_array``,
which pads them again. The row-sparse Adam state converts with
:func:`sparse_state_from_numpy` / :func:`sparse_state_to_numpy`
(``{table: {'step': int32, 'm': array, 'v': array}}``).

iALS factors keep the JAX names too (``user_factors`` [users, d],
``item_factors`` [items, d]): :func:`ials_factors_from_numpy` puts a
JAX model's arrays into a port ``IALS``, :func:`ials_factors_to_numpy`
takes them back out.
"""

import numpy as np
import torch

from recoder_tpu_torch.models.base import adapt_array
from recoder_tpu_torch.optim import uses_device_steps

#: JAX state-tree key -> torch.optim per-parameter state key, per kind
STATE_KEYS = {
    'adam': {'m': 'exp_avg', 'v': 'exp_avg_sq'},
    'sgd': {'momentum': 'momentum_buffer'},
    'adagrad': {'sum': 'sum'},
    'rmsprop': {'sq': 'square_avg', 'buf': 'momentum_buffer'},
}


def params_from_numpy(arrays, device=None, dtype=torch.float32):
  """``{name: np.ndarray}`` -> ``{name: Tensor}`` in ``dtype`` on
  ``device``. The JAX package's bf16 arrays (ml_dtypes bfloat16, which
  ``torch.from_numpy`` cannot read) go through float32, which holds every
  bf16 value: a bf16 array comes back bitwise in ``dtype=bfloat16``."""
  return {k: torch.from_numpy(np.array(v, np.float32)).to(device, dtype)
          for k, v in arrays.items()}


def params_to_numpy(params):
  """``{name: Tensor}`` -> ``{name: float32 np.ndarray}`` (inverse)."""
  return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


def load_params(model, arrays, prefix='model/'):
  """Copy ``{name: array}`` (a JAX model's ``params``, bf16 ones
  included, or a checkpoint's ``model`` tree) into the port ``model``'s
  parameters in place, each cast to its parameter's dtype (rounded to
  nearest even: a float32 array into bf16 storage, as the JAX
  ``_adapt_array``); a JAX sparse table's feature pad is cut
  (:func:`fit_table`)."""
  with torch.no_grad():
    for name, p in model.params().items():
      p.copy_(adapt_array(p, fit_table(f'{prefix}{name}', tuple(p.shape),
                                       arrays[name])))


def to_jax_table(arr, shape):
  """A port array in a JAX parameter's ``shape``: as it is, or a sparse
  table widened with the zero feature columns of the JAX package's
  128-lane pad (the inverse of :func:`fit_table`)."""
  arr = np.asarray(arr, np.float32)
  if arr.ndim == 2 and len(shape) == 2 and shape[1] > arr.shape[1]:
    arr = np.pad(arr, ((0, 0), (0, shape[1] - arr.shape[1])))
  if arr.shape != tuple(shape):
    raise ValueError(f'array of shape {arr.shape} does not fit {shape}')
  return arr


def opt_state_to_numpy(optimizer, named_params, kind, sgd_step=0):
  """A ``torch.optim`` optimizer's state as the JAX optimizer's tree.

  ``named_params`` maps JAX names to the optimizer's parameters.
  Parameters the optimizer has not stepped yet get zero buffers. torch's
  SGD keeps no step counter, so ``sgd_step`` supplies the tree's.
  """
  keys = STATE_KEYS[kind]
  out = {jax_key: {} for jax_key in keys}
  step = sgd_step
  for name, p in named_params.items():
    state = optimizer.state.get(p, {})
    if 'step' in state:
      step = int(state['step'])
    for jax_key, torch_key in keys.items():
      buf = state.get(torch_key)
      out[jax_key][name] = (np.zeros(tuple(p.shape), np.float32)
                            if buf is None
                            else buf.detach().float().cpu().numpy())
  out['step'] = np.asarray(step, np.int32)
  return out


def opt_state_into_torch(optimizer, named_params, tree, kind,
                         dtype=torch.float32):
  """Load the JAX optimizer tree into ``optimizer``'s state, the buffers
  in ``dtype`` (the optimizer's state dtype, whatever the checkpoint
  held)."""
  keys = STATE_KEYS[kind]
  step = int(np.asarray(tree['step']))
  for name, p in named_params.items():
    state = optimizer.state[p]
    for jax_key, torch_key in keys.items():
      arr = np.asarray(tree[jax_key][name], np.float32)
      if arr.shape != tuple(p.shape):
        raise ValueError(f'optimizer/{jax_key}/{name}: shape {arr.shape} '
                         f'does not match the parameter {tuple(p.shape)}')
      state[torch_key] = torch.from_numpy(arr.copy()).to(p.device, dtype)
    if kind != 'sgd':
      # (a capturable or fused torch.optim counts its steps on the
      # device; Bf16Adam takes the count over at its next step)
      state['step'] = torch.tensor(
          float(step), dtype=torch.float32,
          device=p.device if uses_device_steps(optimizer) else None)


def fit_table(name, shape, arr):
  """A float32 copy of a checkpoint array for a parameter or moment of
  ``shape``: as it is, or with a JAX sparse table's zero feature pad cut
  off."""
  arr = np.array(arr, np.float32)
  if (arr.ndim == 2 and len(shape) == 2 and arr.shape[0] == shape[0]
      and arr.shape[1] > shape[1]):
    if np.any(arr[:, shape[1]:]):
      raise ValueError(f'{name}: the feature pad beyond column {shape[1]} '
                       'is not zero')
    arr = np.ascontiguousarray(arr[:, :shape[1]])
  if arr.shape != tuple(shape):
    raise ValueError(f'checkpoint array {name} has shape {arr.shape}, '
                     f'the model expects {tuple(shape)}')
  return arr


def sparse_state_from_numpy(tree, table, dtype=torch.float32):
  """One table's row-sparse Adam state from the JAX tree ``{'step', 'm',
  'v'}``, as tensors in ``dtype`` (the optimizer's state dtype; rounded
  to nearest even) beside ``table``."""
  shape = tuple(table.shape)
  return {'step': torch.tensor(int(np.asarray(tree['step'])),
                               dtype=torch.int64, device=table.device),
          **{k: torch.from_numpy(fit_table(f'sparse_optimizer/{k}', shape,
                                           tree[k])).to(table.device, dtype)
             for k in ('m', 'v')}}


def sparse_state_to_numpy(states):
  """``{table: {'step', 'm', 'v'}}`` as the JAX tree: int32 step,
  float32 moments."""
  return {path: {'step': np.asarray(int(st['step']), np.int32),
                 'm': st['m'].detach().float().cpu().numpy(),
                 'v': st['v'].detach().float().cpu().numpy()}
          for path, st in states.items()}


def ease_weights_from_numpy(model, arrays):
  """Put a JAX EASE model's ``{'item_weights': B}`` into the port
  ``EASE`` ``model`` (float32, on its device)."""
  model.item_weights = torch.from_numpy(
      np.array(arrays['item_weights'], np.float32)).to(model.device)
  model.num_items = int(model.item_weights.shape[0])
  return model


def ease_weights_to_numpy(model):
  """The port ``EASE`` model's B as ``{'item_weights': float32 array}``."""
  return {'item_weights': model.item_weights.detach().float().cpu().numpy()}


IALS_KEYS = ('user_factors', 'item_factors')


def ials_factors_from_numpy(model, arrays):
  """Put ``{'user_factors', 'item_factors'}`` numpy arrays into the port
  ``IALS`` ``model`` as float32 tensors on its device."""
  for key in IALS_KEYS:
    setattr(model, key, torch.from_numpy(
        np.array(arrays[key], np.float32)).to(model.device))
  model.num_users = int(model.user_factors.shape[0])
  model.num_items = int(model.item_factors.shape[0])
  if model.item_factors.shape[1] != model.user_factors.shape[1]:
    raise ValueError(f'factor widths differ: user '
                     f'{tuple(model.user_factors.shape)}, item '
                     f'{tuple(model.item_factors.shape)}')
  model.embedding_size = int(model.item_factors.shape[1])
  return model


def ials_factors_to_numpy(model):
  """The port ``IALS`` model's factors as float32 numpy arrays."""
  return {key: getattr(model, key).detach().float().cpu().numpy()
          for key in IALS_KEYS}
