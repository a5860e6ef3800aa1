"""Weights bridge between the JAX package's arrays and the port's tensors.

Parameters keep the JAX names (``en_embedding``, ``en_bias``,
``encode_w_i``, ``encode_bias_i``, ``decode_w_i``, ``decode_bias_i``,
``de_embedding``, ``de_bias``) and the JAX shapes, sentinel rows
included (``models/base.py`` ``pad_dim``), so one dict converts either
way without renaming or reshaping.

Optimizer state follows ``recoder_tpu/optim.py``'s tree
(``{'step': int32, 'm': {name: array}, 'v': {name: array}}`` for adam)
on the JAX side and ``torch.optim``'s per-parameter state dicts on the
port's side. The JAX update rules are pinned to torch's
(``tests/test_optim.py``), so the moments carry over as they are.
"""

import numpy as np
import torch

#: JAX state-tree key -> torch.optim per-parameter state key, per kind
STATE_KEYS = {
    'adam': {'m': 'exp_avg', 'v': 'exp_avg_sq'},
    'sgd': {'momentum': 'momentum_buffer'},
    'adagrad': {'sum': 'sum'},
    'rmsprop': {'sq': 'square_avg', 'buf': 'momentum_buffer'},
}


def params_from_numpy(arrays, device=None):
  """``{name: np.ndarray}`` -> ``{name: float32 Tensor}`` on ``device``."""
  return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
          for k, v in arrays.items()}


def params_to_numpy(params):
  """``{name: Tensor}`` -> ``{name: float32 np.ndarray}`` (inverse)."""
  return {k: v.detach().float().cpu().numpy() for k, v in params.items()}


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


def opt_state_into_torch(optimizer, named_params, tree, kind):
  """Load the JAX optimizer tree into ``optimizer``'s state."""
  keys = STATE_KEYS[kind]
  step = int(np.asarray(tree['step']))
  for name, p in named_params.items():
    state = optimizer.state[p]
    for jax_key, torch_key in keys.items():
      arr = np.asarray(tree[jax_key][name], np.float32)
      if arr.shape != tuple(p.shape):
        raise ValueError(f'optimizer/{jax_key}/{name}: shape {arr.shape} '
                         f'does not match the parameter {tuple(p.shape)}')
      state[torch_key] = torch.from_numpy(arr.copy()).to(p.device)
    if kind != 'sgd':
      state['step'] = torch.tensor(float(step), dtype=torch.float32)
