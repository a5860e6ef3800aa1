"""Single-file checkpoints in the npz format of ``recoder_tpu/checkpoint.py``.

Arrays are stored under ``arr::``-prefixed '/'-joined tree paths and
the metadata as UTF-8 JSON bytes under ``meta::json``, so a checkpoint
written by the JAX package loads here and one written here loads
there. The write goes to a same-directory temp file that is swapped
into place with ``os.replace``: a crash mid-write leaves any existing
checkpoint at ``path`` intact.
"""

import json
import os

import numpy as np
import torch


def flatten_tree(tree, prefix=''):
  """Flatten a nested dict of arrays into ``{'a/b/c': array}``."""
  out = {}
  if isinstance(tree, dict):
    for k, v in tree.items():
      if '/' in str(k):
        raise ValueError(f'checkpoint keys must not contain "/": {k!r}')
      out.update(flatten_tree(v, f'{prefix}{k}/'))
  elif tree is not None:
    out[prefix[:-1]] = tree
  return out


def unflatten_tree(flat):
  """Inverse of :func:`flatten_tree`."""
  tree = {}
  for path, value in flat.items():
    parts = path.split('/')
    node = tree
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = value
  return tree


def _to_numpy(x):
  if isinstance(x, torch.Tensor):
    x = x.detach()
    if x.dtype == torch.bfloat16:
      # npz has no bfloat16; f32 holds every bf16 value exactly
      x = x.float()
    return x.cpu().numpy()
  return np.asarray(x)


def save_checkpoint(path, arrays_tree, metadata):
  """Write a nested dict of arrays or tensors plus JSON-able metadata."""
  flat = {k: _to_numpy(v) for k, v in flatten_tree(arrays_tree).items()}
  payload = {f'arr::{k}': v for k, v in flat.items()}
  payload['meta::json'] = np.frombuffer(
      json.dumps(metadata).encode('utf-8'), dtype=np.uint8)
  tmp = f'{path}.tmp-save-{os.getpid()}'
  try:
    with open(tmp, 'wb') as f:
      np.savez(f, **payload)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, path)
  finally:
    if os.path.exists(tmp):
      os.unlink(tmp)


def load_checkpoint(path):
  """Returns ``(arrays_tree, metadata)`` with numpy arrays."""
  with np.load(path, allow_pickle=False) as z:
    meta = json.loads(bytes(z['meta::json']).decode('utf-8'))
    flat = {k[len('arr::'):]: z[k] for k in z.files if k.startswith('arr::')}
  return unflatten_tree(flat), meta
