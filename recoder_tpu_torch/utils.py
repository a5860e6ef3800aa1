"""Host-side array utilities (numpy only).

A copy of ``recoder_tpu/utils.py`` (``unzip``, ``normalize``,
``dataframe_to_csr_matrix``): the JAX package's module is numpy-only,
but importing it runs ``recoder_tpu/__init__.py``, which imports jax.

``dataframe`` may be a pandas DataFrame or any mapping from column
name to a 1-D array (a dict of numpy arrays serves where pandas is not
installed).
"""

import numpy as np
from scipy.sparse import coo_matrix


def unzip(l):
  """Inverse of ``zip`` on a list: ``unzip([(a, b), ...]) == [[a...], [b...]]``."""
  return list(map(list, zip(*l)))


def normalize(x, axis=None):
  """L2-normalize ``x`` along ``axis`` (the JAX package's form: the
  norm keeps its dimensions, so every axis broadcasts and the input's
  shape is kept)."""
  return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _column(dataframe, col):
  values = dataframe[col]
  to_numpy = getattr(values, 'to_numpy', None)
  return to_numpy() if to_numpy is not None else np.asarray(values)


def dataframe_to_csr_matrix(dataframe, user_col, item_col,
                            inter_col, item_id_map=None,
                            user_id_map=None):
  """Convert a user/item/interaction table into a CSR matrix.

  Returns ``(csr_matrix, item_id_map, user_id_map)`` where the id maps
  take original ids to contiguous 0-based indices, in order of first
  appearance. A supplied map is used as-is; ids missing from it raise
  ``KeyError``.
  """
  users = _column(dataframe, user_col)
  items = _column(dataframe, item_col)
  inters = _column(dataframe, inter_col)

  def _encode(values, id_map):
    if id_map is None:
      uniq, first_idx = np.unique(values, return_index=True)
      order = np.argsort(first_idx, kind='stable')
      uniq = uniq[order]
      id_map = {v: i for i, v in enumerate(uniq)}
    lut_keys = np.fromiter(id_map.keys(), dtype=np.asarray(values).dtype,
                           count=len(id_map))
    lut_vals = np.fromiter(id_map.values(), dtype=np.int64, count=len(id_map))
    sorter = np.argsort(lut_keys)
    pos = np.searchsorted(lut_keys, values, sorter=sorter)
    pos = np.clip(pos, 0, len(lut_keys) - 1)
    hit = lut_keys[sorter[pos]] == values
    if not np.all(hit):
      missing = np.asarray(values)[~hit][:5]
      raise KeyError(f'ids not present in provided id map: {missing!r}')
    return lut_vals[sorter[pos]], id_map

  user_codes, user_id_map = _encode(users, user_id_map)
  item_codes, item_id_map = _encode(items, item_id_map)

  matrix_size = (len(user_id_map), len(item_id_map))
  csr = coo_matrix((inters, (user_codes, item_codes)),
                   shape=matrix_size).tocsr()
  return csr, item_id_map, user_id_map
