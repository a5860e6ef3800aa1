"""Sharding rules: model parameters and batches over a (data, model) mesh.

Port of ``recoder_tpu/parallel/sharding.py``, with the same placement:

  * embedding tables (axes ``('item'|'user', 'embed')``) and per-item
    bias vectors (``('item',)``): rows split over 'model', each rank
    holding one contiguous range (``np.array_split``'s: the first
    ``n % M`` ranks one row more), so that no rank holds a whole table;
  * MLP weights and biases: replicated;
  * a batch's users: split over 'data', the rest replicated.

A partition spec is a tuple of mesh axis names (or None) per dimension,
the counterpart of a JAX ``PartitionSpec``. JAX places the parameters and
lets XLA insert the collectives; the port places them here and the
trainer runs the collectives itself (``parallel/collectives.py``), each
rank computing its share of a step through a :class:`Partition`.
"""

import torch

from recoder_tpu_torch.parallel import collectives

#: a batch's per-user arrays (split over 'data'); the rest is replicated
BATCH_ROW_KEYS = ('users', 'slab', 'input', 'target')


def row_range(n, parts, index):
  """``(lo, hi)`` of part ``index`` when ``n`` rows split into ``parts``
  contiguous ranges (``np.array_split``'s sizes)."""
  base, extra = divmod(int(n), int(parts))
  lo = index * base + min(index, extra)
  return lo, lo + base + (index < extra)


def param_pspecs(model):
  """Partition specs per parameter, from the model's ``param_axes``:
  'item' and 'user' axes go to 'model', every other axis is
  replicated."""
  return {path: tuple('model' if ax in ('item', 'user') else None
                      for ax in axes)
          for path, axes in model.param_axes().items()}


def sharded_paths(model):
  """The parameters whose rows are split over 'model'."""
  return [path for path, spec in param_pspecs(model).items()
          if spec and spec[0] == 'model']


def shard_params(params, model, mesh):
  """This rank's share of ``params`` (``{name: tensor or array}``, whole):
  its rows of each 'model'-split parameter, every other one as it is."""
  split = sharded_paths(model)
  return {k: v[slice(*row_range(v.shape[0], mesh.shape['model'],
                                mesh.model_rank))] if k in split else v
          for k, v in params.items()}


def batch_pspecs(batch):
  """Partition specs of a batch dict: the per-user arrays
  (``BATCH_ROW_KEYS``) ride 'data', everything else is replicated (the
  COO arrays, the unions, the column mask, the valid-user count)."""
  return {k: None if v is None else
          (('data',) if k in BATCH_ROW_KEYS else ())
          for k, v in batch.items()}


def shard_batch(batch, mesh):
  """This rank's share of a batch that every rank built whole: its
  'data' slice of the per-user arrays (``batch_pspecs``), the rest as
  it is. The valid-user count stays the batch's (the loss divides by
  it); ``'first_row'`` says where the slice starts."""
  specs = batch_pspecs(batch)
  num_rows = next(v.shape[0] for k, v in batch.items()
                  if specs[k] == ('data',))
  lo, hi = row_range(num_rows, mesh.shape['data'], mesh.data_rank)
  out = {k: v[lo:hi] if specs[k] == ('data',) else v
         for k, v in batch.items()}
  out['first_row'] = lo
  return out


class Partition:
  """This rank's share of one batch of ``num_rows`` users: the users
  ``[lo, hi)`` of its 'data' slice, and of each 'model'-split table the
  rows of its axis's range (``ranges['item']``, ``ranges['user']``).

  The models compute through it (``decode_operands(..., shard=...)``, and
  in Mult-VAE's training ``forward(..., shard=...)``):

  * an item union's rows come from the rank's own rows, the columns it
    does not own zeroed (:meth:`take`, :meth:`owned`); the whole catalog
    (ids None) is the rank's contiguous column range (:meth:`columns`);
  * the encoder's product over the owned columns is a partial sum, added
    over 'model' (:meth:`reduce_partial`); the bottleneck enters the
    decoder through :meth:`share`, whose backward adds the ranks'
    gradients over 'model';
  * noise is drawn at the whole batch's shape and sliced
    (:attr:`draw_rows`), so that the masks are the single-device run's.

  The collectives run on every mesh, a (1, 1) one included (on a group
  of one they return their input), so that a (1, 1) mesh computes
  exactly what the trainer without a mesh computes.
  """

  def __init__(self, mesh, model, num_rows):
    self.mesh = mesh
    self.num_rows = int(num_rows)
    self.lo, self.hi = row_range(num_rows, mesh.shape['data'],
                                 mesh.data_rank)
    #: whether the tables' rows are split (more than one 'model' rank)
    self.split = mesh.shape['model'] > 1
    #: each split parameter's axis, and each axis's whole row count
    self.axes = {path: axes[0] for path, axes in model.param_axes().items()
                 if axes and axes[0] in ('item', 'user')}
    self.totals = {'item': model.num_items_padded,
                   'user': getattr(model, 'num_users_padded', None)}
    self.ranges = {axis: row_range(n, mesh.shape['model'], mesh.model_rank)
                   for axis, n in self.totals.items() if n is not None}

  @property
  def draw_rows(self):
    """``(lo, hi, num_rows)``: a noise draw's rows (None: all of them)."""
    if self.hi - self.lo == self.num_rows:
      return None
    return self.lo, self.hi, self.num_rows

  def rows(self, x):
    """The rank's users of a whole-batch tensor ``x [num_rows, ...]``."""
    if x is None or self.hi - self.lo == x.shape[0]:
      return x
    return x[self.lo:self.hi]

  def row_mask(self, valid_users, device):
    """float32 ``[hi - lo]``: 1 for the rank's users below the batch's
    valid count."""
    return (torch.arange(self.lo, self.hi, device=device)
            < valid_users).float()

  def _axis(self, path):
    """The axis of table ``path`` ('item' and 'user' name themselves;
    None: a replicated parameter)."""
    return path if path in self.ranges else self.axes.get(path)

  def total(self, path):
    """The whole row count of table (or axis) ``path``."""
    return self.totals[self._axis(path)]

  def owned(self, path, ids):
    """``[W]`` bool: which of the global row ids this rank holds of
    table (or axis) ``path`` (None: every one)."""
    axis = self._axis(path)
    if not self.split or axis is None:
      return None
    lo, hi = self.ranges[axis]
    return (ids >= lo) & (ids < hi)

  def localize(self, path, ids):
    """Local row ids of ``ids`` in the rank's rows of ``path``, -1 where
    another rank holds the row (the row scatter skips those)."""
    owned = self.owned(path, ids)
    if owned is None:
      return ids
    return torch.where(owned, ids - self.ranges[self._axis(path)][0], -1)

  def take(self, path, table, ids):
    """``table[ids]`` of a split table: the rank's rows of the global
    ids, zero where another rank holds the row; the whole local table
    for ids None (the rank's columns of the catalog)."""
    if ids is None:
      return table
    owned = self.owned(path, ids)
    if owned is None:
      return table.index_select(0, ids)
    local = torch.where(owned, ids - self.ranges[self._axis(path)][0], 0)
    return self.mask(table.index_select(0, local), owned)

  @staticmethod
  def mask(rows, owned):
    """``rows`` with the slots of ``owned`` False zeroed (None: all
    kept)."""
    if owned is None:
      return rows
    keep = owned.view(-1, *([1] * (rows.dim() - 1)))
    return torch.where(keep, rows, torch.zeros((), dtype=rows.dtype,
                                               device=rows.device))

  def columns(self, x):
    """The rank's columns ``[..., lo:hi]`` of a whole-catalog ``x`` (all
    of them when the tables are whole)."""
    if not self.split:
      return x
    lo, hi = self.ranges['item']
    return x[..., lo:hi]

  def reduce_partial(self, x):
    """The sum over 'model' of the ranks' partial products (the
    backward passes the gradient through)."""
    return collectives.sum_forward(x, self.mesh.model_group)

  def share(self, h):
    """``h`` as it is; in the backward pass, the ranks' gradients added
    over 'model' (each rank decodes other columns)."""
    return collectives.sum_backward(h, self.mesh.model_group)


def split_sizes(n, mesh, axis='model'):
  """Each rank's row count of ``n`` rows split over ``axis``."""
  parts = mesh.shape[axis]
  return [row_range(n, parts, i)[1] - row_range(n, parts, i)[0]
          for i in range(parts)]
