"""On-device training data for full-decode steps: a resident dense slab.

Port of the part of ``recoder_tpu/data/device_pipeline.py``'s
``DeviceDataSource`` that full decode uses. In full-decode mode a
user's dense input row spans the whole padded catalog and does not
depend on which batch the user lands in, so the whole densified matrix
``[num_users_padded, num_items_padded]`` is built on the device once
(``maybe_cache_slabs``) and each step fetches its ``batch_size`` rows:
one contiguous slice in 'blocks' mode, one row gather in 'users' mode
(``build_fd_batch``, the JAX ``_build_fd_from_cache``). Storage is
bf16 when every stored value round-trips exactly (binary data always
does), else float32; the step upcasts, so the values -- and the
gradients -- are those of a float32 slab. At the ML-20M shape the slab
is 117,000 x 20,224 bf16, about 4.7 GB.

Differences from the JAX source, on purpose:
  * no fallback: a slab that is not eligible, or does not fit the
    'auto' memory budget, raises (the JAX source falls back to a
    per-step triplet scatter, which the port does not have);
  * the slab request is recorded when a cached slab is reused (the
    JAX source's reuse path returns without updating ``_slab_request``);
  * the epoch permutation comes from a ``torch.Generator`` (the JAX
    package draws it with ``jax.random``; the two streams differ, so
    tests inject permutations).

Not ported yet: the union (gathered) batch build and its overflow
budgets, users-mode per-epoch tables, the packed 1-bit slab tier,
random extra negatives, dual (target) CSRs, mega-batches wider than one
compute batch, and mesh sharding.
"""

import logging
import math

import numpy as np
import torch

log = logging.getLogger(__name__)


class DeviceDataSource:
  """A training CSR matrix densified once into a slab on ``device``.

  Args:
    matrix (scipy.sparse.csr_matrix): user-item interactions.
    batch_size (int): users per compute batch.
    num_sampling_users (int): mega-batch size; full decode reads its
      loss columns off each batch's own slab rows, so it must equal
      ``batch_size``.
    num_items (int): logical catalog size.
    shuffle (str): 'users' draws every batch as a fresh random user
      subset; 'blocks' keeps users in fixed contiguous blocks and
      shuffles the block order each epoch.
    device: where the slab lives.
  """

  #: fraction of the device's free memory the 'auto' request may claim
  SLAB_CACHE_MEMORY_FRACTION = 0.5

  def __init__(self, matrix, batch_size, num_sampling_users, num_items,
               shuffle='users', device='cpu'):
    if shuffle not in ('users', 'blocks'):
      raise ValueError(f'shuffle={shuffle!r}: expected users or blocks')
    if num_sampling_users != batch_size:
      raise ValueError('full decode reads the loss columns off one '
                       'compute batch: num_sampling_users must equal '
                       f'batch_size (got {num_sampling_users} vs '
                       f'{batch_size})')
    matrix = matrix.tocsr()
    if not matrix.has_canonical_format:
      matrix = matrix.copy()
      matrix.sum_duplicates()
    self.matrix = matrix
    self.shuffle = shuffle
    self.device = torch.device(device)
    self.num_users_total = matrix.shape[0]
    self.num_items = int(num_items)
    self.batch_size = batch_size
    self.mega = num_sampling_users
    self.steps_per_epoch = math.ceil(self.num_users_total / batch_size)
    self.n_pad = math.ceil(self.num_users_total / self.mega) * self.mega
    self.n_blocks = self.n_pad // self.mega

    self.d_slab = None
    self._slab_width = None
    self._slab_request = None  # the request that established the cache

  # -- resident dense slab ------------------------------------------------

  def maybe_cache_slabs(self, width, request='auto'):
    """Build the resident slab at catalog width ``width``.

    ``request``: 'auto' builds it when it fits
    ``SLAB_CACHE_MEMORY_FRACTION`` of the device's free memory and
    raises otherwise; True skips that check; False drops the slab.
    Returns whether a slab is resident. Raises when the matrix stores
    explicit zeros: a dense slab cannot hold them, so the loss mask
    read off the slab would differ from the matrix's.
    """
    if request is False:
      self.d_slab = None
      self._slab_width = None
      self._slab_request = None
      return False
    if request not in ('auto', True):
      raise ValueError(f"slab_cache={request!r}: expected 'auto', True or "
                       'False')
    width = int(width)
    if self.d_slab is not None and self._slab_width == width:
      self._slab_request = request
      return True
    if width <= self.num_items:
      raise ValueError(f'slab width {width} must exceed the catalog '
                       f'({self.num_items}) by the sentinel column')
    data = self.matrix.data.astype(np.float32)
    if not np.all(data != 0.0):
      raise ValueError('the matrix stores explicit zero values; a dense '
                       'slab cannot represent them')
    exact = np.array_equal(
        torch.from_numpy(data).to(torch.bfloat16).float().numpy(), data)
    dtype = torch.bfloat16 if exact else torch.float32
    nbytes = self.n_pad * width * (2 if exact else 4)
    if request == 'auto':
      budget = self._memory_budget()
      if budget is not None and nbytes > budget:
        raise MemoryError(
            f'the dense slab needs {nbytes / 2**30:.2f} GiB, over the '
            f'budget of {budget / 2**30:.2f} GiB (slab_cache=True skips '
            'the check)')
    self.d_slab = None  # free a slab of another width before the build
    self._slab_width = None
    self.d_slab = self._build_slab(width, dtype)
    self._slab_width = width
    self._slab_request = request
    log.info('dense slab resident: [%d, %d] %s (%.2f GiB)', self.n_pad,
             width, str(dtype).replace('torch.', ''), nbytes / 2**30)
    return True

  def _memory_budget(self):
    if self.device.type != 'cuda':
      return None  # host memory: the build itself is the check
    free, _ = torch.cuda.mem_get_info(self.device)
    return int(self.SLAB_CACHE_MEMORY_FRACTION * free)

  def _build_slab(self, width, dtype):
    """One densify of the CSR into ``[n_pad, width]`` on the device.

    Each cell receives at most one value (canonical CSR), and bf16 is
    chosen only when every value is exact in it, so writing straight in
    the storage dtype is exact. Pad user rows stay zero.
    """
    m = self.matrix
    counts = np.diff(m.indptr)
    rows = torch.from_numpy(
        np.repeat(np.arange(self.num_users_total, dtype=np.int64), counts))
    cols = torch.from_numpy(m.indices.astype(np.int64))
    vals = torch.from_numpy(m.data.astype(np.float32))
    keep = cols < self.num_items
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    slab = torch.zeros((self.n_pad, width), dtype=dtype, device=self.device)
    slab.index_put_((rows.to(self.device), cols.to(self.device)),
                    vals.to(device=self.device, dtype=dtype))
    return slab

  # -- per-epoch order and per-step batches -------------------------------

  def epoch_permutation(self, generator):
    """Per-epoch shuffle (a CPU int64 tensor): shuffled user ids padded
    with the pad users ('users'), or shuffled block indices ('blocks').

    The partially filled tail block is pinned to the last slot: the
    epoch's ``ceil(num_users / batch_size)`` steps cover every real
    user only if the block whose trailing rows are padding is the one
    the last step takes."""
    if self.shuffle == 'blocks':
      if self.n_pad > self.num_users_total and self.n_blocks > 1:
        head = torch.randperm(self.n_blocks - 1, generator=generator)
        return torch.cat([head, torch.tensor([self.n_blocks - 1])])
      return torch.randperm(self.n_blocks, generator=generator)
    perm = torch.randperm(self.num_users_total, generator=generator)
    pad = torch.arange(self.num_users_total, self.n_pad)
    return torch.cat([perm, pad])

  def build_fd_batch(self, perm, step_idx):
    """Step ``step_idx``'s full-decode payload off the slab.

    Returns ``{'slab': [B, width] storage-dtype rows on the device,
    'users': [B] CPU user ids (pad slots hold num_users),
    'num_users': valid user count as a float, at least 1}``. Every
    count is known on the host, so no step waits on the device.
    """
    if self.d_slab is None:
      raise RuntimeError('no resident slab: call maybe_cache_slabs first')
    B = self.batch_size
    n = self.num_users_total
    if self.shuffle == 'blocks':
      ustart = int(perm[step_idx]) * self.mega
      slab = self.d_slab[ustart:ustart + B]
      users = torch.arange(ustart, ustart + B)
    else:
      users = perm[step_idx * B:(step_idx + 1) * B]
      idx = torch.clamp(users, max=self.n_pad - 1).to(self.device)
      slab = self.d_slab.index_select(0, idx)
    num_users = int(torch.sum(users < n))
    return {'slab': slab, 'users': torch.clamp(users, max=n),
            'num_users': float(max(num_users, 1))}
