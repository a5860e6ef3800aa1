"""On-device training data: a resident dense slab, or item-union batches.

Port of the parts of ``recoder_tpu/data/device_pipeline.py``'s
``DeviceDataSource`` that the port's training paths use.

**Full decode** (``maybe_cache_slabs``, ``build_fd_batch``, the JAX
``_build_fd_from_cache``): a user's dense input row spans the whole
padded catalog and does not depend on which batch the user lands in, so
the whole densified matrix ``[num_users_padded, num_items_padded]`` is
built on the device once and each step fetches its ``batch_size`` rows:
one contiguous slice in 'blocks' mode, one row gather in 'users' mode.
Two storage tiers, as in JAX:

  * the **dense** tier stores the values: bf16 when every stored value
    round-trips exactly (binary data always does), else float32; the
    step upcasts, so the values -- and the gradients -- are those of a
    float32 slab. At the ML-20M shape the slab is 117,000 x 20,224
    bf16, about 4.7 GB;
  * the **packed** tier (binary data only) stores one bit a cell,
    ``[n_pad, width / 32]`` int32 words (column ``c``: bit ``c & 31`` of
    word ``c >> 5``, the JAX uint32 words' bits), 16x smaller than bf16:
    at bench.py's MSD shape 571,500 x 1,288 words, about 2.9 GB, where
    the bf16 slab (47.1 GB) exceeds half of an 80 GB card. Each step
    fetches and unpacks its rows in one launch (``ops/packed_rows.py``)
    to exactly the dense tier's bf16 rows, with the step's loss columns.

**Item-union batches** (``prepare_union``, ``build_union_batch``: the
negative-sampling union of the reference's collator, ``np.unique(cols,
return_inverse=True)`` over the batch's interactions). Each step gives
the batch's sorted item union and its interactions as (row, compressed
column, value) triplets:

  * 'blocks' mode keeps users in fixed contiguous blocks, so every
    block's union is epoch-invariant and is computed once on the host
    (the JAX ``_block_tables``). The compressed column and the row of
    each interaction are stored aligned with the CSR, so a step serves
    three contiguous device slices (the JAX precomputed branch of
    ``build_batch``);
  * 'users' mode draws fresh users each step: their CSR ranges are
    gathered on the device and the union is ``torch.unique(sorted=True,
    return_inverse=True)`` over the gathered columns (the semantics of
    the JAX ``_unique_union`` / ``_build_epoch_tables``).

The JAX package pads every union to a static width with a sentinel item
and every interaction list to a static nnz budget, and rebuilds the
source with larger budgets when a batch overflows them: XLA needs static
shapes. Each step here has its exact sizes, so nothing overflows and
nothing is rebuilt. The sentinel slots contribute exactly zero in JAX
(zero input column, masked loss column, zero gradient that leaves a
zero-moment row unchanged under Adam), so exact widths change no number
beyond reduction order.

**Epoch order.** 'users' mode draws the order as the JAX package does
(``_host_epoch_perm``): numpy ``default_rng([seed + 1, epoch])``, then
the pad users, so both train the same epochs. 'blocks' mode shuffles
the block order with a ``torch.Generator``; JAX draws it with
``jax.random.permutation``, which torch cannot reproduce, so tests
inject it.

Differences from the JAX source, on purpose:
  * where the JAX source declines both tiers and falls back to a
    per-step triplet scatter (non-binary data over the 'auto' budget, a
    packed slab over it, a packed request on non-binary data or at a
    width that is not a multiple of 32, explicit zero values), the port
    raises with the JAX reason: it does not have that path yet. This is
    the one difference in which tier serves a request;
  * the slab request is recorded when a cached slab is reused (the
    JAX source's reuse path returns without updating ``_slab_request``).

**Dual CSRs** (``target_matrix``, 'blocks' mode only, as in JAX): a
second CSR holds each user's target interactions, and each block's
target union is computed on the host as the input's is, independently
of it (the reference collates input and target windows each with its
own ``np.unique``). ``build_union_batch`` then returns the target union
and triplets beside the input's. The JAX source serves both sides from
precomputed block tables and declines when either side's tables exceed
``PRECOMPUTE_BYTE_BUDGET``; the port raises
:class:`FusedPipelineUnavailable` there with the JAX reason, computed
from the bytes the JAX tables would take, and its trainer then takes
the host loader, as the JAX trainer does.

Not ported yet: the per-step triplet scatter, random extra negatives,
mega-batches wider than one compute batch, and mesh sharding.
"""

import logging
import math

import numpy as np
import torch

from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.ops.packed_rows import unpack_rows

log = logging.getLogger(__name__)


class FusedPipelineUnavailable(ValueError):
  """This configuration cannot be served by the on-device source (block
  tables past the byte budget with a target matrix): ``Recoder.train``
  then takes the host loader, as the JAX trainer does."""


def _jax_table_bytes(tables, indptr, n_blocks, mega, n_users):
  """Bytes of the JAX package's precomputed block tables of one CSR
  (``_block_tables``): ``n_blocks x (2 x nnz budget + union width)``
  int32, the budget the largest block nnz aligned up to 1024
  (``_exact_block_budget``), the width the largest block union aligned
  up to 128."""
  edges = np.minimum(np.arange(n_blocks + 1) * mega, n_users)
  block_nnz = np.diff(indptr[edges])
  budget = (max(int(block_nnz.max(initial=0)), 1) + 1023) // 1024 * 1024
  width = int(np.diff(tables['ptr']).max(initial=1))
  width = (width + 127) // 128 * 128
  return n_blocks * (2 * budget + width) * 4


def canonical_csr(matrix):
  """``matrix`` as CSR without duplicate entries."""
  matrix = matrix.tocsr()
  if not matrix.has_canonical_format:
    matrix = matrix.copy()
    matrix.sum_duplicates()
  return matrix


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
    device: where the slab and the union arrays live: the card ('cuda')
      unless the caller asks for 'cpu'.
    seed (int): seed of the epoch orders.
    target_matrix (scipy.sparse.csr_matrix, optional): the users' target
      interactions ('blocks' mode only); union batches then carry the
      target side too.
  """

  #: fraction of the device's free memory the 'auto' request may claim
  SLAB_CACHE_MEMORY_FRACTION = 0.5
  #: bytes of one CSR's JAX block tables past which the JAX source
  #: declines a target matrix
  PRECOMPUTE_BYTE_BUDGET = 2 << 30

  def __init__(self, matrix, batch_size, num_sampling_users, num_items,
               shuffle='users', device=device_lib.DEFAULT, seed=0,
               target_matrix=None):
    if shuffle not in ('users', 'blocks'):
      raise ValueError(f'shuffle={shuffle!r}: expected users or blocks')
    if target_matrix is not None and shuffle != 'blocks':
      raise ValueError('target_matrix requires shuffle="blocks" (the JAX '
                       'source serves both sides from block tables)')
    if num_sampling_users != batch_size:
      raise ValueError('full decode reads the loss columns off one '
                       'compute batch: num_sampling_users must equal '
                       f'batch_size (got {num_sampling_users} vs '
                       f'{batch_size})')
    matrix = canonical_csr(matrix)
    self.matrix = matrix
    self.shuffle = shuffle
    self.device = device_lib.resolve(device)
    self.num_users_total = matrix.shape[0]
    self.num_items = int(num_items)
    self.batch_size = batch_size
    self.mega = num_sampling_users
    self.steps_per_epoch = math.ceil(self.num_users_total / batch_size)
    self.n_pad = math.ceil(self.num_users_total / self.mega) * self.mega
    self.n_blocks = self.n_pad // self.mega

    self.seed = int(seed)
    self.binary = bool(np.all(matrix.data == 1.0))

    self.d_slab = None
    self._slab_width = None
    self._slab_packed = False
    self._slab_request = None  # the request that established the cache

    self._offsets = None  # arange(batch_size) on the device
    self._host_tables = None  # blocks mode: per-block unions (numpy)
    self._union = None  # device arrays of the union path
    self.target_matrix = None
    self._tg_tables = None  # the target side's per-block unions
    if target_matrix is not None:
      self._init_target_side(canonical_csr(target_matrix))

  def _init_target_side(self, target):
    """Check both sides against the JAX tables' byte budget and compute
    the target side's block unions (the JAX ``_init_target_side``)."""
    if target.shape[0] != self.num_users_total:
      raise ValueError('target matrix must cover the same users')
    args = (self.n_blocks, self.mega, self.num_users_total)
    budget = self.PRECOMPUTE_BYTE_BUDGET
    if _jax_table_bytes(self._block_unions(), self.matrix.indptr,
                        *args) > budget:
      raise FusedPipelineUnavailable(
          'target_matrix needs the precomputed block tables (input side '
          'exceeded the byte budget)')
    tables = self._block_tables_of(target)
    if _jax_table_bytes(tables, target.indptr, *args) > budget:
      raise FusedPipelineUnavailable(
          'target-side block tables exceed the byte budget')
    self.target_matrix = target
    self._tg_tables = tables

  # -- resident dense slab ------------------------------------------------

  def maybe_cache_slabs(self, width, request='auto'):
    """Build the resident slab at catalog width ``width`` (the JAX tier
    rule).

    ``request``: 'auto' builds the dense tier when it fits
    ``SLAB_CACHE_MEMORY_FRACTION`` of the device's free memory, and
    otherwise the packed tier when the data is binary, ``width % 32 ==
    0`` and the packed slab fits; True builds the dense tier without the
    check; 'packed' builds the packed tier (binary data only); False
    drops the slab. A slab of the same width is reused unless a forced
    request (True, 'packed') names the other tier. Returns whether a
    slab is resident. Where the JAX source declines to its per-step
    scatter, this raises with its reason (MemoryError over the budget,
    ValueError otherwise) and drops any slab it held.
    """
    if request is False:
      self._drop_slab()
      return False
    if request not in ('auto', True, 'packed'):
      raise ValueError(f"slab_cache={request!r}: expected 'auto', True, "
                       "'packed' or False")
    width = int(width)
    if self.d_slab is not None and self._slab_width == width and not (
        (request is True and self._slab_packed)
        or (request == 'packed' and not self._slab_packed)):
      self._slab_request = request
      return True
    if width <= self.num_items:
      raise ValueError(f'slab width {width} must exceed the catalog '
                       f'({self.num_items}) by the sentinel column')
    if request == 'packed' and not self.binary:
      self._decline(ValueError, "slab_cache='packed' requires binary "
                    '(all-ones) values')
    data = self.matrix.data.astype(np.float32)
    if not np.all(data != 0.0):
      self._decline(ValueError, 'the matrix stores explicit zero values; a '
                    'dense slab cannot represent them')
    exact = np.array_equal(
        torch.from_numpy(data).to(torch.bfloat16).float().numpy(), data)
    dtype = torch.bfloat16 if exact else torch.float32
    packed = request == 'packed'
    packed_bytes = self.n_pad * (width // 32) * 4
    nbytes = packed_bytes if packed else self.n_pad * width * (
        2 if exact else 4)
    if request == 'auto':
      budget = self._memory_budget()
      if budget is not None and nbytes > budget:
        if self.binary and width % 32 == 0 and packed_bytes <= budget:
          packed, nbytes = True, packed_bytes  # the 1-bit tier fits
        else:
          self._decline(MemoryError, f'{nbytes / 2**30:.2f} GiB exceeds the '
                        f'free-memory budget of {budget / 2**30:.2f} GiB '
                        '(slab_cache=True forces the dense tier)')
    if packed and width % 32 != 0:
      self._decline(ValueError, f'packed tier needs width % 32 == 0 (got '
                    f'{width})')
    self._drop_slab()  # free a slab of another width or tier first
    self.d_slab = (self._build_slab_packed(width) if packed
                   else self._build_slab(width, dtype))
    self._slab_width = width
    self._slab_packed = packed
    self._slab_request = request
    log.info('slab resident: [%d, %d] %s (%.2f GiB)', self.n_pad, width,
             'bit-packed' if packed else str(dtype).replace('torch.', ''),
             nbytes / 2**30)
    return True

  def _drop_slab(self):
    self.d_slab = None
    self._slab_width = None
    self._slab_packed = False
    self._slab_request = None

  def _decline(self, error, reason):
    """Raise where the JAX source falls back to its per-step scatter."""
    self._drop_slab()
    raise error(f'no resident slab: {reason}. The JAX package falls back '
                'to a per-step triplet scatter here, which is not ported')

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

  def _build_slab_packed(self, width):
    """One densify of the CSR into ``[n_pad, width / 32]`` int32 words
    on the device (the JAX ``_build_slab_cache_packed``). Each cell's
    bit is added once (canonical CSR), so the add is a bitwise OR:
    distinct powers of two never carry, and bit 31's add (the int32
    minimum) lands on a sum of the lower bits without overflow. Columns
    at or above ``num_items`` drop their bit: the loss mask read off the
    rows must not hold a padding column."""
    m = self.matrix
    n_words = width // 32
    counts = np.diff(m.indptr)
    rows = np.repeat(np.arange(self.num_users_total, dtype=np.int64), counts)
    cols = m.indices.astype(np.int64)
    keep = cols < self.num_items
    rows, cols = rows[keep], cols[keep]
    bits = np.left_shift(np.uint32(1), (cols & 31).astype(np.uint32))
    flat = torch.from_numpy(rows * n_words + (cols >> 5)).to(self.device)
    packed = torch.zeros((self.n_pad, n_words), dtype=torch.int32,
                         device=self.device)
    packed.view(-1).index_add_(
        0, flat, torch.from_numpy(bits.view(np.int32)).to(self.device))
    return packed

  # -- per-epoch order and per-step batches -------------------------------

  def epoch_permutation(self, epoch):
    """Epoch ``epoch``'s order (a CPU int64 tensor): shuffled user ids
    padded with the pad users ('users'), or shuffled block indices
    ('blocks').

    'users' mode draws it as the JAX ``_host_epoch_perm`` does, so the
    two packages train the same epochs. The partially filled tail block
    is pinned to the last slot: the epoch's ``ceil(num_users /
    batch_size)`` steps cover every real user only if the block whose
    trailing rows are padding is the one the last step takes."""
    if self.shuffle == 'blocks':
      generator = torch.Generator().manual_seed(
          ((self.seed + 1) << 32) + int(epoch))
      if self.n_pad > self.num_users_total and self.n_blocks > 1:
        head = torch.randperm(self.n_blocks - 1, generator=generator)
        return torch.cat([head, torch.tensor([self.n_blocks - 1])])
      return torch.randperm(self.n_blocks, generator=generator)
    rng = np.random.default_rng([self.seed + 1, int(epoch)])
    return torch.from_numpy(np.concatenate(
        [rng.permutation(self.num_users_total),
         np.arange(self.num_users_total, self.n_pad)]).astype(np.int64))

  def fd_batch(self, perm, step):
    """Step ``step``'s full-decode payload off the slab, without a host
    read: ``perm`` is the epoch order on the device, ``step`` a 0-dim
    int64 device tensor (a CUDA graph replays the same call with the
    step the device counter holds).

    Returns ``{'slab': [B, width] rows on the device (the dense tier's
    storage dtype; bf16 zeros and ones from the packed tier), 'users':
    [B] user ids on the device (pad slots hold num_users), 'num_users':
    the valid user count as a 0-dim float32 device tensor, at least 1}``,
    and from the packed tier ``'col_mask'``: [width] float32, 1 on the
    columns the batch touched inside the catalog (what the trainer
    otherwise reads off the rows). Both shuffles gather the rows by
    index: 'blocks' the block's ``perm[step] * batch + arange(batch)``.
    """
    if self.d_slab is None:
      raise RuntimeError('no resident slab: call maybe_cache_slabs first')
    B = self.batch_size
    if self._offsets is None:
      self._offsets = torch.arange(B, device=self.device)
    if self.shuffle == 'blocks':
      rows = perm.index_select(0, step.view(1)) * self.mega + self._offsets
    else:
      rows = perm.index_select(0, step * B + self._offsets)
    out = {}
    if self._slab_packed:
      # the kernel clamps indices into the slab; rows < n_pad always
      slab, out['col_mask'] = unpack_rows(self.d_slab, self.num_items,
                                          index=rows)
    else:
      slab = self.d_slab.index_select(0, rows)
    n = self.num_users_total
    out.update(slab=slab, users=torch.clamp(rows, max=n),
               num_users=torch.clamp(torch.sum(rows < n), min=1).float())
    return out

  def build_fd_batch(self, perm, step_idx):
    """:meth:`fd_batch` from a host order and step: ``perm`` an int64
    tensor, ``step_idx`` an int. The same payload with 'users' on the CPU
    and 'num_users' a float (a host read)."""
    out = self.fd_batch(perm.to(self.device),
                        torch.tensor(int(step_idx), device=self.device))
    out['users'] = out['users'].cpu()
    out['num_users'] = float(out['num_users'])
    return out

  # -- item-union batches ---------------------------------------------------

  def _block_unions(self):
    """The per-block unions of 'blocks' mode, on the host, computed once
    (the JAX ``_block_tables``): for each fixed block of users,
    ``np.unique(cols, return_inverse=True)`` over its interactions.

    Returns ``{'cols': compressed column of every interaction, 'rows':
    its user's row within the block (both aligned with the CSR),
    'unions': the blocks' unions concatenated, 'ptr': block b's union
    is unions[ptr[b]:ptr[b + 1]]}``."""
    if self._host_tables is None:
      self._host_tables = self._block_tables_of(self.matrix)
    return self._host_tables

  def _block_tables_of(self, m):
    """:meth:`_block_unions` of the CSR ``m`` (the input's or the
    target's)."""
    S, n = self.mega, self.num_users_total
    indptr = m.indptr.astype(np.int64)
    cols = np.empty(m.nnz, np.int64)
    unions = []
    ptr = np.zeros(self.n_blocks + 1, np.int64)
    for b in range(self.n_blocks):
      lo, hi = indptr[b * S], indptr[min((b + 1) * S, n)]
      u, inv = np.unique(m.indices[lo:hi], return_inverse=True)
      cols[lo:hi] = inv
      unions.append(u.astype(np.int64))
      ptr[b + 1] = ptr[b] + len(u)
    rows = np.repeat(np.arange(n, dtype=np.int64) % S, np.diff(indptr))
    return {'cols': cols, 'rows': rows, 'ptr': ptr,
            'unions': (np.concatenate(unions) if unions
                       else np.zeros(0, np.int64))}

  def union_width(self):
    """The union width by which the JAX trainer's 'auto' rule picks full
    decode (``num_items_padded <= 4 * union_width``): the largest block
    union aligned up to 128 in 'blocks' mode (the JAX ``_block_tables``
    width), the largest union of four sampled random user windows with
    an 8% margin, aligned up to 256, in 'users' mode (the JAX loader's
    ``_estimate_widths``)."""
    if self.shuffle == 'blocks':
      w = int(np.diff(self._block_unions()['ptr']).max(initial=1))
      return (w + 127) // 128 * 128
    m, n = self.matrix, self.num_users_total
    rng = np.random.default_rng(1234)
    widest = 1
    for _ in range(4):
      idx = rng.choice(n, size=min(self.mega, n), replace=False)
      cols = [m.indices[m.indptr[i]:m.indptr[i + 1]] for i in idx]
      if cols:
        widest = max(widest, len(np.unique(np.concatenate(cols))))
    return (int(widest * 1.08) + 255) // 256 * 256

  def prepare_union(self):
    """Put on the device, once, what the union batches read: the
    per-block compressed columns, rows and unions ('blocks'), or the
    CSR columns ('users'); and the values unless they are all ones."""
    if self._union is not None:
      return
    m = self.matrix
    arrays = {}
    if not self.binary:
      arrays['vals'] = m.data.astype(np.float32)
    if self.shuffle == 'blocks':
      t = self._block_unions()
      arrays.update(cols=t['cols'], rows=t['rows'], unions=t['unions'])
      if self._tg_tables is not None:
        t = self._tg_tables
        arrays.update(tg_cols=t['cols'], tg_rows=t['rows'],
                      tg_unions=t['unions'])
        if not np.all(self.target_matrix.data == 1.0):
          arrays['tg_vals'] = self.target_matrix.data.astype(np.float32)
    else:
      arrays['cols'] = m.indices.astype(np.int64)
      indptr = m.indptr.astype(np.int64)
      # per-user nnz and CSR start; the pad users' slot n holds 0 and 0
      self._counts = np.append(np.diff(indptr), 0)
      self._starts = np.append(indptr[:-1], 0)
    self._union = {k: torch.from_numpy(v).to(self.device)
                   for k, v in arrays.items()}

  def build_union_batch(self, perm, step_idx):
    """Step ``step_idx``'s item-union batch.

    Returns ``{'items': [W] the batch's item union, ascending, on the
    device; 'rows', 'cols', 'vals': [nnz] row in the batch, index into
    items and value of each interaction, on the device; 'users': [B] CPU
    user ids (pad slots hold num_users); 'num_users': valid user count
    as a float, at least 1}``. The union holds exactly the items the
    batch's users touched. With a target matrix, ``'tg_items'``,
    ``'tg_rows'``, ``'tg_cols'`` and ``'tg_vals'`` are the same for the
    block's target interactions, over the target union.
    """
    self.prepare_union()
    B, n = self.batch_size, self.num_users_total
    arrays, dev = self._union, self.device
    indptr = self.matrix.indptr
    if self.shuffle == 'blocks':
      b = int(perm[step_idx])
      lo = b * self.mega
      s, e = int(indptr[lo]), int(indptr[min(lo + B, n)])
      ptr = self._host_tables['ptr']
      items = arrays['unions'][int(ptr[b]):int(ptr[b + 1])]
      rows, cols = arrays['rows'][s:e], arrays['cols'][s:e]
      users = torch.arange(lo, lo + B)
      src = slice(s, e)
    else:
      users = perm[step_idx * B:(step_idx + 1) * B]
      u = np.minimum(users.numpy(), n)
      counts, starts = self._counts[u], self._starts[u]
      nnz = int(counts.sum())
      adjust = torch.from_numpy(starts - (np.cumsum(counts) - counts))
      rows = torch.repeat_interleave(
          torch.arange(B, device=dev), torch.from_numpy(counts).to(dev),
          output_size=nnz)
      src = adjust.to(dev)[rows] + torch.arange(nnz, device=dev)
      items, cols = torch.unique(arrays['cols'][src], sorted=True,
                                 return_inverse=True)
    vals = (arrays['vals'][src] if 'vals' in arrays
            else torch.ones(rows.shape[0], device=dev))
    num_users = int(torch.sum(users < n))
    out = {'items': items, 'rows': rows, 'cols': cols, 'vals': vals,
           'users': torch.clamp(users, max=n),
           'num_users': float(max(num_users, 1))}
    if self._tg_tables is not None:
      # the same block's target interactions, over its own union
      t_indptr = self.target_matrix.indptr
      s, e = int(t_indptr[lo]), int(t_indptr[min(lo + B, n)])
      ptr = self._tg_tables['ptr']
      out.update(
          tg_items=arrays['tg_unions'][int(ptr[b]):int(ptr[b + 1])],
          tg_rows=arrays['tg_rows'][s:e], tg_cols=arrays['tg_cols'][s:e],
          tg_vals=(arrays['tg_vals'][s:e] if 'tg_vals' in arrays
                   else torch.ones(e - s, device=dev)))
    return out
