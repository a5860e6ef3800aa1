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

Where neither tier is resident, a full-decode step scatters its
triplets instead (below).

**Mega-batches** (``num_sampling_users = S``, a multiple of
``batch_size = B``; the JAX ``slices_per_mega``): the epoch order is cut
into megas of S users that share one item union -- each user's negatives
are the other S - 1 users' positives -- and each mega is sliced into S / B
compute batches. Step ``i`` reads mega ``m = i // (S / B)`` and slice
``s = i % (S / B)``: 'users' mode's mega is ``perm[m * S:(m + 1) * S]``
(slice s: ``perm[i * B:(i + 1) * B]``), 'blocks' mode's ``perm[m] * S +
arange(S)`` (slice s: ``perm[m] * S + s * B + arange(B)``). The epoch
still has ``ceil(num_users / B)`` steps.

**Item-union batches** (``prepare_union``, the negative-sampling union
of the reference's collator, ``np.unique(cols, return_inverse=True)``
over the mega's interactions). Each step gives the mega's sorted item
union and its slice's interactions as (row, compressed column, value)
triplets:

  * 'blocks' mode keeps users in fixed contiguous megas, so every mega's
    union is epoch-invariant and is computed once on the host (the JAX
    ``_block_tables``) into a ``[n_blocks, W]`` table, each row filled
    past its union with the sentinel item ``num_items`` (a pad row of
    every item table), beside each block's valid width. A slice's users
    are contiguous, so its interactions are one contiguous CSR range,
    read at a fixed window of M entries from a start read off the
    device ``indptr`` (the JAX ``_csr_range``), M the largest slice nnz
    of the CSR. :meth:`union_batch` builds the step from device tensors
    and the device step counter alone, at static shapes -- ``items [W]``
    with its sentinel tail, ``width_valid`` a 0-dim device tensor, the
    M-entry triplets (the entries past the slice's nnz hold row ``B``,
    which the densify drops, and value 0), ``users`` and ``num_users``
    -- so a CUDA graph can record it (the JAX ``build_batch`` blocks
    branch). The sentinel columns contribute exactly zero: zero input,
    masked loss column, zero gradient that leaves a zero-moment row
    unchanged under Adam. Every block's union and nnz are known on the
    host, so W and M are exact maxima and nothing overflows: the JAX
    overflow accounting (``_note_overflow``, ``_rebuild_fused_source``)
    is not ported, by design. :meth:`build_union_batch` is the same
    batch trimmed to its exact sizes (a host read);
  * 'users' mode draws fresh users each epoch, but an epoch's megas are
    fixed once its order is drawn. Where the JAX source builds per-epoch
    tables (:attr:`users_precompute`, below) the port does so too: the
    same static batches then serve the 'users' steps, so a CUDA graph
    records them as it records the 'blocks' ones. Elsewhere each step
    gathers its mega's CSR ranges on the device and takes the union with
    ``torch.unique(sorted=True, return_inverse=True)`` (the semantics of
    the JAX ``_unique_union``), at its exact width
    (:meth:`build_union_batch`, host reads).

**'users' epoch tables** (:meth:`epoch_state`, the JAX
``users_precompute`` path). The JAX gate: 'users' mode without random
negatives or a target matrix, with two epochs of the JAX tables within
``PRECOMPUTE_BYTE_BUDGET``. An epoch's build runs a few batched ops on
the device, none a step: the epoch's CSR laid out in its order (an
``indptr`` over the ordered padded users, gathered from the resident
CSR: the JAX ``_epoch_gather_stage``), then, for union steps, one sort
of the ``mega x radix + column`` keys, whose first occurrences and ranks
give each mega's union, its width and each entry's compressed column
(the JAX ``_build_epoch_tables``). In that layout a mega's users are
contiguous, as a block's are, so :meth:`union_batch` and the 'blocks'
triplet scatter read the epoch with their 'blocks' code (the block
order the identity; the slice's users read off the order). The widths
are exact maxima rounded up the fixed ladder of :func:`_rung` (aligned
to 128, then ratio 26 / 25): the slice and mega windows from the host
counts, the largest union from the device -- the build's one host read.
So nothing overflows, and an epoch's widths (its *signature*) are a
function of the epoch and the data alone: a training resumed at an
epoch draws what the uninterrupted one drew. Each epoch's tables are
copied into buffers of fixed address for their signature (the last
``SIGNATURES`` are kept), so a graph recorded in one epoch replays in
the next epoch of the same signature. Full decode off a resident slab
needs no tables (the JAX rule): it reads the same host order.

**Random extra negatives** (``num_random_negatives = R``, the JAX
``build_batch`` draw): R item ids uniform in ``[0, num_items)`` join each
step's union only, so their columns have zero input and zero target; on
full decode they join the loss mask. The draw comes from ``neg_gen``, a
generator on the device keyed on the global step: seeded ``((seed + 7)
<< 32) + step`` for each step off the card (:meth:`seed_negatives`), or,
for the steps on the card that read the device step counter, one stream
placed at ``step x`` the offset one draw takes
(:meth:`position_negatives`), which a captured CUDA graph registers and
advances as eager steps do. Either way a resumed training draws what the
uninterrupted one drew, and the ids refresh across epochs. torch cannot
reproduce ``jax.random``'s ids: the builders take ``rand_ids`` for tests
to inject them. In 'blocks' mode the block's union row and the R ids
merge in the JAX fixed-shape ``_unique_union`` (one stable sort, first
occurrences, ranks) into a union of the static width ``align128(largest
block union + R)``, again exact.

**Full decode** reads the loss columns of the whole mega: the columns
where any of its S users has an interaction, plus the random ids, inside
the catalog. Off the resident slab the mega's columns are those where
any of its S slab rows is nonzero (the slab holds no zero value): the
dense tier reads ``any(slab[mega rows], 0)``, the packed tier ORs the
rows' bits in a mask-only launch of the unpack kernel. Every shape is
static (S rows, R ids), so the step stays capturable. The JAX source
declines the slab for ``S > B`` (its mask is read off the batch's own B
rows) and scatters; the port keeps the slab there, with the same
columns, values and losses (``tests/test_torch_negatives.py``).

**The per-step triplet scatter** (full decode without a resident slab:
``slab_cache=False``, or where both tiers decline): each step densifies
its slice's triplets at the padded catalog width (raw column ids; a
column at or past the width drops, as the JAX ``mode='drop'``), in the
dense tier's storage dtype, and builds the loss mask from the mega's
column ids, never from the values: an explicitly stored zero still marks
its column (the JAX ``_forward_loss``). In 'blocks' mode, and over the
'users' epoch tables, it reads the slice's and the mega's CSR ranges at
fixed windows, as the union batch does, so a graph can record it;
outside the JAX gate a 'users' step reads its step and order on the
host and runs eagerly.

**Epoch order.** 'users' mode draws the order as the JAX package does
(``_host_epoch_perm``): numpy ``default_rng([seed + 1, epoch])``, then
the pad users, so both train the same epochs (where the JAX source
builds no epoch tables -- with random negatives or tables past its
budget -- it draws the order with ``jax.random`` instead, which torch
cannot reproduce). 'blocks' mode shuffles
the mega order with a ``torch.Generator``; JAX draws it with
``jax.random.permutation``, which torch cannot reproduce, so tests
inject it.

Differences from the JAX source, on purpose:
  * the slab serves megas wider than one compute batch (above);
  * the slab request is recorded when a cached slab is reused (the
    JAX source's reuse path returns without updating ``_slab_request``).

**Dual CSRs** (``target_matrix``, 'blocks' mode without random
negatives only, as in JAX): a second CSR holds each user's target
interactions, and each mega's target union is computed on the host as
the input's is, independently of it (the reference collates input and
target windows each with its own ``np.unique``). The union batches then
carry the target union and triplets beside the input's, at the target
side's own static width and window (``tg_*``, ``tg_width_valid``). The JAX
source serves both sides from precomputed block tables and declines
when either side's tables exceed ``PRECOMPUTE_BYTE_BUDGET``; the port
raises :class:`FusedPipelineUnavailable` there with the JAX reason,
computed from the bytes the JAX tables would take, and its trainer then
takes the host loader, as the JAX trainer does.

On a mesh (``Recoder(mesh=...)``) every rank builds the same source and
the same batches, the resident CSR, tables and slab replicated, as the
JAX ``_put`` replicates them; the trainer takes each rank's share of a
batch.

**'data'-sharded tables** (``table_sharding``, 'blocks' mode on a mesh,
the JAX ``_put_block_table`` / ``_put_csr_chunks``): the block union
table is row-split over the mesh's 'data' ranks (the block rows padded
to a multiple of them), and each flat CSR array (compressed and raw
columns, values; each padded by the largest window, the mega window,
its halo) is split into ``D`` chunks of ``ceil((len - halo) / D)``
entries, each held with the halo past its end, so that a window-wide range starting in a chunk lies
wholly in its rank's part. A step's fetch (:meth:`_table_row`,
:meth:`_fetch`) reads the range on its owner, the other ranks give
zeros, and one sum over 'data' returns it: no rank gathers a table. The
per-user ``indptr`` and the block widths stay replicated, as in JAX.
As in JAX, the tables split only past one 'data' rank
(``SHARD_MIN_DATA_RANKS``): 'data' then shards, and 'auto' past the JAX
byte budget (``SHARD_TABLES_BYTE_BUDGET``). Under 'data' sharding the
slab declines with the JAX reason, and full decode scatters its
triplets.
"""

import collections
import logging
import math

import numpy as np
import torch

from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch import trace
from recoder_tpu_torch.ops.packed_rows import unpack_mask, unpack_rows
from recoder_tpu_torch.parallel import collectives

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


def _align128(width):
  return (max(int(width), 1) + 127) // 128 * 128


def _window(indptr, users):
  """The largest nnz of the ``users``-user ranges that tile the padded
  users of ``indptr`` (at least 1): a static batch's fixed window."""
  return max(int(np.diff(indptr[::users]).max(initial=0)), 1)


def _rung(width):
  """``width`` aligned up to 128, then up to the next rung of a fixed
  ladder: 128, and after each rung ``align128(rung x 26 / 25)``. Integer
  arithmetic alone, so that every machine puts a width on the same
  rung."""
  width, rung = _align128(width), 128
  while rung < width:
    rung = _align128(rung * 26 // 25)
  return rung


def _jax_users_budget(counts, mega):
  """The JAX source's default 'users'-mode nnz budget of a mega
  (``mega_nnz_budget``): the largest nnz of 128 random windows of
  ``mega`` users (numpy ``default_rng(4321)``), plus 12% and 256,
  aligned up to 1024."""
  rng = np.random.default_rng(4321)
  n = len(counts)
  widest = 1
  for _ in range(128):
    idx = rng.choice(n, size=min(mega, n), replace=False)
    widest = max(widest, int(counts[idx].sum()))
  return (int(widest * 1.12) + 256 + 1023) // 1024 * 1024


def canonical_csr(matrix):
  """``matrix`` as CSR without duplicate entries."""
  matrix = matrix.tocsr()
  if not matrix.has_canonical_format:
    matrix = matrix.copy()
    matrix.sum_duplicates()
  return matrix


class DeviceDataSource:
  """A training CSR matrix on ``device``: a resident slab, union batches,
  or per-step scatters.

  Args:
    matrix (scipy.sparse.csr_matrix): user-item interactions.
    batch_size (int): users per compute batch.
    num_sampling_users (int): mega-batch size, a multiple of
      ``batch_size``: the users whose union one step's loss columns span.
    num_items (int): logical catalog size.
    shuffle (str): 'users' draws every mega as a fresh random user
      subset; 'blocks' keeps users in fixed contiguous megas and shuffles
      the mega order each epoch.
    device: where the slab and the union arrays live: the card ('cuda')
      unless the caller asks for 'cpu'.
    seed (int): seed of the epoch orders and of the random negatives.
    target_matrix (scipy.sparse.csr_matrix, optional): the users' target
      interactions ('blocks' mode without random negatives only); union
      batches then carry the target side too.
    num_random_negatives (int): R uniform-random extra negative items a
      step (module docstring).
    mesh (parallel.mesh.Mesh, optional): the trainer's mesh (every rank
      builds the same source).
    table_sharding ('auto' | 'data' | None): the 'blocks' tables' and
      CSR's layout on a mesh of more than one 'data' rank: 'data' split
      over the 'data' axis, 'auto' split past
      ``SHARD_TABLES_BYTE_BUDGET``, None (or any other value) replicated
      (module docstring).
  """

  #: fraction of the device's free memory the 'auto' request may claim
  SLAB_CACHE_MEMORY_FRACTION = 0.5
  #: bytes of one CSR's JAX block tables past which the JAX source
  #: declines a target matrix, and of two epochs of its 'users' tables
  #: past which it builds none
  PRECOMPUTE_BYTE_BUDGET = 2 << 30
  #: width signatures of the 'users' epoch tables whose buffers are kept
  SIGNATURES = 4
  #: replicated bytes of the JAX source's CSR and block tables past which
  #: ``table_sharding='auto'`` splits them over 'data'
  SHARD_TABLES_BYTE_BUDGET = 2 << 30
  #: the fewest 'data' ranks over which ``table_sharding`` splits the
  #: tables (the JAX rule: one rank would save nothing); a check of the
  #: split fetch on one card lowers it to 1
  SHARD_MIN_DATA_RANKS = 2

  def __init__(self, matrix, batch_size, num_sampling_users, num_items,
               shuffle='users', device=device_lib.DEFAULT, seed=0,
               target_matrix=None, num_random_negatives=0, mesh=None,
               table_sharding='auto'):
    if shuffle not in ('users', 'blocks'):
      raise ValueError(f'shuffle={shuffle!r}: expected users or blocks')
    if target_matrix is not None and (shuffle != 'blocks'
                                      or num_random_negatives):
      raise ValueError('target_matrix requires shuffle="blocks" without '
                       'random negatives (the JAX source serves both sides '
                       'from block tables)')
    if num_sampling_users < batch_size or num_sampling_users % batch_size:
      raise ValueError('num_sampling_users must be a multiple of batch_size '
                       f'(got {num_sampling_users} vs {batch_size})')
    matrix = canonical_csr(matrix)
    self.matrix = matrix
    self.shuffle = shuffle
    self.device = device_lib.resolve(device)
    self.num_users_total = matrix.shape[0]
    self.num_items = int(num_items)
    self.batch_size = batch_size
    self.mega = num_sampling_users
    self.slices_per_mega = self.mega // batch_size
    self.steps_per_epoch = math.ceil(self.num_users_total / batch_size)
    self.n_pad = math.ceil(self.num_users_total / self.mega) * self.mega
    self.n_blocks = self.n_pad // self.mega

    self.seed = int(seed)
    self.binary = bool(np.all(matrix.data == 1.0))
    self.num_random_negatives = int(num_random_negatives)
    #: the random negatives' generator (None without them)
    self.neg_gen = None
    self._neg_offset = None  # Philox offset one draw takes (on the card)
    if self.num_random_negatives:
      self.neg_gen = torch.Generator(device=self.device)
      self.seed_negatives(0)

    self.d_slab = None
    self._slab_width = None
    self._slab_packed = False
    self._slab_request = None  # the request that established the cache
    #: the full-decode width of the last slab request (the scatter's)
    self.fd_width = None
    #: why the last request left no slab resident (the JAX reason)
    self.decline_reason = None
    self._storage_dtype = None

    self._offsets = None  # arange(batch_size) on the device
    self._mega_offsets = None  # arange(num_sampling_users) on the device
    self._host_tables = None  # blocks mode: per-mega unions (numpy)
    self._csr = None  # the CSR's columns (and values) on the device
    #: device arrays of the static batches, by CSR side ('' the input's,
    #: 'tg_' the target's): the 'blocks' tables, or the placed 'users'
    #: epoch's
    self._static = {}
    self._epoch = None  # the placed 'users' epoch: key, signature, state
    self._prefetched = {}  # (epoch, full decode) -> tables not yet placed
    self._epoch_buffers = {}  # full decode? -> the fixed-address buffers
    #: width signature -> its buffers, the last SIGNATURES placed
    self._signatures = collections.OrderedDict()
    indptr = matrix.indptr.astype(np.int64)
    # per-user nnz and CSR start; the pad users' slot n holds 0 and 0
    self._counts = np.append(np.diff(indptr), 0)
    self._starts = np.append(indptr[:-1], 0)
    self.target_matrix = None
    self._tg_tables = None  # the target side's per-mega unions
    if target_matrix is not None:
      self._init_target_side(canonical_csr(target_matrix))
    self.mesh = mesh
    #: 'data' where the 'blocks' tables and CSR are split over 'data'
    self.table_sharding = None
    if (shuffle == 'blocks' and mesh is not None
        and mesh.shape['data'] >= self.SHARD_MIN_DATA_RANKS
        and (table_sharding == 'data' or (
            table_sharding == 'auto'
            and self._jax_resident_bytes() > self.SHARD_TABLES_BYTE_BUDGET))):
      self.table_sharding = 'data'
    #: whether 'users' steps read per-epoch tables (the JAX gate), and
    #: why not where they do not
    self.users_precompute = False
    self.precompute_reason = None
    if shuffle == 'users':
      if self.num_random_negatives:
        self.precompute_reason = 'random negatives'
      else:
        nbytes = 2 * self._jax_epoch_table_bytes()
        self.users_precompute = nbytes <= self.PRECOMPUTE_BYTE_BUDGET
        if not self.users_precompute:
          self.precompute_reason = (
              f'two epochs of tables take {nbytes / 2**30:.2f} GiB, past '
              f'the budget of {self.PRECOMPUTE_BYTE_BUDGET / 2**30:.2f} '
              'GiB')

  def _jax_resident_bytes(self):
    """The bytes by which the JAX source's 'auto' rule shards: its CSR
    (4 bytes an entry, 8 unless binary) and its block tables (both
    sides' with a target matrix)."""
    args = (self.n_blocks, self.mega, self.num_users_total)
    nbytes = self.matrix.nnz * (4 if self.binary else 8)
    nbytes += _jax_table_bytes(self._block_unions(), self.matrix.indptr,
                               *args)
    if self._tg_tables is not None:
      nbytes += _jax_table_bytes(self._tg_tables,
                                 self.target_matrix.indptr, *args)
    return nbytes

  def _jax_epoch_table_bytes(self):
    """Bytes of one epoch of the JAX 'users'-mode tables
    (``device_pipeline.py:300-303``): ``n_blocks x (2 M + W + 3)`` int32,
    and ``n_blocks x M`` values unless the data is binary, at the JAX
    source's nnz budget M and the union width W its trainer passes
    (:meth:`union_width`)."""
    M = _jax_users_budget(np.diff(self.matrix.indptr), self.mega)
    nbytes = self.n_blocks * (2 * M + self.union_width() + 3) * 4
    if not self.binary:
      nbytes += self.n_blocks * M * 4
    return nbytes

  def _init_target_side(self, target):
    """Check both sides against the JAX tables' byte budget and compute
    the target side's mega unions (the JAX ``_init_target_side``)."""
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

  # -- random extra negatives ---------------------------------------------

  def seed_negatives(self, global_step):
    """Seed ``neg_gen`` for global step ``global_step``'s draw (an eager
    step: union and sparse steps, full decode off the card)."""
    self.neg_gen.manual_seed(((self.seed + 7) << 32) + int(global_step))

  def position_negatives(self, global_step):
    """Place ``neg_gen`` where global step ``global_step``'s draw starts
    in one stream: seed ``(seed + 7) << 32``, Philox offset ``step x``
    the offset one draw takes (full-decode steps on the card, whose
    captured graphs register the generator)."""
    if self._neg_offset is None:
      probe = torch.Generator(device=self.device)
      probe.manual_seed(0)
      self._draw_negatives(probe)
      self._neg_offset = probe.get_offset()
    self.neg_gen.manual_seed((self.seed + 7) << 32)
    self.neg_gen.set_offset(int(global_step) * self._neg_offset)

  def _draw_negatives(self, generator):
    return torch.randint(0, self.num_items, (self.num_random_negatives,),
                         generator=generator, device=self.device)

  def _negatives(self, rand_ids, neg_step=None):
    """The step's random ids on the device: ``rand_ids`` when given,
    else a draw (after seeding it for ``neg_step`` when given)."""
    if rand_ids is not None:
      return torch.as_tensor(rand_ids).to(self.device, torch.int64)
    if neg_step is not None:
      self.seed_negatives(neg_step)
    return self._draw_negatives(self.neg_gen)

  # -- resident dense slab ------------------------------------------------

  def maybe_cache_slabs(self, width, request='auto'):
    """Build the resident slab at catalog width ``width`` (the JAX tier
    rule), or decline it.

    ``request``: 'auto' builds the dense tier when it fits
    ``SLAB_CACHE_MEMORY_FRACTION`` of the device's free memory, and
    otherwise the packed tier when the data is binary, ``width % 32 ==
    0`` and the packed slab fits; True builds the dense tier without the
    check; 'packed' builds the packed tier (binary data only); False
    drops the slab. A slab of the same width is reused unless a forced
    request (True, 'packed') names the other tier. Returns whether a
    slab is resident. Where the JAX source declines (an explicitly
    stored zero, non-binary data over the budget, a packed slab over it
    or at a width that is not a multiple of 32, a packed request on
    non-binary data), this drops any slab it held, logs the JAX reason
    (``decline_reason``) and returns False: full-decode steps at
    ``width`` then scatter their triplets (:meth:`fd_batch`). Unlike the
    JAX source it does not decline for ``num_sampling_users >
    batch_size`` (module docstring).
    """
    width = int(width)
    self.fd_width = width if width > self.num_items else None
    self.decline_reason = None
    if request is False:
      self._drop_slab()
      return False
    if request not in ('auto', True, 'packed'):
      raise ValueError(f"slab_cache={request!r}: expected 'auto', True, "
                       "'packed' or False")
    if self.table_sharding is not None:
      return self._decline("'data'-sharded CSR storage")
    if self.d_slab is not None and self._slab_width == width and not (
        (request is True and self._slab_packed)
        or (request == 'packed' and not self._slab_packed)):
      self._slab_request = request
      return True
    if width <= self.num_items:
      raise ValueError(f'slab width {width} must exceed the catalog '
                       f'({self.num_items}) by the sentinel column')
    if request == 'packed' and not self.binary:
      return self._decline("slab_cache='packed' requires binary (all-ones) "
                           'values')
    if not np.all(self.matrix.data.astype(np.float32) != 0.0):
      return self._decline('matrix stores explicit zero values')
    dtype = self._dtype()
    packed = request == 'packed'
    packed_bytes = self.n_pad * (width // 32) * 4
    nbytes = packed_bytes if packed else self.n_pad * width * (
        2 if dtype == torch.bfloat16 else 4)
    if request == 'auto':
      budget = self._memory_budget()
      if budget is not None and nbytes > budget:
        if self.binary and width % 32 == 0 and packed_bytes <= budget:
          packed, nbytes = True, packed_bytes  # the 1-bit tier fits
        else:
          return self._decline(f'{nbytes / 2**30:.2f} GiB exceeds the '
                               'free-memory budget of '
                               f'{budget / 2**30:.2f} GiB (slab_cache=True '
                               'forces the dense tier)')
    if packed and width % 32 != 0:
      return self._decline(f'packed tier needs width % 32 == 0 (got '
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

  def _decline(self, reason):
    """Where the JAX source falls back to its per-step scatter: no slab."""
    self._drop_slab()
    self.decline_reason = reason
    log.info('no resident slab: %s; full-decode steps scatter their '
             'triplets', reason)
    return False

  def _dtype(self):
    """The dense tier's storage dtype (and the scatter's): bf16 when
    every stored value round-trips exactly, else float32."""
    if self._storage_dtype is None:
      data = self.matrix.data.astype(np.float32)
      exact = np.array_equal(
          torch.from_numpy(data).to(torch.bfloat16).float().numpy(), data)
      self._storage_dtype = torch.bfloat16 if exact else torch.float32
    return self._storage_dtype

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
    padded with the pad users ('users'), or shuffled mega indices
    ('blocks').

    'users' mode draws it as the JAX ``_host_epoch_perm`` does, so the
    two packages train the same epochs. The partially filled tail mega
    is pinned to the last slot: the epoch's ``ceil(num_users /
    batch_size)`` steps cover every real user only if the mega whose
    trailing rows are padding is the one the last steps take."""
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

  def fd_batch(self, perm, step, rand_ids=None, epoch_tables=False):
    """Step ``step``'s full-decode payload: ``perm`` is the epoch order
    on the device, ``step`` a 0-dim int64 device tensor.

    Off the resident slab nothing is read on the host (a CUDA graph
    replays the same call with the step the device counter holds): the
    slice's B rows are gathered by index ('blocks': ``perm[m] * S + s *
    B + arange(B)``), and the mask of the mega's columns is built from
    its S rows where the mega is wider than the batch. Without a slab (a
    declined request or ``slab_cache=False``) the step's triplets are
    scattered: in 'blocks' mode, and in 'users' mode with
    ``epoch_tables`` over the placed epoch tables (:meth:`epoch_state`),
    from device tensors alone (:meth:`_static_scatter_fd_batch`), else
    reading the step on the host (:meth:`_scatter_fd_batch`).

    Returns ``{'slab': [B, width] rows on the device (the dense tier's
    storage dtype; bf16 zeros and ones from the packed tier), 'users':
    [B] user ids on the device (pad slots hold num_users), 'num_users':
    the valid user count as a 0-dim float32 device tensor, at least 1}``,
    and ``'col_mask'``: [width] float32, 1 on the step's loss columns
    (the mega's, the random ids', inside the catalog) -- except from the
    dense tier with one slice a mega and no random ids, where the
    trainer reads them off the rows. ``rand_ids`` (tests) replaces the
    draw of random negatives from ``neg_gen``.
    """
    if self.d_slab is None:
      if self.fd_width is None:
        raise RuntimeError('no resident slab and no full-decode width: call '
                           'maybe_cache_slabs first')
      if self.shuffle == 'blocks' or epoch_tables:
        return self._static_scatter_fd_batch(perm, step, rand_ids)
      return self._scatter_fd_batch(perm, int(step), rand_ids)
    B, S, spm = self.batch_size, self.mega, self.slices_per_mega
    self._arange_offsets()
    mega_rows = None
    if self.shuffle == 'blocks':
      if spm == 1:
        rows = perm.index_select(0, step.view(1)) * S + self._offsets
      else:
        m = torch.div(step, spm, rounding_mode='floor')
        base = perm.index_select(0, m.view(1)) * S
        rows = base + (step - m * spm) * B + self._offsets
        mega_rows = base + self._mega_offsets
    else:
      rows = perm.index_select(0, step * B + self._offsets)
      if spm > 1:
        m = torch.div(step, spm, rounding_mode='floor')
        mega_rows = perm.index_select(0, m * S + self._mega_offsets)
    R = self.num_random_negatives
    out = {}
    if self._slab_packed:
      # the kernel clamps indices into the slab; rows < n_pad always
      slab, out['col_mask'] = unpack_rows(self.d_slab, self.num_items,
                                          index=rows)
      if mega_rows is not None:
        out['col_mask'] = unpack_mask(self.d_slab, self.num_items,
                                      index=mega_rows)
    else:
      slab = self.d_slab.index_select(0, rows)
      if mega_rows is not None or R:
        mega = (slab if mega_rows is None
                else self.d_slab.index_select(0, mega_rows))
        out['col_mask'] = (torch.any(mega, dim=0)
                           & self._in_catalog(slab.shape[1])).float()
    if R:
      out['col_mask'].index_fill_(0, self._negatives(rand_ids), 1.0)
    n = self.num_users_total
    out.update(slab=slab, users=torch.clamp(rows, max=n),
               num_users=torch.clamp(torch.sum(rows < n), min=1).float())
    return out

  def resident_tensors(self):
    """The device tensors the steps read in place (a CUDA graph that
    recorded a step keeps their addresses): the slab, the static
    'blocks' tables or the fixed buffers of the 'users' epoch tables
    (:meth:`graph_signature` names the rest), and the offsets."""
    out = [t for t in (self.d_slab, self._offsets, self._mega_offsets)
           if t is not None]
    sides = (self._epoch_buffers if self.shuffle == 'users'
             else self._static).values()
    for side in sides:
      out += [v for v in side.values() if torch.is_tensor(v)]
    return out

  def _arange_offsets(self):
    if self._offsets is None:
      self._offsets = torch.arange(self.batch_size, device=self.device)
      self._mega_offsets = torch.arange(self.mega, device=self.device)

  def _in_catalog(self, width):
    return torch.arange(width, device=self.device) < self.num_items

  def _mega_users(self, perm, m):
    """Mega ``m``'s S user ids in order (numpy int64; pad users ``>=
    num_users``) under the 'users' epoch order ``perm``."""
    S = self.mega
    return perm[m * S:(m + 1) * S].cpu().numpy().astype(np.int64)

  def _gather(self, users):
    """The CSR positions of ``users``' interactions, user by user, on the
    device, and each user's nnz offset into them (numpy ``[len + 1]``)."""
    dev = self.device
    u = np.minimum(users, self.num_users_total)
    counts, starts = self._counts[u], self._starts[u]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    nnz = int(offsets[-1])
    owner = torch.repeat_interleave(
        torch.arange(len(u), device=dev), torch.from_numpy(counts).to(dev),
        output_size=nnz)
    adjust = torch.from_numpy(starts - offsets[:-1]).to(dev)
    return adjust[owner] + torch.arange(nnz, device=dev), offsets

  def _slice_rows(self, offsets, s):
    """Slice ``s``'s row of each of its interactions, on the device (the
    mega's nnz ``offsets``)."""
    B = self.batch_size
    counts = np.diff(offsets[s * B:(s + 1) * B + 1])
    return torch.repeat_interleave(
        torch.arange(B, device=self.device),
        torch.from_numpy(counts).to(self.device),
        output_size=int(counts.sum()))

  def _scatter_fd_batch(self, perm, step_idx, rand_ids):
    """:meth:`fd_batch`'s payload without a slab in 'users' mode (the JAX
    ``build_batch`` with ``full_decode=True``): slice ``s`` of mega
    ``m``'s triplets, raw column ids, densified at ``fd_width`` in the
    dense tier's storage dtype (each cell once: canonical CSR); the loss
    mask from the mega's column ids and the random ids, inside the
    catalog. It reads the step and the order on the host."""
    B, n, W = self.batch_size, self.num_users_total, self.fd_width
    dev = self.device
    csr = self._device_csr()
    m, s = divmod(step_idx, self.slices_per_mega)
    users = self._mega_users(perm, m)
    src, offsets = self._gather(users)
    mega_cols = csr['cols'][src]
    a, e = int(offsets[s * B]), int(offsets[(s + 1) * B])
    rows, cols = self._slice_rows(offsets, s), mega_cols[a:e]
    dtype = self._dtype()
    vals = (csr['vals'][src[a:e]].to(dtype) if 'vals' in csr
            else torch.ones(e - a, dtype=dtype, device=dev))
    keep = cols < W  # (the JAX scatter's mode='drop')
    slab = torch.zeros((B, W), dtype=dtype, device=dev)
    slab.index_put_((rows[keep], cols[keep]), vals[keep])
    users = torch.from_numpy(users[s * B:(s + 1) * B]).to(dev)
    present = torch.zeros(W, dtype=torch.bool, device=dev)
    present[mega_cols[mega_cols < W]] = True
    if self.num_random_negatives:
      present[self._negatives(rand_ids)] = True
    return {'slab': slab, 'users': torch.clamp(users, max=n),
            'num_users': torch.clamp(torch.sum(users < n), min=1).float(),
            'col_mask': (present & self._in_catalog(W)).float()}

  def _static_scatter_fd_batch(self, perm, step, rand_ids):
    """:meth:`_scatter_fd_batch` from device tensors alone, in 'blocks'
    mode or over the placed 'users' epoch tables: the slice's triplets
    from its contiguous CSR range at the fixed window (the entries past
    its nnz go to a dropped row), the mask from the mega's range at the
    mega's window. Same payload."""
    B, W, S = self.batch_size, self.fd_width, self.mega
    side = (self._placed('raw') if self.shuffle == 'users'
            else self._static_side(''))
    dev = self.device
    if 'raw' not in side:  # the CSR's columns, padded by the mega window
      self._put_flat(side, 'raw', np.concatenate([
          self.matrix.indices.astype(np.int64),
          np.zeros(side['M_mega'], np.int64)]))
      side['mega_window'] = torch.arange(side['M_mega'], device=dev)
    b, lo = self._block_of(perm, step)
    rows, idx, valid = self._window_rows(side, lo)
    cols = self._fetch(side, 'raw', idx)
    dtype = self._dtype()
    vals = self._window_vals(side, idx, valid).to(dtype)
    keep = cols < W  # (the JAX scatter's mode='drop')
    slab = torch.zeros((B + 1, W), dtype=dtype, device=dev)
    slab.index_put_((torch.where(keep, rows, B), torch.where(keep, cols, 0)),
                    vals)
    bounds = side['indptr'].index_select(0, torch.cat([b * S, b * S + S]))
    midx = bounds[:1] + side['mega_window']
    mcols = self._fetch(side, 'raw', midx)
    present = torch.zeros(W + 1, dtype=torch.bool, device=dev)
    present.index_fill_(0, torch.where((midx < bounds[1:]) & (mcols < W),
                                       mcols, W), True)
    present = present[:W]
    if self.num_random_negatives:
      present.index_fill_(0, self._negatives(rand_ids), True)
    users = self._slice_users(perm, lo)
    n = self.num_users_total
    return {'slab': slab[:B], 'users': torch.clamp(users, max=n),
            'num_users': torch.clamp(torch.sum(users < n), min=1).float(),
            'col_mask': (present & self._in_catalog(W)).float()}

  def build_fd_batch(self, perm, step_idx, rand_ids=None):
    """:meth:`fd_batch` from a host order and step: ``perm`` an int64
    tensor, ``step_idx`` an int. The same payload with 'users' on the CPU
    and 'num_users' a float (a host read). A 'users' triplet scatter
    reads the CSR, not the epoch tables (:meth:`_scatter_fd_batch`)."""
    out = self.fd_batch(perm.to(self.device),
                        torch.tensor(int(step_idx), device=self.device),
                        rand_ids=rand_ids)
    out['users'] = out['users'].cpu()
    out['num_users'] = float(out['num_users'])
    return out

  # -- 'users' epoch tables -------------------------------------------------

  def prefetch_epoch(self, epoch, full_decode=False):
    """Enqueue the build of ``epoch``'s 'users' tables on the device (the
    JAX ``prefetch_epoch``); :meth:`epoch_state` then places them. A
    no-op unless this source precomputes, for tables already built or
    placed, and for full decode off a resident slab, which needs none."""
    key = (int(epoch), bool(full_decode))
    if (not self.users_precompute or key in self._prefetched
        or (self._epoch is not None and self._epoch['key'] == key)
        or (full_decode and self.d_slab is not None)):
      return
    self._prefetched[key] = self._build_epoch(*key)

  def epoch_state(self, epoch, full_decode=False):
    """Epoch ``epoch``'s 'users' tables, built on the device (unless
    :meth:`prefetch_epoch` built them) and placed where the static steps
    read them (the JAX ``epoch_state``); the tables of earlier epochs are
    dropped. Returns None unless this source precomputes; for full decode
    off a resident slab, which reads no table, ``{'perm': the epoch's
    order}``; else the placed side's arrays with ``'perm'`` and
    ``'signature'``: ``('union', W, M)`` -- the union width and the slice
    window -- or ``('full decode', M, M_mega)``, each on the ladder of
    :func:`_rung`. Union steps read ``'unions'`` ``[n_blocks, W]`` (each
    mega's union ascending, then the sentinel), ``'widths'`` and
    ``'cols'`` (each entry's compressed column, in the epoch's CSR order
    ``'indptr'``); the triplet scatter reads ``'raw'``, the columns."""
    if not self.users_precompute:
      return None
    key = (int(epoch), bool(full_decode))
    for k in [k for k in self._prefetched if k[0] < key[0]]:
      del self._prefetched[k]
    if full_decode and self.d_slab is not None:
      return {'perm': self.epoch_permutation(epoch)}
    if self._epoch is None or self._epoch['key'] != key:
      with trace.span('recoder.epoch_tables'):
        staged = self._prefetched.pop(key, None)
        self._place_epoch(key, staged or self._build_epoch(*key))
    return self._epoch['state']

  def _build_epoch(self, epoch, full_decode):
    """An epoch's tables before placement, on the device (the JAX
    ``_users_epoch_state``): its CSR in its order, gathered from the
    resident one (``_epoch_gather_stage``), and for union steps each
    mega's union from one sort of ``mega x radix + column`` keys -- first
    occurrences, ranks, each entry's compressed column, each mega's width
    (``_build_epoch_tables``); the windows from the host counts. Nothing
    is read on the host."""
    perm = self.epoch_permutation(epoch)
    users = np.minimum(perm.numpy(), self.num_users_total)
    counts, starts = self._counts[users], self._starts[users]
    indptr = np.concatenate([[0], np.cumsum(counts)])
    nnz, dev = int(indptr[-1]), self.device
    csr = self._device_csr()
    owner = torch.repeat_interleave(
        torch.arange(self.n_pad, device=dev),
        torch.from_numpy(counts).to(dev), output_size=nnz)
    src = (torch.from_numpy(starts - indptr[:-1]).to(dev)[owner]
           + torch.arange(nnz, device=dev))
    staged = {'perm': perm, 'indptr': torch.from_numpy(indptr).to(dev),
              'M': _window(indptr, self.batch_size),
              'M_mega': _window(indptr, self.mega),
              'raw': csr['cols'].index_select(0, src)}
    if 'vals' in csr:
      staged['vals'] = csr['vals'].index_select(0, src)
    if full_decode:
      return staged
    radix = max(self.num_items, self.matrix.shape[1]) + 1
    mega = torch.div(owner, self.mega, rounding_mode='floor')
    key, order = torch.sort(mega * radix + staged.pop('raw'), stable=True)
    first = torch.ones(nnz, dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    mega = torch.div(key, radix, rounding_mode='floor')
    # (the keys are sorted: each mega's entries are one run of them)
    bounds = torch.searchsorted(
        mega, torch.arange(self.n_blocks + 1, device=dev))
    seen = torch.cumsum(first, 0)
    before = torch.cat([seen.new_zeros(1), seen]).index_select(0, bounds)
    ranks = seen - 1 - before.index_select(0, mega)
    staged.update(cols=torch.empty_like(ranks).scatter_(0, order, ranks),
                  widths=before[1:] - before[:-1], first=first, mega=mega,
                  ranks=ranks, items=key - mega * radix)
    return staged

  def _place_epoch(self, key, staged):
    """Copy an epoch's tables into the buffers the static steps read:
    the layout's, of fixed address (the epoch's CSR, the widths), and the
    width signature's (the windows, the union table), so that a graph
    recorded in one epoch replays in another of its signature. A union
    build reads its largest width here: the build's one host read."""
    full_decode = key[1]
    M, M_mega = _rung(staged['M']), _rung(staged['M_mega'])
    if full_decode:
      sig = ('full decode', M, M_mega)
    else:
      W = _rung(int(staged['widths'].max()))
      sig = ('union', W, M)
    bufs = self._signatures.pop(sig, None)
    if bufs is None:
      dev = self.device
      bufs = {'window': torch.arange(M, device=dev)}
      if full_decode:
        bufs['mega_window'] = torch.arange(M_mega, device=dev)
      else:  # (a spare slot past the table takes the entries not first)
        bufs['unions'] = torch.empty(self.n_blocks * W + 1,
                                     dtype=torch.int64, device=dev)
    self._signatures[sig] = bufs
    while len(self._signatures) > self.SIGNATURES:
      self._signatures.popitem(last=False)
    fixed = self._fixed_buffers(full_decode)
    nnz = self.matrix.nnz
    for name, buf in fixed.items():
      (buf if name in ('indptr', 'widths') else buf[:nnz]).copy_(staged[name])
    side = dict(fixed, M=M, window=bufs['window'])
    if full_decode:
      side.update(M_mega=M_mega, mega_window=bufs['mega_window'])
    else:
      nb = self.n_blocks
      unions = bufs['unions'].fill_(self.num_items)
      unions.scatter_(0, torch.where(staged['first'],
                                     staged['mega'] * W + staged['ranks'],
                                     nb * W), staged['items'])
      side.update(unions=unions[:nb * W].view(nb, W), W=W, W0=W)
    self._static[''] = side
    self._epoch = {'key': key, 'sig': sig, 'state': dict(
        side, perm=staged['perm'], signature=sig)}

  def _fixed_buffers(self, full_decode):
    """The buffers of fixed address that each epoch's tables of one
    layout are copied into: ``indptr`` over the padded users, the columns
    (raw for the triplet scatter, compressed for union steps, with each
    mega's width) and the values unless they are all ones. The entries
    past the CSR's stay 0 and cover every window: the largest mega nnz
    any order can give, on the ladder."""
    fixed = self._epoch_buffers.get(full_decode)
    if fixed is None:
      dev, nnz = self.device, self.matrix.nnz
      top = int(np.sort(self._counts)[-self.mega:].sum())
      size = nnz + _rung(min(top, nnz))
      fixed = {'indptr': torch.zeros(self.n_pad + 1, dtype=torch.int64,
                                     device=dev)}
      fixed['raw' if full_decode else 'cols'] = torch.zeros(
          size, dtype=torch.int64, device=dev)
      if not self.binary:
        fixed['vals'] = torch.zeros(size, device=dev)
      if not full_decode:
        fixed['widths'] = torch.zeros(self.n_blocks, dtype=torch.int64,
                                      device=dev)
      self._epoch_buffers[full_decode] = fixed
    return fixed

  def _placed(self, name):
    """The placed 'users' epoch tables, which must be the layout that
    holds ``name`` ('unions': the union steps', 'raw': the triplet
    scatter's)."""
    side = self._static.get('')
    if side is None or name not in side:
      raise RuntimeError("the 'users' epoch tables of this step are not "
                         'placed: call epoch_state(epoch, full_decode)')
    return side

  def graph_signature(self):
    """What a graph of static 'users' steps records beyond
    :meth:`resident_tensors`: the placed epoch's width signature and the
    addresses of that signature's buffers (None in 'blocks' mode)."""
    if self._epoch is None:
      return None
    sig = self._epoch['sig']
    return sig, tuple(t.data_ptr() for t in self._signatures[sig].values())

  def _device_csr(self):
    """The CSR's columns (and values unless they are all ones) on the
    device, put there once."""
    if self._csr is None:
      arrays = {'cols': self.matrix.indices.astype(np.int64)}
      if not self.binary:
        arrays['vals'] = self.matrix.data.astype(np.float32)
      self._csr = {k: torch.from_numpy(v).to(self.device)
                   for k, v in arrays.items()}
    return self._csr

  # -- item-union batches ---------------------------------------------------

  def _block_unions(self):
    """The per-mega unions of 'blocks' mode, on the host, computed once
    (the JAX ``_block_tables``): for each fixed mega of users,
    ``np.unique(cols, return_inverse=True)`` over its interactions.

    Returns ``{'cols': compressed column of every interaction (aligned
    with the CSR), 'unions': the megas' unions concatenated, 'ptr': mega
    b's union is unions[ptr[b]:ptr[b + 1]]}``."""
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
    return {'cols': cols, 'ptr': ptr,
            'unions': (np.concatenate(unions) if unions
                       else np.zeros(0, np.int64))}

  def union_width(self):
    """The union width by which the JAX trainer's 'auto' rule picks full
    decode (``num_items_padded <= 4 * union_width``): without random
    negatives in 'blocks' mode, the largest mega union aligned up to 128
    (the JAX ``_block_tables`` width); otherwise the largest union of
    four sampled random mega windows plus R, with an 8% margin, aligned
    up to 256 (the JAX loader's ``_estimate_widths``, ``snap(max_union +
    R)``)."""
    R = self.num_random_negatives
    if self.shuffle == 'blocks' and not R:
      return _align128(np.diff(self._block_unions()['ptr']).max(initial=1))
    m, n = self.matrix, self.num_users_total
    rng = np.random.default_rng(1234)
    widest = 1
    for _ in range(4):
      idx = rng.choice(n, size=min(self.mega, n), replace=False)
      cols = [m.indices[m.indptr[i]:m.indptr[i + 1]] for i in idx]
      if cols:
        widest = max(widest, len(np.unique(np.concatenate(cols))))
    return (int((widest + R) * 1.08) + 255) // 256 * 256

  def _static_side(self, prefix):
    """The device arrays the static 'blocks' batches read from one CSR
    (``prefix`` '' the input's, 'tg_' the target's), built at first use:
    its indptr over the padded users, the slice window ``M`` and the
    mega window ``M_mega`` (the largest slice and mega nnz), the values
    padded by the mega window unless they are all ones."""
    side = self._static.get(prefix)
    if side is None:
      m = self.target_matrix if prefix else self.matrix
      n, dev = self.num_users_total, self.device
      indptr = np.append(m.indptr.astype(np.int64),
                         np.full(self.n_pad - n, m.nnz, np.int64))
      M, M_mega = _window(indptr, self.batch_size), _window(indptr, self.mega)
      side = {'indptr': torch.from_numpy(indptr).to(dev), 'M': M,
              'M_mega': M_mega, 'window': torch.arange(M, device=dev)}
      if not np.all(m.data == 1.0):
        self._put_flat(side, 'vals', np.concatenate(
            [m.data.astype(np.float32), np.zeros(M_mega, np.float32)]))
      self._static[prefix] = side
    return side

  # -- 'data'-sharded table storage -------------------------------------------

  def _put_flat(self, side, name, arr):
    """``side[name]``: a flat CSR array (padded by the side's mega window,
    the halo) on the device, whole, or under 'data' sharding this rank's
    chunk of ``ceil((len - halo) / D)`` entries and the halo after it (the
    JAX ``_put_csr_chunks``); ``side['chunk']`` records the chunk length
    and ``side['whole']`` the whole array's shape."""
    side.setdefault('whole', {})[name] = arr.shape
    if self.table_sharding is None:
      side[name] = torch.from_numpy(arr).to(self.device)
      return
    ways, rank = self.mesh.shape['data'], self.mesh.data_rank
    halo = side['M_mega']
    chunk = max(-(-(len(arr) - halo) // ways), 1)
    padded = np.zeros(ways * chunk + halo, arr.dtype)
    padded[:len(arr)] = arr
    side['chunk'] = chunk
    side[name] = torch.from_numpy(
        padded[rank * chunk:(rank + 1) * chunk + halo].copy()).to(self.device)

  def _put_rows(self, side, name, arr):
    """``side[name]``: a ``[n_blocks, X]`` block table on the device,
    whole, or under 'data' sharding this rank's ``ceil(n_blocks / D)``
    rows of the table padded by zero rows to a multiple of D (the JAX
    ``_put_block_table``); ``side['rows_per']`` records the share."""
    side.setdefault('whole', {})[name] = arr.shape
    if self.table_sharding is not None:
      ways, rank = self.mesh.shape['data'], self.mesh.data_rank
      per = side['rows_per'] = -(-arr.shape[0] // ways)
      part = np.zeros((per,) + arr.shape[1:], arr.dtype)
      mine = arr[rank * per:(rank + 1) * per]
      part[:len(mine)] = mine
      arr = part
    side[name] = torch.from_numpy(arr).to(self.device)

  def _owned(self, index, per):
    """``(mine, local)``: whether this rank holds the part ``index //
    per`` (the last rank holds what lies past the parts), and the
    index within it (0 elsewhere)."""
    ways = self.mesh.shape['data']
    owner = torch.clamp(torch.div(index, per, rounding_mode='floor'),
                        max=ways - 1)
    mine = owner == self.mesh.data_rank
    return mine, torch.where(mine, index - owner * per, 0)

  def _fetch(self, side, name, idx):
    """``side[name][idx]`` of a contiguous window ``idx`` of a flat CSR
    array: a gather of the whole array, or under 'data' sharding the
    window's owner's gather, zeros elsewhere, summed over 'data' (the
    JAX ``_csr_range``)."""
    arr = side[name]
    if self.table_sharding is None:
      return arr.index_select(0, idx)
    mine, local = self._owned(idx[:1], side['chunk'])
    part = arr.index_select(0, idx - idx[:1] + local)
    return collectives.sum_over(
        torch.where(mine, part, torch.zeros_like(part)),
        self.mesh.data_group)

  def _table_row(self, side, name, b):
    """Row ``b`` (a [1] device tensor) of a block table, by owner slice
    and a sum over 'data' under 'data' sharding (the JAX
    ``_row_fetch``)."""
    table = side[name]
    if self.table_sharding is None:
      return table.index_select(0, b)[0]
    mine, local = self._owned(b, side['rows_per'])
    row = table.index_select(0, local)[0]
    return collectives.sum_over(
        torch.where(mine, row, torch.zeros_like(row)), self.mesh.data_group)

  def table_shapes(self):
    """``{side + name: (shape held, whole shape)}`` of the 'blocks' tables
    and CSR arrays (a split array's held shape is this rank's share)."""
    return {prefix + k: (list(v.shape),
                         list(side.get('whole', {}).get(k, v.shape)))
            for prefix, side in self._static.items()
            for k, v in side.items() if torch.is_tensor(v)}

  def shard_bytes(self):
    """``{side + name: (bytes held, whole bytes, slack)}`` of the 'blocks'
    tables and CSR arrays. Under 'data' sharding a split array holds
    ``whole / D`` bytes and at most ``slack`` more: a block table's zero
    rows that pad it to a multiple of D (one row a rank), a flat array's
    halo and its chunk's rounding (``M_mega + 1`` entries). Every other
    array is replicated: it holds its whole bytes (slack 0)."""
    out = {}
    for prefix, side in self._static.items():
      for k, v in side.items():
        if not torch.is_tensor(v):
          continue
        whole = side.get('whole', {}).get(k, v.shape)
        size = v.element_size()
        slack = 0
        if self.table_sharding is not None and k in side.get('whole', {}):
          slack = (math.prod(whole[1:]) * size if len(whole) > 1
                   else (side['M_mega'] + 1) * size)
        out[prefix + k] = (v.numel() * size, math.prod(whole) * size, slack)
    return out

  def _static_unions(self, prefix):
    """:meth:`_static_side` with the side's union tables: the compressed
    columns padded by the window, the ``[n_blocks, W0]`` union table
    (sentinel-filled past each block's union, ``W0`` the largest union
    aligned up to 128) and each block's union width; ``W`` the static
    width of a step's union (``W0``, or with R random negatives
    ``align128(largest union + R)``)."""
    side = self._static_side(prefix)
    if 'unions' not in side:
      t = self._tg_tables if prefix else self._block_unions()
      widths = np.diff(t['ptr'])
      W0 = _align128(widths.max(initial=1))
      unions = np.full((self.n_blocks, W0), self.num_items, np.int64)
      unions[np.arange(W0) < widths[:, None]] = t['unions']
      dev = self.device
      self._put_flat(side, 'cols', np.concatenate(
          [t['cols'], np.zeros(side['M_mega'], np.int64)]))
      self._put_rows(side, 'unions', unions)
      side.update(
          widths=torch.from_numpy(widths).to(dev), W0=W0,
          W=(_align128(widths.max(initial=1) + self.num_random_negatives)
             if self.num_random_negatives and not prefix else W0))
    return side

  def prepare_union(self):
    """Put on the device, once, what the union batches read: the static
    'blocks' tables of each CSR side (:meth:`_static_unions`), or the CSR
    ('users': :meth:`_device_csr`; an epoch's tables come from
    :meth:`epoch_state`)."""
    if self.shuffle == 'users':
      self._device_csr()
      return
    self._static_unions('')
    if self._tg_tables is not None:
      self._static_unions('tg_')

  def static_widths(self):
    """``{'W': the union's static width, 'M': the slice window}`` of each
    side of the 'blocks' union batches (``tg_`` keys for the target's)."""
    self.prepare_union()
    return {prefix + k: self._static[prefix][k]
            for prefix in self._static if 'unions' in self._static[prefix]
            for k in ('W', 'M')}

  def _block_of(self, perm, step):
    """``(b, lo)``: the block of step ``step``'s mega and its slice's first
    user, as [1] device tensors, from the device order and step. Over the
    'users' epoch tables the block is the mega and ``lo`` the slice's
    first position in the epoch's order."""
    S, spm = self.mega, self.slices_per_mega
    if self.shuffle == 'users':
      return (torch.div(step, spm, rounding_mode='floor').view(1),
              step.view(1) * self.batch_size)
    if spm == 1:
      b = perm.index_select(0, step.view(1))
      return b, b * S
    m = torch.div(step, spm, rounding_mode='floor')
    b = perm.index_select(0, m.view(1))
    return b, b * S + (step - m * spm) * self.batch_size

  def _slice_users(self, perm, lo):
    """The slice's user ids from its first user (or, over the 'users'
    epoch tables, position) ``lo``."""
    self._arange_offsets()
    users = lo + self._offsets
    return perm.index_select(0, users) if self.shuffle == 'users' else users

  def _window_rows(self, side, lo):
    """The slice's window of CSR positions ``idx`` (M of them, from the
    slice's first entry), which of them are the slice's, and each one's
    row in the slice: ``B`` past the slice's nnz (the row the densify
    drops)."""
    self._arange_offsets()
    bounds = side['indptr'].index_select(0, torch.cat(
        [lo, lo + 1 + self._offsets]))
    idx = bounds[:1] + side['window']
    # (the users whose range ends at or before a position: its row)
    rows = torch.searchsorted(bounds[1:], idx, right=True)
    return rows, idx, idx < bounds[-1:]

  def _window_vals(self, side, idx, valid):
    if 'vals' not in side:
      return valid.float()
    return torch.where(valid, self._fetch(side, 'vals', idx), 0.0)

  def _unique_union(self, items, rand):
    """The JAX fixed-shape ``_unique_union`` of a block's union row and
    the R random ids: ``(union [W], where each of the row's W0 slots
    landed in it, width_valid)`` -- one stable sort, first occurrences,
    ranks; the sentinel sorts last and fills the tail."""
    W = self._static['']['W']
    merged, order = torch.sort(torch.cat([items, rand]), stable=True)
    first = torch.ones_like(merged, dtype=torch.bool)
    first[1:] = merged[1:] != merged[:-1]
    ranks = torch.cumsum(first, 0) - 1
    union = torch.full((W + 1,), self.num_items, dtype=torch.int64,
                       device=self.device)
    union.scatter_(0, torch.where(first, torch.clamp(ranks, max=W), W),
                   merged)
    landed = torch.empty_like(ranks).scatter_(0, order, ranks)
    width_valid = torch.sum(first & (merged != self.num_items))
    return union[:W], landed[:items.shape[0]], width_valid

  def union_batch(self, perm, step, rand_ids=None):
    """Step ``step``'s item-union batch at static shapes and from device
    tensors alone (``perm``: the epoch's block order, or in 'users' mode
    its user order, on the device; ``step``: a 0-dim int64 device
    tensor), so that a CUDA graph can record it: the JAX ``build_batch``
    blocks branch, or in 'users' mode ``_build_from_epoch_tables`` over
    the placed epoch tables (:meth:`epoch_state`).

    Returns ``{'items': [W] the mega's union, ascending, then the
    sentinel num_items; 'width_valid': its valid width, a 0-dim device
    tensor; 'rows', 'cols', 'vals': [M] the slice's window of
    interactions -- row in the batch, index into items, value -- whose
    entries past the slice's nnz hold row B and value 0; 'users': [B]
    user ids (pad slots hold num_users); 'num_users': the valid user
    count as a 0-dim float32 tensor, at least 1}``, all on the device.
    With random negatives the R ids (``rand_ids``, else drawn from
    ``neg_gen`` where it stands) join the union. With a target matrix the
    same for the target side under ``tg_`` keys (``tg_width_valid``)."""
    if self.shuffle == 'users':
      self._placed('unions')
    else:
      self.prepare_union()
    b, lo = self._block_of(perm, step)
    out = {}
    for prefix in ('', 'tg_') if self._tg_tables is not None else ('',):
      side = self._static[prefix]
      rows, idx, valid = self._window_rows(side, lo)
      items = self._table_row(side, 'unions', b)
      width_valid = side['widths'].index_select(0, b)[0]
      cols = self._fetch(side, 'cols', idx)
      if self.num_random_negatives and not prefix:
        items, landed, width_valid = self._unique_union(
            items, self._negatives(rand_ids))
        cols = landed.index_select(0, cols)
      out.update({prefix + 'items': items,
                  prefix + 'width_valid': width_valid,
                  prefix + 'rows': rows, prefix + 'cols': cols,
                  prefix + 'vals': self._window_vals(side, idx, valid)})
    users = self._slice_users(perm, lo)
    n = self.num_users_total
    out.update(users=torch.clamp(users, max=n),
               num_users=torch.clamp(torch.sum(users < n), min=1).float())
    return out

  def build_union_batch(self, perm, step_idx, neg_step=None, rand_ids=None):
    """Step ``step_idx``'s item-union batch at its exact sizes: slice
    ``s`` of mega ``m`` over the mega's union.

    Returns ``{'items': [W] the mega's item union, ascending, on the
    device; 'rows', 'cols', 'vals': [nnz] row in the batch, index into
    items and value of each of the slice's interactions, on the device;
    'users': [B] CPU user ids (pad slots hold num_users); 'num_users':
    valid user count as a float, at least 1}``. The union holds exactly
    the items the mega's users touched and, with random negatives, the R
    ids drawn for global step ``neg_step`` (default ``step_idx``, as the
    JAX ``build_batch``) or given as ``rand_ids``: they widen the union
    only. With a target matrix, ``'tg_items'``, ``'tg_rows'``,
    ``'tg_cols'`` and ``'tg_vals'`` are the same for the slice's target
    interactions, over the mega's target union. In 'blocks' mode this is
    :meth:`union_batch` cut to its valid parts (host reads).
    """
    self.prepare_union()
    B, n, dev = self.batch_size, self.num_users_total, self.device
    if self.num_random_negatives and rand_ids is None:
      self.seed_negatives(step_idx if neg_step is None else neg_step)
    if self.shuffle == 'blocks':
      out = self.union_batch(perm.to(dev),
                             torch.tensor(int(step_idx), device=dev),
                             rand_ids)
      for prefix in ('', 'tg_') if self._tg_tables is not None else ('',):
        width = int(out.pop(prefix + 'width_valid'))
        out[prefix + 'items'] = out[prefix + 'items'][:width]
        keep = out[prefix + 'rows'] < B
        for k in ('rows', 'cols', 'vals'):
          out[prefix + k] = out[prefix + k][keep]
      out['users'] = out['users'].cpu()
      out['num_users'] = float(out['num_users'])
      return out
    arrays = self._device_csr()
    m, s = divmod(int(step_idx), self.slices_per_mega)
    mega_src, offsets = self._gather(self._mega_users(perm, m))
    items, inverse = torch.unique(arrays['cols'][mega_src], sorted=True,
                                  return_inverse=True)
    a, e = int(offsets[s * B]), int(offsets[(s + 1) * B])
    users = perm[step_idx * B:(step_idx + 1) * B]
    rows, cols, src = self._slice_rows(offsets, s), inverse[a:e], \
        mega_src[a:e]
    if self.num_random_negatives:
      merged = torch.unique(torch.cat([items, self._negatives(rand_ids)]),
                            sorted=True)
      cols = torch.searchsorted(merged, items)[cols]
      items = merged
    vals = (arrays['vals'][src] if 'vals' in arrays
            else torch.ones(rows.shape[0], device=dev))
    num_users = int(torch.sum(users < n))
    return {'items': items, 'rows': rows, 'cols': cols, 'vals': vals,
            'users': torch.clamp(users, max=n),
            'num_users': float(max(num_users, 1))}
