"""iALS: implicit-feedback alternating least squares (Hu, Koren,
Volinsky, ICDM'08).

Port of ``recoder_tpu/models/ials.py``. With R the [users, items] raw
interaction matrix, preference ``p = (r > 0)`` and confidence
``c = 1 + alpha * r``, iALS minimizes

    sum_{u,i} c_ui (p_ui - x_u . y_i)^2
      + sum_u reg_u ||x_u||^2 + sum_i reg_i ||y_i||^2

by alternating exact per-row solves. Each user solve is

    (Y^T Y + Y_u^T (C_u - I) Y_u + reg_u I) x_u = Y_u^T c_u

with the shared Gram ``Y^T Y`` and per-row corrections for the observed
items only (items are symmetric). ``reg_scaling='frequency'`` scales
``reg_u = lam * (|I_u| + 1)`` (Rendle'21); ``'none'`` is constant lam.

On the device a half-sweep is, per chunk of rows: gather the padded
factor slab ``F[cols] -> [B, L, d]`` (pad slots gather a trailing zero
row), form the corrections (the JAX package's two einsums, summed in an
order that keeps each row's result independent of its chunk's shape:
:func:`_corrections`, :func:`_halving_sum`), add the Gram and the
ridge, solve the B systems with :func:`~recoder_tpu_torch.ops.spd.spd_solve`
(the CUDA kernel on the card, the blocked recursion on the CPU), and
scatter the solutions into the result (pad row ids drop). The Gram, the
corrections and the scoring matmul are torch products in full float32
(``ops/gather_matmul.full_float32``: the JAX package asks for
``Precision.HIGHEST``).
Rows are nnz-sorted and chunked greedily on power-of-two (B, L) ladders
exactly as in the JAX package; the chunk plans are built once in numpy
and stay on the device for the whole fit.

Serving is fold-in: ``recommend`` solves the query users' factors
against the fitted item factors with the training solve, so a training
user's history reproduces their trained factor bit for bit (neither
the corrections nor the SPD kernel's result for a row depend on the
chunk around it), scores ``x @ Y^T``, masks seen items and takes the
top k.

``fit(mesh=...)`` runs the fit on a ('data', 'model') mesh of processes
(``recoder_tpu_torch.parallel``, one process a card), the JAX package's
two layouts:

  * ``factor_sharding=None``: each chunk's B rows are split over every
    rank (the mesh's 'data' x 'model' ranks flattened, B padded to a
    multiple of their count); each rank solves its rows with the same
    solve, one ``all_gather`` returns the chunk's ``[B, d]`` solutions
    and every rank scatters them into its replicated factors. The Gram
    is replicated and each system is one block of the SPD kernel, so a
    row's solution does not depend on the rank that solved it.
  * ``factor_sharding='users'``: the user factors are row-sharded over
    every rank (``ceil((num_users + 1) / ranks)`` rows each, the pad
    rows zero) and the item factors replicated. The user solve writes
    only the rows each rank owns; the item solve reads user rows by
    owner slice -- each rank fills the slab slots it owns, the others
    stay zero, and the slab is summed onto the rank that solves those
    rows (one reduce a destination: the JAX ring's sum, never a gather
    of the whole user matrix); the Gram of the user factors is the sum
    of the ranks' Grams.

Every collective runs on every mesh, a (1, 1) one included (a group of
one returns its input), so that a (1, 1) mesh fits bitwise what the fit
without a mesh fits.
"""

import numpy as np
import scipy.sparse as sp
import torch

import recoder_tpu_torch
from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from recoder_tpu_torch.ops.gather_matmul import full_float32
from recoder_tpu_torch.parallel import collectives
from recoder_tpu_torch.ops.spd import spd_solve
from recoder_tpu_torch.recommender import topk_unseen


def _pow2_ceil(n):
  return 1 << max(0, int(np.ceil(np.log2(max(1, int(n))))))


def _pow2_floor(n):
  return 1 << max(0, int(np.floor(np.log2(max(1, int(n))))))


def _solve_rows_from_slab(f, gram, valid, vals, alpha, reg):
  """Batched HKV row solve from a gathered factor slab.

  f: [B, L, d] per-row factor slabs (pad slots are zero rows).
  gram: [d, d] unregularized F^T F (shared across rows).
  valid: [B, L] 1.0 where the slot holds a real observation, 0.0 pad.
  vals: [B, L] raw interaction values (pad 0); the weights derive
    here (w_a = alpha * vals, w_b = w_a + valid).
  reg: [B] per-row L2.

  Returns [B, d] solved factors.
  """
  w_a = alpha * vals  # confidence minus one (pad slots: vals == 0)
  w_b = w_a + valid  # full confidence
  # A_b = G + sum_l w_a[b,l] f[b,l,:] f[b,l,:]^T + reg_b I  (SPD), the
  # Gram and the ridge added in place (bitwise what a sum would give)
  a = _corrections(f, w_a)
  a += gram
  a.diagonal(dim1=1, dim2=2).add_(reg[:, None])
  b = _halving_sum(w_b[..., None] * f)  # einsum('bl,bld->bd', w_b, f)
  return spd_solve(a, b, base=32)


def _halving_sum(g):
  """Sum ``g`` [B, n, ...] over axis 1 by halving, ``g[:, :n/2] +
  g[:, n/2:]`` until one entry is left (n padded to a power of two).

  Zero entries at the end of axis 1 then change nothing, bit for bit:
  a row's sum is the same in any chunk shape (B, L), however many pad
  slots its chunk gives it. Fold-in's bit-exact contract needs that;
  cuBLAS's batched products sum in an order that depends on the shape
  (measured on the H100: ``einsum('bl,bld->bd')`` gives another last
  bit for the same row at L=128 and at L=2048).
  """
  n = g.shape[1]
  p = _pow2_ceil(n)
  if p != n:
    g = torch.cat([g, g.new_zeros((g.shape[0], p - n) + g.shape[2:])], 1)
  while p > 1:
    p //= 2
    g = g[:, :p] + g[:, p:]
  return g[:, 0]


def _corrections(f, w_a):
  """``einsum('bl,bld,ble->bde', w_a, f, f)`` [B, d, d], in a summation
  order that does not depend on the chunk shape.

  The L slots split into blocks of ``kb = max(8, pow2_ceil(d))`` (rows
  with L < kb are padded with zero slots); one batched matmul forms
  every block's [d, d] partial, and :func:`_halving_sum` adds the
  partials. Under the chunk plans' budget every chunk then has
  ``B * L / kb`` = chunk_elems / kb blocks, so the matmul runs at one
  shape for every chunk of a fit and of a fold-in, and a row's
  corrections are bitwise the same wherever it is solved. The partials
  take ``d / kb`` <= 1 times the slab's memory.
  """
  B, L, d = f.shape
  kb = max(8, _pow2_ceil(d))
  if L % kb:
    pad = kb - L % kb
    f = torch.cat([f, f.new_zeros((B, pad, d))], 1)
    w_a = torch.cat([w_a, w_a.new_zeros((B, pad))], 1)
    L += pad
  fw = (w_a[..., None] * f).view(-1, kb, d)
  parts = torch.bmm(fw.transpose(1, 2), f.view(-1, kb, d))
  return _halving_sum(parts.view(B, L // kb, d, d))


def _solve_rows(factors_pad, gram, cols, vals, alpha, reg):
  """:func:`_solve_rows_from_slab` after gathering the slab from
  [n + 1, d] opposite-side factors with a trailing zero row: pad slots
  (cols == n) gather it, so they add nothing even before the zero
  weights."""
  B, L = cols.shape
  d = factors_pad.shape[1]
  f = factors_pad.index_select(0, cols.reshape(-1)).view(B, L, d)
  n = factors_pad.shape[0] - 1
  valid = (cols < n).to(vals.dtype)
  return _solve_rows_from_slab(f, gram, valid, vals, alpha, reg)


def _gram(factors):
  return torch.matmul(factors.t(), factors)


def _mesh_ways(mesh):
  """``(ranks, this rank's index)`` of a fit's mesh: 'data' x 'model'
  flattened, the JAX ``flat_idx`` (rank ``r`` of the default group sits
  at ``(r // model, r % model)``); ``(1, 0)`` without one."""
  if mesh is None:
    return 1, 0
  world = mesh.shape['data'] * mesh.shape['model']
  if torch.distributed.get_world_size() != world:
    raise ValueError(f'the mesh has {world} ranks and the process group '
                     f'{torch.distributed.get_world_size()}')
  return world, mesh.data_rank * mesh.shape['model'] + mesh.model_rank


class _UserShards:
  """``factor_sharding='users'``'s layout: rank ``i`` holds user rows
  ``[i * per, (i + 1) * per)``, ``per = ceil((num_users + 1) / ranks)``
  (the sentinel row ``num_users`` exists and stays zero, as in JAX), of
  which the first ``valid`` are real users."""

  def __init__(self, num_users, mesh):
    self.num_users = int(num_users)
    self.world, self.index = _mesh_ways(mesh)
    self.per = -(-(self.num_users + 1) // self.world)
    self.lo = self.index * self.per
    self.valid = max(0, min(self.per, self.num_users - self.lo))

  def local(self, ids):
    """Local rows of the global user ``ids``: ``per`` (a spare row) for
    every id that is not one of this rank's real users."""
    loc = ids - self.lo
    return torch.where((loc >= 0) & (loc < self.valid), loc, self.per)


class IALS:
  """Implicit-feedback weighted matrix factorization via ALS.

  Usage::

      model = IALS(embedding_size=128, alpha=30.0, lam=3e-3,
                   device='cuda')
      model.fit(train_matrix)                # scipy.sparse, raw counts
      recs = model.recommend(users_interactions, num_recommendations=10)

  Plugs into the evaluation stack through
  :class:`recoder_tpu_torch.recommender.InferenceRecommender`.

  Args:
    embedding_size (int): factor dimensionality d.
    alpha (float): confidence slope, ``c = 1 + alpha * r``.
    lam (float): L2 regularization base.
    sweeps (int): alternating solve sweeps (each = one exact user-side
      solve + one exact item-side solve).
    reg_scaling ('frequency' | 'none'): 'frequency' scales each row's
      L2 by ``(nnz + 1)`` (Rendle'21); 'none' is constant ``lam``.
    init_scale (float): stddev of the item-factor init,
      ``N(0, init_scale^2 / d)``.
    seed (int): init seed (numpy, as in the JAX package, so both start
      from the same item factors).
    device: where the factors, the chunk plans and every solve live:
      the card ('cuda') unless the caller asks for 'cpu'.
  """

  def __init__(self, embedding_size=128, alpha=30.0, lam=3e-3, sweeps=10,
               reg_scaling='frequency', init_scale=1.0, seed=0,
               device=device_lib.DEFAULT):
    if reg_scaling not in ('frequency', 'none'):
      raise ValueError(f'unknown reg_scaling {reg_scaling!r}')
    self.embedding_size = int(embedding_size)
    self.alpha = float(alpha)
    self.lam = float(lam)
    self.sweeps = int(sweeps)
    self.reg_scaling = reg_scaling
    self.init_scale = float(init_scale)
    self.seed = int(seed)
    self.device = device_lib.resolve(device)
    self.num_items = None
    self.num_users = None
    self.user_factors = None  # [num_users, d] (training users)
    self.item_factors = None  # [num_items, d]
    #: the last fit's mesh and user-factor layout (None: one device)
    self.mesh = None
    self.factor_sharding = None

  # -- training ----------------------------------------------------------

  def fit(self, train_matrix, sweeps=None, chunk_elems=1 << 21,
          callback=None, mesh=None, factor_sharding=None):
    """Alternating exact solves from a ``scipy.sparse`` [users, items]
    matrix of raw interaction values (binary or counts).

    Args:
      train_matrix: ``scipy.sparse`` [users, items]; values feed the
        confidence ``c = 1 + alpha * r``.
      sweeps: override the constructor's sweep count.
      chunk_elems: element budget for one solve batch's gathered slab
        (B * L); the transient device working set is about
        ``chunk_elems * d * 20`` bytes (slab, weighted slabs, block
        partials, systems; 5 GiB at 2^21 and d=128). The resident chunk
        plans cost ~8 bytes per padded nnz per side.
      callback: optional ``f(sweep)`` called after each sweep.
      mesh: a ('data', 'model') mesh from
        :func:`recoder_tpu_torch.parallel.make_mesh` (every rank calls
        ``fit`` with the same arguments and matrix): each chunk's row
        solves are split over every rank (module docstring); the fit
        runs on the mesh's device. The chunk budget is then each rank's.
      factor_sharding (None | 'users'): 'users' keeps the user factors
        row-sharded over the mesh's ranks (it needs ``mesh``): each
        rank's ``user_factors`` are then its ``[ceil((num_users + 1) /
        ranks), d]`` rows, the pad rows zero. :meth:`save` and
        :meth:`objective` gather them; the item factors, which fold-in,
        ``predict`` and ``recommend`` read, are replicated.
    """
    if factor_sharding not in (None, 'users'):
      raise ValueError(f'unknown factor_sharding {factor_sharding!r}')
    if factor_sharding == 'users' and mesh is None:
      raise ValueError("factor_sharding='users' requires a mesh")
    if mesh is not None:
      if mesh.device.type != self.device.type:
        raise ValueError(f'device {self.device} differs from the mesh\'s '
                         f'{mesh.device}')
      self.device = mesh.device
    self.mesh, self.factor_sharding = mesh, factor_sharding
    m = sp.csr_matrix(train_matrix, copy=True).astype(np.float32)
    m.eliminate_zeros()  # an explicit zero is NOT an observation
    if m.nnz and m.data.min() < 0:
      raise ValueError('iALS confidence c = 1 + alpha * r needs '
                       'non-negative interaction values')
    n_users, n_items = m.shape
    self.num_items = n_items
    self.num_users = n_users
    d = self.embedding_size
    sweeps = self.sweeps if sweeps is None else int(sweeps)

    rng = np.random.default_rng(self.seed)
    # users start at zero: the first user solve is then exact given the
    # item init (x = 0 is what the solve returns for empty rows too)
    item_f = torch.from_numpy(
        (rng.standard_normal((n_items, d)).astype(np.float32)
         * (self.init_scale / np.sqrt(d))).astype(np.float32)
    ).to(self.device)

    user_half, item_half = self._half_sweeps(m, chunk_elems)
    for sweep in range(sweeps):
      user_f = user_half(item_f)
      item_f = item_half(user_f)
      if callback is not None:
        self.user_factors, self.item_factors = user_f, item_f
        callback(sweep)
    # final user half-sweep: stored user factors are exact against the
    # final item factors (fold-in of a training history reproduces them
    # bit for bit, and U @ V^T scores use a consistent pair)
    self.user_factors = user_half(item_f)
    self.item_factors = item_f
    return self

  def _half_sweeps(self, m, chunk_elems):
    """``(user_half, item_half)``: each solves every row of its side
    against the other side's factors, off chunk plans built once (they
    depend only on the CSR), in the fit's layout (``self.mesh``,
    ``self.factor_sharding``)."""
    mesh = self.mesh
    users = self.factor_sharding == 'users'
    user_plan = self._chunk_plan(m, chunk_elems, mesh=mesh)
    item_plan = self._chunk_plan(m.T.tocsr(), chunk_elems, mesh=mesh,
                                 whole_cols=users)
    if not users:
      return (lambda f: self._solve_side(None, f, plan=user_plan, mesh=mesh),
              lambda f: self._solve_side(None, f, plan=item_plan, mesh=mesh))
    shards = _UserShards(m.shape[0], mesh)
    return (lambda f: self._user_half_sharded(f, user_plan, shards),
            lambda f: self._item_half_sharded(f, item_plan, shards))

  def _user_half_sharded(self, item_f, plan, shards):
    """``factor_sharding='users'``'s user solve: this rank's rows of each
    chunk solved against the replicated item factors, the chunk's
    solutions gathered, and the rows this rank owns kept (the others,
    and the pad rows, go to a spare row)."""
    d = item_f.shape[1]
    with full_float32():
      item_pad = torch.cat([item_f, item_f.new_zeros((1, d))])
      gram = _gram(item_f)
      out = item_f.new_zeros((shards.per + 1, d))
      for c in plan['chunks']:
        x = _solve_rows(item_pad, gram, c['cols'], c['vals'], self.alpha,
                        c['reg'])
        x = collectives.gather_rows(x, None, [x.shape[0]] * shards.world)
        out.index_copy_(0, shards.local(c['rows']), x)
    return out[:shards.per]

  def _item_half_sharded(self, user_f, plan, shards):
    """``factor_sharding='users'``'s item solve against the row-sharded
    user factors: for each chunk and each rank ``j``, every rank fills
    the slots of ``j``'s rows whose user it owns (a zero row elsewhere)
    and the slabs are summed onto ``j`` (each slot has one owner: the
    sum is exact); each rank then solves its rows, and the solutions are
    gathered into the replicated item factors. The Gram is the sum of
    the ranks' Grams of their real users' rows. The transient is one
    rank's ``[B / ranks, L, d]`` slab."""
    d = user_f.shape[1]
    with full_float32():
      user_pad = torch.cat([user_f, user_f.new_zeros((1, d))])
      gram = collectives.sum_over(_gram(user_f[:shards.valid]), None)
      out = user_f.new_zeros((plan['n_rows'] + 1, d))
      for c in plan['chunks']:
        b, L = c['cols'].shape
        slab = None
        for j in range(shards.world):
          ids = c['cols_all'][j * b:(j + 1) * b].reshape(-1).long()
          part = user_pad.index_select(0, shards.local(ids)).view(b, L, d)
          collectives.reduce_to(part, j, None)
          if j == shards.index:
            slab = part
        valid = (c['cols'] < shards.num_users).to(c['vals'].dtype)
        x = _solve_rows_from_slab(slab, gram, valid, c['vals'], self.alpha,
                                  c['reg'])
        x = collectives.gather_rows(x, None, [b] * shards.world)
        out.index_copy_(0, c['rows'], x)
    return out[:plan['n_rows']]

  def _whole_user_factors(self):
    """``[num_users, d]`` user factors: the row shards gathered after a
    ``factor_sharding='users'`` fit (every rank calls it), else as they
    are."""
    if self.factor_sharding != 'users':
      return self.user_factors
    per = self.user_factors.shape[0]
    world, _ = _mesh_ways(self.mesh)
    return collectives.gather_rows(self.user_factors, None,
                                   [per] * world)[:self.num_users]

  def _chunk_plan(self, csr, chunk_elems=1 << 21, mesh=None,
                  whole_cols=False):
    """Epoch-invariant padded chunk tensors for :meth:`_solve_side`,
    built in numpy as the JAX package builds them and moved to the
    device once.

    Rows are nnz-sorted and chunked greedily with power-of-two batch B
    and padded row length L; B is bounded by both the [B, L, d] slab
    and the [B, d, d] systems tensor. Returns ``{'chunks': [...],
    'n_rows': int}``; each chunk holds int64 ``rows`` [B] (the scatter's
    index type), int32 ``cols`` [B, L] and float32 ``vals`` [B, L] /
    ``reg`` [B].

    With ``mesh`` B is padded to a multiple of the mesh's ranks (the
    pad rows, id ``n_rows``, have zero weights and drop at the scatter)
    and a rank keeps its ``B / ranks`` rows of ``cols``, ``vals`` and
    ``reg`` (``rows`` stays whole: the scatter of the gathered
    solutions reads it); ``whole_cols`` keeps the chunk's whole ``cols``
    too, as ``cols_all`` (the users-sharded item solve fills the other
    ranks' slots).
    """
    n_rows, n = csr.shape
    nnz = np.diff(csr.indptr).astype(np.int64)
    world, index = _mesh_ways(mesh)
    chunks = []
    for rows, B, L in self._chunk_layout(nnz, chunk_elems):
      # (B is a power of two: only chunks smaller than the mesh pad)
      B = -(-B // world) * world
      cols = np.full((B, L), n, np.int32)
      vals = np.zeros((B, L), np.float32)
      # vectorized padded gather of the chunk's CSR slices
      ks = nnz[rows]
      total = int(ks.sum())
      if total:
        rowpos = np.repeat(np.arange(len(rows)), ks)
        colpos = np.arange(total) - np.repeat(np.cumsum(ks) - ks, ks)
        src = np.repeat(csr.indptr[rows], ks) + colpos
        cols[rowpos, colpos] = csr.indices[src]
        vals[rowpos, colpos] = csr.data[src]
      if self.reg_scaling == 'frequency':
        reg = self.lam * (ks.astype(np.float32) + 1.0)
        reg = np.pad(reg, (0, B - len(rows)), constant_values=self.lam)
      else:
        reg = np.full(B, self.lam, np.float32)
      # pad row ids scatter to the dropped row n_rows
      rows_pad = np.full(B, n_rows, np.int64)
      rows_pad[:len(rows)] = rows
      b = B // world
      mine = slice(index * b, (index + 1) * b)
      arrays = [('rows', rows_pad), ('cols', cols[mine]),
                ('vals', vals[mine]), ('reg', reg[mine])]
      if whole_cols:
        arrays.append(('cols_all', cols))
      chunks.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(
          self.device) for k, v in arrays})
    return {'chunks': chunks, 'n_rows': n_rows}

  def _chunk_layout(self, nnz, chunk_elems=1 << 21):
    """Yield ``(row ids, B, L)`` per chunk for rows of ``nnz`` entries:
    the JAX package's nnz-sorted greedy power-of-two ladder."""
    d = self.embedding_size
    order = np.argsort(-nnz, kind='stable')
    i = 0
    while i < len(nnz):
      L = max(8, _pow2_ceil(nnz[order[i]]))
      if L > chunk_elems:
        raise ValueError(
            f'row nnz {int(nnz[order[i]])} exceeds chunk_elems='
            f'{chunk_elems}; raise chunk_elems (device working set is '
            f'~chunk_elems * d * 20 bytes)')
      # the gathered slab is [B, L, d] AND the systems tensor is
      # [B, d, d]: bound B by both so neither exceeds the budget
      B = max(1, min(_pow2_floor(chunk_elems // L),
                     _pow2_floor(chunk_elems // d)))
      rows = order[i:i + B]
      i += len(rows)
      yield rows, B, L

  def _solve_side(self, csr, factors, chunk_elems=1 << 21, plan=None,
                  mesh=None):
    """Solve every row of ``csr`` against the opposite-side
    ``factors``; returns the new [rows, d] factor matrix (device).

    With ``plan`` (a cached :meth:`_chunk_plan`), ``csr`` is ignored
    and the whole solve runs off resident device tensors. With ``mesh``
    (the plan's) each rank solves its rows of a chunk and the chunk's
    solutions are gathered: every rank returns the whole matrix.
    """
    if plan is None:
      plan = self._chunk_plan(csr, chunk_elems, mesh=mesh)
    world, _ = _mesh_ways(mesh)
    d = factors.shape[1]
    n_rows = plan['n_rows']
    with full_float32():
      factors_pad = torch.cat([factors, factors.new_zeros((1, d))])
      gram = _gram(factors)
      # pad row ids (== n_rows) scatter into the last row, dropped
      out = factors.new_zeros((n_rows + 1, d))
      for c in plan['chunks']:
        x = _solve_rows(factors_pad, gram, c['cols'], c['vals'],
                        self.alpha, c['reg'])
        if mesh is not None:
          x = collectives.gather_rows(x, None, [x.shape[0]] * world)
        out.index_copy_(0, c['rows'], x)
    return out[:n_rows]

  def objective(self, train_matrix):
    """The exact iALS objective on the fitted factors (host float64;
    diagnostic -- ALS decreases it monotonically every half-sweep). After
    a ``factor_sharding='users'`` fit every rank calls it (the user
    factors are gathered)."""
    assert self.item_factors is not None, 'call fit() first'
    m = sp.csr_matrix(train_matrix, copy=True).astype(np.float64)
    m.eliminate_zeros()  # same convention as fit()
    u = self._whole_user_factors().cpu().double().numpy()[:m.shape[0]]
    v = self.item_factors.cpu().double().numpy()

    # sum over ALL pairs of 1 * (0 - x.y)^2 = tr(U^T U V^T V), then
    # correct the observed cells from 1*(x.y)^2 to c*(1 - x.y)^2
    gu, gv = u.T @ u, v.T @ v
    total = float(np.sum(gu * gv))
    coo = m.tocoo()
    s = np.einsum('nd,nd->n', u[coo.row], v[coo.col])
    c = 1.0 + self.alpha * coo.data
    total += float(np.sum(c * (1.0 - s) ** 2 - s ** 2))
    nnz_u = np.diff(m.indptr)
    nnz_v = np.diff(m.tocsc().indptr)
    if self.reg_scaling == 'frequency':
      ru = self.lam * (nnz_u + 1.0)
      rv = self.lam * (nnz_v + 1.0)
    else:
      ru = np.full(m.shape[0], self.lam)
      rv = np.full(m.shape[1], self.lam)
    total += float(ru @ np.einsum('nd,nd->n', u, u))
    total += float(rv @ np.einsum('nd,nd->n', v, v))
    return total

  # -- inference ---------------------------------------------------------

  def fold_in(self, users_interactions):
    """Query-user factors [B, d] solved against the fitted item factors
    with the training solve (a training user's history reproduces their
    trained factor)."""
    assert self.item_factors is not None, 'call fit() or load() first'
    m = users_interactions.interactions_matrix.tocsr().astype(np.float32)
    m.eliminate_zeros()  # same convention as fit()
    if m.nnz and m.data.min() < 0:
      # c = 1 + alpha * r needs r >= 0; a negative value would make the
      # system indefinite and the solve would return NaN silently
      raise ValueError('iALS fold-in requires non-negative '
                       'interaction values')
    if m.shape[1] != self.num_items:
      raise ValueError(f'input has {m.shape[1]} items, model was fit '
                       f'on {self.num_items}')
    return self._solve_side(m, self.item_factors)

  def predict(self, users_interactions, return_input=False):
    """Dense scores [B, num_items] via fold-in + one matmul."""
    x = self.fold_in(users_interactions)
    with full_float32():
      scores = torch.matmul(x, self.item_factors.t())
    if return_input:
      xd = torch.from_numpy(np.asarray(
          users_interactions.interactions_matrix.todense(),
          np.float32)).to(self.device)
      return scores, xd
    return scores

  def recommend(self, users_interactions, num_recommendations):
    """Top-k unseen items per user (same contract as Recoder.recommend)."""
    return topk_unseen(self, users_interactions, num_recommendations)

  def recommend_async(self, users_interactions, num_recommendations):
    """Evaluator-pipeline variant (same results as :meth:`recommend`)."""
    return topk_unseen(self, users_interactions, num_recommendations)

  # -- checkpointing -----------------------------------------------------

  def save(self, path):
    """Write fitted factors + hyperparameters to ``path`` in the JAX
    package's npz format, plus ``init_scale`` and ``seed`` (which the
    JAX package's reader ignores). After a mesh fit every rank calls it:
    the factors are gathered, rank 0 writes the file a single device
    writes, and the other ranks wait for it."""
    assert self.item_factors is not None, 'nothing to save: fit() first'
    user_factors = self._whole_user_factors()
    if self.mesh is None or torch.distributed.get_rank() == 0:
      save_checkpoint(
          path,
          {'user_factors': user_factors,
           'item_factors': self.item_factors},
          {'model': 'ials', 'embedding_size': self.embedding_size,
           'alpha': self.alpha, 'lam': self.lam, 'sweeps': self.sweeps,
           'reg_scaling': self.reg_scaling, 'num_items': self.num_items,
           'init_scale': self.init_scale, 'seed': self.seed,
           'recoder_version': recoder_tpu_torch.__version__})
    if self.mesh is not None:
      torch.distributed.barrier()
    return path

  def load(self, path):
    """Restore a model saved by :meth:`save` or by the JAX package's
    ``IALS.save`` (whose files lack ``init_scale`` and ``seed``: they
    default to 1.0 and 0)."""
    arrays, meta = load_checkpoint(path)
    if meta.get('model') != 'ials':
      raise ValueError(f'{path} is not an iALS checkpoint: {meta}')
    self.embedding_size = int(meta['embedding_size'])
    self.alpha = float(meta['alpha'])
    self.lam = float(meta['lam'])
    self.sweeps = int(meta['sweeps'])
    self.reg_scaling = str(meta['reg_scaling'])
    self.init_scale = float(meta.get('init_scale', 1.0))
    self.seed = int(meta.get('seed', 0))
    self.num_items = int(meta['num_items'])
    self.mesh = self.factor_sharding = None
    self.user_factors = torch.from_numpy(
        np.asarray(arrays['user_factors'], np.float32)).to(self.device)
    self.item_factors = torch.from_numpy(
        np.asarray(arrays['item_factors'], np.float32)).to(self.device)
    self.num_users = int(self.user_factors.shape[0])
    return self
