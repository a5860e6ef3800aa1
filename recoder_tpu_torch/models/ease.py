"""EASE: the closed-form shallow autoencoder (Steck, WWW'19).

Port of ``recoder_tpu/models/ease.py``. With X the [users, items]
interaction matrix and G = X^T X,

    P = (G + lam * I)^{-1}
    B[i, j] = -P[i, j] / P[j, j],   diag(B) = 0

and the scores are X @ B.

``fit`` accumulates G on the device in user chunks (the JAX
``_device_gram``): each chunk's rows are densified on the device and G +=
Xc^T Xc is one library product. Binary data multiplies as bf16 operands,
which hold 0 and 1 exactly, with a float32 output (``torch.mm(...,
out_dtype=float32)``, the JAX ``Precision.HIGH`` rule); every count stays
below 2^24, so G is exact. Other values multiply in float32 with TF32
off (the JAX ``HIGHEST``). The inverse is a Cholesky factorization and
``cholesky_inverse`` (cuSOLVER on the card, LAPACK on the CPU), in
float32 with TF32 off, then B in place with an exactly zero diagonal.

The JAX package inverts by a Newton-Schulz iteration on accelerators
because XLA:TPU's Cholesky did not compile at 20k items; that workaround
is not ported (``solve='newton'`` without a mesh raises).

``fit(mesh=...)`` is the JAX package's row-sharded fit, for catalogs
whose ``[n, n]`` buffers outgrow one card: every ``[n, n]`` buffer is
row-sharded over the mesh's 'model' axis (``np.array_split``'s ranges,
``parallel/sharding.row_range``), so that no rank holds a whole one. G
accumulates from the first user chunk as the rank's rows, ``Xc[:,
rows]^T Xc``. The inverse is the JAX mesh path's own function, the
Newton-Schulz iteration ``X <- X (2I - A X)`` from ``X0 = I / ||A||_1``
(:func:`newton_inverse_rows`): a Cholesky factorization does not split
by rows, the iteration is nothing but products. Each product contracts
the sharded dimension, so it runs as local products over the other
ranks' row blocks, each broadcast by its owner in turn; every product is
float32 with TF32 off. B's rows follow, and ``item_weights`` is the
rank's ``[rows, n]`` block of B: ``predict`` adds the ranks' partial
products over 'model', ``save`` gathers B on rank 0's host, one
rank's rows at a time. The 'data' ranks of a mesh repeat the solve of
their 'model' row.

EASE runs on the card unless it is given ``device='cpu'``; checkpoints
are the JAX package's npz files, readable either way.
"""

import time

import numpy as np
import torch

import recoder_tpu_torch
from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from recoder_tpu_torch.ops.gather_matmul import full_float32
from recoder_tpu_torch.parallel import collectives
from recoder_tpu_torch.parallel.sharding import row_range, split_sizes
from recoder_tpu_torch.recommender import topk_unseen

#: the JAX ``_newton_inverse``'s phases: (tolerance, most iterations) of
#: the coarse phase and of the refinement (on the card both multiply in
#: float32 without TF32; the JAX coarse phase's Precision.HIGH is a speed
#: tier of the TPU)
NEWTON_PHASES = ((1.5e-5, 80), (1e-9, 6))
#: the largest RMS residual the fit accepts (the JAX ``_check_newton``)
NEWTON_MAX_RESIDUAL = 1e-4
#: rows of a residual's correction at a time (a copy of that many rows)
_RESIDUAL_ROWS = 1024


def b_from_p_(p):
  """EASE weights from the inverse, in place: ``B = -P / diag(P)`` by
  column, with an exactly zero diagonal; returns ``p``."""
  p.div_(p.diagonal().neg()[None, :])
  p.fill_diagonal_(0.0)
  return p


def spd_inverse(g, lam):
  """``(G + lam * I)^{-1}`` by Cholesky (TF32 off); ``g`` is not
  changed. Raises where G + lam * I is not positive definite."""
  with full_float32():
    a = g.clone()
    a.diagonal().add_(lam)
    chol = torch.linalg.cholesky(a)
    del a
    return torch.cholesky_inverse(chol)


def _row_block_product(left, right, sizes, group):
  """``(L @ R)[rows]`` of two row-sharded ``[n, n]`` matrices from this
  rank's rows ``left = L[rows]`` and ``right = R[rows]``: the contraction
  runs over every rank's row block of ``R`` (``sizes``: the ranks' row
  counts), each broadcast by its owner in turn, against the matching
  columns of ``left``. A group of one multiplies ``left @ right``."""
  me = torch.distributed.get_rank(group)
  out, col = None, 0
  for j, rows in enumerate(sizes):
    block = (right if j == me
             else right.new_empty((rows, right.shape[1])))
    collectives.broadcast_from(block, j, group)
    part = left[:, col:col + rows]
    out = part @ block if out is None else out.addmm_(part, block)
    col += rows
  return out


def _rms_residual(ax, lo, n, group):
  """``||A X - I||_F / n`` (the true per-entry RMS) from this rank's rows
  ``ax = (A X)[lo:lo + rows]``: sums of squares of row slices, with the
  identity subtracted in a copy, added over the group."""
  total = torch.zeros((), dtype=torch.float64, device=ax.device)
  for r in range(0, ax.shape[0], _RESIDUAL_ROWS):
    rows = ax[r:r + _RESIDUAL_ROWS].clone()
    rows.diagonal(offset=lo + r).sub_(1.0)
    total += torch.sum(rows * rows).double()
  return float(torch.sqrt(collectives.sum_over(total, group))) / n


def newton_inverse_rows(a, lo, n, group):
  """This rank's rows ``[lo, lo + rows)`` of ``A^{-1}`` of an SPD ``A``
  row-sharded over ``group`` (``a = A[lo:lo + rows]``), by the JAX
  ``_newton_inverse``: ``X_{k+1} = X_k (2I - A X_k)`` from ``X_0 =
  I / ||A||_1`` (for SPD A the eigenvalues of ``X_0 A`` lie in (0, 1]).
  Two phases (``NEWTON_PHASES``), each ending at its tolerance, its
  iteration count, or a stall (a residual that failed to decrease:
  the float32 floor); the residual is the true per-entry RMS of ``I -
  A X`` at the iterate before the update. Returns ``(x, residual after
  the last update, (coarse, refinement) iterations)``. Every product is
  float32 with TF32 off."""
  ways = torch.distributed.get_world_size(group)
  sizes = [row_range(n, ways, j)[1] - row_range(n, ways, j)[0]
           for j in range(ways)]
  with full_float32():
    norm1 = collectives.max_over(torch.amax(torch.sum(torch.abs(a), 1)),
                                 group)
    x = torch.zeros_like(a)
    x.diagonal(offset=lo).fill_(1.0)
    x.div_(norm1)
    iters, r = [], float('inf')
    for tol, most in NEWTON_PHASES:
      # (the JAX while_loop: the residual is the iterate's before its
      # update, and the loop tests it after the update)
      r_prev, i = float('inf'), 0
      while r > tol and i < most and (i == 0 or r < r_prev):
        ax = _row_block_product(a, x, sizes, group)
        r_prev, r = r, _rms_residual(ax, lo, n, group)
        # x <- 2 x - x (A x)
        x = _row_block_product(x, ax, sizes, group).neg_().add_(x, alpha=2.0)
        del ax
        i += 1
      iters.append(i)
    r = _rms_residual(_row_block_product(a, x, sizes, group), lo, n, group)
  return x, r, tuple(iters)


class EASE:
  """Embarrassingly Shallow Autoencoder.

  Usage::

      model = EASE(lam=200.0)
      model.fit(train_matrix)                # scipy.sparse CSR
      recs = model.recommend(users_interactions, num_recommendations=10)

  It plugs into the evaluation stack through
  :class:`recoder_tpu_torch.recommender.InferenceRecommender` (the same
  ``recommend(users_interactions, num_recommendations)`` contract as
  :class:`recoder_tpu_torch.model.Recoder`).

  Args:
    lam (float): L2 regularization of the item-item solve.
    device: where G, the solve, B and the scoring live: the card
      ('cuda') unless the caller asks for 'cpu'.
  """

  def __init__(self, lam=200.0, device=device_lib.DEFAULT):
    self.lam = float(lam)
    self.device = device_lib.resolve(device)
    self.num_items = None
    self.item_weights = None  # B [items, items], zero diagonal
    #: the last fit's mesh (None: one device); on a mesh
    #: ``item_weights`` holds this rank's rows ``rows`` of B
    self.mesh = None
    self.rows = None
    #: the last mesh fit's record: the Newton-Schulz iterations
    #: (coarse, refinement), the RMS residual, the shapes of the rank's
    #: Gram and iterate, and the seconds of the Gram and of the solve
    self.fit_info = None

  # -- training ----------------------------------------------------------

  def fit(self, train_matrix, gram='auto', max_items=65536,
          solve='auto', mesh=None):
    """Closed-form fit from a ``scipy.sparse`` user-item matrix.

    Args:
      train_matrix: ``scipy.sparse`` [users, items].
      gram ('auto' | 'device' | 'host'): where to accumulate X^T X:
        'device' in user chunks on this model's device, 'host' as a
        scipy sparse product; 'auto' is 'device' on the card and 'host'
        on the CPU.
      max_items (int): the guard on the [items, items] working set
        (G, its factor and P, float32); fit raises past it.
      solve ('auto' | 'cholesky' | 'newton'): 'auto' and 'cholesky'
        factor by Cholesky on every device; the JAX package's
        Newton-Schulz iteration ('newton') is a TPU workaround and is
        not ported for one device. A mesh fit runs Newton-Schulz
        whatever this says, as in JAX.
      mesh: a ('data', 'model') mesh from
        :func:`recoder_tpu_torch.parallel.make_mesh` (every rank calls
        ``fit`` with the same arguments and matrix): G, the iterate and
        B row-sharded over 'model' (module docstring); the fit runs on
        the mesh's device. It raises RuntimeError, as the JAX fit does,
        where the iteration ends above an RMS residual of
        ``NEWTON_MAX_RESIDUAL``.
    """
    if mesh is not None:
      if mesh.device.type != self.device.type:
        raise ValueError(f'device {self.device} differs from the mesh\'s '
                         f'{mesh.device}')
      self.device = mesh.device
    self.mesh = mesh
    if solve == 'newton' and mesh is None:
      raise NotImplementedError(
          "EASE solve='newton' is not ported: the Newton-Schulz inverse "
          "exists because XLA:TPU's Cholesky did not compile at 20k items "
          "(ROADMAP, 'Do not port TPU-only workarounds'); cuSOLVER's "
          "Cholesky has no such limit, use solve='auto'")
    if solve not in ('auto', 'cholesky', 'newton'):
      raise ValueError(f'unknown solve {solve!r}')
    if gram not in ('auto', 'device', 'host'):
      raise ValueError(f'unknown gram mode {gram!r}')
    m = train_matrix.tocsr().astype(np.float32)
    if m.shape[1] > max_items:
      raise ValueError(
          f'EASE is dense [items, items]: {m.shape[1]} items needs '
          f'~{3 * m.shape[1] ** 2 * 4 / 2 ** 30:.0f} GiB for G/P/B, '
          f'past the max_items={max_items} guard. EASE targets '
          f'catalogs <= ~60k items; use DynamicAutoencoder/MultVAE '
          f'for larger catalogs, or pass max_items= explicitly if '
          f'the memory is really there.')
    self.num_items = m.shape[1]
    if gram == 'auto':
      gram = 'device' if self.device.type == 'cuda' else 'host'
    self.rows = (None if mesh is None else
                 row_range(m.shape[1], mesh.shape['model'], mesh.model_rank))
    lo, hi = self.rows or (0, m.shape[1])
    t0 = time.time()
    if gram == 'device':
      g = self._device_gram(m)
    else:
      g = torch.from_numpy(np.asarray((m[:, lo:hi].T @ m).todense(),
                                      dtype=np.float32)).to(self.device)
    if mesh is not None:
      self.item_weights = self._newton_b(g, time.time() - t0)
      return self
    p = spd_inverse(g, self.lam)
    del g
    self.item_weights = b_from_p_(p)
    return self

  def _newton_b(self, g, gram_s):
    """The mesh fit's B rows from the rank's G rows (consumed): the
    Newton-Schulz inverse of ``G + lam I`` (:func:`newton_inverse_rows`,
    refused above ``NEWTON_MAX_RESIDUAL`` as in JAX), then ``B = -P /
    diag(P)`` by column, with ``diag(P)`` gathered over 'model', and a
    zero diagonal."""
    group, (lo, hi), n = self.mesh.model_group, self.rows, self.num_items
    t0 = time.time()
    g.diagonal(offset=lo).add_(self.lam)
    p, resid, iters = newton_inverse_rows(g, lo, n, group)
    del g
    if self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
    self.fit_info = {'iterations': iters, 'residual': resid,
                     'gram_shape': (hi - lo, n), 'iterate_shape':
                     tuple(p.shape), 'gram_s': gram_s,
                     'solve_s': time.time() - t0}
    if not resid < NEWTON_MAX_RESIDUAL:  # (also catches NaN)
      raise RuntimeError(
          f'Newton-Schulz inverse did not converge (RMS residual '
          f'{resid:.2e} after {sum(iters)} iterations); the Gram is '
          f'too ill-conditioned for this lam -- raise lam')
    diag = collectives.gather_rows(p.diagonal(offset=lo).contiguous(),
                                   group, split_sizes(n, self.mesh))
    p.div_(diag.neg()[None, :])
    p.diagonal(offset=lo).fill_(0.0)
    return p

  def _device_gram(self, m, chunk_users=8192):
    """G = X^T X accumulated on the device over chunks of
    ``chunk_users`` users: each chunk densified by one scatter, then one
    product (bf16 operands with a float32 output for binary data, exact;
    float32 without TF32 otherwise). Once a mesh fit has set
    :attr:`rows`, G's rows ``[first, last)`` alone, ``Xc[:, first:last]^T
    Xc``."""
    n_users, n_items = m.shape
    binary = bool(np.all(m.data == 1.0))
    dtype = torch.bfloat16 if binary else torch.float32
    dev = self.device
    first, last = self.rows or (0, n_items)
    g = torch.zeros((last - first, n_items), dtype=torch.float32, device=dev)
    with full_float32():
      for s in range(0, n_users, chunk_users):
        e = min(s + chunk_users, n_users)
        lo, hi = int(m.indptr[s]), int(m.indptr[e])
        rows = np.repeat(np.arange(e - s, dtype=np.int64),
                         np.diff(m.indptr[s:e + 1]))
        slab = torch.zeros((e - s, n_items), dtype=dtype, device=dev)
        slab.index_put_(
            (torch.from_numpy(rows).to(dev),
             torch.from_numpy(m.indices[lo:hi].astype(np.int64)).to(dev)),
            torch.from_numpy(m.data[lo:hi]).to(dev, dtype), accumulate=True)
        if dev.type == 'cuda' and binary:
          g.add_(torch.mm(slab[:, first:last].t(), slab,
                          out_dtype=torch.float32))
        else:
          # (the CPU has no bf16 GEMM with a float32 output: the 0/1
          # operands multiply exactly in float32)
          slab = slab.float()
          g.addmm_(slab[:, first:last].t(), slab)
    return g

  # -- inference ---------------------------------------------------------

  def predict(self, users_interactions, return_input=False):
    """Dense scores [B, num_items] (``X @ B``, float32, TF32 off) for a
    batch of users; ``(scores, input)`` on the device when
    ``return_input``. Nothing is masked. After a mesh fit every rank
    calls it and gets the whole scores."""
    if self.item_weights is None:
      raise RuntimeError('call fit() or load() first')
    x = np.asarray(users_interactions.interactions_matrix.todense(),
                   dtype=np.float32)
    if x.shape[1] != self.num_items:
      raise ValueError(f'input has {x.shape[1]} items, model was fit '
                       f'on {self.num_items}')
    xd = torch.from_numpy(x).to(self.device)
    with full_float32():
      if self.mesh is None:
        scores = xd @ self.item_weights
      else:
        # (every rank calls it: the ranks' partial products, added)
        lo, hi = self.rows
        scores = collectives.sum_over(xd[:, lo:hi] @ self.item_weights,
                                      self.mesh.model_group)
    return (scores, xd) if return_input else scores

  def recommend(self, users_interactions, num_recommendations):
    """Top-k unseen items per user (same contract as Recoder.recommend)."""
    return topk_unseen(self, users_interactions, num_recommendations)

  def recommend_async(self, users_interactions, num_recommendations):
    """Evaluator-pipeline variant (same results as :meth:`recommend`)."""
    return topk_unseen(self, users_interactions, num_recommendations)

  # -- checkpointing -----------------------------------------------------

  def save(self, path):
    """Write the fitted weights and hyper-parameters to ``path`` in the
    JAX package's npz format. After a mesh fit every rank calls it: B's
    row blocks go one at a time to rank 0's host
    (:func:`~recoder_tpu_torch.parallel.collectives.gather_rows_to_host`,
    no card holds more than its share), rank 0 writes the file a single
    device writes, and the other ranks wait for it."""
    if self.item_weights is None:
      raise RuntimeError('nothing to save: fit() first')
    weights = self.item_weights
    if self.mesh is not None:
      # (the 'data' ranks repeat the 'model' rows: the first row gathers)
      weights = None if self.mesh.data_rank else (
          collectives.gather_rows_to_host(
              self.item_weights, self.mesh.model_group,
              split_sizes(self.num_items, self.mesh)))
    if self.mesh is None or torch.distributed.get_rank() == 0:
      save_checkpoint(path, {'item_weights': weights},
                      {'model': 'ease', 'lam': self.lam,
                       'num_items': self.num_items,
                       'recoder_version': recoder_tpu_torch.__version__})
    if self.mesh is not None:
      torch.distributed.barrier()
    return path

  def load(self, path):
    """Restore a model saved by :meth:`save` or by the JAX package's
    ``EASE.save``."""
    arrays, meta = load_checkpoint(path)
    if meta.get('model') != 'ease':
      raise ValueError(f'{path} is not an EASE checkpoint: {meta}')
    self.lam = float(meta['lam'])
    self.num_items = int(meta['num_items'])
    self.mesh = self.rows = None
    self.item_weights = torch.from_numpy(
        np.asarray(arrays['item_weights'], np.float32)).to(self.device)
    return self
