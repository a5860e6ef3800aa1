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
is not ported (``solve='newton'`` raises). ``fit(mesh=...)`` (the JAX
package's row-sharded solve) is not ported yet.

EASE runs on the card unless it is given ``device='cpu'``; checkpoints
are the JAX package's npz files, readable either way.
"""

import numpy as np
import torch

import recoder_tpu_torch
from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from recoder_tpu_torch.ops.gather_matmul import full_float32
from recoder_tpu_torch.recommender import topk_unseen


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
        not ported.
      mesh: the JAX package's row-sharded solve; not ported yet.
    """
    if mesh is not None:
      raise NotImplementedError(
          'EASE fit(mesh=...) is not ported to the PyTorch package yet '
          '(multi-GPU, ROADMAP Queue 1 item 8); fit on one device')
    if solve == 'newton':
      raise NotImplementedError(
          "EASE solve='newton' is not ported: the Newton-Schulz inverse "
          "exists because XLA:TPU's Cholesky did not compile at 20k items "
          "(ROADMAP, 'Do not port TPU-only workarounds'); cuSOLVER's "
          "Cholesky has no such limit, use solve='auto'")
    if solve not in ('auto', 'cholesky'):
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
    if gram == 'device':
      g = self._device_gram(m)
    else:
      g = torch.from_numpy(np.asarray((m.T @ m).todense(),
                                      dtype=np.float32)).to(self.device)
    p = spd_inverse(g, self.lam)
    del g
    self.item_weights = b_from_p_(p)
    return self

  def _device_gram(self, m, chunk_users=8192):
    """G = X^T X accumulated on the device over chunks of
    ``chunk_users`` users: each chunk densified by one scatter, then one
    product (bf16 operands with a float32 output for binary data, exact;
    float32 without TF32 otherwise)."""
    n_users, n_items = m.shape
    binary = bool(np.all(m.data == 1.0))
    dtype = torch.bfloat16 if binary else torch.float32
    dev = self.device
    g = torch.zeros((n_items, n_items), dtype=torch.float32, device=dev)
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
          g.add_(torch.mm(slab.t(), slab, out_dtype=torch.float32))
        else:
          # (the CPU has no bf16 GEMM with a float32 output: the 0/1
          # operands multiply exactly in float32)
          slab = slab.float()
          g.addmm_(slab.t(), slab)
    return g

  # -- inference ---------------------------------------------------------

  def predict(self, users_interactions, return_input=False):
    """Dense scores [B, num_items] (``X @ B``, float32, TF32 off) for a
    batch of users; ``(scores, input)`` on the device when
    ``return_input``. Nothing is masked."""
    if self.item_weights is None:
      raise RuntimeError('call fit() or load() first')
    x = np.asarray(users_interactions.interactions_matrix.todense(),
                   dtype=np.float32)
    if x.shape[1] != self.num_items:
      raise ValueError(f'input has {x.shape[1]} items, model was fit '
                       f'on {self.num_items}')
    xd = torch.from_numpy(x).to(self.device)
    with full_float32():
      scores = xd @ self.item_weights
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
    JAX package's npz format."""
    if self.item_weights is None:
      raise RuntimeError('nothing to save: fit() first')
    save_checkpoint(path, {'item_weights': self.item_weights},
                    {'model': 'ease', 'lam': self.lam,
                     'num_items': self.num_items,
                     'recoder_version': recoder_tpu_torch.__version__})
    return path

  def load(self, path):
    """Restore a model saved by :meth:`save` or by the JAX package's
    ``EASE.save``."""
    arrays, meta = load_checkpoint(path)
    if meta.get('model') != 'ease':
      raise ValueError(f'{path} is not an EASE checkpoint: {meta}')
    self.lam = float(meta['lam'])
    self.num_items = int(meta['num_items'])
    self.item_weights = torch.from_numpy(
        np.asarray(arrays['item_weights'], np.float32)).to(self.device)
    return self
