"""CSR-backed user-interactions dataset (numpy/scipy only).

A copy of ``recoder_tpu/data/dataset.py``; see ``recoder_tpu_torch.utils``
for why the port copies host-only modules instead of importing them.
"""

import numpy as np
import scipy.sparse as sparse


class UsersInteractions:
  """Interactions of a set of users as a CSR matrix.

  Args:
    users (np.ndarray): user ids; ``interactions_matrix[i]`` holds the
      interactions of ``users[i]``.
    interactions_matrix (scipy.sparse.csr_matrix): user-item matrix.
  """

  def __init__(self, users, interactions_matrix):
    self.users = users
    self.interactions_matrix = interactions_matrix


def _take_rows(matrix, index):
  """Extract rows ``index`` of a CSR matrix as a new CSR matrix."""
  index = np.asarray(index).reshape(-1)
  if index.size and index.min() < 0:
    n_rows = matrix.shape[0]
    bad = index[index < -n_rows]
    if bad.size:
      raise IndexError(f'row index {int(bad[0])} out of range for '
                       f'{n_rows} rows')
    index = np.where(index < 0, index + n_rows, index)
  indptr = matrix.indptr
  counts = indptr[index + 1] - indptr[index]
  out_indptr = np.zeros(len(index) + 1, dtype=indptr.dtype)
  np.cumsum(counts, out=out_indptr[1:])
  nnz = int(out_indptr[-1])
  out_indices = np.empty(nnz, dtype=matrix.indices.dtype)
  out_data = np.empty(nnz, dtype=matrix.data.dtype)
  if nnz:
    starts = indptr[index]
    reps = np.repeat(starts - out_indptr[:-1], counts)
    src = np.arange(nnz, dtype=np.int64) + reps
    out_indices[:] = matrix.indices[src]
    out_data[:] = matrix.data[src]
  return sparse.csr_matrix((out_data, out_indices, out_indptr),
                           shape=(len(index), matrix.shape[1]))


class RecommendationDataset:
  """Dataset over users' interactions with items.

  Indexing returns ``(UsersInteractions, UsersInteractions or None)``
  for the input and (optional) target matrices.

  Args:
    interactions_matrix (scipy.sparse.csr_matrix): user-item matrix.
    target_interactions_matrix (scipy.sparse.csr_matrix, optional):
      target matrix (evaluation ground truth).
  """

  def __init__(self, interactions_matrix, target_interactions_matrix=None):
    self.interactions_matrix = interactions_matrix.tocsr()
    self.target_interactions_matrix = (
        target_interactions_matrix.tocsr()
        if target_interactions_matrix is not None else None)
    self.users = np.arange(self.interactions_matrix.shape[0])
    self.items = np.arange(self.interactions_matrix.shape[1])

  def __len__(self):
    return self.interactions_matrix.shape[0]

  def __getitem__(self, index):
    users = np.array(index).reshape(-1)
    extracted = _take_rows(self.interactions_matrix, users)
    if self.target_interactions_matrix is None:
      return UsersInteractions(users=users, interactions_matrix=extracted), None
    extracted_target = _take_rows(self.target_interactions_matrix, users)
    return (UsersInteractions(users=users, interactions_matrix=extracted),
            UsersInteractions(users=users, interactions_matrix=extracted_target))
