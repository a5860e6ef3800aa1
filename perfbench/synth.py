"""Synthetic interaction matrices with a published data set's shape.

A frozen copy of the laws of ``bench.py``'s ``synthesize`` (also
``recoder_tpu_torch/data/synthetic.py``), redrawn on the device from the
run's seed so that set-up pays a few batched launches instead of a host
sort: per-user counts lognormal (sigma 0.9) around ``mean_items x
mean_factor``, clipped to [5, 1000] and truncated to integers; each
interaction's item ``floor(num_items x u ** 2.2)`` for ``u`` uniform in
[0, 1) (a Zipf-like popularity); duplicate (user, item) draws collapse
into one interaction of value 1. The same seed on the same kind of device
gives the same matrix; the laws are the original's, the draws are not
numpy's.
"""

import numpy as np
import torch

#: the seed of the user sizes: every run draws the same set of sizes
SIZES_SEED = 0


def synthesize(shape, seed, device):
  """CSR matrix (scipy, float32 ones, sorted column indices) drawn on
  ``device`` with the laws of the configuration's ``data`` block
  ``shape``: ``num_users``, ``num_items``, ``mean_items``,
  ``mean_factor``, ``sigma``, ``min_items``, ``max_items``, ``zipf``.
  Every run draws the same set of user sizes (from :data:`SIZES_SEED`)
  and deals them to the users, and draws each interaction's item, from
  ``seed``: the work of a step does not depend on the seed, its data
  does."""
  from scipy.sparse import csr_matrix
  n, m = int(shape['num_users']), int(shape['num_items'])
  gen = torch.Generator(device=device)
  gen.manual_seed(SIZES_SEED)
  counts = torch.empty(n, dtype=torch.float64, device=device).log_normal_(
      float(np.log(shape['mean_items'] * shape['mean_factor'])),
      float(shape['sigma']), generator=gen)
  counts = counts.clamp_(shape['min_items'], shape['max_items']).long()
  gen.manual_seed(int(seed))
  counts = counts[torch.randperm(n, device=device, generator=gen)]
  users = torch.repeat_interleave(torch.arange(n, device=device), counts)
  u = torch.rand(users.numel(), dtype=torch.float64, device=device,
                 generator=gen)
  items = torch.floor(m * u ** float(shape['zipf'])).long().clamp_(max=m - 1)
  keys = torch.unique(users * m + items)  # sorted: CSR order
  rows = torch.div(keys, m, rounding_mode='floor')
  indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
  indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
  indices = (keys - rows * m).int()
  matrix = csr_matrix((np.ones(keys.numel(), np.float32),
                       indices.cpu().numpy(), indptr.cpu().numpy()),
                      shape=(n, m))
  matrix.has_canonical_format = True  # (unique keys, sorted)
  return matrix
