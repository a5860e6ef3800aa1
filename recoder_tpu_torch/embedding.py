"""Embedding indexes: ANN search over item embeddings.

Port of ``recoder_tpu/embedding.py``: the same classes, names and save
formats, so each package loads the other's index files.

  * :class:`AnnEmbeddingsIndex` -- the C++ random-projection-forest ANN
    index (``recoder_tpu_torch/native/ann_index.cpp``, a copy of the JAX
    package's) with angular metric, save/load, and ctypes bindings. It
    runs on the host, as in the JAX package.
  * :class:`BruteForceEmbeddingsIndex` -- exact search: the normalized
    table lives on a device (the card unless the caller passes
    ``device='cpu'``), and a batch of queries is one ``[m, N]`` product
    followed by :func:`recoder_tpu_torch.ops.topk.top_k` (``lax.top_k``'s
    order: equal cosines go to the lower row) and one host read. It is
    the accuracy reference for the ANN index.

Similarity convention (the reference's): angular distance ``d = sqrt(2
- 2 cos)``; ``get_similarity`` returns ``((1 - d^2/2) + 1) / 2`` in
[0, 1].
"""

import pickle

import numpy as np
import torch

from recoder_tpu_torch import device as device_lib
from recoder_tpu_torch.ops.topk import top_k


class EmbeddingsIndex:
  """Abstract embeddings index (fetch + nearest-neighbor search)."""

  def get_embedding(self, embedding_id):
    """Embedding vector of item ``embedding_id``."""
    raise NotImplementedError

  def get_nns_by_id(self, embedding_id, n):
    """The ``n`` nearest neighbors of item ``embedding_id``."""
    raise NotImplementedError

  def get_nns_by_embedding(self, embedding, n):
    """The ``n`` nearest neighbors of a raw ``embedding`` vector."""
    raise NotImplementedError

  def get_similarity(self, id1, id2):
    """Similarity in [0, 1] between two items."""
    raise NotImplementedError

  # -- batch API (loop fallbacks; concrete indexes override with
  # vectorized / native-threaded implementations) ----------------------

  def get_nns_by_ids(self, ids, n):
    """Batch NN search: one id array per query (ids only, no dists)."""
    out = []
    for i in ids:
      r = self.get_nns_by_id(i, n)
      if isinstance(r, dict):
        r = list(r.keys())
      out.append(np.asarray(r).reshape(-1))
    return out

  def get_embeddings(self, ids):
    """Batch embedding fetch: [m, d] float32 array."""
    ids = list(ids)  # materialize once: a generator must not be
    # consumed twice (the second pass would see it exhausted)
    return np.asarray([self.get_embedding(i) for i in ids],
                      dtype=np.float32).reshape(len(ids), -1)


class _BaseIndex(EmbeddingsIndex):
  """Shared id-map plumbing for concrete indexes.

  Args:
    embeddings (np.ndarray [N, d], optional): required to build.
    id_map (dict, optional): original id -> embedding row; identity if
      omitted.
  """

  def __init__(self, embeddings=None, id_map=None):
    self.embeddings = (np.asarray(embeddings, dtype=np.float32)
                       if embeddings is not None else None)
    self.id_map = id_map
    self.inverse_id_map = None
    self.embedding_size = (self.embeddings.shape[1]
                           if self.embeddings is not None else None)

  def _finalize_id_map(self, n):
    if self.id_map is None:
      self.id_map = {i: i for i in range(n)}
    self.inverse_id_map = {v: k for k, v in self.id_map.items()}

  def _ids_out(self, indices, distances, include_distances):
    ids = [self.inverse_id_map[int(i)] for i in indices]
    if include_distances:
      return dict(zip(ids, [float(d) for d in distances]))
    return ids

  @staticmethod
  def _angular_to_similarity(distance):
    cosine_similarity = 1 - (distance ** 2) / 2  # [-1, 1]
    return (cosine_similarity + 1) / 2  # [0, 1]


class BruteForceEmbeddingsIndex(_BaseIndex):
  """Exact angular-metric search: normalize once, one product per batch.

  The rows are normalized on the host as the JAX package normalizes them
  (numpy float32) and placed on ``device``; the raw table stays on the
  host for ``get_embedding(s)`` and ``save``.

  Args:
    embeddings (np.ndarray, optional): [N, d] matrix; required to build.
    id_map (dict, optional): original-id -> row map.
    include_distances (bool): include distances in NN results.
    device: where the normalized table and the products live: the card
      ('cuda') unless the caller asks for 'cpu'.
  """

  def __init__(self, embeddings=None, id_map=None, include_distances=False,
               device=device_lib.DEFAULT):
    super().__init__(embeddings, id_map)
    self.include_distances = include_distances
    self.device = device_lib.resolve(device)
    self._normed = None

  def _place(self):
    norms = np.linalg.norm(self.embeddings, axis=1, keepdims=True)
    self._normed = torch.from_numpy(
        self.embeddings / np.maximum(norms, 1e-12)).to(self.device)

  def build(self, index_file=None):
    """Build (normalize rows); optionally save to ``index_file``."""
    assert self.embeddings is not None, 'embeddings required to build'
    self.embedding_size = self.embeddings.shape[1]
    self._place()
    self._finalize_id_map(self.embeddings.shape[0])
    if index_file:
      self._save(index_file)

  def _save(self, index_file):
    np.save(index_file + '.embeddings.npy', self.embeddings)
    state = {'embedding_size': self.embedding_size, 'id_map': self.id_map}
    with open(index_file, 'wb') as f:
      pickle.dump(state, f)

  def load(self, index_file):
    """Load a previously saved index."""
    with open(index_file, 'rb') as f:
      state = pickle.load(f)
    self.embedding_size = state['embedding_size']
    self.id_map = state['id_map']
    self.embeddings = np.load(index_file + '.embeddings.npy')
    self._place()
    self.inverse_id_map = {v: k for k, v in self.id_map.items()}

  def get_embedding(self, embedding_id):
    return self.embeddings[self.id_map[embedding_id]].tolist()

  def _nns(self, query, n):
    q = np.asarray(query, dtype=np.float32)
    qn = torch.from_numpy(q / max(np.linalg.norm(q), 1e-12))
    cos = torch.mv(self._normed, qn.to(self.device))
    n = min(n, cos.shape[0])
    vals, idx = top_k(cos, n)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    dist = np.sqrt(np.maximum(2.0 - 2.0 * vals, 0.0))
    return idx, dist

  def get_nns_by_id(self, embedding_id, n):
    idx, dist = self._nns(self.embeddings[self.id_map[embedding_id]], n)
    return self._ids_out(idx, dist, self.include_distances)

  def get_nns_by_embedding(self, embedding, n):
    idx, dist = self._nns(embedding, n)
    return self._ids_out(idx, dist, self.include_distances)

  def get_similarity(self, id1, id2):
    a = self._normed[self.id_map[id1]]
    b = self._normed[self.id_map[id2]]
    distance = float(np.sqrt(max(2.0 - 2.0 * float(a @ b), 0.0)))
    return self._angular_to_similarity(distance)

  def get_nns_by_ids(self, ids, n):
    """Exact batch search: one [m, N] product + per-row top-n on the
    device, one host read."""
    ids = list(ids)
    if not ids:
      return []
    rows = torch.as_tensor([self.id_map[i] for i in ids], dtype=torch.int64)
    q = self._normed[rows.to(self.device)]
    cos = torch.mm(q, self._normed.T)                       # [m, N]
    idx = top_k(cos, min(n, cos.shape[1]))[1].cpu().numpy()
    inv = self.inverse_id_map
    return [np.asarray([inv[int(r)] for r in row]) for row in idx]

  def get_embeddings(self, ids):
    rows = [self.id_map[i] for i in ids]
    return self.embeddings[rows].astype(np.float32, copy=False)


class AnnEmbeddingsIndex(_BaseIndex):
  """Approximate NN index: C++ random-projection forest, angular metric.

  The native backend (``recoder_tpu_torch/native/ann_index.cpp``) is a
  forest of random-hyperplane trees, searched best-first with a shared
  priority queue, candidates re-ranked exactly (the algorithm class of
  annoy, which the reference used).

  Args:
    embeddings (np.ndarray, optional): [N, d]; required to build.
    id_map (dict, optional): original-id -> row map.
    n_trees (int): trees in the forest.
    search_k (int): nodes to inspect during search (-1: n * n_trees).
    include_distances (bool): include distances in NN results.
  """

  def __init__(self, embeddings=None, id_map=None,
               n_trees=10, search_k=-1, include_distances=False):
    super().__init__(embeddings, id_map)
    self.n_trees = n_trees
    self.search_k = search_k
    self.include_distances = include_distances
    self._native = None

  def _backend(self):
    from recoder_tpu_torch.native import ann
    return ann

  def build(self, index_file=None):
    """Build the forest; optionally save to ``index_file``."""
    assert self.embeddings is not None, 'embeddings required to build'
    self.embedding_size = self.embeddings.shape[1]
    ann = self._backend()
    self._native = ann.AnnIndex(self.embedding_size)
    self._native.add_items(self.embeddings)
    self._native.build(self.n_trees)
    self._finalize_id_map(self.embeddings.shape[0])
    if index_file:
      embeddings_file = index_file + '.embeddings'
      self._native.save(embeddings_file)
      state = {'embedding_size': self.embedding_size, 'id_map': self.id_map}
      with open(index_file, 'wb') as f:
        pickle.dump(state, f)

  def load(self, index_file):
    """Load forest + id map saved by :meth:`build`."""
    with open(index_file, 'rb') as f:
      state = pickle.load(f)
    self.embedding_size = state['embedding_size']
    self.id_map = state['id_map']
    ann = self._backend()
    self._native = ann.AnnIndex(self.embedding_size)
    self._native.load(index_file + '.embeddings')
    self.inverse_id_map = {v: k for k, v in self.id_map.items()}

  def get_embedding(self, embedding_id):
    return self._native.get_item_vector(self.id_map[embedding_id])

  def get_nns_by_id(self, embedding_id, n):
    idx, dist = self._native.get_nns_by_item(self.id_map[embedding_id], n,
                                             self.search_k)
    return self._ids_out(idx, dist, self.include_distances)

  def get_nns_by_embedding(self, embedding, n):
    idx, dist = self._native.get_nns_by_vector(np.asarray(embedding,
                                                          np.float32),
                                               n, self.search_k)
    return self._ids_out(idx, dist, self.include_distances)

  def get_similarity(self, id1, id2):
    distance = self._native.get_distance(self.id_map[id1],
                                         self.id_map[id2])
    return self._angular_to_similarity(distance)

  def get_nns_by_ids(self, ids, n):
    """Native threaded batch search (one FFI call for all queries)."""
    ids = list(ids)
    if not ids:
      return []
    rows = np.asarray([self.id_map[i] for i in ids], dtype=np.int32)
    out_ids, _, counts = self._native.get_nns_batch(rows, n, self.search_k)
    inv = self.inverse_id_map
    return [np.asarray([inv[int(r)] for r in out_ids[i, :counts[i]]])
            for i in range(len(ids))]

  def get_embeddings(self, ids):
    rows = np.asarray([self.id_map[i] for i in ids], dtype=np.int32)
    return self._native.get_items(rows)


# Drop-in name for users migrating from the reference API.
AnnoyEmbeddingsIndex = AnnEmbeddingsIndex


class MemCacheEmbeddingsIndex(EmbeddingsIndex):
  """Memoizes nearest-neighbor lookups of a wrapped index."""

  def __init__(self, embedding_index):
    self.embedding_index = embedding_index
    self._nns_cache = {}

  def get_embedding(self, embedding_id):
    return self.embedding_index.get_embedding(embedding_id)

  def get_nns_by_embedding(self, embedding, n):
    return self.embedding_index.get_nns_by_embedding(embedding, n)

  def get_nns_by_id(self, embedding_id, n):
    key = (embedding_id, n)
    if key not in self._nns_cache:
      self._nns_cache[key] = \
          self.embedding_index.get_nns_by_id(embedding_id, n)
    return self._nns_cache[key]

  def get_similarity(self, id1, id2):
    return self.embedding_index.get_similarity(id1, id2)

  def get_nns_by_ids(self, ids, n):
    # memoized like the per-id path (cache keyed on (id, n) so a later
    # call with a different n never returns stale-length lists):
    # repeated evaluate() passes re-query only unseen items
    ids = list(ids)
    missing = [i for i in ids if (i, n) not in self._nns_cache]
    if missing:
      results = self.embedding_index.get_nns_by_ids(missing, n)
      for i, r in zip(missing, results):
        self._nns_cache[(i, n)] = r
    return [self._nns_cache[(i, n)] for i in ids]

  def get_embeddings(self, ids):
    return self.embedding_index.get_embeddings(ids)


def build_embeddings_index(recoder, index_class=BruteForceEmbeddingsIndex,
                           id_map=None, **kw):
  """Extract item embeddings from a trained Recoder and build an index.

  Takes the decoder embedding table of an autoencoder (the encoder's of
  a constrained one) or the item table of MF, trims the padding rows and
  columns, and builds the index. A table stored in bf16 is cast to
  float32 on its device before it is read to the host.
  """
  params = recoder.model.params()
  if 'de_embedding' in params:
    table = params['de_embedding']
  elif 'en_embedding' in params:  # constrained autoencoder
    table = params['en_embedding']
  else:
    table = params['item_embedding']
  d = (getattr(recoder.model, 'embedding_size', None)
       or recoder.model.hidden_layers[0])
  table = table.detach()[:recoder.num_items, :d].float().cpu().numpy()
  index = index_class(embeddings=table, id_map=id_map, **kw)
  index.build()
  return index
