"""ctypes bindings + on-demand build of the C++ ANN index.

A copy of ``recoder_tpu/native/ann.py`` over this package's own
``ann_index.cpp`` (a byte-for-byte copy of the JAX package's). The
forest is host C++ in both packages: it runs no device code.

At first use the source is compiled with ``g++ -O3 -std=c++17 -shared
-fPIC -pthread`` into ``build/native/`` at the root of the checkout
(listed in ``.gitignore``). As ``recoder_tpu_torch.kernels`` names its
kernels, the library's name carries a hash of the source and the flags,
so a stale library is never loaded; the compiler writes to a temporary
file that ``os.replace`` moves into place, so two processes that build
at once never load a half-written one. Without ``g++`` the build raises.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'ann_index.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                         'native')
FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')
_LOCK = threading.Lock()
_LIB = None


def _lib_path():
  with open(SOURCE, 'rb') as f:
    digest = hashlib.sha1(f.read() + ' '.join(FLAGS).encode())
  return os.path.join(BUILD_DIR,
                      f'libann_index-{digest.hexdigest()[:12]}.so')


def _build_lib(out):
  os.makedirs(os.path.dirname(out), exist_ok=True)
  tmp = f'{out}.build.{os.getpid()}'
  cmd = ['g++', *FLAGS, '-o', tmp, SOURCE]
  try:
    subprocess.run(cmd, check=True, capture_output=True, text=True)
  except subprocess.CalledProcessError as e:
    raise RuntimeError(
        f'building libann_index.so failed:\n{e.stderr}') from e
  except FileNotFoundError as e:
    raise RuntimeError('building libann_index.so requires g++ on PATH'
                       ) from e
  os.replace(tmp, out)


def _load():
  global _LIB
  with _LOCK:
    if _LIB is not None:
      return _LIB
    path = _lib_path()
    if not os.path.exists(path):
      _build_lib(path)
    lib = ctypes.CDLL(path)
    lib.ann_create.restype = ctypes.c_void_p
    lib.ann_create.argtypes = [ctypes.c_int]
    lib.ann_free.argtypes = [ctypes.c_void_p]
    lib.ann_add_items.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int]
    lib.ann_build.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_uint32, ctypes.c_int]
    lib.ann_build.restype = ctypes.c_int
    lib.ann_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ann_save.restype = ctypes.c_int
    lib.ann_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ann_load.restype = ctypes.c_int
    lib.ann_n_items.argtypes = [ctypes.c_void_p]
    lib.ann_n_items.restype = ctypes.c_int
    lib.ann_dim.argtypes = [ctypes.c_void_p]
    lib.ann_dim.restype = ctypes.c_int
    lib.ann_get_item.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.ann_get_item.restype = ctypes.c_int
    lib.ann_get_nns_by_item.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
    lib.ann_get_nns_by_item.restype = ctypes.c_int
    lib.ann_get_nns_by_vector.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p]
    lib.ann_get_nns_by_vector.restype = ctypes.c_int
    lib.ann_get_distance.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.ann_get_distance.restype = ctypes.c_float
    lib.ann_get_nns_batch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib.ann_get_items.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.ann_get_items.restype = ctypes.c_int
    _LIB = lib
    return lib


class AnnIndex:
  """Thin object wrapper over the C ABI.

  Args:
    dim (int): embedding dimensionality.
  """

  def __init__(self, dim):
    self._lib = _load()
    self._dim = int(dim)
    self._ptr = self._lib.ann_create(self._dim)

  def __del__(self):
    if getattr(self, '_ptr', None):
      self._lib.ann_free(self._ptr)
      self._ptr = None

  def add_items(self, embeddings):
    arr = np.ascontiguousarray(embeddings, dtype=np.float32)
    assert arr.ndim == 2 and arr.shape[1] == self._dim
    self._lib.ann_add_items(self._ptr, arr.ctypes.data, arr.shape[0])

  def build(self, n_trees, seed=0, leaf_size=0):
    if not self._lib.ann_build(self._ptr, int(n_trees), int(seed),
                               int(leaf_size)):
      raise RuntimeError(
          'build() needs staged items: add_items() must precede it, '
          'and an index can only be built once (a built or loaded '
          'index is immutable -- create a new AnnIndex to rebuild)')

  def save(self, path):
    if not self._lib.ann_save(self._ptr, path.encode()):
      raise IOError(f'failed to save index to {path}')

  def load(self, path):
    if not self._lib.ann_load(self._ptr, path.encode()):
      raise IOError(f'failed to load index from {path}')

  @property
  def n_items(self):
    return self._lib.ann_n_items(self._ptr)

  def get_item_vector(self, i):
    out = np.empty(self._dim, dtype=np.float32)
    if not self._lib.ann_get_item(self._ptr, int(i), out.ctypes.data):
      raise IndexError(f'item id {i} out of range '
                       f'[0, {self.n_items})')
    return out.tolist()

  def get_nns_by_item(self, i, n, search_k=-1):
    ids = np.empty(n, dtype=np.int32)
    dists = np.empty(n, dtype=np.float32)
    k = self._lib.ann_get_nns_by_item(self._ptr, int(i), int(n),
                                      int(search_k), ids.ctypes.data,
                                      dists.ctypes.data)
    if k < 0:
      raise IndexError(f'item id {i} out of range '
                       f'[0, {self.n_items})')
    return ids[:k].tolist(), dists[:k].tolist()

  def get_nns_by_vector(self, vec, n, search_k=-1):
    v = np.ascontiguousarray(vec, dtype=np.float32)
    ids = np.empty(n, dtype=np.int32)
    dists = np.empty(n, dtype=np.float32)
    k = self._lib.ann_get_nns_by_vector(self._ptr, v.ctypes.data, int(n),
                                        int(search_k), ids.ctypes.data,
                                        dists.ctypes.data)
    return ids[:k].tolist(), dists[:k].tolist()

  def get_distance(self, i, j):
    d = float(self._lib.ann_get_distance(self._ptr, int(i), int(j)))
    if d < 0:  # real angular distances are >= 0; -1 = bad id
      raise IndexError(f'item id out of range: {i} or {j}')
    return d

  def get_nns_batch(self, items, n, search_k=-1, n_threads=0):
    """Batched NN search over a C++ worker pool.

    Args:
      items (array-like int): item ids to query.
      n (int): neighbors per query.
      search_k (int): per-query node-inspection budget (-1: default).
      n_threads (int): worker threads (0: hardware concurrency).

    Returns:
      (ids [m, n] int32, dists [m, n] float32, counts [m] int32) --
      row i has ``counts[i]`` valid leading entries.
    """
    q = np.ascontiguousarray(items, dtype=np.int32)
    m = q.shape[0]
    ids = np.empty((m, n), dtype=np.int32)
    dists = np.empty((m, n), dtype=np.float32)
    counts = np.empty(m, dtype=np.int32)
    if m:
      self._lib.ann_get_nns_batch(self._ptr, q.ctypes.data, m, int(n),
                                  int(search_k), int(n_threads),
                                  ids.ctypes.data, dists.ctypes.data,
                                  counts.ctypes.data)
      if counts.min() < 0:
        bad = q[np.argmin(counts)]
        raise IndexError(f'item id {bad} out of range '
                         f'[0, {self.n_items})')
    return ids, dists, counts

  def get_items(self, ids):
    """Bulk embedding-row fetch: [m, dim] float32."""
    q = np.ascontiguousarray(ids, dtype=np.int32)
    out = np.empty((q.shape[0], self._dim), dtype=np.float32)
    if q.shape[0]:
      if not self._lib.ann_get_items(self._ptr, q.ctypes.data,
                                     q.shape[0], out.ctypes.data):
        raise IndexError(f'an item id is out of range '
                         f'[0, {self.n_items}): {q.tolist()[:8]}...')
    return out
