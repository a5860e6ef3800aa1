"""The port's embeddings indexes against the JAX package's.

The same numpy embeddings (from seeds) go to ``recoder_tpu.embedding``
and ``recoder_tpu_torch.embedding``:

* the port's ``native/ann_index.cpp`` is the JAX package's, byte for
  byte, and the port builds it into ``build/native/``, never loading the
  library the JAX package builds beside its source;
* the two native ``AnnIndex`` wrappers, built from the same embeddings,
  trees and seed, write byte-equal files and answer every query alike;
* each package loads the other's saved ANN and brute-force files;
* ``BruteForceEmbeddingsIndex(device='cpu')`` returns the JAX ids except
  where two adjacent cosines are within ``NEAR_TIE`` of each other (the
  port's top-k sends ties to the lower row, numpy's argpartition to no
  rule), and distances within ``DIST_ATOL``;
* ``build_embeddings_index`` on a port Recoder restored from a JAX
  checkpoint gives the JAX table (bf16 storage: its rounded values);
* tests/test_embedding.py's cases, run against the port's classes.
"""

import filecmp
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import recoder_tpu.embedding as jax_embedding
import recoder_tpu.native.ann as jax_ann
import recoder_tpu_torch.embedding as embedding
import recoder_tpu_torch.native.ann as ann
from recoder_tpu.data import RecommendationDataset as JaxDataset
from recoder_tpu.model import Recoder as JaxRecoder
from recoder_tpu.models import DynamicAutoencoder as JaxDynAE
from recoder_tpu.models import MatrixFactorization as JaxMF
from recoder_tpu_torch.model import Recoder
from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: cosines closer than this may rank either way between the packages
NEAR_TIE = 1e-6
DIST_ATOL = 1e-6

PORT = dict(brute=lambda **kw: embedding.BruteForceEmbeddingsIndex(
                device='cpu', **kw),
            ann=embedding.AnnEmbeddingsIndex)
JAX = dict(brute=jax_embedding.BruteForceEmbeddingsIndex,
           ann=jax_embedding.AnnEmbeddingsIndex)


@pytest.fixture(scope='module')
def embeddings():
  rng = np.random.default_rng(0)
  return rng.random((1000, 128)).astype(np.float32)


def _unit(emb):
  unit = emb.astype(np.float64)
  return unit / np.linalg.norm(unit, axis=-1, keepdims=True)


def _cosines(emb):
  """[N, N] float64 cosines between the rows of ``emb``."""
  unit = _unit(emb)
  return unit @ unit.T


def assert_same_up_to_near_ties(got, want, cos_rows):
  """Per query: equal lengths, and at each rank either the same id or
  two ids whose cosines to the query are within NEAR_TIE."""
  assert len(got) == len(want)
  for g, w, cos in zip(got, want, cos_rows):
    g, w = np.asarray(g), np.asarray(w)
    assert g.shape == w.shape
    differ = g != w
    np.testing.assert_array_less(np.abs(cos[g[differ]] - cos[w[differ]]),
                                 NEAR_TIE)


def assert_distances_close(got, want):
  """Distances within DIST_ATOL, and the cosines they encode (1 - d^2 /
  2) within DIST_ATOL too: near d = 0, sqrt turns a one-ulp difference of
  a float32 cosine into ~1e-4 of distance, so the self match is held by
  its cosine."""
  got, want = np.asarray(list(got), np.float64), np.asarray(list(want),
                                                             np.float64)
  np.testing.assert_allclose(1 - got ** 2 / 2, 1 - want ** 2 / 2,
                             rtol=0, atol=DIST_ATOL)
  far = want > 1e-2
  np.testing.assert_allclose(got[far], want[far], rtol=0, atol=DIST_ATOL)


def test_native_source_is_the_jax_copy():
  assert filecmp.cmp(ann.SOURCE, os.path.join(REPO, 'recoder_tpu', 'native',
                                              'ann_index.cpp'),
                     shallow=False)
  path = ann._lib_path()
  assert os.path.dirname(path) == os.path.join(REPO, 'build', 'native')
  ann._load()
  assert os.path.exists(path)
  assert ann._LIB is not jax_ann._load()


def test_native_indexes_write_equal_files_and_answer_alike(tmp_path):
  rng = np.random.default_rng(4)
  emb = rng.normal(size=(700, 24)).astype(np.float32)
  built = []
  for mod, name in ((ann, 'port'), (jax_ann, 'jax')):
    idx = mod.AnnIndex(24)
    idx.add_items(emb)
    idx.build(7, seed=3)
    idx.save(str(tmp_path / name))
    built.append(idx)
  assert (tmp_path / 'port').read_bytes() == (tmp_path / 'jax').read_bytes()
  port, ref = built
  for i in (0, 5, 350, 698):
    assert port.get_nns_by_item(i, 12) == ref.get_nns_by_item(i, 12)
    assert port.get_nns_by_item(i, 12, 40) == ref.get_nns_by_item(i, 12, 40)
    assert port.get_distance(i, 698 - i) == ref.get_distance(i, 698 - i)
    assert port.get_item_vector(i) == ref.get_item_vector(i)
  v = rng.normal(size=24).astype(np.float32)
  assert port.get_nns_by_vector(v, 9) == ref.get_nns_by_vector(v, 9)
  items = rng.integers(0, 700, 50)
  for a, b in zip(port.get_nns_batch(items, 10), ref.get_nns_batch(items, 10)):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(port.get_items(items), ref.get_items(items))


@pytest.mark.parametrize('kind', ['brute', 'ann'])
@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_each_package_loads_the_others_files(kind, writer, embeddings,
                                             tmp_path):
  id_map = {f'item_{i}': i for i in range(len(embeddings))}
  make_w, make_r = ((PORT, JAX) if writer == 'port' else (JAX, PORT))
  path = str(tmp_path / 'index')
  written = make_w[kind](embeddings=embeddings, id_map=id_map)
  written.build(index_file=path)
  read = make_r[kind]()
  read.load(path)
  assert read.embedding_size == 128 and read.id_map == id_map
  ids = ['item_3', 'item_500', 'item_999']
  np.testing.assert_array_equal(read.get_embeddings(ids),
                                embeddings[[3, 500, 999]])
  cos = _cosines(embeddings)
  got = [[id_map[i] for i in r] for r in read.get_nns_by_ids(ids, 20)]
  want = [[id_map[i] for i in r] for r in written.get_nns_by_ids(ids, 20)]
  assert_same_up_to_near_ties(got, want, cos[[3, 500, 999]])
  if kind == 'ann':
    assert got == want


def test_brute_force_matches_jax(embeddings):
  port = embedding.BruteForceEmbeddingsIndex(embeddings, device='cpu',
                                             include_distances=True)
  ref = jax_embedding.BruteForceEmbeddingsIndex(embeddings,
                                                include_distances=True)
  port.build()
  ref.build()
  np.testing.assert_array_equal(port._normed.numpy(), ref._normed)
  cos = _cosines(embeddings)
  rng = np.random.default_rng(7)
  queries = rng.integers(0, 1000, 64)
  for n in (1, 10, 100, 1000, 1500):
    assert_same_up_to_near_ties(port.get_nns_by_ids(queries, n),
                                ref.get_nns_by_ids(queries, n),
                                cos[queries])
  for q in queries[:8]:
    got, want = port.get_nns_by_id(int(q), 50), ref.get_nns_by_id(int(q), 50)
    assert_same_up_to_near_ties([list(got)], [list(want)], cos[[q]])
    assert_distances_close(got.values(), want.values())
    assert port.get_similarity(int(q), 3) == pytest.approx(
        ref.get_similarity(int(q), 3), abs=DIST_ATOL)
  v = rng.normal(size=128).astype(np.float32)
  got, want = port.get_nns_by_embedding(v, 30), ref.get_nns_by_embedding(v, 30)
  vcos = _unit(embeddings) @ _unit(v)
  assert_same_up_to_near_ties([list(got)], [list(want)], [vcos])
  assert_distances_close(got.values(), want.values())


def test_brute_force_ties_go_to_the_lower_row():
  emb = np.ones((6, 4), np.float32)
  emb[4] = -1.0
  index = embedding.BruteForceEmbeddingsIndex(emb, device='cpu')
  index.build()
  np.testing.assert_array_equal(index.get_nns_by_ids([2], 6)[0],
                                [0, 1, 2, 3, 5, 4])
  assert index.get_nns_by_id(3, 3) == [0, 1, 2]


@pytest.mark.parametrize('kind', ['brute', 'ann'])
def test_memcache_matches_jax(kind, embeddings):
  port = embedding.MemCacheEmbeddingsIndex(PORT[kind](embeddings=embeddings))
  ref = jax_embedding.MemCacheEmbeddingsIndex(JAX[kind](embeddings=embeddings))
  port.embedding_index.build()
  ref.embedding_index.build()
  cos = _cosines(embeddings)
  for ids, n in (([1, 2, 3], 5), ([2, 3, 4], 5), ([1, 3], 2), ([1, 3], 7)):
    got, want = port.get_nns_by_ids(ids, n), ref.get_nns_by_ids(ids, n)
    assert [len(r) for r in got] == [n] * len(ids)
    assert_same_up_to_near_ties(got, want, cos[ids])
    assert sorted(port._nns_cache) == sorted(ref._nns_cache)
  assert len(port.get_nns_by_id(3, 4)) == 4
  assert len(port.get_nns_by_id(3, 2)) == 2
  assert port.get_similarity(1, 2) == pytest.approx(ref.get_similarity(1, 2),
                                                    abs=DIST_ATOL)


def _jax_checkpoint(tmp_path, model):
  rng = np.random.default_rng(2)
  m = sp.csr_matrix((rng.random((40, 90)) < 0.15).astype(np.float32))
  tr = JaxRecoder(model, optimizer_type='adam', loss='mse')
  tr.train(JaxDataset(m), batch_size=10, num_epochs=1,
           negative_sampling=True)
  return tr, tr.save_state(str(tmp_path / 'ck'))


@pytest.mark.parametrize('family', ['autoencoder', 'constrained', 'mf'])
@pytest.mark.parametrize('params_dtype', [None, 'bfloat16'])
def test_build_embeddings_index_from_a_jax_checkpoint(family, params_dtype,
                                                      tmp_path):
  jax_model, port_model = {
      'autoencoder': lambda: (JaxDynAE([16]),
                              DynamicAutoencoder(params_dtype=params_dtype)),
      'constrained': lambda: (JaxDynAE([16], is_constrained=True),
                              DynamicAutoencoder(params_dtype=params_dtype)),
      'mf': lambda: (JaxMF(8), MatrixFactorization(
          embedding_size=1, params_dtype=params_dtype)),
  }[family]()
  jax_tr, path = _jax_checkpoint(tmp_path, jax_model)
  want = jax_embedding.build_embeddings_index(jax_tr).embeddings
  tr = Recoder(port_model, device='cpu')
  tr.init_from_model_file(path)
  index = embedding.build_embeddings_index(tr, device='cpu')
  assert index.embeddings.dtype == np.float32
  if params_dtype:
    want = torch.from_numpy(want).bfloat16().float().numpy()
  np.testing.assert_array_equal(index.embeddings, want)
  assert isinstance(index, embedding.BruteForceEmbeddingsIndex)
  assert index.device.type == 'cpu'
  ann_index = embedding.build_embeddings_index(
      tr, index_class=embedding.AnnEmbeddingsIndex, n_trees=3)
  assert ann_index._native.n_items == want.shape[0]


# -- tests/test_embedding.py's cases against the port's classes ----------

@pytest.mark.parametrize('kind', ['brute', 'ann'])
def test_build_save_load_roundtrip(kind, embeddings, tmp_path):
  index = PORT[kind](embeddings=embeddings)
  path = str(tmp_path / 'test_embeddings')
  index.build(index_file=path)

  loaded = PORT[kind]()
  loaded.load(index_file=path)

  assert loaded.embedding_size == index.embedding_size == 128

  rng = np.random.default_rng(1)
  test_item = int(rng.integers(1000))
  assert index.get_embedding(test_item) == loaded.get_embedding(test_item)
  assert index.get_nns_by_id(test_item, 100) == \
      loaded.get_nns_by_id(test_item, 100)

  i1, i2 = int(rng.integers(1000)), int(rng.integers(1000))
  assert index.get_similarity(i1, i2) == loaded.get_similarity(i1, i2)
  assert 0.0 <= index.get_similarity(i1, i2) <= 1.0
  assert index.get_similarity(i1, i1) == pytest.approx(1.0, abs=1e-5)


def test_brute_force_exactness(embeddings):
  index = PORT['brute'](embeddings=embeddings)
  index.build()
  q = 17
  nns = index.get_nns_by_id(q, 10)
  normed = embeddings / np.linalg.norm(embeddings, axis=1, keepdims=True)
  cos = normed @ normed[q]
  expected = np.argsort(-cos)[:10].tolist()
  assert nns == expected
  assert nns[0] == q


def test_ann_recall_vs_exact(embeddings):
  exact = PORT['brute'](embeddings=embeddings)
  exact.build()

  def mean_recall(search_k):
    index = embedding.AnnEmbeddingsIndex(embeddings=embeddings, n_trees=20,
                                         search_k=search_k)
    index.build()
    rng = np.random.default_rng(2)
    recalls = []
    for q in rng.integers(0, 1000, 30):
      truth = set(exact.get_nns_by_id(int(q), 10))
      got = set(index.get_nns_by_id(int(q), 10))
      recalls.append(len(truth & got) / 10)
    return np.mean(recalls)

  low, high = mean_recall(200), mean_recall(2000)
  assert high >= 0.9
  assert high >= low


@pytest.mark.parametrize('kind', ['brute', 'ann'])
def test_include_distances(kind, embeddings):
  index = PORT[kind](embeddings=embeddings, include_distances=True)
  index.build()
  out = index.get_nns_by_id(5, 10)
  assert isinstance(out, dict) and len(out) == 10
  assert min(out.values()) >= 0.0
  if kind == 'ann':
    assert out[5] == pytest.approx(0.0, abs=1e-5)
  else:  # a float32 cosine near 1, through sqrt: held by its cosine
    assert 1 - out[5] ** 2 / 2 == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize('kind', ['brute', 'ann'])
def test_id_map(kind, embeddings):
  id_map = {f'item_{i}': i for i in range(len(embeddings))}
  index = PORT[kind](embeddings=embeddings, id_map=id_map)
  index.build()
  nns = index.get_nns_by_id('item_42', 5)
  assert all(isinstance(i, str) and i.startswith('item_') for i in nns)
  assert nns[0] == 'item_42'


def test_memcache_wrapper(embeddings):
  class Counting(embedding.BruteForceEmbeddingsIndex):
    calls = 0

    def get_nns_by_id(self, embedding_id, n):
      Counting.calls += 1
      return super().get_nns_by_id(embedding_id, n)

  inner = Counting(embeddings=embeddings, device='cpu')
  inner.build()
  cached = embedding.MemCacheEmbeddingsIndex(inner)
  a = cached.get_nns_by_id(3, 5)
  b = cached.get_nns_by_id(3, 5)
  assert a == b and Counting.calls == 1
  assert cached.get_similarity(1, 2) == inner.get_similarity(1, 2)


@pytest.mark.parametrize('kind', ['brute', 'ann'])
def test_batch_queries_match_single(kind):
  rng = np.random.default_rng(5)
  emb = rng.normal(size=(300, 16)).astype(np.float32)
  kw = {'n_trees': 8} if kind == 'ann' else {}
  index = PORT[kind](embeddings=emb, **kw)
  index.build()
  ids = [0, 17, 123, 299]
  batch = index.get_nns_by_ids(ids, 10)
  for i, lst in zip(ids, batch):
    np.testing.assert_array_equal(lst, index.get_nns_by_id(i, 10))
  for row, i in zip(index.get_embeddings(ids), ids):
    np.testing.assert_allclose(row, emb[i], rtol=1e-6)


def test_ann_mmap_load_and_resave(tmp_path):
  rng = np.random.default_rng(9)
  emb = rng.normal(size=(500, 24)).astype(np.float32)
  idx = embedding.AnnEmbeddingsIndex(embeddings=emb, n_trees=6)
  idx.build(index_file=str(tmp_path / 'a.index'))
  want = idx.get_nns_by_ids([0, 123, 499], 8)

  loaded = embedding.AnnEmbeddingsIndex(n_trees=6)
  loaded.load(str(tmp_path / 'a.index'))
  got = loaded.get_nns_by_ids([0, 123, 499], 8)
  for a, b in zip(want, got):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_allclose(loaded.get_embeddings([7]), emb[7:8],
                             rtol=1e-6)
  loaded._native.save(str(tmp_path / 'b.embeddings'))
  assert ((tmp_path / 'a.index.embeddings').read_bytes()
          == (tmp_path / 'b.embeddings').read_bytes())


def test_memcache_batch_path_is_cached(embeddings):
  class CountingBatch(embedding.BruteForceEmbeddingsIndex):
    batch_ids = []

    def get_nns_by_ids(self, ids, n):
      CountingBatch.batch_ids.append(list(ids))
      return super().get_nns_by_ids(ids, n)

  inner = CountingBatch(embeddings=embeddings, device='cpu')
  inner.build()
  cached = embedding.MemCacheEmbeddingsIndex(inner)
  first = cached.get_nns_by_ids([1, 2, 3], 4)
  second = cached.get_nns_by_ids([2, 3, 4], 4)
  assert CountingBatch.batch_ids == [[1, 2, 3], [4]]
  assert [list(np.asarray(r)) for r in second[:2]] == \
         [list(np.asarray(r)) for r in first[1:]]


def test_get_embeddings_accepts_generator(embeddings):
  idx = PORT['brute'](embeddings=embeddings)
  idx.build()
  got = embedding.EmbeddingsIndex.get_embeddings(idx, (i for i in (0, 1, 2)))
  assert got.shape == (3, embeddings.shape[1])


def test_ann_native_guard_rails(tmp_path, embeddings):
  idx = ann.AnnIndex(embeddings.shape[1])
  idx.add_items(embeddings)
  idx.build(4, seed=1)
  with pytest.raises(RuntimeError, match='built once'):
    idx.build(4, seed=1)
  with pytest.raises(IndexError):
    idx.get_nns_by_item(len(embeddings), 5)
  with pytest.raises(IndexError):
    idx.get_item_vector(-1)
  with pytest.raises(IndexError):
    idx.get_distance(0, len(embeddings) + 3)
  with pytest.raises(IndexError):
    idx.get_items([0, len(embeddings)])
  with pytest.raises(IndexError):
    idx.get_nns_batch([1, -2], 5)
  before = idx.get_nns_by_item(3, 5)
  bad = tmp_path / 'corrupt.ann'
  bad.write_bytes(b'NOTANINDEXNOTANINDEX' * 4)
  with pytest.raises(IOError):
    idx.load(str(bad))
  assert idx.get_nns_by_item(3, 5) == before


@pytest.mark.parametrize('kind', ['brute', 'ann'])
def test_memcache_n_change_not_stale(kind, embeddings):
  inner = PORT[kind](embeddings=embeddings)
  inner.build()
  cached = embedding.MemCacheEmbeddingsIndex(inner)
  assert len(cached.get_nns_by_id(3, 5)) == 5
  assert len(cached.get_nns_by_id(3, 2)) == 2
  assert [len(r) for r in cached.get_nns_by_ids([1, 3], 5)] == [5, 5]
  assert [len(r) for r in cached.get_nns_by_ids([1, 3], 3)] == [3, 3]


def test_the_index_refuses_a_missing_card():
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    embedding.BruteForceEmbeddingsIndex(np.ones((3, 2), np.float32))
