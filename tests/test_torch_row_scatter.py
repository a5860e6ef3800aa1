"""The row scatter's plain twin (the CPU route of ``row_scatter_``)
against the TPU kernel it ports, ``apply_block_scatter`` over the Pallas
``_write_kernel`` run in interpret mode as ``tests/test_block_scatter.py``
runs it, and against numpy at ragged shapes; its checks, and the
kernel's 16-byte-path rule. Every comparison is exact: a scatter copies.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import recoder_tpu.experiments.block_scatter as bs
from recoder_tpu_torch.ops import row_scatter as rs


def _case(N, d, W, seed=0, ntables=3):
  """Tables, ids and rows; a repeated id gets the same payload."""
  rng = np.random.default_rng(seed)
  tables = [rng.standard_normal((N, d)).astype(np.float32)
            for _ in range(ntables)]
  ids = rng.integers(0, N, W).astype(np.int64)
  rows = [rng.standard_normal((N, d)).astype(np.float32)[ids]
          for _ in range(ntables)]
  return tables, ids, rows


def test_matches_the_tpu_kernel_in_interpret_mode():
  orig = pl.pallas_call

  def interpreted(*a, **k):
    k['interpret'] = True
    return orig(*a, **k)

  rng = np.random.default_rng(0)
  N, d, W = 1024, 128, 96
  table = rng.normal(size=(N, d)).astype(np.float32)
  ids = np.sort(rng.choice(N - 8, W, False)).astype(np.int32)
  # sentinel-style duplicate tail with identical payloads
  ids = np.concatenate([ids, np.full(16, N - 1, np.int32)])
  rows = rng.normal(size=(len(ids), d)).astype(np.float32)
  rows[W:] = rows[W]
  with mock.patch.object(pl, 'pallas_call', interpreted):
    plan = bs.plan_block_scatter(jnp.asarray(ids), N, width=len(ids))
    want = np.asarray(bs.apply_block_scatter(jnp.asarray(table), plan,
                                             jnp.asarray(rows)))
  got = torch.from_numpy(table.copy())
  rs.row_scatter_([got], torch.from_numpy(ids.astype(np.int64)),
                  [torch.from_numpy(rows)])
  np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('ntables', [1, 3])
@pytest.mark.parametrize('N,d,W', [(1, 1, 5), (37, 3, 37), (41, 7, 1),
                                   (64, 200, 0), (300, 1000, 20)])
def test_matches_numpy(N, d, W, ntables):
  tables, ids, rows = _case(N, d, W, seed=N + d, ntables=ntables)
  got = [torch.from_numpy(t.copy()) for t in tables]
  rs.row_scatter_(got, torch.from_numpy(ids),
                  [torch.from_numpy(r) for r in rows])
  for g, t, r in zip(got, tables, rows):
    want = t.copy()
    want[ids] = r
    np.testing.assert_array_equal(g.numpy(), want)


def test_column_slice_table():
  """A table that is a column slice of a wider one: only its columns of
  the touched rows change."""
  tables, ids, rows = _case(50, 9, 12, seed=3, ntables=1)
  base = torch.from_numpy(tables[0].copy())
  rs.row_scatter_([base[:, 1:8]], torch.from_numpy(ids),
                  [torch.from_numpy(rows[0][:, 1:8].copy())])
  want = tables[0].copy()
  want[ids, 1:8] = rows[0][:, 1:8]
  np.testing.assert_array_equal(base.numpy(), want)


def test_checks():
  tables, ids, rows = _case(10, 4, 3)
  t = [torch.from_numpy(x) for x in tables]
  r = [torch.from_numpy(x) for x in rows]
  i = torch.from_numpy(ids)
  with pytest.raises(IndexError):
    rs.row_scatter_(t, torch.tensor([0, 10, 2]), r)
  with pytest.raises(IndexError):
    rs.row_scatter_(t, torch.tensor([0, -1, 2]), r)
  with pytest.raises(ValueError, match='int64'):
    rs.row_scatter_(t, i.int(), r)
  with pytest.raises(ValueError, match='shape'):
    rs.row_scatter_(t, i[:2], r)
  with pytest.raises(ValueError, match='float32'):
    rs.row_scatter_([x.double() for x in t], i, [x.double() for x in r])
  with pytest.raises(ValueError, match='tables'):
    rs.row_scatter_(t + t[:1], i, r + r[:1])
  with pytest.raises(ValueError, match='tables'):
    rs.row_scatter_(t, i, r[:2])
  # the kernel itself takes CUDA tensors only, and nothing is counted
  before = dict(rs.LAUNCHES)
  with pytest.raises(ValueError, match='CUDA'):
    rs.row_scatter_kernel(t, i, r)
  assert rs.LAUNCHES == before


def test_vector_path_rule():
  """The 16-byte path needs d % 4 == 0, row strides % 4 == 0 and 16-byte
  aligned base pointers; a column slice one float in is not aligned."""
  wide = torch.zeros((8, 204))
  rows = torch.zeros((3, 200))
  assert wide.data_ptr() % 16 == 0
  assert rs.vector_path([wide[:, 4:204]], [rows])
  assert not rs.vector_path([wide[:, 1:201]], [rows])
  assert not rs.vector_path([torch.zeros((8, 202))[:, :200]], [rows])
  assert not rs.vector_path([torch.zeros((8, 198))], [torch.zeros((3, 198))])
