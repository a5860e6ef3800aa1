"""The yardstick's arithmetic against hand counts and plain loops at
small shapes: bounds, bytes, model FLOPs, the batch order, the ladder of
union widths and the matrix generator."""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix

from perfbench import roofline, synth
from perfbench.reference import autoencoder as ref

SHAPE = dict(num_users=300, num_items=170, mean_items=12, mean_factor=0.683,
             sigma=0.9, min_items=5, max_items=1000, zipf=2.2)


def test_bound_picks_the_larger_side():
  assert roofline.bound(989e9, 0.0, 989e12) == (1.0, 'operations')
  assert roofline.bound(0.0, 3.35e9, 989e12) == (1.0, 'bytes')


def test_decode_loss_bounds_by_hand():
  B, d, W = 2, 3, 5
  bf = roofline.decode_loss_bounds(B, d, W, target_bytes=2, bf16=True)
  # forward: h, bias, row mask, col mask (4 B each), rows (4 B), target
  # (2 B), the loss (4 B) and E0 [2, 8] in bf16
  fwd = 4 * (2 * 3 + 5 + 2) + 4 * (5 * 3 + 5) + 2 * 2 * 5 + 4 + 2 * 2 * 8
  assert bf['fwd'] == (fwd / 3.35e12 * 1e3, 'bytes')
  # backward: E0, h, rows, the upstream gradient; dh, drows, dbias out
  bwd = 2 * 2 * 8 + 4 * 2 * 3 + 4 * 5 * 3 + 4 + 4 * 2 * 3 + 4 * (5 * 3 + 5)
  assert bf['bwd'] == (bwd / 3.35e12 * 1e3, 'bytes')
  big = roofline.decode_loss_bounds(4096, 4096, 4096, bf16=True)
  assert big['fwd'] == (2.0 * 4096 ** 3 / 989e12 * 1e3, 'operations')


def test_adam_bytes_by_hand():
  assert roofline.adam_bound_ms(1000) == pytest.approx(
      20_000 / 3.35e12 * 1e3)


def test_pad_dim():
  assert [roofline.pad_dim(n) for n in (1, 255, 256, 20108, 41140)] == [
      256, 256, 512, 20224, 41216]


def _plain_groups(matrix, order, B):
  users, nnz, union = [], [], []
  for g in range(0, len(order), B):
    ids = [u for u in order[g:g + B] if u < matrix.shape[0]]
    cols = [c for u in ids for c in matrix[u].indices]
    users.append(len(ids))
    nnz.append(len(cols))
    union.append(len(set(cols)))
  return users, nnz, union


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_group_stats_and_flops_against_a_loop(shuffle):
  matrix = synth.synthesize(SHAPE, 7, 'cpu')
  order = ref.epoch_order(shuffle, 11, 1, matrix.shape[0], 64)
  got = roofline.group_stats(matrix, order, 64, 'cpu')
  want = _plain_groups(matrix, order, 64)
  assert [g.tolist() for g in got] == [list(w) for w in want]
  config = {'model': {'hidden_layers': [8]}}
  flops = ref.step_flops(matrix, order, 64, config, 'cpu')
  assert flops.tolist() == [4.0 * n * 8 + 6.0 * b * u * 8
                            for b, n, u in zip(*want)]


def test_epoch_order():
  blocks = ref.epoch_order('blocks', 3, 1, 1000, 300)
  assert sorted(blocks.tolist()) == list(range(1200))
  assert blocks[-300:].tolist() == list(range(900, 1200))  # pinned last
  assert (blocks.reshape(4, 300)[:, 0] % 300 == 0).all()
  users = ref.epoch_order('users', 3, 1, 1000, 300)
  assert sorted(users[:1000].tolist()) == list(range(1000))
  assert users[1000:].tolist() == list(range(1000, 1200))
  assert not np.array_equal(users, ref.epoch_order('users', 3, 2, 1000, 300))


def test_ladder_against_a_loop():
  rungs = [128]
  while rungs[-1] < 50_000:
    rungs.append((rungs[-1] * 26 // 25 + 127) // 128 * 128)
  for width in (1, 128, 129, 5000, 18117, 20480, 41140):
    assert ref.ladder(width) == min(r for r in rungs
                                    if r >= (width + 127) // 128 * 128)


def test_synthesize_is_seeded_and_canonical():
  a = synth.synthesize(SHAPE, 2 ** 31 + 5, 'cpu')
  b = synth.synthesize(SHAPE, 2 ** 31 + 5, 'cpu')
  c = synth.synthesize(SHAPE, 2 ** 31 + 6, 'cpu')
  assert isinstance(a, csr_matrix) and a.shape == (300, 170)
  assert (a != b).nnz == 0 and (a != c).nnz > 0
  assert set(np.unique(a.data)) == {1.0} and a.has_canonical_format
  counts = np.diff(a.indptr)
  assert counts.max() <= 1000 and counts.min() >= 1
  # (the same set of sizes, dealt to other users; duplicates collapse)
  assert abs(a.nnz - c.nnz) < 0.05 * a.nnz
  pop = np.bincount(a.indices, minlength=170)
  assert pop[:17].sum() > pop[-17:].sum()  # Zipf: the low ids are popular
  assert torch.equal(torch.as_tensor(a.indptr), torch.as_tensor(b.indptr))
