"""Tests of the port that need a CUDA card: the fused decode-loss
kernels against their plain PyTorch version at ragged and boundary
shapes and at the training and union widths, a bfloat16 target bitwise
equal to the float32 one, no cotangent written under no_grad, the
wrapper's refusals, and the trainer on the card against the trainer on
the CPU; both bf16 kernel sets (wgmma and mma.sync) against the plain
bf16 composition, each route's launch counters, two runs bitwise equal,
the wgmma forward without E0 and the bf16 copies it keeps for its
backward; the SPD-solve kernel against the blocked recursion (at the
edges of its 16-column panels too), its batch independence, NaN on an
indefinite system that leaves the rest of its batch bitwise unchanged,
its shared memory and resident blocks, and the iALS fit on
the card against the fit on the CPU; the row-scatter kernel against
``index_copy_`` (bitwise: it is a copy) at ragged shapes, on a
misaligned column slice and with an empty id vector, and the sparse
training step through the kernel against the same step through the
plain twin (bitwise); the packed-slab unpack kernel against its plain
version (bitwise) at ragged batches and word widths in both fetch modes,
and a packed-tier training bitwise equal to a dense-tier one; captured
steps against eager ones; the host loader's batches on the card equal to
the CPU's, training against a target matrix (host loader and dual CSRs,
dense and tied sparse tables) and its validation loss on the card against
the CPU, and captured training bitwise the same with validation between
its epochs; megas with random negatives captured bitwise eager (and a
resume), the triplet scatter bitwise the slab route, and the packed
kernel's mask-only launch against its plain version; MatrixFactorization's decode-loss route against its plain
twin, the sparse MF and Mult-VAE steps through the row scatter against
index_copy_ (bitwise), MF and Mult-VAE captured steps bitwise eager (the
KL weight changing inside the graphs), and EASE on the card against the
CPU; the top-k in lax.top_k's order on the card bitwise the CPU's (ties,
-inf, NaN, signed zeros), chunked recommend on the card against the CPU
and against the monolithic path, the lowest ids of tied scores, a
deterministic ``encode_coo``, the chunked validation loss against the
dense one, the full-catalog sparse step on the card against the CPU (no
row-scatter launch), and the asynchronous evaluator's results; bf16
parameter storage: the decode-loss kernels on bf16 rows (both bf16 sets,
and the 3xTF32 set at float32 compute) bitwise the float32 rows of the
same values, the Adam kernel's bf16-parameter instantiations against its
plain twin, the row scatter over tables of mixed element sizes, captured
bf16-parameter steps bitwise eager, and bf16-parameter training on the
card against the CPU (dense, union, sparse; autoencoder and MF); the
captured 'blocks' union, sparse, target, random-negative, full-catalog
sparse and triplet-scatter steps bitwise eager (and a resume), with the
row scatter and the wgmma decode-loss route inside the replays; the
captured 'users' union, sparse and triplet-scatter steps over each
epoch's tables bitwise eager across an epoch whose width signature
changes (and a resume), the host spans of a captured 'users' run, and
no cyclic garbage collection inside a capture.

Every test skips where ``torch.cuda.is_available()`` is False. The file
imports neither jax nor the JAX package, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: loss rtol 1e-4; gradients rtol 1e-3 with an absolute floor
of 1e-4 times the largest reference entry (3xTF32 tensor-core products
and sums in another order than cuBLAS's float32). SPD solve: max abs error within 1e-4 of max |x| of
the blocked recursion and relative residual |Ax - b| / |b| within 1e-3
(well-conditioned systems, float32 Cholesky in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from recoder_tpu_torch.ops import fused_decode_loss as fdl
from recoder_tpu_torch.ops import row_scatter as rs
from recoder_tpu_torch.ops import spd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  torch.backends.cuda.matmul.allow_tf32 = False
  return torch.device('cuda')


def _problem(B, d, W, device, seed=0):
  gen = torch.Generator().manual_seed(seed)
  h = torch.tanh(torch.randn(B, d, generator=gen))
  rows = 0.2 * torch.randn(W, d, generator=gen)
  bias = 0.1 * torch.randn(W, generator=gen)
  target = (torch.rand(B, W, generator=gen) < 0.1).float()
  row_mask = (torch.arange(B) < max(1, B - 2)).float()
  col_mask = (torch.rand(W, generator=gen) < 0.8).float()
  return [x.to(device) for x in (h, rows, bias, target, row_mask, col_mask)]


def _run(fn, problem, kind, confidence):
  h, rows, bias, target, rm, cm = problem
  leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]
  loss = fn(*leaves, target, rm, cm, kind, confidence)
  loss.backward()
  return loss.item(), [x.grad.cpu().numpy() for x in leaves]


@pytest.mark.parametrize('kind,confidence', [
    ('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)])
@pytest.mark.parametrize('B,d,W', [
    (37, 24, 1000),   # ragged on every axis
    (1, 1, 1),        # one of everything
    (33, 256, 65),    # the widest feature axis; one row past a tile
    (64, 255, 2049),  # odd feature width; one column past a tile
    (500, 200, 333),  # the training batch and width, a short catalog
    (9, 7, 130),      # odd feature width below one k step
    (500, 200, 18117),  # an odd union width (MSD)
    (500, 200, 20224),  # the ML-20M full-decode width
])
def test_kernel_matches_plain(cuda, B, d, W, kind, confidence):
  problem = _problem(B, d, W, cuda)
  before = dict(fdl.LAUNCHES)
  got = _run(fdl.fused_decode_loss, problem, kind, confidence)
  ref = _run(fdl.fused_decode_loss_plain, problem, kind, confidence)
  assert fdl.LAUNCHES['fused_decode_loss_fwd'] == \
      before['fused_decode_loss_fwd'] + 1
  assert fdl.LAUNCHES['fused_decode_loss_bwd'] == \
      before['fused_decode_loss_bwd'] + 1
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
  for a, b in zip(got[1], ref[1]):
    np.testing.assert_allclose(a, b, rtol=1e-3,
                               atol=1e-4 * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize('kind,confidence', [
    ('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)])
def test_bfloat16_target_is_bitwise_float32(cuda, kind, confidence):
  problem = _problem(500, 200, 18117, cuda, seed=2)
  f32 = _run(fdl.fused_decode_loss, problem, kind, confidence)
  problem[3] = problem[3].bfloat16()
  bf16 = _run(fdl.fused_decode_loss, problem, kind, confidence)
  assert f32[0] == bf16[0]
  for a, b in zip(f32[1], bf16[1]):
    np.testing.assert_array_equal(a, b)


def test_no_grad_forward_writes_no_cotangent(cuda):
  """Under no_grad the forward launches without E0 and gives the same
  loss, bit for bit, as the forward that writes it."""
  from unittest import mock
  h, rows, bias, target, rm, cm = _problem(300, 64, 3000, cuda, seed=3)
  stashes = []
  real = fdl._kernel_forward

  def spy(*args):
    stashes.append(args[-1])
    return real(*args)

  hh = h.clone().requires_grad_(True)
  with mock.patch.object(fdl, '_kernel_forward', spy):
    with torch.no_grad():
      a = fdl.fused_decode_loss(hh, rows, bias, target, rm, cm, 'mse', 3.0)
    b = fdl.fused_decode_loss(hh, rows, bias, target, rm, cm, 'mse', 3.0)
  assert stashes == [False, True]
  assert torch.equal(a, b.detach())


def test_kernel_is_deterministic(cuda):
  problem = _problem(300, 64, 3000, cuda, seed=1)
  a = _run(fdl.fused_decode_loss, problem, 'mse', 3.0)
  b = _run(fdl.fused_decode_loss, problem, 'mse', 3.0)
  assert a[0] == b[0]
  for x, y in zip(a[1], b[1]):
    np.testing.assert_array_equal(x, y)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
  h, rows, bias, target, rm, cm = _problem(8, 300, 40, cuda)
  with pytest.raises(ValueError, match='feature width'):
    fdl.fused_decode_loss(h, rows, bias, target, rm, cm, 'mse', 0.0)
  h, rows, bias, target, rm, cm = _problem(8, 16, 40, cuda)
  with pytest.raises(ValueError, match='contiguous'):
    fdl.fused_decode_loss(h, rows, bias, target.t().contiguous().t(), rm,
                          cm, 'mse', 0.0)
  with pytest.raises(ValueError, match='float32'):
    fdl.fused_decode_loss(h, rows, bias, target.half(), rm, cm, 'mse', 0.0)
  with pytest.raises(ValueError, match='is on'):
    fdl.fused_decode_loss(h, rows, bias, target.cpu(), rm, cm, 'mse', 0.0)


def test_trainer_on_cuda_matches_cpu(cuda):
  """Noise off, the same init and permutation: the per-step losses on
  the card (through the kernel) follow the CPU run (plain twin)."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  rng = np.random.default_rng(0)
  m = sp.csr_matrix((rng.random((90, 300)) < 0.05).astype(np.float32))
  losses = {}
  for device in ('cpu', cuda):
    tr = Recoder(DynamicAutoencoder([32], noise_prob=0.0),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=device)
    tr.train(RecommendationDataset(m), batch_size=16, lr=1e-3,
             weight_decay=2e-5, negative_sampling=True, shuffle='users',
             num_epochs=1)
    losses[str(device)] = tr.last_epoch_losses
  assert len(losses['cpu']) == 6
  np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-4)


def _spd_problem(B, d, device, seed=0):
  """SPD systems as iALS builds them: a Gram of factors at the init
  scale plus a ridge."""
  rng = np.random.default_rng(seed)
  f = rng.standard_normal((B, d + 8, d)).astype(np.float32) / np.sqrt(d)
  a = np.einsum('blk,blm->bkm', f, f) + 0.05 * np.eye(d, dtype=np.float32)
  b = rng.standard_normal((B, d)).astype(np.float32)
  return (torch.from_numpy(a.astype(np.float32)).to(device),
          torch.from_numpy(b).to(device))


@pytest.mark.parametrize('B', [1, 37])
@pytest.mark.parametrize('d', [1, 7, 15, 16, 17, 33, 64, 127, 128, 129,
                               130, 200, 255, 256])
def test_spd_kernel_matches_blocked(cuda, B, d):
  a, b = _spd_problem(B, d, cuda, seed=d)
  before = spd.LAUNCHES['spd_solve']
  x = spd.spd_solve(a, b)
  assert spd.LAUNCHES['spd_solve'] == before + 1
  ref = spd.spd_solve(a, b, impl='blocked')
  assert spd.LAUNCHES['spd_solve'] == before + 1
  assert x.shape == b.shape
  err = float((x - ref).abs().max())
  assert err <= 1e-4 * float(ref.abs().max()), err
  res = torch.linalg.vector_norm(
      torch.einsum('bij,bj->bi', a, x) - b, dim=1)
  rel = res / torch.linalg.vector_norm(b, dim=1)
  assert float(rel.max()) <= 1e-3


@pytest.mark.parametrize('d', [128, 200])
def test_spd_kernel_is_batch_independent(cuda, d):
  """A system's x is bitwise the same alone, at any position of a batch
  of 37, and from run to run: fold-in's bit-exact contract rests on it.
  d = 200 is padded inside the kernel to whole panels."""
  a, b = _spd_problem(37, d, cuda, seed=5)
  batch = spd.spd_solve_kernel(a, b)
  np.testing.assert_array_equal(batch.cpu().numpy(),
                                spd.spd_solve_kernel(a, b).cpu().numpy())
  for i in (0, 17, 36):
    alone = spd.spd_solve_kernel(a[i:i + 1].contiguous(),
                                 b[i:i + 1].contiguous())
    np.testing.assert_array_equal(alone[0].cpu().numpy(),
                                  batch[i].cpu().numpy())
  perm = torch.randperm(37, generator=torch.Generator().manual_seed(0))
  shuffled = spd.spd_solve_kernel(a[perm.to(cuda)].contiguous(),
                                  b[perm.to(cuda)].contiguous())
  np.testing.assert_array_equal(shuffled.cpu().numpy(),
                                batch[perm.to(cuda)].cpu().numpy())


def test_spd_kernel_indefinite_gives_nan(cuda):
  a, b = _spd_problem(3, 64, cuda, seed=2)
  a[1] = -a[1]
  x = spd.spd_solve_kernel(a, b)
  assert torch.isnan(x[1]).all()
  assert torch.isfinite(x[0]).all() and torch.isfinite(x[2]).all()
  assert torch.isnan(spd.spd_solve(a, b, impl='blocked')[1]).all()


@pytest.mark.parametrize('d', [128, 200])
def test_spd_kernel_indefinite_leaves_the_others_bitwise(cuda, d):
  """One indefinite system among 37 comes out all NaN; the other 36 are
  bitwise their solve in a batch without it."""
  a, b = _spd_problem(37, d, cuda, seed=3)
  a[11] = -a[11]
  x = spd.spd_solve_kernel(a, b)
  keep = torch.tensor([i for i in range(37) if i != 11], device=cuda)
  rest = spd.spd_solve_kernel(a[keep].contiguous(), b[keep].contiguous())
  assert torch.isnan(x[11]).all()
  assert torch.isfinite(rest).all()
  np.testing.assert_array_equal(x[keep].cpu().numpy(), rest.cpu().numpy())


def test_spd_kernel_reports_its_resources(cuda):
  res = spd.kernel_resources(128)
  assert 0 < res['smem_bytes'] <= 232448
  assert res['blocks_per_sm'] >= 4
  with pytest.raises(ValueError, match='width'):
    spd.kernel_resources(257)


def test_spd_kernel_refuses_what_it_does_not_take(cuda):
  a, b = _spd_problem(2, 257, cuda)
  with pytest.raises(ValueError, match='width'):
    spd.spd_solve(a, b, impl='kernel')
  before = spd.LAUNCHES['spd_solve']
  spd.spd_solve(a, b)  # d > 256 takes the blocked recursion
  a, b = _spd_problem(2, 16, cuda)
  spd.spd_solve(a, b[..., None].repeat(1, 1, 3))  # a matrix rhs too
  assert spd.LAUNCHES['spd_solve'] == before
  with pytest.raises(ValueError, match='B, d'):
    spd.spd_solve(a, b[..., None], impl='kernel')
  with pytest.raises(ValueError, match='contiguous'):
    spd.spd_solve(a.transpose(1, 2), b, impl='kernel')
  with pytest.raises(ValueError, match='float32'):
    spd.spd_solve(a.double(), b.double(), impl='kernel')
  with pytest.raises(ValueError, match='is on'):
    spd.spd_solve(a, b.cpu(), impl='kernel')


def test_ials_on_cuda_matches_cpu(cuda):
  """The fit on the card (through the kernel) follows the fit on the CPU
  (blocked recursion); fold-in of a subset of the training users on the
  card reproduces their factors bit for bit."""
  from recoder_tpu_torch.data import UsersInteractions
  from recoder_tpu_torch.models import IALS

  rng = np.random.default_rng(0)
  m = sp.csr_matrix((rng.random((300, 120)) < 0.08).astype(np.float32))
  kw = dict(embedding_size=16, alpha=10.0, lam=0.05, sweeps=3, seed=1)
  cpu = IALS(**kw, device='cpu').fit(m)
  before = spd.LAUNCHES['spd_solve']
  gpu = IALS(device=cuda, **kw).fit(m, chunk_elems=1 << 10)
  assert spd.LAUNCHES['spd_solve'] > before
  np.testing.assert_allclose(gpu.item_factors.cpu().numpy(),
                             cpu.item_factors.numpy(), rtol=1e-3, atol=1e-4)
  np.testing.assert_allclose(gpu.user_factors.cpu().numpy(),
                             cpu.user_factors.numpy(), rtol=1e-3, atol=1e-4)
  users = np.arange(0, 300, 7)
  ui = UsersInteractions(users, m[users])
  np.testing.assert_array_equal(gpu.fold_in(ui).cpu().numpy(),
                                gpu.user_factors[users].cpu().numpy())


def _scatter_case(N, d, W, device, seed=0, ntables=3):
  """Tables, ids and rows; a repeated id gets the same payload."""
  rng = np.random.default_rng(seed)
  tables = [torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
            .to(device) for _ in range(ntables)]
  ids = rng.integers(0, N, W).astype(np.int64)
  payload = [rng.standard_normal((N, d)).astype(np.float32)
             for _ in range(ntables)]
  rows = [torch.from_numpy(p[ids]).to(device) for p in payload]
  return tables, torch.from_numpy(ids).to(device), rows


def _scatter_both(tables, ids, rows):
  kernel = [t.clone() for t in tables]
  plain = [t.clone() for t in tables]
  ptrs = [t.data_ptr() for t in kernel]
  before = rs.LAUNCHES['row_scatter']
  rs.row_scatter_(kernel, ids, rows)
  launched = rs.LAUNCHES['row_scatter'] - before
  rs.row_scatter_plain(plain, ids, rows)
  torch.cuda.synchronize()
  assert [t.data_ptr() for t in kernel] == ptrs
  for a, b in zip(kernel, plain):
    assert torch.equal(a, b)
  return kernel, launched


@pytest.mark.parametrize('W', [0, 1, 37])
@pytest.mark.parametrize('d', [1, 3, 7, 128, 200, 256, 1000])
@pytest.mark.parametrize('N', [1, 37, 41216])
def test_row_scatter_matches_index_copy(cuda, N, d, W):
  tables, ids, rows = _scatter_case(N, d, W, cuda, seed=N + d + W)
  out, launched = _scatter_both(tables, ids, rows)
  assert launched == (1 if W else 0)
  untouched = torch.ones(N, dtype=torch.bool, device=cuda)
  untouched[ids] = False
  for a, b in zip(out, tables):
    assert torch.equal(a[untouched], b[untouched])


def test_row_scatter_misaligned_column_slice(cuda):
  """A column slice starts 4 bytes past a 16-byte boundary: the kernel
  takes the scalar path and writes the same bytes as index_copy_, and
  the columns outside the slice stay put."""
  base, ids, rows = _scatter_case(41216, 201, 37, cuda, seed=4, ntables=1)
  tables = [base[0][:, 1:201]]
  rows = [r[:, 1:201].contiguous() for r in rows]
  assert not rs.vector_path(tables, rows)
  out, launched = _scatter_both(tables, ids, rows)
  assert launched == 1
  whole = base[0].clone()
  rs.row_scatter_([whole[:, 1:201]], ids, rows)
  torch.cuda.synchronize()
  assert torch.equal(whole[:, 0], base[0][:, 0])
  assert torch.equal(whole[:, 1:201], out[0])
  wide = torch.zeros((8, 204), device=cuda)
  assert rs.vector_path([wide[:, 4:200]],
                        [torch.zeros((3, 196), device=cuda)])


def test_row_scatter_sentinel_tail_and_msd_shape(cuda):
  """Three [41,216, 200] tables, sorted unique ids with a sentinel tail
  of identical payloads (the JAX union layout)."""
  rng = np.random.default_rng(7)
  N, d = 41216, 200
  ids = np.sort(rng.choice(41140, 18000, replace=False))
  ids = np.concatenate([ids, np.full(48, 41140)]).astype(np.int64)
  tables = [torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
            .to(cuda) for _ in range(3)]
  rows = []
  for _ in range(3):
    r = rng.standard_normal((len(ids), d)).astype(np.float32)
    r[18000:] = r[18000]
    rows.append(torch.from_numpy(r).to(cuda))
  ids = torch.from_numpy(ids).to(cuda)
  assert rs.vector_path(tables, rows)
  _scatter_both(tables, ids, rows)


@pytest.mark.parametrize('d', [3, 200])
def test_row_scatter_skips_the_slots_of_id_minus_one(cuda, d):
  """A mesh rank's sparse update: the union slots whose row another rank
  holds carry id -1 and write nothing (both paths of the kernel)."""
  tables, ids, rows = _scatter_case(41216, d, 1000, cuda, seed=d)
  ids = torch.where(torch.arange(1000, device=cuda) % 3 == 0, -1, ids)
  out, launched = _scatter_both(tables, ids, rows)
  assert launched == 1
  untouched = torch.ones(41216, dtype=torch.bool, device=cuda)
  untouched[ids[ids >= 0]] = False
  for a, b in zip(out, tables):
    assert torch.equal(a[untouched], b[untouched])


def test_row_scatter_refuses_what_it_does_not_take(cuda):
  tables, ids, rows = _scatter_case(10, 8, 4, cuda)
  with pytest.raises(ValueError, match='int64'):
    rs.row_scatter_(tables, ids.int(), rows)
  with pytest.raises(ValueError, match='float32'):
    rs.row_scatter_([t.double() for t in tables], ids,
                    [r.double() for r in rows])
  with pytest.raises(ValueError, match='column stride'):
    rs.row_scatter_([t.t().contiguous().t() for t in tables], ids, rows)
  with pytest.raises(ValueError, match='is on'):
    rs.row_scatter_(tables, ids, [rows[0].cpu()] + rows[1:])
  with pytest.raises(ValueError, match='tables'):
    rs.row_scatter_(tables + tables[:1], ids, rows + rows[:1])


def test_sparse_step_kernel_matches_plain_twin(cuda):
  """Three sparse steps on the card through the kernel and through
  index_copy_: the same tables, moments and losses, bit for bit."""
  from unittest import mock

  from recoder_tpu_torch import optim
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  rng = np.random.default_rng(0)
  m = sp.csr_matrix((rng.random((90, 300)) < 0.05).astype(np.float32))
  out = {}
  for route in ('kernel', 'plain'):
    tr = Recoder(DynamicAutoencoder([32], noise_prob=0.5, sparse=True),
                 optimizer_type='adam', loss='logloss', device=cuda)
    patch = (mock.patch.object(optim, 'row_scatter_', rs.row_scatter_plain)
             if route == 'plain' else mock.MagicMock())
    before = rs.LAUNCHES['row_scatter']
    with patch:
      tr.train(RecommendationDataset(m), batch_size=32, lr=1e-2,
               weight_decay=2e-5, negative_sampling=True, shuffle='users',
               num_epochs=1)
    launched = rs.LAUNCHES['row_scatter'] - before
    assert launched == (6 if route == 'kernel' else 0)
    out[route] = (tr.last_epoch_losses,
                  {k: v.cpu() for k, v in tr.model.params().items()},
                  {p: (s['m'].cpu(), s['v'].cpu())
                   for p, s in tr.sparse_states.items()})
  (lk, pk, sk), (lp, pp, spl) = out['kernel'], out['plain']
  assert lk == lp
  for name in pk:
    assert torch.equal(pk[name], pp[name]), name
  for p in sk:
    assert torch.equal(sk[p][0], spl[p][0]) and torch.equal(sk[p][1],
                                                            spl[p][1])


# -- the bf16 variant of the decode-loss kernels ------------------------------

def _rel_fro(a, b):
  return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run_bf16(fn, problem, kind, confidence):
  h, rows, bias, target, rm, cm = problem
  leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]
  loss = fn(*leaves, target, rm, cm, kind, confidence, 'bfloat16')
  loss.backward()
  return loss.item(), [x.grad.cpu().numpy() for x in leaves]


@pytest.mark.parametrize('kind,confidence', [
    ('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)])
@pytest.mark.parametrize('B,d,W', [
    (37, 24, 1000), (1, 1, 1), (33, 256, 65), (64, 255, 2049), (9, 7, 130),
    (500, 200, 18117), (500, 200, 20224)])
def test_bf16_kernel_matches_plain(cuda, B, d, W, kind, confidence):
  """The bf16 kernels against autograd through the plain bf16
  composition: loss rtol 1e-2, gradients within 2e-2 in relative
  Frobenius norm (a score or gradient on a bf16 rounding boundary may
  round the other way after a sum in another order)."""
  problem = _problem(B, d, W, cuda)
  before = dict(fdl.LAUNCHES)
  got = _run_bf16(fdl.fused_decode_loss, problem, kind, confidence)
  ref = _run_bf16(fdl.fused_decode_loss_plain, problem, kind, confidence)
  for name in ('fused_decode_loss_fwd_bf16', 'fused_decode_loss_bwd_bf16'):
    assert fdl.LAUNCHES[name] == before[name] + 1
  for name in ('fused_decode_loss_fwd', 'fused_decode_loss_bwd'):
    assert fdl.LAUNCHES[name] == before[name]
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-2)
  for a, b in zip(got[1], ref[1]):
    assert _rel_fro(a, b) <= 2e-2
  for a in got[1][:2]:  # dh and drows are bf16 values
    t = torch.from_numpy(a)
    assert torch.equal(t, t.to(torch.bfloat16).float())


def test_bf16_kernel_is_deterministic_and_stashes_bf16(cuda):
  problem = _problem(500, 200, 18117, cuda, seed=4)
  a = _run_bf16(fdl.fused_decode_loss, problem, 'mse', 3.0)
  b = _run_bf16(fdl.fused_decode_loss, problem, 'mse', 3.0)
  assert a[0] == b[0]
  for x, y in zip(a[1], b[1]):
    np.testing.assert_array_equal(x, y)
  h, rows, bias, target, rm, cm = problem
  loss, e0, _ = fdl._kernel_forward(h, rows, bias, target, rm, cm, 'mse',
                                    3.0, 'bfloat16', True)
  assert e0.dtype == torch.bfloat16 and e0.shape == (500, 18120)
  assert not e0[:, 18117:].any()  # the pad columns are zero
  _, plain_e0 = fdl._plain_forward(h, rows, bias, target, rm, cm, 'mse', 3.0,
                                   'bfloat16', True)
  # E0 only differs where a score sits on a bf16 rounding boundary
  assert (e0[:, :18117] != plain_e0).float().mean().item() < 1e-3
  with torch.no_grad():
    nograd, none, _ = fdl._kernel_forward(h, rows, bias, target, rm, cm,
                                          'mse', 3.0, 'bfloat16', False)
  assert none is None and torch.equal(nograd, loss)


WGMMA_SHAPES = [(37, 200, 1000), (480, 200, 18120), (500, 200, 20224)]


def _bf16_target(problem):
  return problem[:3] + [problem[3].to(torch.bfloat16)] + problem[4:]


@pytest.mark.parametrize('kind,confidence', [
    ('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)])
@pytest.mark.parametrize('B,d,W', WGMMA_SHAPES)
def test_bf16_wgmma_kernel_matches_plain(cuda, B, d, W, kind, confidence):
  """The wgmma kernels (a bf16 target, W % 8 == 0, a compiled width)
  against autograd through the plain bf16 composition at the bf16
  tolerances; their counters move, the mma.sync set's do not; two runs
  are bitwise equal."""
  problem = _bf16_target(_problem(B, d, W, cuda))
  assert fdl.bf16_route(*problem[:2], problem[3]) == 'wgmma'
  before = dict(fdl.LAUNCHES)
  got = _run_bf16(fdl.fused_decode_loss, problem, kind, confidence)
  ref = _run_bf16(fdl.fused_decode_loss_plain, problem, kind, confidence)
  for name in ('fused_decode_loss_fwd_bf16_wgmma',
               'fused_decode_loss_bwd_bf16_wgmma'):
    assert fdl.LAUNCHES[name] == before[name] + 1
  for name in ('fused_decode_loss_fwd_bf16', 'fused_decode_loss_bwd_bf16',
               'fused_decode_loss_fwd', 'fused_decode_loss_bwd'):
    assert fdl.LAUNCHES[name] == before[name]
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-2)
  for a, b in zip(got[1], ref[1]):
    assert _rel_fro(a, b) <= 2e-2
  for a in got[1][:2]:  # dh and drows are bf16 values
    t = torch.from_numpy(a)
    assert torch.equal(t, t.to(torch.bfloat16).float())
  again = _run_bf16(fdl.fused_decode_loss, problem, kind, confidence)
  assert again[0] == got[0]
  for x, y in zip(again[1], got[1]):
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('kind,confidence', [
    ('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)])
def test_bf16_wgmma_agrees_with_mma_and_without_e0(cuda, kind, confidence):
  """At the ML-20M shape the two bf16 kernel sets write the same E0
  (the scores take the same roundings; a sum in another order moves a
  score across a bf16 boundary rarely); the wgmma forward without E0
  gives its loss bit for bit and writes nothing else; the bf16 copies it
  keeps for the backward are [bf16(h) | 1 | 0..] and bf16(rows)."""
  h, rows, bias, target, rm, cm = _bf16_target(_problem(500, 200, 20224,
                                                        cuda, seed=6))
  args = (target, rm, cm, kind, confidence, 'bfloat16')
  before = dict(fdl.LAUNCHES)
  loss, e0, copies = fdl._kernel_forward(h, rows, bias, *args, True)
  assert copies is not None and e0.shape == (500, 20224)
  nograd, none, no_copies = fdl._kernel_forward(h, rows, bias, *args, False)
  assert none is None and no_copies is None and torch.equal(nograd, loss)
  assert fdl.LAUNCHES['fused_decode_loss_fwd_bf16_wgmma'] == \
      before['fused_decode_loss_fwd_bf16_wgmma'] + 2
  mloss, me0, _ = fdl._kernel_forward(h, rows, bias, *args, True,
                                      route='mma')
  assert fdl.LAUNCHES['fused_decode_loss_fwd_bf16'] == \
      before['fused_decode_loss_fwd_bf16'] + 1
  assert (e0 != me0).float().mean().item() < 1e-3
  np.testing.assert_allclose(loss.item(), mloss.item(), rtol=1e-4)
  hb, rows_b = copies
  assert hb.shape == (500, 208) and torch.equal(hb[:, :200], h.bfloat16())
  assert (hb[:, 200] == 1).all() and not hb[:, 201:].any()
  assert torch.equal(rows_b, rows.bfloat16())


def test_bf16_wgmma_refuses_what_it_cannot_describe(cuda):
  """Forced onto the wgmma kernels, a target that TMA cannot describe (a
  contiguous one of W % 8 != 0: its row stride is not 16-byte runs)
  raises rather than falling back."""
  h, rows, bias, target, rm, cm = _bf16_target(_problem(64, 200, 1001,
                                                        cuda))
  with pytest.raises(RuntimeError):
    fdl._kernel_forward(h, rows, bias, target, rm, cm, 'mse', 3.0,
                        'bfloat16', True, route='wgmma')


def _padded(x):
  """``x [B, W]`` in the ``[:B, :W]`` view of rows W rounded up to 8
  elements long: the row stride of the trainer's union targets."""
  B, W = x.shape
  out = torch.zeros((B, -(-W // 8) * 8), dtype=x.dtype, device=x.device)
  out[:, :W] = x
  return out[:, :W]


#: (B, d, W): union widths and the ladder's feature widths
PADDED_WGMMA_SHAPES = [(500, 200, 18117), (37, 24, 1001), (64, 8, 130),
                       (480, 104, 18120), (500, 128, 20223), (37, 248, 45)]


@pytest.mark.parametrize('kind,confidence', [('mse', 3.0), ('logistic', 0.0)])
@pytest.mark.parametrize('B,d,W', PADDED_WGMMA_SHAPES)
def test_bf16_wgmma_at_every_width_matches_plain(cuda, B, d, W, kind,
                                                 confidence):
  """A bf16 target at the union targets' row stride (W rounded up to 8)
  and a feature width d % 8 == 0 up to 248: the wgmma kernels, against
  the plain composition at the bf16 tolerances, two runs bitwise equal;
  E0's pad columns zero; the same target contiguous at W % 8 != 0 goes
  to the mma.sync set."""
  h, rows, bias, target, rm, cm = _bf16_target(_problem(B, d, W, cuda))
  padded = _padded(target)
  problem = [h, rows, bias, padded, rm, cm]
  assert fdl.bf16_route(h, rows, padded) == 'wgmma'
  before = dict(fdl.LAUNCHES)
  got = _run_bf16(fdl.fused_decode_loss, problem, kind, confidence)
  for name in ('fused_decode_loss_fwd_bf16_wgmma',
               'fused_decode_loss_bwd_bf16_wgmma'):
    assert fdl.LAUNCHES[name] == before[name] + 1
  ref = _run_bf16(fdl.fused_decode_loss_plain, problem, kind, confidence)
  np.testing.assert_allclose(got[0], ref[0], rtol=1e-2)
  for a, b in zip(got[1], ref[1]):
    assert _rel_fro(a, b) <= 2e-2
  again = _run_bf16(fdl.fused_decode_loss, problem, kind, confidence)
  assert again[0] == got[0]
  for x, y in zip(again[1], got[1]):
    np.testing.assert_array_equal(x, y)
  _, e0, _ = fdl._kernel_forward(h, rows, bias, padded, rm, cm, kind,
                                 confidence, 'bfloat16', True)
  assert e0.shape == (B, -(-W // 8) * 8) and not e0[:, W:].any()
  if W % 8:
    assert fdl.bf16_route(h, rows, target) == 'mma'


def test_bf16_trainer_on_cuda_matches_cpu(cuda):
  """bench.py's numerics (bf16 compute, bf16 moments), noise off: the
  losses on the card (bf16 kernels, the Adam kernel) follow the CPU run
  (plain versions) within rtol 1e-2."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import adam

  rng = np.random.default_rng(0)
  m = sp.csr_matrix((rng.random((90, 300)) < 0.05).astype(np.float32))
  losses = {}
  for device in ('cpu', cuda):
    tr = Recoder(DynamicAutoencoder([32], noise_prob=0.0,
                                    compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=device,
                 opt_state_dtype='bfloat16')
    before = adam.LAUNCHES['adam_bf16']
    # one eager dispatch a step: each launch is counted (a graph replay
    # runs its launches without Python)
    tr.train(RecommendationDataset(m), batch_size=16, lr=1e-3,
             weight_decay=2e-5, negative_sampling=True, shuffle='users',
             num_epochs=1, fused_steps_per_call=1)
    losses[str(device)] = tr.last_epoch_losses
    launched = adam.LAUNCHES['adam_bf16'] - before
    assert launched == (6 if device == cuda else 0)
  np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-2)


# -- the fused bf16-moment Adam kernel ---------------------------------------

def _adam_set(sizes, device, seed=0, offset=0):
  """Parameters, gradients and bf16 moments of the given sizes (``offset``
  elements into a larger buffer: a misaligned start)."""
  gen = torch.Generator().manual_seed(seed)
  out = []
  for n in sizes:
    p = 0.1 * torch.randn(n + offset, generator=gen)
    g = 0.01 * torch.randn(n + offset, generator=gen)
    m = (0.001 * torch.randn(n + offset, generator=gen)).to(torch.bfloat16)
    v = (1e-5 * torch.rand(n + offset, generator=gen)).to(torch.bfloat16)
    out.append([x.to(device)[offset:] for x in (p, g, m, v)])
  return [list(x) for x in zip(*out)]


def _f32_ulps(a, b):
  """|a - b| in float32 ulps of b."""
  a, b = a.double(), b.double()
  ulp = torch.finfo(torch.float32).eps * b.abs().clamp(min=1e-30)
  return float(((a - b).abs() / ulp).max())


@pytest.mark.parametrize('sizes,offset', [
    ((1,), 0), ((3, 5), 0), ((4097,), 0), ((1_000_003,), 0),
    ((4096, 200, 4_044_800, 20_224), 0), ((4096, 1000), 1)])
def test_adam_kernel_matches_plain(cuda, sizes, offset):
  """Five steps through the kernel and through its plain version: m and v
  bitwise (the same float32 operations, no multiply-add contraction),
  p within 2 float32 ulps; one launch a step for the whole set."""
  from recoder_tpu_torch.ops import adam
  # the kernel on the (possibly misaligned) views, the plain on copies
  kp, grads, km, kv = _adam_set(sizes, cuda, offset=offset)
  params, ms, vs = ([x.clone() for x in xs] for xs in (kp, km, kv))
  wds = [2e-5 if i % 2 == 0 else 0.0 for i in range(len(sizes))]
  before = adam.LAUNCHES['adam_bf16']
  for step in range(1, 6):
    lr = 1e-3 * (0.1 if step > 3 else 1.0)
    adam.adam_bf16_kernel(kp, grads, km, kv, wds,
                          adam.step_scalars(lr, step, (0.9, 0.999), 1e-8))
    adam.adam_bf16_plain(params, grads, ms, vs, wds,
                         adam.step_scalars(lr, step, (0.9, 0.999), 1e-8))
  torch.cuda.synchronize()
  assert adam.LAUNCHES['adam_bf16'] == before + 5
  for a, b in zip(km + kv, ms + vs):
    assert torch.equal(a, b)
  for a, b in zip(kp, params):
    assert _f32_ulps(a, b) <= 2


def test_adam_kernel_is_deterministic_and_refuses(cuda):
  from recoder_tpu_torch.ops import adam
  runs = []
  for _ in range(2):
    params, grads, ms, vs = _adam_set((70_001, 33), cuda, seed=3)
    adam.adam_bf16_step(params, grads, ms, vs, [1e-2, 0.0], 1e-2, 7)
    runs.append(params + ms + vs)
  for a, b in zip(*runs):
    assert torch.equal(a, b)
  params, grads, ms, vs = _adam_set((10,), cuda)
  with pytest.raises(ValueError, match='bfloat16'):
    adam.adam_bf16_step(params, grads, [m.float() for m in ms], vs, [0.0],
                        1e-3, 1)
  with pytest.raises(ValueError, match='is on'):
    adam.adam_bf16_step(params, [g.cpu() for g in grads], ms, vs, [0.0],
                        1e-3, 1)


# -- the packed-slab row fetch with bit unpack --------------------------------

def _packed_slab(n_rows, n_words, seed=0):
  """Random words with bit 31 set in every fourth one, the last row zero
  (the pad users' row)."""
  rng = np.random.default_rng(seed)
  words = rng.integers(0, 2 ** 32, (n_rows, n_words), dtype=np.uint64)
  words[:, ::4] |= np.uint64(1 << 31)
  words[-1] = 0
  return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _unpack_both(packed, num_items, **fetch):
  from recoder_tpu_torch.ops import packed_rows as pr
  before = pr.LAUNCHES['packed_rows']
  got = pr.unpack_rows(packed, num_items, **fetch)
  torch.cuda.synchronize()
  assert pr.LAUNCHES['packed_rows'] == before + 1
  ref = pr.unpack_rows_plain(packed, num_items, **fetch)
  for a, b in zip(got, ref):
    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize('n_words', [1, 5, 33, 644, 1288])
@pytest.mark.parametrize('B', [1, 37, 500])
def test_packed_rows_kernel_matches_plain(cuda, B, n_words):
  """Bitwise, both fetch modes: a contiguous fetch at the last block and
  at an inner one, and a gather with pad users past the slab (clamped to
  its zero last row) and repeated rows; num_items inside the last word
  and at the width."""
  n_rows = 2 * B + 3
  packed = _packed_slab(n_rows, n_words, seed=B + n_words).to(cuda)
  W = 32 * n_words
  for num_items in (W - 7, W):
    _unpack_both(packed, num_items, start=n_rows - B, count=B)
    _unpack_both(packed, num_items, start=1, count=B)
    rng = np.random.default_rng(n_words)
    index = rng.integers(0, n_rows + 40, B).astype(np.int64)
    index[-1] = n_rows + 100  # a pad user
    _unpack_both(packed, num_items, index=torch.from_numpy(index).to(cuda))


def test_packed_rows_kernel_refuses_and_handles_empty(cuda):
  from recoder_tpu_torch.ops import packed_rows as pr
  packed = _packed_slab(8, 3).to(cuda)
  _unpack_both(packed, 90, start=2, count=0)
  with pytest.raises(ValueError, match='int32'):
    pr.unpack_rows(packed.long(), 90, start=0, count=2)
  with pytest.raises(ValueError, match='outside'):
    pr.unpack_rows(packed, 90, start=7, count=2)
  with pytest.raises(ValueError, match='int64'):
    pr.unpack_rows(packed, 90, index=torch.zeros(2, dtype=torch.int32,
                                                 device=cuda))
  with pytest.raises(ValueError, match='contiguous'):
    pr.unpack_rows_kernel(packed.t().contiguous().t(), 90, start=0, count=2)


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_packed_training_is_bitwise_dense_on_the_card(cuda, shuffle):
  """Five bf16 logloss steps from the packed and from the dense slab:
  the same losses and parameters, bit for bit, with one unpack launch a
  step."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import packed_rows as pr
  rng = np.random.default_rng(1)
  m = sp.csr_matrix((rng.random((150, 300)) < 0.05).astype(np.float32))
  out = {}
  for cache in ('packed', True):
    tr = Recoder(DynamicAutoencoder([32], noise_prob=0.5,
                                    compute_dtype='bfloat16'),
                 optimizer_type='adam', loss='logloss', device=cuda,
                 opt_state_dtype='bfloat16')
    before = pr.LAUNCHES['packed_rows']
    tr.train(RecommendationDataset(m), batch_size=32, lr=1e-2,
             weight_decay=2e-5, negative_sampling=True, shuffle=shuffle,
             num_epochs=1, slab_cache=cache, full_decode=True,
             fused_steps_per_call=1)
    assert tr.fused_data_source._slab_packed == (cache == 'packed')
    assert pr.LAUNCHES['packed_rows'] - before == (5 if cache == 'packed'
                                                   else 0)
    out[cache] = (tr.last_epoch_losses,
                  {k: v.cpu() for k, v in tr.model.params().items()})
  assert out['packed'][0] == out[True][0]
  for name, p in out['packed'][1].items():
    assert torch.equal(p, out[True][1][name]), name


# -- captured full-decode steps (CUDA graphs) ---------------------------------

def _capture_trainer(cuda, dtype, noise=0.5):
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  return Recoder(DynamicAutoencoder([32], 'tanh', noise_prob=noise,
                                    compute_dtype=dtype),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=cuda,
                 opt_state_dtype=dtype)


def _capture_data():
  """700 users in batches of 32: 22 steps an epoch, the last block with
  4 pad users."""
  from recoder_tpu_torch.data import RecommendationDataset
  rng = np.random.default_rng(2)
  return RecommendationDataset(sp.csr_matrix(
      (rng.random((700, 600)) < 0.04).astype(np.float32)))


def _capture_train(tr, data, spc, tier, shuffle, num_epochs=3, **kw):
  tr.train(data, batch_size=32, lr=1e-2, weight_decay=2e-5,
           num_epochs=num_epochs, lr_milestones=[2], negative_sampling=True,
           shuffle=shuffle, full_decode=True, slab_cache=tier,
           fused_steps_per_call=spc, **kw)
  return tr


def _assert_bitwise_trainers(a, b):
  assert a.last_epoch_losses == b.last_epoch_losses
  theirs = b.model.params()
  for name, p in a.model.params().items():
    assert torch.equal(p, theirs[name]), name
    sa, sb = a.optimizer.state[p], b.optimizer.state[theirs[name]]
    for key in sa:
      assert torch.equal(torch.as_tensor(sa[key]).cpu().float(),
                         torch.as_tensor(sb[key]).cpu().float()), (name, key)


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('tier', [True, 'packed'])
@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_captured_steps_are_bitwise_eager(cuda, dtype, tier, shuffle,
                                          tmp_path):
  """3 epochs of 22 steps (66), noise 0.5, an lr milestone, a tail block
  with pad users: 16 steps a graph against one eager step a dispatch --
  the losses, parameters and moments bit for bit. Then a resume from a
  checkpoint written 10 steps into epoch 1 ends bitwise where the
  uninterrupted run does."""
  data = _capture_data()
  eager = _capture_train(_capture_trainer(cuda, dtype), data, 1, tier,
                         shuffle)
  captured = _capture_train(_capture_trainer(cuda, dtype), data, 16, tier,
                            shuffle)
  assert eager.last_epoch_dispatch == 'eager'
  assert eager.last_epoch_dispatches == 22
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  assert captured.last_epoch_dispatches == 1 + 6  # a graph, 6 singles
  assert sorted(captured._graphs) == [1, 16]
  assert len(captured.last_epoch_losses) == 22
  _assert_bitwise_trainers(captured, eager)

  first = _capture_train(_capture_trainer(cuda, dtype), data, 16, tier,
                         shuffle, num_epochs=1, iters_per_epoch=10,
                         model_checkpoint_prefix=str(tmp_path / 'c'))
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  resumed = Recoder(DynamicAutoencoder(), optimizer_type='adam', device=cuda,
                    opt_state_dtype=dtype)
  resumed.init_from_model_file(str(tmp_path / 'c_epoch_1.model'))
  assert not resumed._graphs and resumed._iters_consumed == 10
  del first
  _capture_train(resumed, data, 16, tier, shuffle)
  _assert_bitwise_trainers(resumed, captured)


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
@pytest.mark.parametrize('tier', [True, 'packed'])
def test_captured_megas_with_negatives_are_bitwise_eager(cuda, tier, shuffle,
                                                         tmp_path):
  """Megas of 64 users (2 slices) and 40 random negatives a step, bf16,
  3 epochs: 16 steps a graph against one eager step a dispatch -- the
  losses, parameters and moments bit for bit (the random ids come from a
  generator each graph registers). A resume from a checkpoint 10 steps
  into epoch 1 draws what the uninterrupted run drew and ends bitwise
  where it does."""
  kw = dict(num_sampling_users=64, num_random_negatives=40)
  data = _capture_data()
  eager = _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 1, tier,
                         shuffle, **kw)
  captured = _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 16,
                            tier, shuffle, **kw)
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  source = captured.fused_data_source
  assert source.slices_per_mega == 2 and source.d_slab is not None
  assert source._slab_packed == (tier == 'packed')
  _assert_bitwise_trainers(captured, eager)
  _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 16, tier,
                 shuffle, num_epochs=1, iters_per_epoch=10,
                 model_checkpoint_prefix=str(tmp_path / 'c'), **kw)
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  resumed = Recoder(DynamicAutoencoder(), optimizer_type='adam', device=cuda,
                    opt_state_dtype='bfloat16')
  resumed.init_from_model_file(str(tmp_path / 'c_epoch_1.model'))
  _capture_train(resumed, data, 16, tier, shuffle, **kw)
  _assert_bitwise_trainers(resumed, captured)


@pytest.mark.parametrize('shuffle', ['blocks', 'users'])
def test_scatter_route_equals_the_slab_route(cuda, shuffle):
  """20 eager steps with megas of 64 and 40 random negatives, noise 0.5,
  bf16: through the per-step triplet scatter (slab_cache=False) and from
  the dense slab, bit for bit."""
  data = _capture_data()
  out = {}
  for cache in (True, False):
    tr = _capture_trainer(cuda, 'bfloat16')
    _capture_train(tr, data, 1, cache, shuffle, num_epochs=1,
                   iters_per_epoch=20, num_sampling_users=64,
                   num_random_negatives=40)
    assert (tr.fused_data_source.d_slab is None) == (cache is False)
    assert len(tr.last_epoch_losses) == 20
    out[cache] = tr
  _assert_bitwise_trainers(out[False], out[True])


@pytest.mark.parametrize('B', [1, 37, 2000])
@pytest.mark.parametrize('n_words', [1, 33, 632, 1288])
def test_packed_mask_kernel_matches_plain(cuda, B, n_words):
  """The mask-only launch (a mega's loss columns, no row written) against
  its plain version, bitwise, in both fetch modes, pad users past the
  slab in the gather."""
  from recoder_tpu_torch.ops import packed_rows as pr
  n_rows = B + 3
  packed = _packed_slab(n_rows, n_words, seed=B * n_words).to(cuda)
  rng = np.random.default_rng(B)
  index = rng.integers(0, n_rows + 40, B).astype(np.int64)
  index[-1] = n_rows + 100
  for fetch in (dict(index=torch.from_numpy(index).to(cuda)),
                dict(start=n_rows - B, count=B)):
    before = pr.LAUNCHES['packed_rows']
    got = pr.unpack_mask(packed, 32 * n_words - 7, **fetch)
    torch.cuda.synchronize()
    assert pr.LAUNCHES['packed_rows'] == before + 1
    assert torch.equal(got, pr.unpack_mask_plain(packed, 32 * n_words - 7,
                                                 **fetch))


def test_reset_training_state_keeps_the_graphs(cuda):
  """reset_training_state re-initializes in place: the next epoch replays
  the graphs already captured and is a fresh trainer's first, bit for
  bit."""
  data = _capture_data()
  fresh = _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 16,
                         'packed', 'blocks', num_epochs=1)
  tr = _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 16,
                      'packed', 'blocks', num_epochs=1)
  graphs = dict(tr._graphs)
  tr.reset_training_state()
  _capture_train(tr, data, 16, 'packed', 'blocks', num_epochs=1)
  assert tr._graphs == graphs  # the same graph objects, none captured
  _assert_bitwise_trainers(tr, fresh)


def test_captured_replays_run_each_kernel_once_a_step(cuda):
  """A profile of replays (epoch 1 again, as train resumes at the current
  epoch, and epoch 2: 44 steps): each hand kernel of the bf16 packed step
  once a step, by kernel name (d = 32: the wgmma decode-loss set)."""
  from torch.profiler import ProfilerActivity, profile
  data = _capture_data()
  tr = _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 16,
                      'packed', 'blocks', num_epochs=1)
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    _capture_train(tr, data, 16, 'packed', 'blocks', num_epochs=2)
    torch.cuda.synchronize()
  assert tr.last_epoch_dispatches == 7  # every step replayed
  counts = {}
  for ev in prof.key_averages():
    for name in ('decode_loss_fwd_bf16_wgmma_kernel',
                 'drows_dbias_bf16_wgmma_kernel', 'dh_bf16_wgmma_kernel',
                 'adam_bf16_kernel', 'packed_rows_kernel'):
      if name in ev.key:
        counts[name] = counts.get(name, 0) + ev.count
  assert counts == dict.fromkeys(counts, 44) and len(counts) == 5, counts


def test_failed_capture_raises(cuda, monkeypatch):
  """A step that fails while a graph records it raises out of train: no
  eager fallback."""
  from recoder_tpu_torch.model import Recoder
  real = Recoder._dense_step_math

  def failing(self, *args, **kwargs):
    if torch.cuda.is_current_stream_capturing():
      raise RuntimeError('refused under capture')
    return real(self, *args, **kwargs)

  monkeypatch.setattr(Recoder, '_dense_step_math', failing)
  tr = _capture_trainer(cuda, None)
  with pytest.raises(RuntimeError, match='refused under capture'):
    _capture_train(tr, _capture_data(), 16, True, 'users', num_epochs=1)
  assert not tr._graphs


# -- the host loader, target training and validation ------------------------

def _target_data(seed=0):
  rng = np.random.default_rng(seed)
  m = sp.csr_matrix((rng.random((70, 260)) < 0.06).astype(np.float32))
  t = sp.csr_matrix((rng.random((70, 260)) < 0.03).astype(np.float32)
                    * rng.integers(1, 4, size=(70, 260)))
  return m, t


def test_host_batches_on_the_card_equal_the_cpu(cuda):
  """The staged batches that reach the card (pinned memory, a copy
  stream, an event) hold what the CPU's hold, from two collation
  workers, over two passes."""
  from recoder_tpu_torch.data import (RecommendationDataLoader,
                                      RecommendationDataset)
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  m, t = _target_data()
  got = {}
  for device in ('cpu', cuda):
    tr = Recoder(DynamicAutoencoder([8]), device=device)
    loader = RecommendationDataLoader(RecommendationDataset(m, t),
                                      batch_size=16, negative_sampling=True,
                                      num_sampling_users=32, num_workers=2,
                                      seed=4)
    got[str(device)] = [list(tr._device_batch_iter(loader, depth=2))
                        for _ in range(2)]
  for a_pass, b_pass in zip(got['cuda'], got['cpu']):
    assert len(a_pass) == len(b_pass) == 5
    for a, b in zip(a_pass, b_pass):
      assert a.keys() == b.keys()
      for k, v in b.items():
        if torch.is_tensor(v):
          assert a[k].is_cuda and torch.equal(a[k].cpu(), v), k
        else:
          assert a[k] == v, k


@pytest.mark.parametrize('shuffle', ['users', 'blocks'])
@pytest.mark.parametrize('sparse', [False, True])
def test_target_training_on_cuda_matches_cpu(cuda, shuffle, sparse):
  """Training against a target matrix (host loader in 'users' mode, dual
  CSRs in 'blocks' mode), a tied decoder, noise off: the per-step losses
  and the validation loss on the card (kernels) follow the CPU run
  (plain twins) within rtol 1e-4."""
  from recoder_tpu_torch.data import (RecommendationDataLoader,
                                      RecommendationDataset)
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import row_scatter as rs

  m, t = _target_data(1)
  out = {}
  for device in ('cpu', cuda):
    tr = Recoder(DynamicAutoencoder([32], is_constrained=True,
                                    sparse=sparse),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=device)
    rs.LAUNCHES['row_scatter'] = 0
    tr.train(RecommendationDataset(m, t), batch_size=16, lr=1e-3,
             negative_sampling=True, shuffle=shuffle, num_epochs=1,
             fused_steps_per_call=1)
    out[str(device)] = (tr.last_epoch_losses, tr._validate(
        RecommendationDataLoader(RecommendationDataset(t, m), batch_size=16,
                                 negative_sampling=True, seed=7)),
        rs.LAUNCHES['row_scatter'])
  assert len(out['cpu'][0]) == 5
  np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], rtol=1e-4)
  np.testing.assert_allclose(out['cuda'][1], out['cpu'][1], rtol=1e-4)
  # the tied table over two unions: one row scatter a step
  assert out['cuda'][2] == (5 if sparse else 0)


def test_validation_keeps_captured_training_bitwise(cuda):
  """eval_freq=1 against eval_freq=0, captured full-decode steps with
  noise: bitwise the same trajectory, and no graph captured again after
  a validation."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import Recall

  data = _capture_data()
  m = data.interactions_matrix
  val = RecommendationDataset(m[:40], m[40:80])
  runs = []
  for eval_freq in (1, 0):
    tr = _capture_train(_capture_trainer(cuda, 'bfloat16'), data, 16, True,
                        'blocks', val_dataset=val, eval_freq=eval_freq,
                        metrics=[Recall(5)], eval_num_recommendations=5)
    runs.append(tr)
  assert runs[0].captures == runs[1].captures == 2
  _assert_bitwise_trainers(*runs)


# -- MatrixFactorization, Mult-VAE and EASE on the card -----------------------

def _family_data(seed=4):
  """90 users x 300 items; 'users' batches of 32 leave 6 pad users."""
  from recoder_tpu_torch.data import RecommendationDataset
  rng = np.random.default_rng(seed)
  return RecommendationDataset(sp.csr_matrix(
      (rng.random((90, 300)) < 0.05).astype(np.float32)))


@pytest.mark.parametrize('dtype', [None, 'bfloat16'])
def test_mf_fused_route_matches_plain(cuda, dtype):
  """MF's full-decode 'mse' steps through the decode-loss kernels (once
  a step, dropout 0.2) against the same steps through the plain decode +
  ``MSELoss`` (losses rtol 1e-3, bf16 1e-2)."""
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MatrixFactorization
  from recoder_tpu_torch.ops.losses import MSELoss

  data = _family_data()
  out = {}
  for route in ('kernel', 'plain'):
    plain = route == 'plain'
    tr = Recoder(MatrixFactorization(64, 'tanh', 0.2, compute_dtype=dtype),
                 optimizer_type='adam',
                 loss=MSELoss(confidence=40, reduction='sum') if plain
                 else 'mse', loss_params=None if plain
                 else {'confidence': 40},
                 device=cuda, opt_state_dtype=dtype)
    before = dict(fdl.LAUNCHES)
    tr.train(data, batch_size=32, lr=1e-2, negative_sampling=True,
             shuffle='users', full_decode=True, num_epochs=1,
             fused_steps_per_call=1)
    launched = {k: v - before[k] for k, v in fdl.LAUNCHES.items()
                if v != before[k]}
    if route == 'kernel':  # (bf16, d = 64: the wgmma pair)
      names = (('fused_decode_loss_fwd', 'fused_decode_loss_bwd')
               if dtype is None else ('fused_decode_loss_fwd_bf16_wgmma',
                                      'fused_decode_loss_bwd_bf16_wgmma'))
      assert launched == dict.fromkeys(names, 3), launched
    else:
      assert not launched
    out[route] = tr.last_epoch_losses
  np.testing.assert_allclose(out['kernel'], out['plain'],
                             rtol=1e-3 if dtype is None else 1e-2)


@pytest.mark.parametrize('family', ['mf', 'multvae'])
def test_sparse_family_step_kernel_matches_plain_twin(cuda, family):
  """Three sparse steps of MF (user and item tables) and of Mult-VAE
  (encoder and decoder tables) through the row-scatter kernel -- 2
  launches a step -- and through index_copy_: bitwise the same tables,
  moments and losses."""
  from unittest import mock

  from recoder_tpu_torch import optim
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MatrixFactorization, MultVAE

  out = {}
  for route in ('kernel', 'plain'):
    if family == 'mf':
      tr = Recoder(MatrixFactorization(32, 'tanh', 0.2, sparse=True),
                   optimizer_type='adam', loss='mse', device=cuda)
    else:
      tr = Recoder(MultVAE(32, 8, total_anneal_steps=4, sparse=True),
                   optimizer_type='adam', loss='logloss', device=cuda)
    patch = (mock.patch.object(optim, 'row_scatter_', rs.row_scatter_plain)
             if route == 'plain' else mock.MagicMock())
    before = rs.LAUNCHES['row_scatter']
    with patch:
      tr.train(_family_data(), batch_size=32, lr=1e-2, negative_sampling=True,
               shuffle='users', num_epochs=1)
    assert rs.LAUNCHES['row_scatter'] - before == (6 if route == 'kernel'
                                                   else 0)
    out[route] = (tr.last_epoch_losses,
                  {k: v.cpu() for k, v in tr.model.params().items()},
                  {p: (s['m'].cpu(), s['v'].cpu())
                   for p, s in tr.sparse_states.items()})
  (lk, pk, sk), (lp, pp, spl) = out['kernel'], out['plain']
  assert lk == lp and len(sk) == 2
  for name in pk:
    assert torch.equal(pk[name], pp[name]), name
  for p in sk:
    assert torch.equal(sk[p][0], spl[p][0]) and torch.equal(sk[p][1],
                                                            spl[p][1])
  if family == 'mf':  # the pad slots step the sentinel row: zero moments
    assert not sk['user_embedding'][0][90].any()


@pytest.mark.parametrize('family,dtype', [('mf', None), ('mf', 'bfloat16'),
                                          ('multvae', None),
                                          ('multvae', 'bfloat16')])
def test_family_captured_steps_are_bitwise_eager(cuda, family, dtype,
                                                 tmp_path):
  """3 epochs of 22 full-decode steps, 16 a graph against one eager step
  a dispatch: bitwise the same losses, parameters and moments. Mult-VAE
  trains with the full softmax and its KL weight changes inside the
  graphs (total_anneal_steps=40: beta grows over the first 8 steps), so
  the captured step reads the global step from the device; a resume from
  a checkpoint 10 steps into epoch 1 ends where the uninterrupted run
  does."""
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import MatrixFactorization, MultVAE

  def trainer():
    if family == 'mf':
      return Recoder(MatrixFactorization(32, 'tanh', 0.2,
                                         compute_dtype=dtype),
                     optimizer_type='adam', loss='mse',
                     loss_params={'confidence': 40}, device=cuda,
                     opt_state_dtype=dtype)
    return Recoder(MultVAE(32, 8, total_anneal_steps=40,
                           compute_dtype=dtype),
                   optimizer_type='adam', loss='logloss', device=cuda,
                   opt_state_dtype=dtype)

  data = _capture_data()

  def run(tr, spc, num_epochs=3, **kw):
    tr.train(data, batch_size=32, lr=1e-2, num_epochs=num_epochs,
             lr_milestones=[2], negative_sampling=family == 'mf',
             shuffle='blocks', full_decode=True, fused_steps_per_call=spc,
             **kw)
    return tr

  eager = run(trainer(), 1)
  captured = run(trainer(), 16)
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  _assert_bitwise_trainers(captured, eager)
  run(trainer(), 16, num_epochs=1, iters_per_epoch=10,
      model_checkpoint_prefix=str(tmp_path / 'c'))
  resumed = Recoder(MatrixFactorization(1) if family == 'mf' else MultVAE(),
                    optimizer_type='adam', device=cuda,
                    opt_state_dtype=dtype)
  resumed.init_from_model_file(str(tmp_path / 'c_epoch_1.model'))
  _assert_bitwise_trainers(run(resumed, 16), captured)


def test_ease_on_the_card_matches_cpu(cuda):
  """EASE on the card (the chunked bf16 Gram with float32 output,
  cuSOLVER's Cholesky): the Gram exactly scipy's, B within 1e-4 of max |B|
  of the CPU fit, the diagonal exactly zero, the same recommendations."""
  from recoder_tpu_torch.data import UsersInteractions
  from recoder_tpu_torch.models import EASE

  m = _family_data().interactions_matrix
  gpu = EASE(lam=5.0, device=cuda)
  g = gpu._device_gram(m.tocsr(), chunk_users=37)
  np.testing.assert_array_equal(g.cpu().numpy(),
                                np.asarray((m.T @ m).todense(), np.float32))
  gpu.fit(m)
  cpu = EASE(lam=5.0, device='cpu').fit(m)
  b, want = gpu.item_weights.cpu().numpy(), cpu.item_weights.numpy()
  np.testing.assert_array_equal(np.diag(b), 0.0)
  np.testing.assert_allclose(b, want, rtol=0, atol=1e-4 * np.abs(want).max())
  ui = UsersInteractions(np.arange(20), m[:20])
  for a, c in zip(gpu.recommend(ui, 10), cpu.recommend(ui, 10)):
    assert len(set(a.tolist()) ^ set(c.tolist())) <= 2


# -- large-catalog evaluation -------------------------------------------------

def _topk_rows(kind, shape=(8, 300_000), seed=0):
  rng = np.random.default_rng(seed)
  if kind == 'random':
    return rng.standard_normal(shape).astype(np.float32)
  x = (rng.integers(0, 4, shape) / 4.0).astype(np.float32)
  if kind == 'special':  # -inf ties, NaN, signed zeros
    x[0] = -np.inf
    x[0, rng.choice(shape[1], 3, replace=False)] = 1.0
    x[1, ::7] = np.nan
    x[2] = np.where(np.arange(shape[1]) % 2, 0.0, -0.0)
  return x


@pytest.mark.parametrize('kind', ['random', 'quantized', 'special'])
@pytest.mark.parametrize('k', [1, 100])
def test_top_k_on_the_card_equals_the_cpu(cuda, kind, k):
  """``ops/topk.top_k`` (lax.top_k's order) on a wide row: the card and
  the CPU give the same indices and bitwise the same values."""
  from recoder_tpu_torch.ops.topk import top_k
  x = torch.from_numpy(_topk_rows(kind))
  v, i = top_k(x.to(cuda), k)
  cv, ci = top_k(x, k)
  assert torch.equal(i.cpu(), ci)
  assert torch.equal(v.cpu().view(torch.int32), cv.view(torch.int32))


def _chunk_trainers(cuda, kind='ae', seed=3):
  """The same random model in a CPU and a card trainer (float32)."""
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
  m = _family_data().interactions_matrix
  out = []
  for device in ('cpu', cuda):
    model = (DynamicAutoencoder([16], 'tanh') if kind == 'ae'
             else MatrixFactorization(16, 'tanh'))
    tr = Recoder(model, num_items=m.shape[1], num_users=m.shape[0],
                 seed=seed, device=device)
    tr._init_model()
    with torch.no_grad():
      bias = tr.model.de_bias if kind == 'ae' else tr.model.bias
      bias.copy_(0.3 * torch.randn(bias.shape[0], generator=torch.Generator()
                                   .manual_seed(seed)).to(device))
    out.append(tr)
  return m, out


def _tie_tolerant(a, b, scores, rel=1e-5):
  tol = rel * np.abs(scores[np.isfinite(scores)]).max()
  for u, (x, y) in enumerate(zip(a, b)):
    for p, q in zip(x, y):
      assert p == q or abs(scores[u, p] - scores[u, q]) <= tol, (u, x, y)


@pytest.mark.parametrize('kind', ['ae', 'mf'])
def test_chunked_recommend_on_the_card_matches_cpu(cuda, kind):
  """Chunked recommend (192: the last chunk clamped) on the card against
  the CPU's and against the card's monolithic one: the same ids but for
  swaps of scores within 1e-5 of the largest; every id in the catalog,
  unseen."""
  from recoder_tpu_torch.data import UsersInteractions
  m, (cpu, gpu) = _chunk_trainers(cuda, kind)
  users = UsersInteractions(np.arange(40), m[:40])
  scores = cpu.predict(users)
  for tr in (cpu, gpu):
    tr.eval_item_chunk = 192
  got, want = gpu.recommend(users, 20), cpu.recommend(users, 20)
  _tie_tolerant(got, want, scores)
  gpu.eval_item_chunk = 0
  _tie_tolerant(got, gpu.recommend(users, 20), scores)
  for u, rec in enumerate(got):
    assert max(rec) < m.shape[1] and not set(rec) & set(m[u].indices)


def test_chunked_ties_on_the_card_take_the_lowest_ids(cuda):
  from recoder_tpu_torch.data import UsersInteractions
  m, (_, gpu) = _chunk_trainers(cuda)
  with torch.no_grad():
    gpu.model.de_embedding.zero_()
    gpu.model.de_bias.zero_()
  users = UsersInteractions(np.arange(5), m[:5])
  for chunk in (0, 64):
    gpu.eval_item_chunk = chunk
    for u, rec in enumerate(gpu.recommend(users, 12)):
      seen = set(m[u].indices)
      assert rec == [i for i in range(m.shape[1]) if i not in seen][:12]


def test_encode_coo_on_the_card_is_deterministic(cuda):
  """``encode_coo`` sums each row in CSR order (``row_sums``): two runs on
  the card are bitwise equal, and within 1e-5 of the CPU's."""
  m, (cpu, gpu) = _chunk_trainers(cuda)
  from recoder_tpu_torch.data import UsersInteractions
  users = UsersInteractions(np.arange(60), m[:60])
  out = []
  for tr in (gpu, gpu, cpu):
    rows, cols, vals, ids = tr._inference_coo(users)
    with torch.no_grad():
      out.append(tr.model.encode_coo(rows, cols, vals, 60).cpu())
  assert torch.equal(out[0], out[1])
  np.testing.assert_allclose(out[0].numpy(), out[2].numpy(), rtol=1e-5,
                             atol=1e-6)


def test_chunked_val_loss_on_the_card_matches_dense(cuda):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.data.loader import RecommendationDataLoader
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  m = _family_data().interactions_matrix
  for loss in ('mse', 'logistic', 'logloss'):
    tr = Recoder(DynamicAutoencoder([16], 'tanh'), optimizer_type='adam',
                 loss=loss, device=cuda)
    tr.train(RecommendationDataset(m), batch_size=32, negative_sampling=True)
    losses = []
    for chunk in (0, 100):
      # (a fresh loader each time: the same batches)
      tr.eval_item_chunk = chunk
      losses.append(tr._validate(RecommendationDataLoader(
          RecommendationDataset(m), batch_size=32)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_full_catalog_sparse_training_on_the_card_matches_cpu(cuda):
  """The full-catalog sparse step (negative sampling off) on the card:
  no row-scatter launch, and 4 steps' losses and tables against the
  CPU's (rtol 1e-4)."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  m = _family_data().interactions_matrix
  runs = []
  for device in ('cpu', cuda):
    tr = Recoder(DynamicAutoencoder([16], 'tanh', sparse=True),
                 optimizer_type='adam', loss='logloss', device=device)
    rs.LAUNCHES['row_scatter'] = 0
    tr.train(RecommendationDataset(m), batch_size=32, num_epochs=1,
             iters_per_epoch=4, negative_sampling=False)
    assert rs.LAUNCHES['row_scatter'] == 0
    runs.append(tr)
  np.testing.assert_allclose(runs[1].last_epoch_losses,
                             runs[0].last_epoch_losses, rtol=1e-4)
  for name, p in runs[0].model.params().items():
    np.testing.assert_allclose(runs[1].model.params()[name].detach().cpu()
                               .numpy(), p.detach().numpy(), rtol=1e-4,
                               atol=1e-5, err_msg=name)


def test_async_evaluator_on_the_card_gives_the_sync_results(cuda):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
  from recoder_tpu_torch.recommender import InferenceRecommender
  m, (_, gpu) = _chunk_trainers(cuda)
  val = _family_data(seed=5).interactions_matrix
  rec = InferenceRecommender(gpu, 10)

  class Sync:
    def recommend(self, users):
      return rec.recommend(users)
  metrics = [Recall(k=5), NDCG(k=10)]
  ds = RecommendationDataset(m, val)
  for chunk in (0, 96):
    gpu.eval_item_chunk = chunk
    got = RecommenderEvaluator(rec, metrics).evaluate(ds, batch_size=7)
    want = RecommenderEvaluator(Sync(), metrics).evaluate(ds, batch_size=7)
    assert got == want


# -- bf16 parameter storage ---------------------------------------------------

BF = torch.bfloat16


def _bf16_storage(problem, h_bf16=False):
  """The problem with bf16 rows and bias (and h, as MatrixFactorization's
  activated user rows are): bf16 parameter storage. Also the float32
  problem that holds the same values."""
  h, rows, bias, *rest = problem
  stored = [h.to(BF) if h_bf16 else h, rows.to(BF), bias.to(BF)] + rest
  same = [stored[0].float(), stored[1].float(), stored[2].float()] + rest
  return stored, same


def _grads(fn, problem, kind, confidence, compute_dtype):
  h, rows, bias, target, rm, cm = problem
  leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]
  loss = fn(*leaves, target, rm, cm, kind, confidence, compute_dtype)
  loss.backward()
  return loss, [x.grad for x in leaves]


@pytest.mark.parametrize('h_bf16', [False, True])
@pytest.mark.parametrize('kind,confidence', [('mse', 3.0), ('logistic', 0.0)])
@pytest.mark.parametrize('B,d,W,route', [
    (37, 24, 1000, 'mma'), (9, 7, 130, 'mma'), (500, 200, 18117, 'mma'),
    (37, 200, 1000, 'wgmma'), (500, 200, 20224, 'wgmma')])
def test_bf16_rows_kernels_are_bitwise_the_same_values_in_float32(
    cuda, B, d, W, route, kind, confidence, h_bf16):
  """bf16 tables read as stored: the loss, E0 and every gradient bit for
  bit those of float32 operands holding the same values (the kernels
  round those to the same bf16), each gradient in its input's dtype; the
  wgmma backward takes the table itself (no copy); against the plain
  composition at the bf16 tolerances. d = 7 takes the element-wise load
  of bf16 rows."""
  problem = _problem(B, d, W, cuda, seed=B + W)
  if route == 'wgmma':
    problem = _bf16_target(problem)
  stored, same = _bf16_storage(problem, h_bf16)
  assert fdl.bf16_route(stored[0], stored[1], stored[3]) == route
  counter = ('fused_decode_loss_fwd_bf16_wgmma' if route == 'wgmma'
             else 'fused_decode_loss_fwd_bf16')
  before = fdl.LAUNCHES[counter]
  loss, grads = _grads(fdl.fused_decode_loss, stored, kind, confidence, BF)
  ref_loss, ref = _grads(fdl.fused_decode_loss, same, kind, confidence, BF)
  assert fdl.LAUNCHES[counter] == before + 2
  assert torch.equal(loss, ref_loss)
  for g, r, x in zip(grads, ref, stored[:3]):
    assert g.dtype == x.dtype
    assert torch.equal(g.float(), r.to(x.dtype).float())
  plain_loss, plain = _grads(fdl.fused_decode_loss_plain, stored, kind,
                             confidence, BF)
  np.testing.assert_allclose(loss.item(), plain_loss.item(), rtol=1e-2)
  for g, r in zip(grads, plain):
    assert _rel_fro(g.float().cpu().numpy(), r.float().cpu().numpy()) <= 2e-2
  if route == 'wgmma':
    _, _, copies = fdl._kernel_forward(*stored, kind, confidence, BF, True)
    assert copies[1] is stored[1]


def test_float32_compute_over_bf16_rows(cuda):
  """bench.py's --dtype float32 over bf16 storage: the 3xTF32 kernels on
  a float32 copy of the rows; the loss and dh those of the float32 rows
  of the same values, drows and dbias rounded once from theirs."""
  stored, same = _bf16_storage(_problem(64, 40, 333, cuda, seed=3))
  before = fdl.LAUNCHES['fused_decode_loss_bwd']
  loss, grads = _grads(fdl.fused_decode_loss, stored, 'mse', 3.0, None)
  ref_loss, ref = _grads(fdl.fused_decode_loss, same, 'mse', 3.0, None)
  assert fdl.LAUNCHES['fused_decode_loss_bwd'] == before + 2
  assert torch.equal(loss, ref_loss)
  assert torch.equal(grads[0], ref[0])
  for g, r in zip(grads[1:], ref[1:]):
    assert g.dtype == BF and torch.equal(g, r.to(BF))


def _adam_set_dtypes(sizes, device, p_dtype, m_dtype, seed=0):
  params, grads, ms, vs = _adam_set(sizes, device, seed=seed)
  return ([p.to(p_dtype) for p in params], [g.to(p_dtype) for g in grads],
          [m.to(m_dtype) for m in ms], [v.to(m_dtype) for v in vs])


@pytest.mark.parametrize('p_dtype,m_dtype', [(BF, BF), (BF, torch.float32)])
@pytest.mark.parametrize('sizes', [(1,), (3, 5), (4097,),
                                   (4096, 200, 4_044_800, 20_224)])
def test_adam_kernel_over_bf16_params_matches_plain(cuda, sizes, p_dtype,
                                                    m_dtype):
  """Five steps of the bf16-parameter instantiations against the plain
  twin: m and v bitwise, the bf16 parameters within one bf16 ulp (the
  float32 update agrees within 2 float32 ulps; a value on a rounding
  boundary may round the other way), every dtype kept; one launch a
  step."""
  from recoder_tpu_torch.ops import adam
  kp, grads, km, kv = _adam_set_dtypes(sizes, cuda, p_dtype, m_dtype)
  params, ms, vs = ([x.clone() for x in xs] for xs in (kp, km, kv))
  wds = [2e-5 if i % 2 == 0 else 0.0 for i in range(len(sizes))]
  before = adam.LAUNCHES['adam_bf16']
  for step in range(1, 6):
    scalars = adam.step_scalars(1e-3, step, (0.9, 0.999), 1e-8)
    adam.adam_bf16_kernel(kp, grads, km, kv, wds, scalars)
    adam.adam_bf16_plain(params, grads, ms, vs, wds, scalars)
  torch.cuda.synchronize()
  assert adam.LAUNCHES['adam_bf16'] == before + 5
  for a, b in zip(km + kv, ms + vs):
    assert a.dtype == m_dtype and torch.equal(a, b)
  for a, b in zip(kp, params):
    ulp = torch.finfo(BF).eps * b.float().abs().clamp(min=1e-30)
    assert a.dtype == p_dtype
    assert float(((a.float() - b.float()).abs() / ulp).max()) <= 1


@pytest.mark.parametrize('d', [1, 3, 8, 200])
@pytest.mark.parametrize('dtypes', [(BF, torch.float32, torch.float32),
                                    (BF, BF, BF), (torch.float32, BF, BF)])
def test_row_scatter_mixed_element_sizes(cuda, dtypes, d):
  """One launch over tables of different element sizes (a bf16 table
  beside float32 moments, all bf16): bitwise index_copy_ each, the
  16-byte path per table where its rows are whole 16-byte units."""
  tables, ids, rows = _scatter_case(4099, d, 37, cuda, seed=d)
  tables = [t.to(dt) for t, dt in zip(tables, dtypes)]
  rows = [r.to(dt) for r, dt in zip(rows, dtypes)]
  out, launched = _scatter_both(tables, ids, rows)
  assert launched == 1
  assert [t.dtype for t in out] == list(dtypes)


def _bf16_params_trainer(device, state=None, sparse=False, noise=0.5,
                         family='ae'):
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
  model = (MatrixFactorization(16, 'tanh', dropout_prob=0.2, sparse=sparse,
                               params_dtype='bfloat16') if family == 'mf'
           else DynamicAutoencoder([32], 'tanh', noise_prob=noise,
                                   sparse=sparse, params_dtype='bfloat16'))
  return Recoder(model, optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=device,
                 opt_state_dtype=state)


@pytest.mark.parametrize('state', [None, 'bfloat16'])
def test_captured_bf16_params_are_bitwise_eager(cuda, state):
  """bf16 parameters, full decode, 3 epochs: 16 steps a graph against
  one eager step a dispatch, losses, parameters and moments bit for bit;
  the moments bf16 or float32 as asked."""
  data = _capture_data()
  runs = [_capture_train(_bf16_params_trainer(cuda, state), data, spc,
                         True, 'blocks') for spc in (1, 16)]
  eager, captured = runs
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  _assert_bitwise_trainers(captured, eager)
  for p in captured.model.parameters():
    assert p.dtype == BF
    assert captured.optimizer.state[p]['exp_avg'].dtype == (
        BF if state else torch.float32)


@pytest.mark.parametrize('family,sparse,full_decode', [
    ('ae', False, True), ('ae', False, False), ('ae', True, 'auto'),
    ('mf', False, True), ('mf', True, 'auto')])
def test_bf16_params_trainer_on_cuda_matches_cpu(cuda, family, sparse,
                                                 full_decode):
  """bf16 parameters (bf16 moments on the sparse tables), noise off, one
  eager epoch: the card's losses (the bf16-row kernels, the Adam kernel,
  the row scatter) follow the CPU's within rtol 1e-2, and every
  parameter stays bf16."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.ops import adam
  rng = np.random.default_rng(0)
  m = sp.csr_matrix((rng.random((90, 300)) < 0.05).astype(np.float32))
  losses = {}
  for device in ('cpu', cuda):
    tr = _bf16_params_trainer(device, 'bfloat16', sparse, noise=0.0,
                              family=family)
    counts = dict(adam.LAUNCHES, **rs.LAUNCHES)
    tr.train(RecommendationDataset(m), batch_size=16, lr=1e-3,
             weight_decay=2e-5, negative_sampling=True, shuffle='users',
             num_epochs=1, full_decode=full_decode, fused_steps_per_call=1)
    losses[str(device)] = tr.last_epoch_losses
    if device == cuda:
      assert adam.LAUNCHES['adam_bf16'] - counts['adam_bf16'] == 6
      assert rs.LAUNCHES['row_scatter'] - counts['row_scatter'] == (
          12 if sparse else 0)
    assert all(p.dtype == BF for p in tr.model.parameters())
  np.testing.assert_allclose(losses['cuda'], losses['cpu'], rtol=1e-2)


# -- captured 'blocks' union and sparse steps ---------------------------------

#: case -> (model, train arguments): 'blocks' steps on static-width batches
UNION_CAPTURE_CASES = {
    # (d = 200: the width the wgmma decode-loss pair is compiled for)
    'dense union, bf16': (dict(compute_dtype='bfloat16', hidden_layers=[200]),
                          dict(full_decode=False)),
    'sparse union': (dict(sparse=True), {}),
    'sparse union, megas and negatives': (
        dict(sparse=True), dict(num_sampling_users=64,
                                num_random_negatives=40)),
    'tied sparse, target matrix': (dict(sparse=True, is_constrained=True),
                                   dict(target=True)),
    'full-catalog sparse': (dict(sparse=True), dict(negative_sampling=False)),
    'triplet scatter': ({}, dict(full_decode=True, slab_cache=False,
                                 num_sampling_users=64,
                                 num_random_negatives=40)),
    'sparse MF': ('mf', {}),
}


def _union_capture_run(cuda, case, spc, num_epochs=3, resume_from=None,
                       cases=UNION_CAPTURE_CASES, data=None, **extra):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
  model_kw, kw = cases[case]
  kw = dict(kw)
  data = _capture_data() if data is None else data
  if kw.pop('target', False):
    rng = np.random.default_rng(5)
    data = RecommendationDataset(data.interactions_matrix, sp.csr_matrix(
        (rng.random((700, 600)) < 0.02).astype(np.float32)))
  if resume_from is not None:
    tr = resume_from
  elif model_kw == 'mf':
    tr = Recoder(MatrixFactorization(16, 'tanh', dropout_prob=0.2,
                                     sparse=True),
                 optimizer_type='adam', loss='mse', device=cuda)
  else:
    tr = Recoder(DynamicAutoencoder(**{'hidden_layers': [32],
                                       'activation_type': 'tanh',
                                       'noise_prob': 0.5, **model_kw}),
                 optimizer_type='adam', loss='mse',
                 loss_params={'confidence': 3}, device=cuda,
                 opt_state_dtype=model_kw.get('compute_dtype'))
  tr.train(data, **{**dict(batch_size=32, lr=1e-2, weight_decay=2e-5,
                           num_epochs=num_epochs, lr_milestones=[2],
                           negative_sampling=True, shuffle='blocks',
                           fused_steps_per_call=spc), **kw, **extra})
  return tr


def _assert_bitwise_sparse_states(a, b):
  assert a.sparse_states.keys() == b.sparse_states.keys()
  for path, st in a.sparse_states.items():
    for k, v in st.items():
      assert torch.equal(v, b.sparse_states[path][k]), (path, k)


@pytest.mark.parametrize('case', list(UNION_CAPTURE_CASES))
def test_captured_union_and_sparse_steps_are_bitwise_eager(cuda, case,
                                                           tmp_path):
  """'blocks' steps over the static-width batches, 3 epochs of 22 steps,
  noise 0.5 (dropout 0.2 for MF), an lr milestone: 16 steps a graph
  against one eager step a dispatch -- losses, parameters, dense moments,
  the sparse tables' moments and step counts bit for bit. Then a resume
  from a checkpoint 10 steps into epoch 1 ends bitwise where the
  uninterrupted run does."""
  eager = _union_capture_run(cuda, case, 1)
  captured = _union_capture_run(cuda, case, 16)
  assert eager.last_epoch_dispatch == 'eager'
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  assert captured.last_epoch_dispatches == 1 + 6  # a graph, 6 singles
  assert captured.captures == 2
  _assert_bitwise_trainers(captured, eager)
  _assert_bitwise_sparse_states(captured, eager)
  _union_capture_run(cuda, case, 16, num_epochs=1, iters_per_epoch=10,
                     model_checkpoint_prefix=str(tmp_path / 'c'))
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
  model = (MatrixFactorization(16, sparse=True)
           if UNION_CAPTURE_CASES[case][0] == 'mf'
           else DynamicAutoencoder(**{
               k: v for k, v in UNION_CAPTURE_CASES[case][0].items()
               if k == 'sparse'}))
  resumed = Recoder(model, optimizer_type='adam', device=cuda,
                    opt_state_dtype=captured.opt_state_dtype)
  resumed.init_from_model_file(str(tmp_path / 'c_epoch_1.model'))
  _union_capture_run(cuda, case, 16, resume_from=resumed)
  _assert_bitwise_trainers(resumed, captured)
  _assert_bitwise_sparse_states(resumed, captured)


def test_row_scatter_and_wgmma_run_inside_the_replays(cuda):
  """A profile of one captured epoch of sparse 'blocks' steps holds the
  row-scatter kernel twice a step, and of bf16 dense union steps the
  wgmma decode-loss pair once a step: the static widths are multiples of
  128, so no union step takes the mma.sync set."""
  from torch.profiler import ProfilerActivity, profile
  for case, want in (('sparse union', {'row_scatter_kernel': 2}),
                     ('dense union, bf16', {
                         'decode_loss_fwd_bf16_wgmma_kernel': 1,
                         'drows_dbias_bf16_wgmma_kernel': 1,
                         'decode_loss_fwd_bf16_kernel': 0})):
    tr = _union_capture_run(cuda, case, 16, num_epochs=1)
    for _ in range(3):  # (the profiler at times drops a device event)
      torch.cuda.synchronize()
      with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
          torch.cuda._sleep(20000)
        torch.cuda.synchronize()
        _union_capture_run(cuda, case, 16, num_epochs=2, resume_from=tr)
        torch.cuda.synchronize()
      assert tr.last_epoch_dispatches == 7
      got = {name: sum(ev.count for ev in prof.key_averages()
                       if name in ev.key) / 22 for name in want}
      if got == want:
        break
    assert got == want, (case, got)


# -- captured 'users' steps over the epoch tables ------------------------------

#: case -> (model, train arguments): 'users' steps inside the JAX gate
USERS_CAPTURE_CASES = {
    'dense union, bf16': (dict(compute_dtype='bfloat16', hidden_layers=[200]),
                          dict(full_decode=False)),
    'sparse union': (dict(sparse=True), {}),
    'triplet scatter': ({}, dict(full_decode=True, slab_cache=False,
                                 num_sampling_users=64)),
    'sparse MF': ('mf', {}),
}


@pytest.mark.parametrize('case', list(USERS_CAPTURE_CASES))
def test_captured_users_steps_are_bitwise_eager(cuda, case, tmp_path):
  """'users' steps over each epoch's tables, through the first epoch
  boundary where the tables' width signature changes (22 steps an
  epoch, noise 0.5, an lr milestone): 16 steps a graph against one eager
  step a dispatch -- losses, parameters, moments, the sparse tables'
  moments and step counts bit for bit; each signature captures its own
  graphs. Then a resume from a checkpoint 10 steps into epoch 1 ends
  bitwise where the uninterrupted run does."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.data.device_pipeline import DeviceDataSource
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder, MatrixFactorization
  model_kw, kw = USERS_CAPTURE_CASES[case]
  # (700 users x 600 items at 5%: the slice window's rung moves between
  # epochs)
  rng = np.random.default_rng(2)
  m = sp.csr_matrix((rng.random((700, 600)) < 0.05).astype(np.float32))
  fd = kw.get('full_decode') is True
  probe = DeviceDataSource(m, 32, kw.get('num_sampling_users', 32),
                           int(m.indices.max()) + 1, shuffle='users',
                           seed=42, device='cpu')
  sigs = [probe.epoch_state(e, fd)['signature'] for e in range(1, 9)]
  changes = [e for e in range(1, 8) if sigs[e - 1] != sigs[e]]
  assert changes, sigs
  epochs = changes[0] + 1
  run = dict(cases=USERS_CAPTURE_CASES, shuffle='users', num_epochs=epochs,
             data=RecommendationDataset(m))
  eager = _union_capture_run(cuda, case, 1, **run)
  captured = _union_capture_run(cuda, case, 16, **run)
  assert eager.last_epoch_dispatch == 'eager'
  assert captured.last_epoch_dispatch == 'captured, 16 steps a graph'
  # (a graph and 6 singles, or 3 warm-up steps, a graph and 3 singles)
  assert captured.last_epoch_dispatches == 7
  # (a graph of 16 and one of 1 a signature)
  assert captured.captures == 2 * len(set(sigs[:epochs]))
  assert captured.fused_data_source._epoch['sig'] == sigs[epochs - 1]
  _assert_bitwise_trainers(captured, eager)
  _assert_bitwise_sparse_states(captured, eager)
  _union_capture_run(cuda, case, 16, **dict(
      run, num_epochs=1, iters_per_epoch=10,
      model_checkpoint_prefix=str(tmp_path / 'c')))
  model = (MatrixFactorization(16, sparse=True) if model_kw == 'mf'
           else DynamicAutoencoder(sparse=model_kw.get('sparse', False)))
  resumed = Recoder(model, optimizer_type='adam', device=cuda,
                    opt_state_dtype=captured.opt_state_dtype)
  resumed.init_from_model_file(str(tmp_path / 'c_epoch_1.model'))
  _union_capture_run(cuda, case, 16, resume_from=resumed, **run)
  _assert_bitwise_trainers(resumed, captured)
  _assert_bitwise_sparse_states(resumed, captured)


def test_spans_of_a_captured_users_run(cuda):
  """Three captured 'users' epochs of sparse union steps: one
  ``recoder.capture`` a capture (the change in ``Recoder.captures``),
  one ``recoder.warm_up`` a new width signature (two captures each), one
  ``recoder.epoch_tables`` an epoch (each builds its tables), a
  ``recoder.replay`` a replayed graph and no ``recoder.eager``."""
  from recoder_tpu_torch import trace
  before = trace.totals()
  tr = _union_capture_run(cuda, 'sparse union', 16, num_epochs=3,
                          cases=USERS_CAPTURE_CASES, shuffle='users')
  got = {name: total[0] - before.get(name, (0,))[0]
         for name, total in trace.totals().items()}
  assert tr.last_epoch_dispatch == 'captured, 16 steps a graph'
  assert got['recoder.capture'] == tr.captures >= 2
  assert got['recoder.warm_up'] == tr.captures // 2
  assert got['recoder.epoch_tables'] == got['recoder.epoch_start'] == 3
  assert got['recoder.train'] == 1 and got['recoder.losses'] == 3
  assert got['recoder.replay'] >= tr.last_epoch_dispatches - 3
  assert got.get('recoder.eager', 0) == 0


def test_no_cyclic_collection_inside_a_capture(cuda, monkeypatch):
  """The cyclic GC is off while a graph records: collecting a dead cycle
  that holds CUDA graphs (a dropped trainer's) inside a capture destroys
  them there, which invalidates the capture (CUDA error 901)."""
  import gc
  from recoder_tpu_torch import model as model_lib
  dead = _union_capture_run(cuda, 'sparse union', 16, num_epochs=1,
                            cases=USERS_CAPTURE_CASES, shuffle='users')
  dead.cycle = dead  # (only the cyclic GC frees it)
  del dead
  seen = []
  step = model_lib.Recoder._device_step

  def recording(self, loop, path, reseed_step=None):
    if torch.cuda.is_current_stream_capturing():
      seen.append(gc.isenabled())
    return step(self, loop, path, reseed_step)

  monkeypatch.setattr(model_lib.Recoder, '_device_step', recording)
  tr = _union_capture_run(cuda, 'sparse union', 16, num_epochs=1,
                          cases=USERS_CAPTURE_CASES, shuffle='users')
  assert tr.captures == 2 and seen == [False] * 17
  assert gc.isenabled()
