"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each of which raises on failure:

  1. device  -- requires CUDA; prints the card's name and power limit.
  2. build   -- compiles the port's CUDA kernels from this checkout.
  3. kernels -- the fused decode-loss kernel (forward and backward)
                against its plain PyTorch version on the card, for 'mse'
                (c=0, c=3) and 'logistic', at a ragged shape and at the
                training shape; median times of both.
  4. slice   -- the training path at the full width of the ML-20M-shaped
                configuration (bench.py's synthetic CSR, 116,677 users x
                20,108 items): DynamicAutoencoder[200], MSE confidence 3,
                Adam, batch 500, negative sampling, block shuffle, one
                epoch through the kernel; then recommend and a
                checkpoint round trip.
  5. paths   -- 20 training steps on the fixture through the kernel and
                through the plain decode + loss, from the same init,
                permutation and noise: the losses must agree.
  6. quality -- the tests/test_model.py protocol on the fixture
                (logloss, 30 epochs, float32) must reach the pinned
                Recall@20 / Recall@50 / NDCG@100, and a checkpoint
                reload must give the same metrics.
  7. spd kernel -- the batched SPD-solve kernel against the blocked
                recursion on the card at ragged shapes (B in {1, 37},
                d in {1, 7, 64, 128, 130, 200, 256}) and at the iALS
                shape (B = 16,384, d = 128, systems built as iALS builds
                them): max abs error and residual, bitwise independence
                of batch position; median times of the kernel, the
                blocked recursion and cholesky_ex + cholesky_solve.
  8. ials slice -- iALS at the full width of tools/bench_ials.py on the
                same ML-20M-shaped CSR (d=128, alpha 10, lam 3e-3, 8
                sweeps, seed 0): the objective falls, per-sweep and fit
                seconds, one kernel launch per chunk per half-sweep,
                fold-in of 500 training users is bitwise their stored
                factors, recommend(k=100) is valid, and a save -> load
                round trip gives identical recommendations.
  9. ials quality -- the tests/test_ials.py fixture protocol (d=4, alpha
                30, lam 0.01, 8 sweeps, seed 0) through the kernel must
                reach Recall@20 > 0.080 and NDCG@100 > 0.120, with
                identical metrics after a reload; the same fit through
                the blocked recursion on the card, for the distance
                between the two.

The last three lines of standard output are the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": ...}``.
Without CUDA, or without the rest of the repository, it exits non-zero
before printing any of them.
"""

import csv
import functools
import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(HERE, 'tests', 'data')

SOURCES = {
    'fused_decode_loss_fwd': 'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'fused_decode_loss_bwd': 'recoder_tpu_torch/kernels/fused_decode_loss.cu',
    'spd_solve': 'recoder_tpu_torch/kernels/spd_solve.cu',
}
REPLACES = {
    'fused_decode_loss_fwd': 'recoder_tpu/experiments/pallas_loss.py:145',
    'fused_decode_loss_bwd': 'recoder_tpu/experiments/pallas_loss.py:165',
    'spd_solve': 'recoder_tpu/ops/spd.py:235',
}
#: reference values pinned in tests/test_model.py (atol 0.01)
PINNED = {'Recall@20': 0.1417, 'Recall@50': 0.2393, 'NDCG@100': 0.1684}

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_ATOL_FRACTION = 1e-4  # of max |reference|
PATHS_RTOL = 1e-3
SPD_ATOL_FRACTION = 1e-4  # of max |x| of the blocked recursion
SPD_RESIDUAL = 1e-3       # max_i |A x - b| / |b| per system
#: tools/bench_ials.py's configuration (and fit's default chunk budget)
IALS_FULL = dict(embedding_size=128, alpha=10.0, lam=3e-3, sweeps=8,
                 seed=0)
#: the tests/test_ials.py fixture protocol and its floors
IALS_FIXTURE = dict(embedding_size=4, alpha=30.0, lam=0.01, sweeps=8,
                    seed=0)
IALS_FLOORS = {'Recall@20': 0.080, 'NDCG@100': 0.120}


def say(*args):
  print(*args, flush=True)


# -- phase 1 ---------------------------------------------------------------

def phase_device():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: CUDA is not available; this script '
                     'runs only on a GPU')
  torch.backends.cuda.matmul.allow_tf32 = False  # full float32 reference
  torch.backends.cudnn.allow_tf32 = False
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  say(f'device: {torch.cuda.get_device_name(0)} '
      f'(count {torch.cuda.device_count()}); torch {torch.__version__}, '
      f'CUDA {torch.version.cuda}; card: {card}')
  return card


# -- phase 2 ---------------------------------------------------------------

def phase_build():
  """Both sources at once, one nvcc each."""
  from concurrent.futures import ThreadPoolExecutor

  from recoder_tpu_torch.kernels import BUILD_LOGS
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  from recoder_tpu_torch.ops import spd
  t0 = time.time()
  with ThreadPoolExecutor(max_workers=2) as pool:
    for fut in [pool.submit(fdl._lib), pool.submit(spd._lib)]:
      fut.result()
  say(f'build: fused_decode_loss and spd_solve in {time.time() - t0:.1f} s')
  for name in ('fused_decode_loss', 'spd_solve'):
    for line in BUILD_LOGS.get(name, '').splitlines():
      if 'registers' in line or 'spill' in line or 'Compiling' in line:
        say('  ' + line.strip())


# -- phase 3 ---------------------------------------------------------------

def make_problem(B, d, W, device, seed=0):
  """Inputs at training-like magnitudes: tanh-range activations, small
  table entries, sparse binary targets, masks that hold zeros."""
  import torch
  gen = torch.Generator().manual_seed(seed)
  h = torch.tanh(torch.randn(B, d, generator=gen))
  rows = 0.1 * torch.randn(W, d, generator=gen)
  bias = 0.1 * torch.randn(W, generator=gen)
  target = (torch.rand(B, W, generator=gen) < 0.02).float()
  row_mask = (torch.arange(B) < B - max(1, B // 10)).float()
  col_mask = (torch.rand(W, generator=gen) < 0.8).float()
  return [x.to(device) for x in (h, rows, bias, target, row_mask, col_mask)]


def _close(got, ref, rtol, atol):
  err = (got - ref).abs()
  return bool((err <= atol + rtol * ref.abs()).all()), float(err.max())


def compare_kernel(B, d, W, kind, confidence, device):
  """Kernel loss and gradients against autograd through the plain
  version; returns the largest abs errors (loss, grads)."""
  import torch
  from recoder_tpu_torch.ops.fused_decode_loss import (
      fused_decode_loss, fused_decode_loss_plain)
  h, rows, bias, target, rm, cm = make_problem(B, d, W, device)
  results = {}
  for name, fn in (('kernel', fused_decode_loss),
                   ('plain', fused_decode_loss_plain)):
    hh, rr, bb = (x.clone().requires_grad_(True) for x in (h, rows, bias))
    loss = fn(hh, rr, bb, target, rm, cm, kind, confidence)
    loss.backward()
    results[name] = (loss.detach(), hh.grad, rr.grad, bb.grad)
  (lk, *gk), (lp, *gp) = results['kernel'], results['plain']
  ok, loss_err = _close(lk, lp, LOSS_RTOL, 0.0)
  if not ok:
    raise AssertionError(f'{kind} c={confidence} [{B},{d},{W}]: loss '
                         f'{float(lk)} vs plain {float(lp)}')
  grad_err = 0.0
  for gname, a, b in zip(('dh', 'drows', 'dbias'), gk, gp):
    atol = GRAD_ATOL_FRACTION * float(b.abs().max())
    ok, err = _close(a, b, GRAD_RTOL, atol)
    grad_err = max(grad_err, err)
    if not ok:
      raise AssertionError(f'{kind} c={confidence} [{B},{d},{W}]: {gname} '
                           f'max abs err {err} (atol {atol})')
  say(f'  {kind:8s} c={confidence:<3} [{B}, {d}, {W}]: loss {float(lk):.6g} '
      f'(plain {float(lp):.6g}), max abs err loss {loss_err:.3g} '
      f'grads {grad_err:.3g}')
  return loss_err, grad_err


def median_ms(fn, reps=30, warmup=3):
  import torch
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def time_kernel(B, d, W, kind, confidence, device):
  """Median ms of forward, backward and forward+backward, kernel and
  plain, at one shape."""
  import torch
  from recoder_tpu_torch.ops import fused_decode_loss as fdl
  h, rows, bias, target, rm, cm = make_problem(B, d, W, device)
  g = torch.ones((), device=device)
  args = (target, rm, cm, kind, confidence)
  leaves = [x.clone().requires_grad_(True) for x in (h, rows, bias)]

  def fwd(fn):
    def run():
      with torch.no_grad():
        fn(h, rows, bias, *args)
    return run

  def fwd_bwd(fn):
    def run():
      for x in leaves:
        x.grad = None
      fn(*leaves, *args).backward()
    return run

  out = {}
  for name, f_fwd, f_bwd, f_all in (
      ('kernel', fwd(fdl.fused_decode_loss),
       lambda: fdl._kernel_backward(g, h, rows, bias, *args),
       fwd_bwd(fdl.fused_decode_loss)),
      ('plain', fwd(fdl.fused_decode_loss_plain),
       lambda: fdl._plain_backward(g, h, rows, bias, *args),
       fwd_bwd(fdl.fused_decode_loss_plain))):
    out[name] = {'fwd': median_ms(f_fwd), 'bwd': median_ms(f_bwd),
                 'fwd_bwd': median_ms(f_all)}
  return out


def phase_kernels(device='cuda', ragged=(37, 24, 1000),
                  full=(500, 200, 20224)):
  cases = [('mse', 0.0), ('mse', 3.0), ('logistic', 0.0)]
  errs = {}
  for shape in (ragged, full):
    for kind, c in cases:
      errs[(shape, kind, c)] = compare_kernel(*shape, kind, c, device)
  times = time_kernel(*full, 'mse', 3.0, device)
  for name in ('kernel', 'plain'):
    t = times[name]
    say(f'  time {name:6s} mse c=3 {list(full)}: fwd {t["fwd"]:.4f} ms, '
        f'bwd {t["bwd"]:.4f} ms, fwd+bwd {t["fwd_bwd"]:.4f} ms (median)')
  main_err = errs[(full, 'mse', 3.0)]
  return times, main_err


# -- data ------------------------------------------------------------------

def load_fixture():
  """The fixture's train and validation matrices, mapped as
  tests/test_model.py maps them (read without pandas)."""
  from recoder_tpu_torch.utils import dataframe_to_csr_matrix

  def read(name):
    with gzip.open(os.path.join(DATA_DIR, name), 'rt') as f:
      reader = csv.reader(f)
      header = next(reader)
      cols = np.array(list(reader), dtype=np.int64).T
    return dict(zip(header, cols))

  train, val = read('train.csv.gz'), read('val.csv.gz')
  keep = np.isin(val['sid'], np.unique(train['sid']))
  val = {k: v[keep] for k, v in val.items()}
  train_m, item_map, user_map = dataframe_to_csr_matrix(
      train, 'uid', 'sid', 'watched')
  val_m, _, _ = dataframe_to_csr_matrix(
      val, 'uid', 'sid', 'watched', item_id_map=item_map,
      user_id_map=user_map)
  return train_m, val_m


# -- phase 4 ---------------------------------------------------------------

def phase_slice(matrix, device='cuda', epochs_timed=2):
  """One full epoch of the main path; returns launch counts and rates."""
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops import fused_decode_loss as fdl

  dataset = RecommendationDataset(matrix)
  common = dict(batch_size=500, lr=1e-3, weight_decay=2e-5,
                negative_sampling=True, shuffle='blocks')

  def new_trainer():
    return Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5),
                   optimizer_type='adam', loss='mse',
                   loss_params={'confidence': 3}, device=device)

  trainer = new_trainer()
  for k in fdl.LAUNCHES:
    fdl.LAUNCHES[k] = 0
  t0 = time.time()
  trainer.train(dataset, num_epochs=1, **common)
  if device != 'cpu':
    torch.cuda.synchronize()
  first_call_s = time.time() - t0
  launches = dict(fdl.LAUNCHES)

  losses = np.asarray(trainer.last_epoch_losses)
  steps = len(losses)
  if steps != -(-matrix.shape[0] // 500):
    raise AssertionError(f'epoch ran {steps} steps')
  if not np.all(np.isfinite(losses)):
    raise AssertionError('non-finite training loss')
  head, tail = losses[:10].mean(), losses[-10:].mean()
  if not tail < head:
    raise AssertionError(f'loss did not fall: first 10 steps {head}, '
                         f'last 10 {tail}')
  epoch_rate = steps / trainer.last_epoch_seconds
  say(f'  epoch 1: {steps} steps in {trainer.last_epoch_seconds:.3f} s = '
      f'{epoch_rate:.2f} user-batches/s (first call {first_call_s:.1f} s '
      f'with the slab build); loss first 10 steps {head:.4f}, last 10 '
      f'{tail:.4f}')

  # steady state: train() resumes at current_epoch inclusive, so this
  # call runs epochs 1..epochs_timed again
  rates = []
  for epoch in range(2, epochs_timed + 2):
    trainer.train(dataset, num_epochs=epoch, **common)
    rates.append(len(trainer.last_epoch_losses)
                 / trainer.last_epoch_seconds)
  say(f'  steady epochs: {", ".join(f"{r:.2f}" for r in rates)} '
      f'user-batches/s')

  users, _ = dataset[np.arange(500)]
  recs = np.asarray(trainer.recommend(users, 100))
  seen = users.interactions_matrix
  if recs.shape != (500, 100):
    raise AssertionError(f'recommend shape {recs.shape}')
  if recs.min() < 0 or recs.max() >= matrix.shape[1]:
    raise AssertionError('recommended ids outside the catalog')
  for i in range(500):
    row_seen = seen.indices[seen.indptr[i]:seen.indptr[i + 1]]
    if np.isin(recs[i], row_seen).any() or len(set(recs[i])) != 100:
      raise AssertionError(f'user {i}: seen or repeated recommendations')
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'slice'))
    restored = Recoder(DynamicAutoencoder(), device=device)
    restored.init_from_model_file(path)
    recs2 = np.asarray(restored.recommend(users, 100))
  if not np.array_equal(recs, recs2):
    raise AssertionError('recommendations changed across the checkpoint')
  say('  recommend k=100 for 500 users: in range, unseen, identical after '
      'save_state -> init_from_model_file')
  return launches, epoch_rate, rates


# -- phase 5 ---------------------------------------------------------------

def phase_paths(train_m, device='cuda', steps=20):
  """'mse' trains through the fused kernel; an ``MSELoss`` instance
  (the same loss) through the decode matmul and ops/losses.py."""
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder
  from recoder_tpu_torch.ops.losses import MSELoss

  dataset = RecommendationDataset(train_m)
  trajectories = {}
  for fused in (True, False):
    loss = 'mse' if fused else MSELoss(confidence=3, reduction='sum')
    trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5),
                      optimizer_type='adam', loss=loss,
                      loss_params={'confidence': 3} if fused else None,
                      device=device)
    trainer.train(dataset, batch_size=500, lr=1e-3, weight_decay=2e-5,
                  negative_sampling=True, shuffle='blocks', num_epochs=1,
                  iters_per_epoch=steps)
    trajectories[fused] = np.asarray(trainer.last_epoch_losses)
  k, p = trajectories[True], trajectories[False]
  if len(k) != steps or len(p) != steps:
    raise AssertionError(f'ran {len(k)} and {len(p)} steps, not {steps}')
  rel = np.abs(k - p) / np.abs(p)
  if not np.all(rel <= PATHS_RTOL):
    raise AssertionError(f'kernel and plain trajectories differ: max rel '
                         f'{rel.max()} (kernel {k}, plain {p})')
  say(f'  {steps} steps, kernel vs plain loss: max rel diff {rel.max():.3g}'
      f' (first {k[0]:.5f} / {p[0]:.5f}, last {k[-1]:.5f} / {p[-1]:.5f})')
  return float(rel.max())


# -- phase 6 ---------------------------------------------------------------

def phase_quality(train_m, val_m, device='cuda', epochs=30, atol=0.01):
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall
  from recoder_tpu_torch.model import Recoder
  from recoder_tpu_torch.models import DynamicAutoencoder

  train_ds = RecommendationDataset(train_m)
  val_ds = RecommendationDataset(val_m, train_m)
  trainer = Recoder(DynamicAutoencoder([200], 'tanh', noise_prob=0.5),
                    optimizer_type='adam', loss='logloss', device=device)
  t0 = time.time()
  trainer.train(train_ds, batch_size=500, lr=1e-3, weight_decay=2e-5,
                num_epochs=epochs, negative_sampling=True)
  train_s = time.time() - t0
  metrics = [Recall(k=20), Recall(k=50), NDCG(k=100)]
  results = trainer._evaluate(val_ds, 100, metrics, batch_size=500)
  means = {str(m): float(np.mean(v)) for m, v in results.items()}
  say(f'  {epochs} epochs in {train_s:.1f} s; '
      + ', '.join(f'{k} {v:.4f} (pinned {PINNED[k]})'
                  for k, v in means.items()))
  misses = {k: v for k, v in means.items() if abs(v - PINNED[k]) > atol}
  with tempfile.TemporaryDirectory() as tmp:
    path = trainer.save_state(os.path.join(tmp, 'quality'))
    restored = Recoder(DynamicAutoencoder(), device=device)
    restored.init_from_model_file(path)
    results2 = restored._evaluate(val_ds, 100, metrics, batch_size=500)
  means2 = {str(m): float(np.mean(v)) for m, v in results2.items()}
  if means2 != means:
    raise AssertionError(f'metrics changed across the checkpoint: {means} '
                         f'vs {means2}')
  if misses:
    raise AssertionError(f'quality outside atol {atol} of the pinned '
                         f'values: {misses}')
  say('  checkpoint reload: identical metrics')
  return means


# -- phase 7 ---------------------------------------------------------------

def ials_systems(B, d, device, seed=0, n_items=20108, L=64, alpha=10.0,
                 lam=3e-3):
  """SPD systems as an iALS user half-sweep builds them: the Gram of
  item factors at the init scale, plus confidence-weighted corrections
  from L observed items, plus the frequency-scaled ridge."""
  import torch
  gen = torch.Generator(device=device).manual_seed(seed)
  items = torch.randn(n_items, d, device=device, generator=gen) / d ** 0.5
  cols = torch.randint(0, n_items, (B, L), device=device, generator=gen)
  counts = torch.randint(1, L + 1, (B,), device=device, generator=gen)
  valid = (torch.arange(L, device=device) < counts[:, None]).float()
  f = items[cols] * valid[..., None]
  w = alpha * valid
  a = items.t() @ items + torch.einsum('bl,bld,ble->bde', w, f, f)
  a = a + (lam * (counts + 1.0))[:, None, None] * torch.eye(d, device=device)
  b = torch.einsum('bl,bld->bd', w + valid, f)
  return a.contiguous(), b.contiguous()


def check_spd(a, b, what):
  """Kernel against the blocked recursion (base 32, as iALS calls it);
  returns the max abs error."""
  import torch
  from recoder_tpu_torch.ops import spd
  x = spd.spd_solve_kernel(a, b)
  ref = spd.spd_solve_blocked(a, b, 32)
  torch.cuda.synchronize()
  err = float((x - ref).abs().max())
  scale = float(ref.abs().max())
  res = (torch.linalg.vector_norm(torch.einsum('bij,bj->bi', a, x) - b, dim=1)
         / torch.linalg.vector_norm(b, dim=1))
  rel = float(res.max())
  if not (torch.isfinite(x).all() and err <= SPD_ATOL_FRACTION * scale
          and rel <= SPD_RESIDUAL):
    raise AssertionError(f'spd_solve {what}: max abs err {err} (max |x| '
                         f'{scale}), relative residual {rel}')
  return err, scale, rel


def phase_spd(device='cuda', full=(16384, 128)):
  import torch
  from recoder_tpu_torch.ops import spd
  worst = 0.0
  for B in (1, 37):
    for d in (1, 7, 64, 128, 130, 200, 256):
      rng = np.random.default_rng(d)
      f = rng.standard_normal((B, d + 8, d)).astype(np.float32) / np.sqrt(d)
      a = np.einsum('blk,blm->bkm', f, f) + 0.05 * np.eye(d)
      b = rng.standard_normal((B, d)).astype(np.float32)
      err, scale, _ = check_spd(
          torch.from_numpy(a.astype(np.float32)).to(device),
          torch.from_numpy(b).to(device), f'[{B}, {d}]')
      worst = max(worst, err / scale)
  say(f'  ragged B in (1, 37) x d in (1, 7, 64, 128, 130, 200, 256): '
      f'worst max abs err {worst:.3g} of max |x|')

  B, d = full
  a, b = ials_systems(B, d, device)
  err, scale, rel = check_spd(a, b, f'iALS shape [{B}, {d}]')
  say(f'  iALS shape [{B}, {d}]: max abs err {err:.3g} (max |x| '
      f'{scale:.3g}), worst relative residual {rel:.3g}')
  # bitwise: a system's x alone, in another batch position, run to run
  x = spd.spd_solve_kernel(a, b)
  idx = torch.tensor([5, 0, B - 1, 777], device=device)
  again = spd.spd_solve_kernel(a, b)
  sub = spd.spd_solve_kernel(a[idx].contiguous(), b[idx].contiguous())
  one = spd.spd_solve_kernel(a[777:778].contiguous(),
                             b[777:778].contiguous())
  if not (torch.equal(x, again) and torch.equal(sub, x[idx])
          and torch.equal(one[0], x[777])):
    raise AssertionError('spd_solve kernel is not bitwise independent of '
                         'batch position')
  say('  bitwise equal run to run, alone and at other batch positions')

  def cusolver():
    l, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b[..., None], l)

  times = {'kernel': median_ms(lambda: spd.spd_solve_kernel(a, b), reps=10),
           'blocked': median_ms(lambda: spd.spd_solve_blocked(a, b, 32),
                                reps=10),
           'cholesky_ex+cholesky_solve': median_ms(cusolver, reps=10)}
  say('  time at the iALS shape (median of 10): '
      + ', '.join(f'{k} {v:.4f} ms' for k, v in times.items()))
  return err, times


# -- phase 8 ---------------------------------------------------------------

def ials_chunks(model, matrix):
  """Chunks per user and per item half-sweep of ``model``'s plans."""
  nnz_u = np.diff(matrix.indptr).astype(np.int64)
  nnz_i = np.bincount(matrix.indices, minlength=matrix.shape[1])
  return tuple(sum(1 for _ in model._chunk_layout(n.astype(np.int64)))
               for n in (nnz_u, nnz_i))


def check_recommendations(recs, seen, k, n_items):
  if any(len(r) != k for r in recs):
    raise AssertionError('recommend returned fewer than k items')
  for i, r in enumerate(recs):
    row_seen = seen.indices[seen.indptr[i]:seen.indptr[i + 1]]
    if (r.min() < 0 or r.max() >= n_items or np.isin(r, row_seen).any()
        or len(set(r.tolist())) != k):
      raise AssertionError(f'user {i}: out of range, seen or repeated '
                           f'recommendations')


def phase_ials_slice(matrix, device='cuda'):
  import torch
  from recoder_tpu_torch.data import UsersInteractions
  from recoder_tpu_torch.models import IALS
  from recoder_tpu_torch.ops import spd

  model = IALS(device=device, **IALS_FULL)
  sweeps = IALS_FULL['sweeps']
  n_user_chunks, n_item_chunks = ials_chunks(model, matrix)
  objectives, sweep_s, objective_s = {}, [], [0.0]
  clock = [0.0]

  def tick(sweep):
    torch.cuda.synchronize()
    sweep_s.append(time.time() - clock[0])
    if sweep in (0, sweeps - 1):
      t0 = time.time()
      objectives[sweep] = model.objective(matrix)
      objective_s[0] += time.time() - t0
    clock[0] = time.time()

  spd.LAUNCHES['spd_solve'] = 0
  t0 = clock[0] = time.time()
  model.fit(matrix, callback=tick)
  torch.cuda.synchronize()
  fit_s = time.time() - t0 - objective_s[0]
  launches = spd.LAUNCHES['spd_solve']
  expected = sweeps * (n_user_chunks + n_item_chunks) + n_user_chunks
  say(f'  fit: {fit_s:.3f} s without the host objective (plan build and '
      f'final user half-sweep included); sweeps '
      + ', '.join(f'{t:.3f}' for t in sweep_s) + ' s')
  say(f'  objective after sweep 1: {objectives[0]:.6g}, after sweep '
      f'{sweeps}: {objectives[sweeps - 1]:.6g} (host, {objective_s[0]:.1f} s)')
  if not objectives[sweeps - 1] < objectives[0]:
    raise AssertionError(f'objective did not fall: {objectives}')
  say(f'  spd_solve launches: {launches} ({n_user_chunks} user and '
      f'{n_item_chunks} item chunks per half-sweep)')
  if launches != expected:
    raise AssertionError(f'{launches} kernel launches, expected one per '
                         f'chunk per half-sweep: {expected}')
  for name in ('user_factors', 'item_factors'):
    if not torch.isfinite(getattr(model, name)).all():
      raise AssertionError(f'non-finite {name}')

  users = np.linspace(0, matrix.shape[0] - 1, 500).astype(np.int64)
  ui = UsersInteractions(users, matrix[users])
  t0 = time.time()
  x = model.fold_in(ui)
  torch.cuda.synchronize()
  fold_s = time.time() - t0
  if not torch.equal(x, model.user_factors[torch.from_numpy(users).to(
      device)]):
    raise AssertionError('fold-in of training users is not bitwise their '
                         'stored factors')
  t0 = time.time()
  recs = model.recommend(ui, 100)
  rec_s = time.time() - t0
  check_recommendations(recs, ui.interactions_matrix, 100, matrix.shape[1])
  with tempfile.TemporaryDirectory() as tmp:
    path = model.save(os.path.join(tmp, 'ials.model'))
    restored = IALS(device=device).load(path)
  recs2 = restored.recommend(ui, 100)
  if not all(np.array_equal(p, q) for p, q in zip(recs, recs2)):
    raise AssertionError('recommendations changed across the checkpoint')
  say(f'  fold-in of 500 training users: bitwise their stored factors '
      f'({fold_s:.3f} s); recommend k=100: in range, unseen, no repeats '
      f'({rec_s:.3f} s), identical after save -> load')
  return launches, fit_s, sweep_s


# -- phase 9 ---------------------------------------------------------------

def phase_ials_quality(train_m, val_m, device='cuda'):
  import torch
  from recoder_tpu_torch.data import RecommendationDataset
  from recoder_tpu_torch.metrics import NDCG, Recall, RecommenderEvaluator
  from recoder_tpu_torch.models import IALS
  from recoder_tpu_torch.models import ials as ials_lib
  from recoder_tpu_torch.ops import spd
  from recoder_tpu_torch.recommender import InferenceRecommender

  val_ds = RecommendationDataset(val_m, train_m)
  metrics = [Recall(k=20), NDCG(k=100)]

  def evaluate(model):
    ev = RecommenderEvaluator(InferenceRecommender(model, 100), metrics)
    res = ev.evaluate(val_ds, batch_size=500)
    return {str(m): float(np.mean(v)) for m, v in res.items()}

  before = spd.LAUNCHES['spd_solve']
  t0 = time.time()
  model = IALS(device=device, **IALS_FIXTURE).fit(train_m)
  torch.cuda.synchronize()
  fit_s = time.time() - t0
  if spd.LAUNCHES['spd_solve'] == before:
    raise AssertionError('the fixture fit did not launch the kernel')
  means = evaluate(model)
  say(f'  kernel: fit {fit_s:.2f} s; ' + ', '.join(
      f'{k} {v:.4f} (floor {IALS_FLOORS[k]})' for k, v in means.items()))
  with tempfile.TemporaryDirectory() as tmp:
    path = model.save(os.path.join(tmp, 'ials.model'))
    means2 = evaluate(IALS(device=device).load(path))
  if means2 != means:
    raise AssertionError(f'metrics changed across the checkpoint: {means} '
                         f'vs {means2}')
  short = {k: v for k, v in means.items() if not v > IALS_FLOORS[k]}
  if short:
    raise AssertionError(f'iALS fixture quality below the floors: {short}')
  say('  checkpoint reload: identical metrics')

  blocked = functools.partial(ials_lib.spd_solve, impl='blocked')
  with mock.patch.object(ials_lib, 'spd_solve', blocked):
    launches = spd.LAUNCHES['spd_solve']
    plain = IALS(device=device, **IALS_FIXTURE).fit(train_m)
    plain_means = evaluate(plain)
    if spd.LAUNCHES['spd_solve'] != launches:
      raise AssertionError('the plain-route fit launched the kernel')
  diff = {name: float((getattr(model, name) - getattr(plain, name))
                      .abs().max() / getattr(plain, name).abs().max())
          for name in ('user_factors', 'item_factors')}
  say(f'  blocked recursion on the card: ' + ', '.join(
      f'{k} {v:.4f}' for k, v in plain_means.items())
      + '; kernel vs plain factors, max abs diff / max |plain|: '
      + ', '.join(f'{k} {v:.3g}' for k, v in diff.items()))
  return means


# -- main ------------------------------------------------------------------

def run(name, fn, *args, **kwargs):
  say(f'== phase {name}')
  t0 = time.time()
  out = fn(*args, **kwargs)
  say(f'== phase {name}: ok ({time.time() - t0:.1f} s)')
  return out


def main():
  import torch
  card = run('1 device', phase_device)
  sys.path.insert(0, HERE)
  import bench  # numpy/scipy only: the ML-20M-shaped synthetic CSR

  run('2 build', phase_build)
  times, (loss_err, grad_err) = run('3 kernels', phase_kernels)
  t0 = time.time()
  matrix = bench.synthesize_ml20m()
  say(f'ML-20M-shaped CSR {matrix.shape}, nnz {matrix.nnz:,} '
      f'({time.time() - t0:.1f} s)')
  launches, epoch_rate, steady = run('4 slice', phase_slice, matrix)
  say(f'  kernel launches in the epoch: {launches}')
  if any(v < 1 for v in launches.values()):
    raise AssertionError(f'the main path did not launch every kernel: '
                         f'{launches}')
  train_m, val_m = load_fixture()
  run('5 paths', phase_paths, train_m)
  run('6 quality', phase_quality, train_m, val_m)
  spd_err, spd_times = run('7 spd kernel', phase_spd)
  launches['spd_solve'], ials_fit_s, ials_sweeps = run(
      '8 ials slice', phase_ials_slice, matrix)
  del matrix
  run('9 ials quality', phase_ials_quality, train_m, val_m)

  measured = {
      'fused_decode_loss_fwd': (loss_err, times['kernel']['fwd'],
                                times['plain']['fwd']),
      'fused_decode_loss_bwd': (grad_err, times['kernel']['bwd'],
                                times['plain']['bwd']),
      'spd_solve': (spd_err, spd_times['kernel'], spd_times['blocked']),
  }
  kernels = [{'name': name, 'route': 'cuda', 'source': SOURCES[name],
              'replaces': REPLACES[name], 'launches': launches[name],
              'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}
             for name, (err, ms, plain_ms) in measured.items()]
  say(f'slice: {epoch_rate:.2f} user-batches/s first epoch, steady '
      f'{max(steady):.2f}; fused fwd+bwd {times["kernel"]["fwd_bwd"]:.4f} '
      f'ms vs plain {times["plain"]["fwd_bwd"]:.4f} ms; iALS fit '
      f'{ials_fit_s:.3f} s, median sweep '
      f'{statistics.median(ials_sweeps):.3f} s; card {card}')
  say(json.dumps({'kernels': kernels}))
  say(card)
  say(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
  main()
