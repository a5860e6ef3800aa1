"""Where a warm iALS sweep of the port spends its device time, by stage.

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_ials_breakdown.py

It builds the ML-20M-shaped CSR of ``bench.synthesize_ml20m`` and
``chip_smoke.IALS_FULL``'s configuration (d=128, alpha 10, lam 3e-3,
seed 0), fits two sweeps, then runs one more sweep (a user
and an item half-sweep) stage by stage, as ``IALS._solve_side`` runs it,
with CUDA events between the stages of every chunk:

  gram         F^T F of the opposite side, once a half-sweep
  gather       the [B, L, d] factor slab of each chunk
  corrections  the systems: weighted block products, their halving sum,
               the Gram and the ridge
  rhs          the confidence-weighted right-hand sides
  solve        spd_solve (the SPD-solve kernel)
  scatter      index_copy_ of the chunk's solutions

The events do not synchronize, so the host enqueues ahead and each
stage's time is the device's, gaps included. It also times the same
sweep through ``IALS._solve_side`` by the host clock, with a
synchronize at its end, and prints it beside the stages' sum.
The last line is a JSON object of the results.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the repository root, above)

STAGES = ('gram', 'gather', 'corrections', 'rhs', 'solve', 'scatter')


def half_sweep(model, factors, plan, events):
  """``IALS._solve_side`` with an event after every stage; appends
  (stage, start, end) to ``events``."""
  import torch

  from recoder_tpu_torch.models import ials
  from recoder_tpu_torch.ops.gather_matmul import full_float32
  from recoder_tpu_torch.ops.spd import spd_solve

  def mark():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e

  d = factors.shape[1]
  with full_float32():
    t = mark()
    factors_pad = torch.cat([factors, factors.new_zeros((1, d))])
    gram = ials._gram(factors)
    out = factors.new_zeros((plan['n_rows'] + 1, d))
    events.append(('gram', t, t := mark()))
    n = factors_pad.shape[0] - 1
    for c in plan['chunks']:
      cols, vals, reg = c['cols'], c['vals'], c['reg']
      B, L = cols.shape
      f = factors_pad.index_select(0, cols.reshape(-1)).view(B, L, d)
      valid = (cols < n).to(vals.dtype)
      events.append(('gather', t, t := mark()))
      w_a = model.alpha * vals
      a = ials._corrections(f, w_a)
      a += gram
      a.diagonal(dim1=1, dim2=2).add_(reg[:, None])
      events.append(('corrections', t, t := mark()))
      b = ials._halving_sum((w_a + valid)[..., None] * f)
      events.append(('rhs', t, t := mark()))
      x = spd_solve(a, b, base=32)
      events.append(('solve', t, t := mark()))
      out.index_copy_(0, c['rows'], x)
      events.append(('scatter', t, t := mark()))
  return out[:plan['n_rows']]


def main():
  import numpy as np
  import scipy.sparse as sp
  import torch

  import bench
  from recoder_tpu_torch.models import IALS
  from recoder_tpu_torch.ops import spd

  card = cs.phase_device()
  matrix = bench.synthesize_ml20m()
  model = IALS(device='cuda', **dict(cs.IALS_FULL, sweeps=2))
  model.fit(matrix)
  m = sp.csr_matrix(matrix, dtype=np.float32)
  user_plan = model._chunk_plan(m)
  item_plan = model._chunk_plan(m.T.tocsr())
  item_f = model.item_factors

  torch.cuda.synchronize()
  t0 = time.time()
  user_f = model._solve_side(None, item_f, plan=user_plan)
  model._solve_side(None, user_f, plan=item_plan)
  torch.cuda.synchronize()
  sweep_s = time.time() - t0

  events = []
  launches = spd.LAUNCHES['spd_solve']
  torch.cuda.synchronize()
  t0 = time.time()
  user_f = half_sweep(model, item_f, user_plan, events)
  half_sweep(model, user_f, item_plan, events)
  torch.cuda.synchronize()
  staged_s = time.time() - t0
  launches = spd.LAUNCHES['spd_solve'] - launches
  ms = {s: 0.0 for s in STAGES}
  for stage, start, end in events:
    ms[stage] += start.elapsed_time(end)
  total = sum(ms.values())
  cs.say(f'warm sweep: {sweep_s:.4f} s through IALS._solve_side (host '
         f'clock); staged {staged_s:.4f} s, device stages {total:.2f} ms '
         f'({launches} solves)')
  for s in STAGES:
    cs.say(f'  {s:12s} {ms[s]:9.2f} ms  {100 * ms[s] / total:5.1f}%')
  cs.say(card)
  cs.say(json.dumps({'card': card, 'sweep_s': sweep_s, 'staged_s': staged_s,
                     'stage_ms': ms, 'stages_ms': total,
                     'solve_launches': launches}))


if __name__ == '__main__':
  main()
