"""Readings from which a cell's correctness limits are set.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--seconds <s>] [--out <file>]

For each of ``--seeds``: the program's start and later block (the timed
path's own set-up, a window of ``--seconds``, then the later block, as a
run of ``perfbench/run.py`` drives them) against the float32 reference,
at the cell's sizes: the lower readings. For each of ``--control-seeds``
besides: the control -- the reference put in the program's place,
computed in the precision below the cell's
(:data:`perfbench.check.CONTROL`) -- and the fault of half the batch
left out (the mean over the rest), each from the same starts and against
the same float32 reference: the upper readings. A step that leaves the
state unchanged reads 1 on ``change`` and ``change_later`` by the
measure, with no run. One JSON line a reading, and a summary line: the
largest lower and the smallest upper reading of each number.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed, device, seconds, upper=False):
  """``{what: (numbers, detail)}`` for 'program', and with ``upper`` for
  'control' and 'half' too, each against the float32 reference on the
  matrix of ``seed``."""
  import torch

  from perfbench import check, harness
  device = torch.device(device)
  run, prog, start, _ = harness.set_up(cell, seed, device,
                                       time.perf_counter())
  harness.drive_window(run, prog, seconds)
  later = harness.later_block(run, prog)
  del prog
  harness.free(device)
  ref, ref_later = harness.follow(run, later)
  got = {'program': (start, later)}
  if upper:
    precision = cell['traffic']['model']['compute_dtype'] or 'float32'
    for what, kw in (('control', {'precision': check.CONTROL[precision]}),
                     ('half', {'fault': 'half'})):
      a, b = harness.follow(run, later, **kw)
      got[what] = (check.as_program(a), check.as_program(b))
  return {what: (check.readings(a, ref, b, ref_later),
                 {'start': check.by_leaf(a, ref),
                  'later': check.by_leaf(b, ref_later)})
          for what, (a, b) in got.items()}


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seeds', type=int, nargs='+', required=True)
  ap.add_argument('--control-seeds', type=int, nargs='*', default=[])
  ap.add_argument('--seconds', type=float, default=10.0)
  ap.add_argument('--out')
  args = ap.parse_args(argv)
  sys.path[0] = ROOT
  import torch

  from perfbench import harness
  if not torch.cuda.is_available():
    print('no CUDA device', file=sys.stderr)
    return 1
  cell = harness.load_cell(args.workload)
  lines, lower, upper = [], {}, {}
  seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
  for seed in seeds:
    out = readings(cell, seed, 'cuda', args.seconds,
                   upper=seed in args.control_seeds)
    for what, (got, detail) in out.items():
      line = {'workload': args.workload, 'seed': seed, 'what': what, **got,
              'detail': detail}
      print(json.dumps(line), flush=True)
      lines.append(line)
      for k, v in got.items():
        if what == 'program':
          lower[k] = max(lower.get(k, 0.0), v)
        else:
          upper.setdefault(what, {})[k] = min(
              upper.get(what, {}).get(k, v), v)
  summary = {'workload': args.workload, 'lower': lower, 'upper': upper,
             'device': torch.cuda.get_device_name(0)}
  print(json.dumps(summary), flush=True)
  if args.out:
    with open(args.out, 'a') as f:
      for line in lines + [summary]:
        f.write(json.dumps(line) + '\n')
  return 0


if __name__ == '__main__':
  sys.exit(main())
