"""The comparison that decides ``correct`` for a training cell.

Two stretches of the training are compared with the plain reference:

* the start: the first 20 steps from the init -- three eager warm-up
  steps, then a replay of the 16-step CUDA graph and one of the
  single-step graph, the graphs the window replays;
* a later block: the first 20 steps of an epoch after the
  window (on the 'users' union path, the first epoch whose static union
  width differs from the first epoch's, so that its graphs are another
  width signature's), from the program's own state there.

The numbers, each against its limit from the cell's file
(``perfbench/workloads/<cell>.json``):

* ``loss``: the largest relative gap of the start's step losses
  (``loss1``: the first step's, read for the record);
* ``grad``: the first step's gradient as the optimizer got it (Adam's
  first moment after one step over ``1 - beta1``), by the worst leaf:
  the gap between the program's norm and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``grad_diff``: the first step's gradient again, by the worst leaf's
  norm of the difference in the same measure. A gap of norms is of the
  second order in unbiased rounding, so neither gap tells the program's
  precision from the one below it (bf16 from fp8, float32 from TF32);
  the difference is of the first order and does;
* ``change``: each leaf's change over the start, by the worst leaf's gap
  of norms in the same measure, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (they move under
  Adam by round-off alone);
* ``loss_later``, ``change_later``: the same two of the later block.

A cell's file names the numbers it compares and their limits.
"""

import statistics

BETA1 = 0.9
#: the control of each compute precision: the reference computed in the
#: nearest precision below it
CONTROL = {'bfloat16': 'fp8', 'float32': 'tf32'}
#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of the change
QUIET_LEAF = 1e-3


def _norm(x):
  return float(x.double().norm())


def worst_leaf(program, reference, leaves=None):
  """The worst leaf's gap of norms (see the module docstring)."""
  names = sorted(reference if leaves is None else leaves)
  ref = {k: _norm(reference[k]) for k in names}
  floor = statistics.median(ref.values())
  return max(abs(_norm(program[k]) - ref[k]) / max(ref[k], floor, 1e-30)
             for k in names)


def worst_leaf_difference(program, reference):
  """The worst leaf's norm of the difference, in the same measure."""
  ref = {k: _norm(reference[k]) for k in reference}
  floor = statistics.median(ref.values())
  return max(_norm(program[k].double().cpu() - reference[k].double().cpu())
             / max(ref[k], floor, 1e-30) for k in sorted(reference))


def loss_gaps(program, reference):
  """Each step's relative loss gap (a step the program did not run reads
  infinite)."""
  gaps = [abs(p - r) / max(abs(r), 1e-30)
          for p, r in zip(program['losses'], reference['losses'])]
  return gaps + [float('inf')] * (len(reference['losses']) - len(gaps))


def moving(reference):
  """The leaves whose reference gradient is not nought to rounding."""
  norms = {k: _norm(v) for k, v in reference['grads'].items()}
  median = statistics.median(norms.values())
  return [k for k, v in norms.items() if v >= QUIET_LEAF * median]


def readings(program, reference, later=None, reference_later=None):
  """The numbers: ``program`` holds the start's ``losses``, ``m1`` (each
  leaf's first moment after step 1) and ``change``; ``later`` the later
  block's ``losses`` and ``change``; ``reference`` and
  ``reference_later`` the outputs of the reference module's
  ``Reference.run`` over the same steps."""
  grads = {k: v.float() / (1 - BETA1) for k, v in program['m1'].items()}
  losses = loss_gaps(program, reference)
  out = {'loss': max(losses), 'loss1': losses[0],
         'grad': worst_leaf(grads, reference['grads']),
         'grad_diff': worst_leaf_difference(grads, reference['grads']),
         'change': worst_leaf(program['change'], reference['change'],
                              moving(reference))}
  if later is not None:
    out['loss_later'] = max(loss_gaps(later, reference_later))
    out['change_later'] = worst_leaf(later['change'],
                                     reference_later['change'],
                                     moving(reference_later))
  return out


def by_leaf(program, reference):
  """Each step's loss gap and each leaf's gap of norms (gradient and
  change), for the record of how a limit was set."""
  out = {'loss_steps': loss_gaps(program, reference)}
  pairs = [('change', program['change'], reference['change'])]
  if 'm1' in program:
    pairs.append(('grad', {k: v.float() / (1 - BETA1)
                           for k, v in program['m1'].items()},
                  reference['grads']))
  for key, got, ref in pairs:
    out[key + '_leaves'] = {k: worst_leaf({k: got[k]}, {k: ref[k]})
                            for k in ref}
  return out


def as_program(reference):
  """A reference's output in the program's form, so that the control and
  the faults, put in the program's place, are read as the program is."""
  return {k: reference[k] for k in ('losses', 'm1', 'change')}


def decide(numbers, limits):
  """``(correct, {name: {'value', 'limit'}})``: every number finite and
  at or under its limit."""
  compared = {k: {'value': numbers[k], 'limit': limits[k]} for k in limits}
  ok = all(v['value'] == v['value'] and v['value'] <= v['limit']
           for v in compared.values())
  return ok, compared
