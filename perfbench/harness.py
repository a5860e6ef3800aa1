"""One run of one training cell: set-up, the timed window, a profiled
slice, the per-layer readers and the correctness check.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
the harness reads ``configs/<config>.json`` (the model's class in
``recoder_tpu_torch.models`` and its arguments, the trainer, the data's
shape, and the name of the model's module under ``reference/``),
``traffic/<traffic>.json`` (the ``train`` arguments and the model's path
and precision) and ``workloads/<cell>.json`` (the correctness limits),
and loads ``metrics/<metric>.py`` for each per-layer metric whose
``workloads`` names the cell. A new configuration (of another model,
with its own reference module), traffic mix, cell or metric is new files
and entries.

Set-up (``setup_s``, from the process's start): the matrix drawn on the
device from the seed, the trainer built as a user builds it
(``Recoder`` over the configuration's model with the trainer's seed),
then ``Recoder.train`` itself drives the first steps: a call of no step
(the model, optimizer, data source and slab), one step, two steps, and
``WARM_STEPS`` more, which capture every CUDA graph the epoch replays
(the program's state is copied to the host between them for the check).
Kernels load from the program's build cache (``build/kernels/`` in the
checkout); only a checkout's first run compiles them.

The window resumes ``train`` epoch after epoch, each call the rest of
the current epoch (``current_epoch`` advanced between calls, as a
resumed training sets it), until ``seconds`` have passed; the per-epoch
work (the order, the 'users' epoch tables, captures of new width
signatures) is inside it. ``train_batches_per_s`` is every step the
window ran over the window's wall time, which ends in a synchronize.

With ``trace``, the same window runs, then the next epoch -- one call,
the window's unit of work -- is profiled (:mod:`perfbench.devtrace`).

Then the peak device memory is read, the program runs the later block
the check compares (:mod:`perfbench.check`) with its state copied before
it, the trainer is freed, and the plain reference follows the start from
the seed and the later block from the copied state.
"""

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules that must not be loaded (top-level names, compared whole)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'recoder_tpu')
#: steps after the first three that capture the epoch's graphs: one
#: 16-step graph and one single-step graph (the start the check compares
#: is the three and these)
WARM_STEPS = 17
#: steps of the later block the check compares
LATER_STEPS = 20
#: epochs after the window searched for one of another width signature
LATER_SEARCH = 6


def load_json(*parts):
  with open(os.path.join(*parts)) as f:
    return json.load(f)


def forbidden_modules():
  """The forbidden top-level module names ``sys.modules`` holds."""
  loaded = {name.split('.')[0] for name in sys.modules}
  return sorted(loaded & set(FORBIDDEN))


def load_cell(name, manifest=None):
  """The cell's manifest entry with its configuration, traffic and limits
  (``config``, ``traffic``, ``limits``, ``per_layer``: the manifest's
  per-layer entries that name the cell)."""
  manifest = manifest or load_json(ROOT, 'BENCHMARK.json')
  entry, = [w for w in manifest['workloads'] if w['name'] == name]
  cell = dict(entry)
  cell['config'] = load_json(HERE, 'configs', f'{entry["config"]}.json')
  cell['traffic'] = load_json(HERE, 'traffic', f'{entry["traffic"]}.json')
  own = load_json(HERE, 'workloads', f'{name}.json')
  if (own['config'], own['traffic']) != (entry['config'], entry['traffic']):
    raise ValueError(f'{name}: workloads/{name}.json names another '
                     'configuration or traffic than BENCHMARK.json')
  cell['limits'] = own['limits']
  cell['end_to_end'] = [m for m in manifest['end_to_end']
                        if name in m.get('workloads', [name])]
  cell['per_layer'] = [m for m in manifest['per_layer']
                       if name in m.get('workloads', [name])]
  return cell


def load_reader(metric):
  """The module of ``metrics/<metric>.py``."""
  path = os.path.join(HERE, 'metrics', f'{metric}.py')
  spec = importlib.util.spec_from_file_location(
      'perfbench_metric_' + metric.replace('.', '_').replace('-', '_'), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def load_reference(config):
  """The configuration's reference module, ``reference/<name>.py``: its
  ``Reference`` class and its counts (``param_count``, ``decode_width``,
  ``step_flops``, ``signature``)."""
  return importlib.import_module(f'perfbench.reference.{config["reference"]}')


def trainer_seed(seed):
  """The trainer's seed: the run's, kept within 31 bits (the trainer
  shifts it left by 32 for its noise generator)."""
  return int(seed) % (2 ** 31 - 1)


class Run:
  """What the readers read: the cell, the matrix, the reference module,
  the window's counters and the profiled slice (``slice`` None without
  ``trace``)."""

  def __init__(self, cell, matrix, seed, device):
    self.cell, self.matrix, self.seed, self.device = cell, matrix, seed, device
    self.config, self.traffic = cell['config'], cell['traffic']
    self.reference = load_reference(self.config)
    self.batch = self.traffic['train']['batch_size']
    self.precision = self.traffic['model'].get('compute_dtype') or 'float32'
    self.num_users, self.num_items = matrix.shape
    self.steps_per_epoch = math.ceil(self.num_users / self.batch)
    self.steps = self.dispatches = self.captures = self.nonfinite = 0
    self.window_s = self.peak_bytes = None
    self.slice = None
    self.slice_steps = 0


class Program:
  """The program under test, driven as a user drives it: one ``Recoder``
  over one model of the configuration's class (``model_class`` in
  ``recoder_tpu_torch.models``) and the dataset of ``matrix``, trained
  by ``Recoder.train`` with the traffic's arguments.

  :meth:`start_steps` runs the start the check compares and copies it to
  the host: each step's loss, each leaf's first moment after step 1 and
  its change; :meth:`later_steps` the later block, with the state before
  it."""

  def __init__(self, cell, matrix, seed, device):
    from recoder_tpu_torch import models
    from recoder_tpu_torch.data import RecommendationDataset
    from recoder_tpu_torch.model import Recoder
    config, traffic = cell['config'], cell['traffic']
    path = dict(traffic['model'])
    opt_state_dtype = path.pop('opt_state_dtype', None)
    self.dataset = RecommendationDataset(matrix)
    model = getattr(models, config['model_class'])(**config['model'], **path)
    self.trainer = Recoder(model, seed=trainer_seed(seed), device=device,
                           opt_state_dtype=opt_state_dtype,
                           **config['trainer'])
    self.kw = dict(traffic['train'])
    self.steps_per_epoch = math.ceil(matrix.shape[0]
                                     / self.kw['batch_size'])
    self.consumed = 0  # steps of the current epoch that ran
    self.steps_run = 0  # steps of the training that ran
    self.copy_s = 0.0  # seconds spent copying the state for the check

  def train(self, iters=None):
    """One ``train`` call of the current epoch's next ``iters`` steps (all
    that are left by default); returns their losses."""
    trainer = self.trainer
    trainer.train(self.dataset, num_epochs=trainer.current_epoch,
                  iters_per_epoch=iters, **self.kw)
    losses = trainer.last_epoch_losses
    self.consumed += len(losses)
    self.steps_run += len(losses)
    return losses

  def next_call(self):
    """The rest of the current epoch, or the next epoch where this one is
    done (started as a resumed training starts it, by
    ``current_epoch``); returns the call's losses."""
    if self.consumed >= self.steps_per_epoch:
      self.trainer.current_epoch += 1
      self.consumed = 0
    return self.train()

  def _copy(self, tensors):
    """Float32 host copies of ``tensors`` (the time goes to ``copy_s``)."""
    import torch
    t = time.perf_counter()
    out = {k: v.detach().to('cpu', torch.float32, copy=True)
           for k, v in tensors.items()}
    self.copy_s += time.perf_counter() - t
    return out

  def _moments(self):
    """Each leaf's Adam moments ``(m, v)`` on the host (zeros where no
    step ran, which the check reads as such)."""
    import torch
    trainer = self.trainer
    m, v = {}, {}
    for name, p in trainer.model.params().items():
      if name in trainer.sparse_states:
        state = trainer.sparse_states[name]
        m[name], v[name] = state['m'], state['v']
      else:
        state = trainer.optimizer.state[p]
        m[name] = state.get('exp_avg', torch.zeros_like(p))
        v[name] = state.get('exp_avg_sq', torch.zeros_like(p))
    m, v = self._copy(m), self._copy(v)
    return {k: (m[k], v[k]) for k in m}

  def start_steps(self):
    """The start: after a call of no step (which builds the model, the
    optimizer, the data source and the slab), calls of one step, of two
    and of ``WARM_STEPS`` (which capture the graphs); returns
    ``{'losses', 'm1', 'change'}`` on the host."""
    trainer = self.trainer
    self.train(0)
    p0 = self._copy(trainer.model.params())
    losses = list(self.train(1))
    m1 = {k: m for k, (m, _) in self._moments().items()}
    losses += list(self.train(2))
    losses += list(self.train(WARM_STEPS))
    p1 = self._copy(trainer.model.params())
    return {'losses': losses, 'm1': m1,
            'change': {k: p1[k] - p0[k] for k in p0}}

  def later_steps(self, epoch, steps):
    """Epochs up to ``epoch`` run to their end, then a call of ``steps``
    steps at the start of ``epoch``; returns ``{'losses', 'change',
    'start'}``, ``start`` the state before it as the reference takes it
    (``epoch``, ``global_step``, ``params``, ``moments``)."""
    trainer = self.trainer
    while trainer.current_epoch < epoch - 1 or (
        self.consumed < self.steps_per_epoch):
      self.next_call()
    trainer.current_epoch, self.consumed = epoch, 0
    start = {'epoch': epoch, 'global_step': self.steps_run,
             'params': self._copy(trainer.model.params()),
             'moments': self._moments()}
    losses = list(self.train(steps))
    p1 = self._copy(trainer.model.params())
    return {'losses': losses, 'start': start,
            'change': {k: p1[k] - start['params'][k] for k in p1}}


def later_epoch(run, current):
  """The epoch of the later block: on a path whose steps bake in a width
  signature, the first of the ``LATER_SEARCH`` epochs after ``current``
  whose signature differs from the first epoch's; else the next one."""
  ref, seed = run.reference, trainer_seed(run.seed)
  first = ref.signature(run.matrix, run.traffic, seed, 1, run.device)
  if first is not None:
    for epoch in range(current + 1, current + 1 + LATER_SEARCH):
      if ref.signature(run.matrix, run.traffic, seed, epoch,
                       run.device) != first:
        return epoch
  return current + 1


def follow(run, later, precision='float32', fault=None):
  """The reference's start (the first ``3 + WARM_STEPS`` steps from the
  init) and later block (``later``: the program's, whose ``start`` state
  it continues from, ``LATER_STEPS`` steps) in ``precision``, with
  ``fault``: ``(start, later)`` outputs."""
  Reference = run.reference.Reference
  args = (run.matrix, run.config, run.traffic, trainer_seed(run.seed),
          run.device)
  ref = Reference(*args, precision=precision, fault=fault).run(
      3 + WARM_STEPS)
  ref_later = Reference(*args, precision=precision, fault=fault,
                        start=later['start']).run(LATER_STEPS)
  return ref, ref_later


def _sync(device):
  import torch
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def set_up(cell, seed, device, t_start):
  """Set-up: the matrix, the trainer and the start; returns ``(run,
  program, start, setup_s)`` (``t_start``: the process's start on
  ``time.perf_counter``)."""
  from perfbench import synth
  marks = [('imports', time.perf_counter())]
  matrix = synth.synthesize(cell['config']['data'], seed, device)
  marks.append(('matrix', time.perf_counter()))
  run = Run(cell, matrix, seed, device)
  prog = Program(cell, matrix, seed, device)
  start = prog.start_steps()
  _sync(device)
  marks.append(('trainer and the start', time.perf_counter()))
  setup_s = time.perf_counter() - t_start - prog.copy_s
  print('set-up: ' + ', '.join(
      f'{name} {t - before:.3f} s' for (name, t), before in
      zip(marks, [t_start] + [t for _, t in marks])) +
        f' (copies for the check {prog.copy_s:.3f} s, left out)',
        file=sys.stderr)
  return run, prog, start, setup_s


def drive_window(run, prog, seconds):
  """The timed window: whole calls until ``seconds`` have passed."""
  import numpy as np
  trainer = prog.trainer
  captures = trainer.captures
  t0 = time.perf_counter()
  while True:
    losses = prog.next_call()
    run.steps += len(losses)
    run.dispatches += trainer.last_epoch_dispatches
    run.nonfinite += int(np.sum(~np.isfinite(np.asarray(losses))))
    if time.perf_counter() - t0 >= seconds:
      break
  _sync(run.device)
  run.window_s = time.perf_counter() - t0
  run.captures = trainer.captures - captures


def later_block(run, prog):
  """The program's later block (:meth:`Program.later_steps`)."""
  epoch = later_epoch(run, prog.trainer.current_epoch)
  later = prog.later_steps(epoch, LATER_STEPS)
  print(f'later block: epoch {epoch}, after {later["start"]["global_step"]} '
        'steps', file=sys.stderr)
  return later


def free(device):
  """Return what a dropped trainer held to the device."""
  import torch
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()


def run_cell(cell, seed, seconds, trace, device, t_start):
  """One run of ``cell`` on ``device``; returns the result line's dict
  (``t_start``: the process's start on ``time.perf_counter``)."""
  import torch

  from perfbench import check, devtrace

  device = torch.device(device)
  run, prog, start, setup_s = set_up(cell, seed, device, t_start)
  drive_window(run, prog, seconds)
  if trace:
    run.slice = devtrace.profile_slice(prog.next_call)
    run.slice_steps = len(prog.trainer.last_epoch_losses)
  if device.type == 'cuda':
    run.peak_bytes = torch.cuda.max_memory_allocated(device)

  metrics = {}
  for entry in cell['per_layer'] if trace else cell['end_to_end']:
    if trace:
      value = load_reader(entry['name']).read(run)
    else:
      value = {'train_batches_per_s': run.steps / run.window_s,
               'setup_s': setup_s}.get(entry['name'])
    if value is not None:
      metrics[entry['name']] = {'value': value, 'unit': entry['unit']}

  later = later_block(run, prog)
  del prog
  free(device)
  ref, ref_later = follow(run, later)
  correct, compared = check.decide(check.readings(start, ref, later,
                                                  ref_later),
                                   cell['limits'])
  compared['nonfinite_losses'] = {'value': run.nonfinite, 'limit': 0}
  result = {'correct': bool(correct and run.nonfinite == 0),
            'attempted': run.steps, 'failed': run.nonfinite,
            'metrics': metrics, 'device': device_info(device, run)}
  if trace:
    result['breakdown'] = {'device_ops': run.slice.top_ops(),
                           'idle_gaps': run.slice.idle_gaps()}
  result['compared'] = compared
  return result


def device_info(device, run):
  import torch
  info = {'platform': 'gpu' if device.type == 'cuda' else device.type,
          'kind': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else device.type),
          'count': 1,
          'memory_peak_bytes': int(run.peak_bytes or 0)}
  if run.slice is not None:
    info['busy_s'] = run.slice.busy_s
    info['window_s'] = run.slice.window_s
  return info
