"""The manifest and the files it names: found by name, within the
manifest's limits on names, sizes and bounds, and each per-layer reader
beside its entry."""

import json
import math
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
MANIFEST = harness.load_json(ROOT, 'BENCHMARK.json')
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in MANIFEST['workloads']]
METRICS = [m['name'] for m in MANIFEST['per_layer']]


def test_top_level_keys_and_command():
  assert set(MANIFEST) == {'command', 'paths', 'run_seconds', 'configs',
                           'workloads', 'end_to_end', 'per_layer'}
  assert MANIFEST['paths'] == ['perfbench']
  assert MANIFEST['command'] == ['python3', 'perfbench/run.py']
  assert isinstance(MANIFEST['run_seconds'], int)
  assert 1 <= MANIFEST['run_seconds'] <= 51
  assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 64 * 1024


def _one_line(text):
  return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_names_units_and_text():
  entries = (MANIFEST['configs'] + MANIFEST['workloads']
             + MANIFEST['end_to_end'] + MANIFEST['per_layer'])
  for entry in entries:
    assert NAME.match(entry['name']), entry['name']
  for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
    names = [e['name'] for e in MANIFEST[group]]
    assert len(names) == len(set(names)), group
  for m in MANIFEST['end_to_end'] + MANIFEST['per_layer']:
    assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
  for entry in MANIFEST['configs'] + MANIFEST['workloads']:
    assert _one_line(entry['why'])
  for c in MANIFEST['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
    assert _one_line(c['source']) and len(c['reduced']) <= 16


def test_end_to_end_bounds():
  e2e = {m['name']: m for m in MANIFEST['end_to_end']}
  assert set(e2e) == {'train_batches_per_s', 'setup_s'}
  for m in e2e.values():
    assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                      'workloads'}
    assert 0.01 <= m['bound'] <= 0.25
    assert m['source'] in ('host_clock', 'device_trace')


@pytest.mark.parametrize('cell', CELLS)
def test_cell_found_by_name(cell):
  got = harness.load_cell(cell, MANIFEST)
  entry, = [w for w in MANIFEST['workloads'] if w['name'] == cell]
  assert entry['chips'] == 1
  assert set(entry) == {'name', 'config', 'traffic', 'chips', 'why'}
  assert got['config']['name'] == entry['config']
  assert {'loss', 'grad_diff', 'change', 'loss_later',
          'change_later'} <= set(got['limits']) <= {
              'loss', 'grad', 'grad_diff', 'change', 'loss_later',
              'change_later'}
  assert {m['name'] for m in got['end_to_end']} >= {'setup_s',
                                                    'train_batches_per_s'}
  assert got['per_layer'], 'every cell reports a per-layer metric'
  assert set(got['traffic']['model']) == {'sparse', 'compute_dtype',
                                          'opt_state_dtype'}


@pytest.mark.parametrize('config', MANIFEST['configs'],
                         ids=lambda c: c['name'])
def test_config_file_under_paths(config):
  assert config['file'] == f'perfbench/configs/{config["name"]}.json'
  data = harness.load_json(ROOT, config['file'])
  assert data['name'] == config['name'] and data['source'] == config['source']
  assert data['assumed'], 'the synthetic data is listed as assumed'
  used = [w for w in MANIFEST['workloads'] if w['config'] == config['name']]
  assert used


@pytest.mark.parametrize('config', MANIFEST['configs'],
                         ids=lambda c: c['name'])
def test_config_names_its_model_and_reference(config):
  """The model's class and the reference module are found by the names
  the configuration's file gives, so another model comes as files."""
  from recoder_tpu_torch import models
  data = harness.load_json(ROOT, config['file'])
  assert isinstance(getattr(models, data['model_class']), type)
  reference = harness.load_reference(data)
  for name in ('Reference', 'param_count', 'decode_width', 'step_flops',
               'signature'):
    assert callable(getattr(reference, name)), name


@pytest.mark.parametrize('metric', METRICS)
def test_reader_found_by_name(metric):
  entry, = [m for m in MANIFEST['per_layer'] if m['name'] == metric]
  reader = harness.load_reader(metric)
  assert reader.LAYER == entry['layer'] and reader.MOVES == entry['moves']
  assert entry['moves'] == 'train_batches_per_s'
  assert set(entry['workloads']) <= set(CELLS)
  assert callable(reader.read)


def test_a_new_metric_entry_reaches_its_cell():
  manifest = json.loads(json.dumps(MANIFEST))
  manifest['per_layer'].append(dict(manifest['per_layer'][0],
                                    name='later_metric',
                                    workloads=[CELLS[0]]))
  assert 'later_metric' in [m['name'] for m in
                            harness.load_cell(CELLS[0], manifest)['per_layer']]
  assert 'later_metric' not in [m['name'] for m in
                                harness.load_cell(CELLS[1],
                                                  manifest)['per_layer']]


def test_every_metric_is_reported_in_some_cell_and_full_check_fits():
  cells = len(CELLS)
  assert 1 <= cells <= 24 and 1 <= len(MANIFEST['per_layer']) <= 128
  runs = 2 + 14 * 24
  seconds = runs * (MANIFEST['run_seconds'] + 60) + 24 * 2 * 90 + 1200
  assert seconds <= 43200
  assert math.isfinite(seconds)
