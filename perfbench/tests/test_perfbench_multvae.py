"""Mult-VAE's counts against hand counts (``param_count``,
``decode_width``, ``step_flops``), and the readers that list its cell
(``aten_ms_per_step``, ``gemm_ms_per_step``, ``adam_roofline``,
``mfu_pct``) on a made-up Mult-VAE run and slice."""

import types

import numpy as np
import pytest

from perfbench import devtrace, harness, roofline, synth
from perfbench.reference import autoencoder
from perfbench.reference import multvae as ref

CONFIG = {'model': {'hidden_dim': 600, 'latent_dim': 200}}
SHAPE = dict(num_users=300, num_items=170, mean_items=12, mean_factor=0.683,
             sigma=0.9, min_items=5, max_items=1000, zipf=2.2)


def test_param_count_and_decode_width_by_hand():
  rows = 20224  # (20,108 padded to a multiple of 256, strictly above)
  tables = 2 * rows * 600
  mlp = 600 * 200 + 600 * 200 + 200 * 600
  biases = 600 + 200 + 200 + 600 + rows
  assert ref.param_count(CONFIG, 20108) == tables + mlp + biases
  assert ref.param_count(CONFIG, 20108) == 24_650_624
  assert ref.decode_width(CONFIG) == 600
  assert ref.signature(None, None, 1, 1, 'cpu') is None


def test_init_has_the_counted_leaves():
  config = {'model': {'hidden_dim': 6, 'latent_dim': 2}}
  params = ref.init_params(170, config, 5)
  assert sum(v.numel() for v in params.values()) == ref.param_count(config,
                                                                    170)
  assert params['en_embedding'].shape == (256, 6)
  assert params['w_dec'].shape == (2, 6)
  limit = (6.0 / (6 + 170)) ** 0.5
  assert float(params['de_embedding'].abs().max()) <= limit


def test_step_flops_by_hand():
  """4 nnz h for the encoder, 6 B N h for the output layer over the
  logical catalog, 6 B h d for each of the three MLP products."""
  h, d = 8, 3
  config = {'model': {'hidden_dim': h, 'latent_dim': d}}
  matrix = synth.synthesize(SHAPE, 7, 'cpu')
  order = autoencoder.epoch_order('users', 11, 1, matrix.shape[0], 64)
  flops = ref.step_flops(matrix, order, 64, config, 'cpu')
  want = []
  for g in range(0, len(order), 64):
    ids = [u for u in order[g:g + 64] if u < matrix.shape[0]]
    nnz = sum(matrix[u].nnz for u in ids)
    B = len(ids)
    want.append(4.0 * nnz * h + 6.0 * B * 170 * h + 3 * 6.0 * B * h * d)
  assert flops.tolist() == want


def _slice(ops):
  return devtrace.Slice(ops, [('perfbench.slice', 0.0, 1.0)], 0.0, 1.0,
                        markers=64)


OPS = [
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
     'at::native::func_wrapper_t<float, at::native::MaxNanFunctor<float> '
     '> > >', 0.10, 0.14),
    ('void at::native::vectorized_elementwise_kernel<4, at::native::'
     'exp_kernel_cuda>', 0.20, 0.23),
    ('nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN', 0.30, 0.42),
    ('sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64', 0.50,
     0.58),
    ('void (anonymous namespace)::adam_bf16_kernel<float, __nv_bfloat16>',
     0.60, 0.64),
    ('void (anonymous namespace)::adam_bf16_kernel<float, __nv_bfloat16>',
     0.70, 0.74),
]


def _run(ops=OPS, steps=2):
  matrix = synth.synthesize(SHAPE, 7, 'cpu')
  cell = {'config': {'model': {'hidden_dim': 600, 'latent_dim': 200}},
          'traffic': {'train': {'batch_size': 64, 'shuffle': 'users'}}}
  return types.SimpleNamespace(
      slice=_slice(ops), slice_steps=steps, config=cell['config'],
      traffic=cell['traffic'], reference=ref, num_items=20108,
      num_users=matrix.shape[0], matrix=matrix, batch=64, seed=9,
      device='cpu', precision='bfloat16', steps=1000, window_s=2.0)


def test_aten_and_gemm_readers_read_the_slice():
  run = _run()
  aten = harness.load_reader('aten_ms_per_step').read(run)
  assert aten == pytest.approx((0.04 + 0.03) * 1e3 / 2)
  gemm = harness.load_reader('gemm_ms_per_step').read(run)
  assert gemm == pytest.approx((0.12 + 0.08) * 1e3 / 2)
  empty = types.SimpleNamespace(slice=None, slice_steps=0)
  for name in ('aten_ms_per_step', 'gemm_ms_per_step', 'adam_roofline'):
    assert harness.load_reader(name).read(empty) is None


def test_adam_roofline_at_multvaes_parameters():
  got = harness.load_reader('adam_roofline').read(_run())
  bound = roofline.adam_bound_ms(24_650_624)
  assert got == pytest.approx(100.0 * bound / 40.0)


def test_mfu_counts_multvaes_flops():
  run = _run()
  got = harness.load_reader('mfu_pct').read(run)
  n_pad = -(-run.num_users // 64) * 64
  rng = np.random.default_rng([9, 7])
  order = np.concatenate([rng.permutation(run.num_users),
                          np.arange(run.num_users, n_pad)])
  flops = ref.step_flops(run.matrix, order, 64, run.config, 'cpu')
  want = 100.0 * float(flops.mean()) * 1000 / (2.0 * 989e12)
  assert got == pytest.approx(want)
  assert harness.load_reader('mfu_pct').read(
      types.SimpleNamespace(steps=0, window_s=None)) is None


@pytest.mark.cuda
def test_draws_at_the_programs_philox_offsets(card):
  """On the card the trainer places its generator at ``global step x``
  the offset one step's draws take: the reference's offset is the
  program's, and its keep mask and ``eps`` at a global step are the
  model's draws from the generator placed there."""
  import copy

  import torch

  cell = copy.deepcopy(harness.load_cell('multvae-ml20m.softmax-users'))
  cell['config']['data'].update(num_users=1500, num_items=700,
                                mean_items=20)
  cell['traffic']['train']['batch_size'] = 50
  matrix = synth.synthesize(cell['config']['data'], 3, card)
  prog = harness.Program(cell, matrix, 3, card)
  prog.train(1)
  trainer = prog.trainer
  reference = ref.Reference(matrix, cell['config'], cell['traffic'], 3, card)
  assert trainer._noise_increment(trainer._device_loop,
                                  False) == reference.increment
  model, gen = trainer.model, torch.Generator(device=card)
  x = reference._batch(0)[0].to(torch.bfloat16)
  for step in (0, 1, 7, 40001):
    gen.manual_seed(3 << 32)
    gen.set_offset(step * reference.increment)
    t = torch.tensor(step, device=card)
    keep, eps = reference.draws(step)
    with torch.no_grad():
      drawn = model(x, generator=gen, training=True, step=t)
      fed = model(x, training=True, step=t, keep_mask=keep, eps=eps)
    for a, b in zip(drawn, fed):
      assert torch.equal(a, b)
