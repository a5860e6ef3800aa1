"""The input pipeline's two trace readers on a synthetic slice:
``aten_ms_per_step`` (PyTorch's own kernels, device ms a step) and
``noised_input_per_step`` (the one-pass input kernel's launches a step)."""

import types

import pytest

from perfbench import devtrace, harness


def _run(ops, steps=4):
  s = devtrace.Slice(ops, [('perfbench.slice', 0.0, 1.0)], 0.0, 1.0,
                     markers=64)
  return types.SimpleNamespace(slice=s, slice_steps=steps)


OPS = [
    ('void at::native::vectorized_elementwise_kernel<4, at::native::'
     'BinaryFunctor<float, float, float, at::native::binary_internal::'
     'DivFunctor<float> > >', 0.10, 0.11),
    ('void at::native::(anonymous namespace)::distribution_elementwise_'
     'grid_stride_kernel<float, 4>', 0.20, 0.22),
    ('void (anonymous namespace)::noised_input_bf16_kernel<true, 1>'
     '(uint4 const*, long long, int, void const*, float, uint4*)',
     0.30, 0.33),
    ('void (anonymous namespace)::noised_input_bf16_kernel<true, 1>'
     '(uint4 const*, long long, int, void const*, float, uint4*)',
     0.40, 0.43),
    ('nvjet_tst_128x64_64x8_1x1_v_bz_TNT', 0.50, 0.60),
    ('void (anonymous namespace)::adam_bf16_kernel<float, __nv_bfloat16>',
     0.70, 0.75),
]


def test_aten_ms_per_step_reads_pytorchs_kernels_only():
  reader = harness.load_reader('aten_ms_per_step')
  assert reader.read(_run(OPS)) == pytest.approx((0.01 + 0.02) * 1e3 / 4)
  assert reader.read(_run(OPS[2:])) == 0.0  # no PyTorch kernel ran
  assert reader.read(types.SimpleNamespace(slice=None, slice_steps=0)) is None


def test_noised_input_per_step_counts_launches():
  reader = harness.load_reader('noised_input_per_step')
  assert reader.read(_run(OPS, steps=2)) == 1.0
  assert reader.read(_run(OPS[:2] + OPS[4:], steps=2)) == 0.0  # the parent
  assert reader.read(types.SimpleNamespace(slice=None, slice_steps=0)) is None
