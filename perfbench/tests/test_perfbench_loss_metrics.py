"""The multinomial loss's two trace readers on a synthetic slice:
``mnll_per_step`` (the forward kernel's launches a step) and
``mnll_ms_per_step`` (device ms a step of the loss's kernels)."""

import types

import pytest

from perfbench import devtrace, harness


def _run(ops, steps=4):
  s = devtrace.Slice(ops, [('perfbench.slice', 0.0, 1.0)], 0.0, 1.0,
                     markers=64)
  return types.SimpleNamespace(slice=s, slice_steps=steps)


FWD = ('void (anonymous namespace)::mnll_fwd_kernel<unsigned short>((anonymous '
       'namespace)::Operand, (anonymous namespace)::Operand, int, int, float '
       'const*, float4*)')
FINISH = ('(anonymous namespace)::mnll_finish_kernel(float4 const*, int, '
          'int, float const*, float*, float*)')
BWD = ('void (anonymous namespace)::mnll_bwd_kernel<unsigned short>((anonymous '
       'namespace)::Operand, (anonymous namespace)::Operand, int, int, float '
       'const*, float const*, float const*, float const*, void*)')
OTHERS = [
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
     'at::native::func_wrapper_t<float, at::native::MaxNanFunctor<float> >, '
     'unsigned int, float, 4, 4> >', 0.01, 0.03),
    ('nvjet_tst_128x64_64x8_1x1_v_bz_TNT', 0.05, 0.06),
    ('void (anonymous namespace)::adam_bf16_kernel<float, __nv_bfloat16>',
     0.07, 0.08),
]
# two steps of the kernel pair
OPS = OTHERS + [(FWD, 0.10, 0.11), (FINISH, 0.11, 0.112), (BWD, 0.12, 0.14),
                (FWD, 0.20, 0.21), (FINISH, 0.21, 0.212), (BWD, 0.22, 0.24)]


def test_mnll_per_step_counts_forward_launches():
  reader = harness.load_reader('mnll_per_step')
  assert reader.read(_run(OPS, steps=2)) == 1.0
  assert reader.read(_run(OTHERS, steps=2)) == 0.0  # the parent
  assert reader.read(types.SimpleNamespace(slice=None, slice_steps=0)) is None


def test_mnll_ms_per_step_sums_the_loss_kernels():
  reader = harness.load_reader('mnll_ms_per_step')
  assert reader.read(_run(OPS, steps=2)) == pytest.approx(
      (0.01 + 0.002 + 0.02) * 1e3)
  assert reader.read(_run(OTHERS, steps=2)) is None  # nothing to read
  assert reader.read(types.SimpleNamespace(slice=None, slice_steps=0)) is None


def test_the_loss_kernels_are_no_products_and_no_aten():
  gemm = harness.load_reader('gemm_ms_per_step')
  aten = harness.load_reader('aten_ms_per_step')
  for name in (FWD, FINISH, BWD):
    assert not gemm.is_gemm(name) and aten.PATTERN not in name
