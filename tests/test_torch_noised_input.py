"""The encoder's input helper ``models.base.noised_input`` on the CPU:
it routes to the plain chain and gives exactly ``dropout(
l2_normalize_rows(x))`` (float32 and bf16, a drawn and a given mask, a
mesh rank's rows, no noise), draws what the plain chain draws, and the
models' encoders go through it. The kernel's route runs only on the card
(``tests/test_torch_noised_input_cuda.py``)."""

import pytest
import torch

from recoder_tpu_torch.models import DynamicAutoencoder, MultVAE
from recoder_tpu_torch.models import base
from recoder_tpu_torch.ops import noised_input as ni


def _rows(dtype, B=6, W=40, seed=0):
  gen = torch.Generator().manual_seed(seed)
  x = (torch.rand(B, W, generator=gen) < 0.3).float()
  x[1] *= torch.rand(W, generator=gen) * 5  # values other than 0 and 1
  x[2] = 0.0  # a row of zeros
  return x.to(dtype)


def _gen(seed=7):
  return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize('given_mask', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_helper_is_the_plain_chain(dtype, given_mask):
  x = _rows(dtype)
  keep = ((torch.rand(x.shape, generator=_gen(3)) < 0.5).to(dtype)
          if given_mask else None)
  before = dict(ni.LAUNCHES)
  got = base.noised_input(x, 0.5, _gen(), keep)
  want = base.dropout(base.l2_normalize_rows(x), 0.5, _gen(), keep)
  assert got.dtype == dtype
  assert torch.equal(got, want)
  assert ni.LAUNCHES == before  # no kernel on the CPU


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_helper_with_a_mesh_ranks_rows(dtype):
  """``rows = (lo, hi, n)``: the rank's rows of the whole batch's draw."""
  x = _rows(dtype, B=10)
  lo, hi = 3, 7
  got = base.noised_input(x[lo:hi], 0.25, _gen(), rows=(lo, hi, 10))
  whole = base.noised_input(x, 0.25, _gen())
  assert torch.equal(got, whole[lo:hi])
  want = base.dropout(base.l2_normalize_rows(x[lo:hi]), 0.25, _gen(),
                      rows=(lo, hi, 10))
  assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_no_noise_is_the_normalization_alone(dtype):
  x = _rows(dtype)
  gen = _gen()
  state = gen.get_state()
  got = base.noised_input(x, 0.0, gen, torch.zeros(x.shape))
  assert torch.equal(got, base.l2_normalize_rows(x))
  assert torch.equal(gen.get_state(), state)  # nothing drawn


def test_plain_version_is_the_composition():
  x = _rows(torch.bfloat16)
  assert torch.equal(ni.noised_input_plain(x, 0.5, _gen()),
                     ni.dropout(ni.l2_normalize_rows(x), 0.5, _gen()))
  assert torch.equal(ni.noised_input_plain(x, 0.0),
                     ni.l2_normalize_rows(x))
  # the model module's names are the ops module's
  assert base.dropout is ni.dropout
  assert base.l2_normalize_rows is ni.l2_normalize_rows


def test_the_draw_advances_the_generator_as_the_plain_chain():
  x = _rows(torch.bfloat16)
  a, b = _gen(), _gen()
  base.noised_input(x, 0.5, a)
  ni.noised_input_plain(x, 0.5, b)
  assert torch.equal(a.get_state(), b.get_state())


@pytest.mark.parametrize('shape,strides', [((4, 8), (8, 1)), ((4, 8), (16, 1)),
                                           ((4, 8), (1, 4)), ((4, 8), (0, 1))])
def test_kernel_takes_nothing_on_the_cpu(shape, strides):
  x = torch.empty_strided(shape, strides, dtype=torch.bfloat16)
  assert not ni.takes(x)
  with pytest.raises(ValueError, match='CUDA'):
    ni.noised_input_kernel(x, 0.5, torch.ones(shape, dtype=torch.bool))


def test_encoders_go_through_the_helper(monkeypatch):
  """``DynamicAutoencoder.encode`` and ``MultVAE._hidden`` take their
  input through ``noised_input``: the noise rate in training, 0 out of
  it, the mesh rows and a given mask passed on."""
  from recoder_tpu_torch.models import autoencoder, multvae
  calls = []

  def spy(x, rate, generator=None, keep_mask=None, rows=None):
    calls.append((tuple(x.shape), rate, keep_mask is not None, rows))
    return base.noised_input(x, rate, generator, keep_mask, rows)

  monkeypatch.setattr(autoencoder, 'noised_input', spy)
  monkeypatch.setattr(multvae, 'noised_input', spy)
  ae = DynamicAutoencoder([8], 'tanh', noise_prob=0.5)
  ae.init_model(num_items=30, seed=0)
  x = _rows(torch.float32, B=4, W=ae.num_items_padded)
  ae.decode_operands(x, training=True, generator=_gen())
  ae.decode_operands(x, training=False)
  vae = MultVAE(16, 8, dropout_prob=0.3)
  vae.init_model(num_items=30, seed=0)
  keep = torch.ones(x.shape)
  vae(x, training=True, generator=_gen(), keep_mask=keep,
      eps=torch.zeros(4, 8))
  vae(x, training=False)
  W = ae.num_items_padded
  assert calls == [((4, W), 0.5, False, None), ((4, W), 0.0, False, None),
                   ((4, W), 0.3, True, None), ((4, W), 0.0, False, None)]
