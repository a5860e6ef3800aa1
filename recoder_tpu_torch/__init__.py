"""recoder-tpu on PyTorch and CUDA: the port of ``recoder_tpu`` to an
NVIDIA Hopper GPU.

The package keeps the module layout and names of ``recoder_tpu`` so
that each module's counterpart is easy to find, and is held against it
by the differential tests in ``tests/test_torch_*.py``. It imports
``torch`` and never ``jax``, and never imports ``recoder_tpu`` (whose
package ``__init__`` imports jax).

Ported so far -- the DynamicAutoencoder training path with full-catalog
decode, the serving path it needs, and iALS:

  recoder_tpu/utils.py                  -> recoder_tpu_torch.utils
  recoder_tpu/data/dataset.py           -> recoder_tpu_torch.data.dataset
  recoder_tpu/data/device_pipeline.py   -> recoder_tpu_torch.data.device_pipeline
  recoder_tpu/checkpoint.py             -> recoder_tpu_torch.checkpoint
  (new) weights bridge                  -> recoder_tpu_torch.convert
  recoder_tpu/models/base.py            -> recoder_tpu_torch.models.base
  recoder_tpu/models/autoencoder.py     -> recoder_tpu_torch.models.autoencoder
  recoder_tpu/ops/losses.py             -> recoder_tpu_torch.ops.losses
  recoder_tpu/ops/gather_matmul.py      -> recoder_tpu_torch.ops.gather_matmul
  recoder_tpu/experiments/pallas_loss.py
      -> recoder_tpu_torch.ops.fused_decode_loss
         + recoder_tpu_torch/kernels/fused_decode_loss.cu
  recoder_tpu/optim.py                  -> recoder_tpu_torch.optim
  recoder_tpu/model.py                  -> recoder_tpu_torch.model
  recoder_tpu/metrics.py                -> recoder_tpu_torch.metrics
  recoder_tpu/recommender.py            -> recoder_tpu_torch.recommender
  recoder_tpu/ops/spd.py                -> recoder_tpu_torch.ops.spd
                                           + recoder_tpu_torch/kernels/spd_solve.cu
  recoder_tpu/models/ials.py            -> recoder_tpu_torch.models.ials
"""

__version__ = '0.2.0'
