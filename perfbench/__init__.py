"""The benchmark of ``recoder_tpu_torch`` on an NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything here is the yardstick: the matrix generator
(:mod:`perfbench.synth`), the roofline and model-FLOP arithmetic
(:mod:`perfbench.roofline`), the reduction of a device trace
(:mod:`perfbench.devtrace`), the plain float32 reference and the comparison
that decides ``correct`` (:mod:`perfbench.reference`,
:mod:`perfbench.check`). The program under test is ``recoder_tpu_torch``;
nothing here imports ``jax`` or the JAX package ``recoder_tpu``.
"""
