"""The benchmark of the PyTorch and CUDA port (``vit_cnn_tpu_torch``).

Run one cell from the root of a checkout, on a machine with an NVIDIA card:

  python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, their configurations,
traffic mixes and metrics; the harness finds every file of a cell by those
names (:mod:`gpubench.layout`). ``README.md`` beside this file says how a
window is measured and how ``correct`` is decided.
"""
