"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W
limit) and the least time of a call, copied from
``vit_cnn_tpu_torch/tools/__init__.py`` (``PEAK_*``, ``bound``) so that
the yardstick does not move with the program.
"""

from __future__ import annotations

#: HBM bytes/s; special-function-unit exps/s (16 / clock / SM x 132 SMs x
#: 1.98 GHz); FLOP/s by input type (bf16 on the tensor cores, float32 on
#: the CUDA cores)
PEAK_BYTES, PEAK_EXPS = 3.35e12, 4.2e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float32": 4}


def least_seconds(nbytes: float, exps: float = 0.0, flops: float = 0.0,
                  dtype: str = "bfloat16") -> float:
    """The least time of one call: the larger of its bytes (each input
    read once, each output written once) over the HBM rate and its
    operations over their peak rate."""
    return max(nbytes / PEAK_BYTES, exps / PEAK_EXPS,
               flops / PEAK_FLOPS[dtype])
