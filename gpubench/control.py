"""Readings of a cell's control, the numbers that set the upper end of
its limits (README.md, "How correct is decided").

  python -m gpubench.control --workload <cell> --seeds 11 12 13 [--mode fp8]

For each seed, with the cell's own scene, weights and sizes, the numbers
that decide ``correct``, read from the reference computed with fp8
products (``--mode fp8``, the control: one precision below the
configurations' bf16) in the program's place: for a serving cell at the
bands a run of ``--requests`` requests samples, for a training cell over
its first three steps. ``--mode half_batch`` or ``unchanged`` reads a
training cell's program with that fault planted (:mod:`gpubench.faults`)
instead, and ``--mode program`` the program's own numbers (a serving
cell's from one request), many seeds in one process. Two more modes are
witnesses, not controls: ``program_float32`` runs the program under its
float32 policy with TF32 off (where it should agree with the reference
to float32 rounding), and ``bf16`` the reference with bfloat16 products,
the program's own rounding without the program. One JSON line a seed.
The benchmark's runs do not run this; it needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seed: int, mode: str, device: str = "cuda",
             requests: int = 2, info=None) -> dict:
    from . import layout
    from .run import driver

    from .faults import TRAIN

    info = info or layout.cell(workload)
    if mode == "program_float32":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        info = dict(info, traffic=dict(info["traffic"],
                                       precision="float32"))
        mode = "program"
    if mode in TRAIN:
        return driver(info, seed, device, TRAIN[mode]).control("program")
    drv = driver(info, seed, device)
    if info["traffic"]["kind"] != "serve":
        return drv.control(mode)
    if mode == "program":
        drv.setup()
        drv.window(0.0)
        drv.release()
        return drv.check()
    drv.prepare()
    return drv.gaps(mode, requests=requests)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--mode", default="fp8")
    parser.add_argument("--requests", type=int, default=2)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(args.workload, seed, args.mode,
                       requests=args.requests)
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              mode=args.mode, seconds=time.perf_counter() - t0,
                              **out)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
