"""Command line of the port: the ``--serve`` daemon.

Port of ``run_serve`` in :mod:`vit_cnn_tpu.cli`, with the flags it reads
under the same names. Run as::

  python -m vit_cnn_tpu_torch --dataset Synthetic \\
      --model Multimodality_Mamba --bf16 --serve

Status lines go to stderr, so stdout carries only JSON responses.
Training, pretraining and ``--restore`` (a JAX ``best.msgpack``) are
later items of ROADMAP Queue 1.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import torch

from vit_cnn_tpu.data.registry import dataset_names, get_dataset

from ..infer.server import SceneServer
from ..models.registry import get_model, model_names
from ..nn.layers import init_parameters


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Serve full-scene HSI+LiDAR classification on a GPU "
                    "(PyTorch + CUDA port of vit_cnn_tpu)")
    parser.add_argument("--dataset", type=str, default="MUUFL",
                        choices=dataset_names(), help="Dataset to use.")
    parser.add_argument("--model", type=str, default="Multimodality_Mamba",
                        help="Model to serve. Available: " +
                             ", ".join(model_names()))
    parser.add_argument("--folder", type=str, default="./Datasets/",
                        help="Folder where the datasets are stored.")
    parser.add_argument("--seed", type=int, default=1,
                        help="Seed of the random weights served when no "
                             "state_dict is given")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute policy for the model")
    parser.add_argument("--infer_chunk", type=int, default=8192,
                        help="Windows per inference band")
    parser.add_argument("--serve", action="store_true",
                        help="persistent serving mode: answer JSON-line "
                             "full-scene requests on stdin (see "
                             "infer/server.py for the protocol)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cuda' raises when CUDA is "
                             "absent (the CPU runs only on --device cpu)")
    return parser


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device {}: CUDA is not available (pass "
                           "--device cpu to run the plain versions on the "
                           "CPU)".format(name))
    return device


def run_serve(args, in_stream=None, out_stream=None,
              state_dict: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """Build the model once on ``--device``, load ``state_dict`` (the
    seeded random init of ``--seed`` without one), then answer JSON-line
    requests until EOF or quit. Returns the number of requests served."""
    device = _device(args.device)
    (img1, img2, gt, label_values, ignored_labels, rgb_bands,
     palette) = get_dataset(args.dataset, args.folder)
    hyperparams = {k: v for k, v in vars(args).items() if v is not None}
    hyperparams.update({
        "n_classes": len(label_values),
        "n_bands": (img1.shape[-1], img2.shape[-1]),
        "ignored_labels": list(ignored_labels), "dataset": args.dataset,
    })
    model, spec, hp = get_model(args.model, **hyperparams)
    if state_dict is None:
        init_parameters(model, args.seed)
        print("# --serve without weights: serving an UNTRAINED {}".format(
            args.model), file=sys.stderr, flush=True)
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device).eval()

    server = SceneServer(model, hp, ignored_labels=ignored_labels,
                         chunk=args.infer_chunk)
    print('# ready: {} on {} ({}) — one JSON request per line, '
          '{{"cmd": "quit"}} ends'.format(args.model, args.dataset, device),
          file=sys.stderr, flush=True)
    return server.loop(in_stream or sys.stdin, out_stream or sys.stdout,
                       img1, img2)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.serve:
        raise SystemExit("vit_cnn_tpu_torch serves only (--serve); training "
                         "is ROADMAP Queue 1, item 7")
    return run_serve(args)
