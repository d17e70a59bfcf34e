"""Command line of the port: one training run, or the ``--serve`` daemon.

Port of :mod:`vit_cnn_tpu.cli`, with the flags it reads under the same
names and defaults. Run as::

  python -m vit_cnn_tpu_torch --dataset Synthetic --bf16 \\
      --epoch 10 --batch_size 1024 --flip_augmentation     # train
  python -m vit_cnn_tpu_torch --dataset Synthetic \\
      --model Multimodality_Mamba --bf16 --serve            # serve

Without ``--serve`` the run is one run of the JAX ``run_experiments``:
split, model, pipelines, ``Trainer.fit``, the full-scene map of the best
weights, OA/AA/Kappa, and one JSON line on stdout. Status lines go to
stderr, so stdout carries only JSON. ``--runs`` > 1 aggregation, the
artifact writer, ``--restore`` (a JAX ``best.msgpack``), profiling and
pretraining are later items of ROADMAP Queue 1.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..data import compute_imf_weights, dataset_names, get_dataset
from ..data.sampling import sample_gt
from ..infer.fullscene import full_scene_probabilities
from ..infer.server import SceneServer
from ..models.registry import get_model, model_names
from ..nn.layers import init_parameters
from ..pipeline.patches import AugmentConfig, PatchPipeline
from ..train.loop import Trainer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train and serve full-scene HSI+LiDAR classification on "
                    "a GPU (PyTorch + CUDA port of vit_cnn_tpu)")
    parser.add_argument("--dataset", type=str, default="MUUFL",
                        choices=dataset_names(), help="Dataset to use.")
    parser.add_argument("--model", type=str, default="Multimodality_Mamba",
                        help="Model to serve. Available: " +
                             ", ".join(model_names()))
    parser.add_argument("--folder", type=str, default="./Datasets/",
                        help="Folder where the datasets are stored.")
    parser.add_argument("--seed", type=int, default=1,
                        help="Seed of the random initial weights, and of "
                             "training's shuffle and augmentation draws")
    group_dataset = parser.add_argument_group("Dataset")
    group_dataset.add_argument(
        "--train_val_split", type=float, default=1,
        help="Percentage of samples to use for training and validation; "
             "'1' means all training data are used to train")
    group_dataset.add_argument(
        "--training_sample", type=float, default=20,
        help="Percentage of samples to use for training; if sampling_mode =="
             "'random_fixednumber', the per-class training count")
    group_dataset.add_argument(
        "--sampling_mode", type=str, default="random_fixednumber",
        help="random | random_fixednumber")
    group_train = parser.add_argument_group("Training")
    group_train.add_argument("--epoch", type=int, default=None,
                             help="Training epochs (model default if absent)")
    group_train.add_argument("--lr", type=float, default=None,
                             help="Learning rate (model default if absent)")
    group_train.add_argument("--class_balancing", action="store_true",
                             help="Inverse median frequency class balancing")
    group_train.add_argument("--batch_size", type=int, default=None,
                             help="Batch size (model default if absent)")
    group_train.add_argument("--flip_augmentation", action="store_true",
                             help="Random flips (if patch_size > 1)")
    group_train.add_argument("--log_every", type=int, default=10,
                             help="Print loss/val every N epochs (0 = silent)")
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
    model, spec, hp = get_model(args.model, **_hyperparams(
        args, img1, img2, label_values, ignored_labels))
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


def _hyperparams(args, img1, img2, label_values, ignored_labels):
    hyperparams = {k: v for k, v in vars(args).items() if v is not None}
    hyperparams.update({
        "n_classes": len(label_values),
        "n_bands": (img1.shape[-1], img2.shape[-1]),
        "ignored_labels": list(ignored_labels), "dataset": args.dataset,
    })
    return hyperparams


def run_train(args, state_dict: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict:
    """One run of the JAX ``run_experiments`` (run 0): the split (seed 0,
    numpy and python RNGs seeded with ``--seed`` first), ``get_model``,
    the train / val pipelines, ``Trainer.fit`` on ``--device`` from
    ``state_dict`` (the seeded random init of ``--seed`` without one), the
    full-scene map of the best weights in a model of their own, and
    OA/AA/Kappa against the test split. Prints one JSON line on stdout and
    returns it as a dict."""
    from vit_cnn_tpu.metrics.classification import metrics

    device = _device(args.device)
    (img1, img2, gt, label_values, ignored_labels, rgb_bands,
     palette) = get_dataset(args.dataset, args.folder)
    n_classes = len(label_values)
    random.seed(args.seed)
    np.random.seed(args.seed)
    train_gt, test_gt = sample_gt(gt, args.training_sample,
                                  mode=args.sampling_mode, seed=0)
    train_gt, test_gt = train_gt.astype(np.int64), test_gt.astype(np.int64)
    print("{} samples selected (over {})".format(
        np.count_nonzero(train_gt), np.count_nonzero(gt)),
        file=sys.stderr, flush=True)

    hp = _hyperparams(args, img1, img2, label_values, ignored_labels)
    if args.class_balancing:
        hp["weights"] = compute_imf_weights(train_gt, n_classes,
                                            ignored_labels)
    model, spec, hp = get_model(args.model, **hp)
    if args.train_val_split != 1:
        train_gt, val_gt = sample_gt(train_gt, args.train_val_split,
                                     mode="random")
    else:
        val_gt = sample_gt(train_gt, 0.95, mode="random")[1]

    aug = AugmentConfig(flip=hp.get("flip_augmentation", False),
                        radiation=hp.get("radiation_augmentation", False),
                        mixture=hp.get("mixture_augmentation", False))
    pipe = PatchPipeline(img1, img2, train_gt, hp["patch_size"],
                         hp["ignored_labels"], n_classes, augment=aug,
                         supervision=hp.get("supervision", "full"),
                         device=device)
    val_pipe = PatchPipeline(img1, img2, val_gt, hp["patch_size"],
                             hp["ignored_labels"], n_classes, device=device)
    if state_dict is None:
        init_parameters(model, args.seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device)
    trainer = Trainer(model, hp, pipe, val_pipeline=val_pipe, seed=args.seed)
    best = trainer.fit(log_every=args.log_every)

    served, _, _ = get_model(args.model, **hp)
    served.load_state_dict(best, strict=True)
    served.to(device).eval()
    probabilities = full_scene_probabilities(served, img1, img2, hp,
                                             chunk=args.infer_chunk)
    prediction = np.argmax(probabilities, axis=-1)
    m = metrics(prediction, test_gt, ignored_labels=hp["ignored_labels"],
                n_classes=n_classes)
    log = trainer.log
    result = {
        "model": args.model, "dataset": args.dataset, "device": str(device),
        "train_samples": len(pipe), "epochs": len(log.losses),
        "losses": log.losses, "val_accuracies": log.val_accuracies,
        "patches_per_s": len(pipe) * len(log.losses)
        / max(sum(log.epoch_seconds), 1e-9),
        "OA": float(m["Accuracy"]), "AA": float(m["AA"]),
        "Kappa": float(m["Kappa"]),
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.serve:
        return run_serve(args)
    return run_train(args)
