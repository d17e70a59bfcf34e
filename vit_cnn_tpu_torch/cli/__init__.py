"""Command line of the port: the run loop of experiments, the
``--serve`` daemon, or MoCo pretraining (``--pretrain``).

Port of :mod:`vit_cnn_tpu.cli`, with its flags under the same names,
types and defaults (those left out are listed in :data:`LEFT_OUT`). Run
as::

  python -m vit_cnn_tpu_torch --dataset Synthetic --bf16 --runs 2 \\
      --epoch 10 --batch_size 1024 --flip_augmentation     # train
  python -m vit_cnn_tpu_torch --dataset Synthetic --model MHST --bf16 \\
      --runs 1 --epoch 2 --batch_size 1024    # train a zoo model
  python -m vit_cnn_tpu_torch --dataset Synthetic --bf16 --serve \\
      --restore checkpoints/.../best_epoch/<file>.msgpack   # serve
  python -m vit_cnn_tpu_torch --dataset Synthetic --pretrain --cos \\
      --radiation_augmentation --mixture_augmentation       # pretrain

Without ``--serve``, :func:`run_experiments` is the JAX run loop
(ref: main.py:377-552): for each of ``--runs`` runs a seeded split,
class balancing, the train / val pipelines, ``Trainer.fit`` (from
``--restore`` when given: a fine-tuning start) with best-epoch and
final-epoch checkpoint files under ``./checkpoints`` of the working
directory, the full-scene map of the best weights, OA/AA/Kappa, the
artifacts (PNG maps, the confusion matrix, the scalar stream) and the
report under ``<out_dir>/<dataset>_<model>/``; then the aggregated report
(mean ± std). stdout carries only JSON: one line a run, and with
``--runs`` > 1 an aggregated line. Status lines and the text reports go
to stderr; the reports also go to ``report.txt``. ``--pretrain`` is
dispatched before ``--serve``, as in the JAX package.

The mesh (:mod:`..parallel.mesh`) engages as the JAX command line's: for
the run loop and ``--serve`` (not ``--pretrain``), when more than one
device is visible and ``--no_mesh`` is off, over ``--n_devices`` of them
(all by default). On the card the visible devices are the CUDA cards, so
one card leaves the mesh off; on the CPU only ``--n_devices`` makes a
mesh (``--device cpu --n_devices 2``: two gloo ranks). This process is
rank 0 and the only one that prints and writes files; a failure on any
rank ends every rank and raises here.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import compute_imf_weights, dataset_names, get_dataset
from ..data.io import open_file
from ..data.normalize import apply_pca
from ..data.sampling import sample_gt
from ..infer.fullscene import full_scene_probabilities
from ..infer.server import SceneServer
from ..metrics import metrics
from ..metrics.report import show_results
from ..models.moco import DualModalEncoder
from ..models.registry import get_model, model_names
from ..nn.layers import init_parameters
from ..parallel.mesh import make_mesh, visible_devices
from ..pipeline.patches import AugmentConfig, PatchPipeline
from ..pipeline.twoview import TwoViewPipeline
from ..train.checkpoint import restore_state_dict
from ..train.loop import Trainer
from ..train.pretrain import Pretrainer
from ..utils import nancheck, profiling
from ..utils.palette import build_palette, convert_to_color
from ..utils.seeding import seed_everything
from ..utils.viz import ArtifactWriter

#: flags of the JAX command line the port does not take: --download,
#: which is not to port (neither host has the network)
LEFT_OUT = ("download",)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train and serve full-scene HSI+LiDAR classification on "
                    "a GPU (PyTorch + CUDA port of vit_cnn_tpu)")
    parser.add_argument("--dataset", type=str, default="MUUFL",
                        choices=dataset_names(), help="Dataset to use.")
    parser.add_argument("--applyPCA", type=bool, default=None,
                        help="optional, if absent will be set by the model "
                             "(HCTnet: 30 whitened PCA components of the "
                             "HSI)")
    parser.add_argument("--model", type=str, default="Multimodality_Mamba",
                        help="Model to train or serve. Available: " +
                             ", ".join(model_names()))
    parser.add_argument("--folder", type=str, default="./Datasets/",
                        help="Folder where the datasets are stored.")
    parser.add_argument("--cuda", type=int, default=0,
                        help="Accepted for reference-CLI compatibility; "
                             "--device selects the card")
    parser.add_argument("--runs", type=int, default=10,
                        help="Number of runs (default: 10)")
    parser.add_argument("--restore", type=str, default=None,
                        help="Checkpoint (.msgpack, the port's or the JAX "
                             "package's) to start training from, or to "
                             "serve")
    parser.add_argument("--seed", type=int, default=1,
                        help="Seed of --serve's random weights without "
                             "--restore (the runs take theirs from the "
                             "run index, as the reference does)")
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
        help="random | fixed | disjoint | random_fixednumber")
    group_dataset.add_argument(
        "--train_set", type=str, default=None,
        help="Path to the train ground truth (supersedes --sampling_mode)")
    group_dataset.add_argument(
        "--test_set", type=str, default=None,
        help="Path to the test set (by default the entire ground truth "
             "minus the training)")
    group_train = parser.add_argument_group("Training")
    group_train.add_argument("--epoch", type=int, default=None,
                             help="Training epochs (model default if absent)")
    group_train.add_argument("--patch_size", type=int, default=None,
                             help="Size of the spatial neighbourhood")
    group_train.add_argument("--lr", type=float, default=None,
                             help="Learning rate (model default if absent)")
    group_train.add_argument("--class_balancing", action="store_true",
                             help="Inverse median frequency class balancing")
    group_train.add_argument("--batch_size", type=int, default=None,
                             help="Batch size (model default if absent)")
    group_train.add_argument("--test_stride", type=int, default=1,
                             help="Sliding window stride during inference")
    group_train.add_argument("--flip_augmentation", action="store_true",
                             help="Random flips (if patch_size > 1)")
    group_train.add_argument("--radiation_augmentation", action="store_true",
                             help="Random radiation noise (illumination)")
    group_train.add_argument("--mixture_augmentation", action="store_true",
                             help="Random mixes between spectra")
    group_train.add_argument("--log_every", type=int, default=10,
                             help="Print loss/val every N epochs (0 = silent)")
    parser.add_argument("--with_exploration", action="store_true",
                        help="Write the per-class mean spectra")
    group_run = parser.add_argument_group("Run")
    group_run.add_argument("--out_dir", type=str, default="./results",
                           help="Artifact directory (replaces Visdom)")
    group_run.add_argument("--strict_seed_parity", type=int, default=1,
                           help="1 (default): reproduce the reference's "
                                "constant seed[2] model seeding "
                                "(ref: main.py:378); 0: per-run seeds")
    group_run.add_argument("--profile_dir", type=str, default=None,
                           help="Write a torch.profiler trace of run 0's "
                                "first training epoch to this directory")
    group_run.add_argument("--n_devices", type=int, default=None,
                           help="Mesh size for data-parallel train/infer "
                                "(default: all visible devices)")
    group_run.add_argument("--no_mesh", action="store_true",
                           help="Force single-device execution")
    group_run.add_argument("--bf16", action="store_true",
                           help="bfloat16 compute policy for the model")
    group_run.add_argument("--infer_chunk", type=int, default=8192,
                           help="Windows per inference band")
    group_run.add_argument("--serve", action="store_true",
                           help="persistent serving mode: answer JSON-line "
                                "full-scene requests on stdin (see "
                                "infer/server.py for the protocol) with "
                                "--restore's weights")
    group_run.add_argument("--device", type=str, default="cuda",
                           help="torch device; 'cuda' raises when CUDA is "
                                "absent (the CPU runs only on --device cpu)")
    group_run.add_argument("--debug_nans", action="store_true",
                           help="Stop training at the first NaN in a "
                                "module's output, a gradient or a parameter "
                                "(FloatingPointError; each check waits for "
                                "the device)")
    group_pre = parser.add_argument_group("Contrastive pretraining")
    group_pre.add_argument("--pretrain", action="store_true",
                           help="Run MoCo contrastive pretraining over all "
                                "interior pixels instead of supervised "
                                "training (ref: model_utils.py:682-851)")
    group_pre.add_argument("--cos", action="store_true",
                           help="Cosine lr schedule during pretraining "
                                "(ref: utils.py:21-30)")
    group_pre.add_argument("--queue_size", type=int, default=2048,
                           help="MoCo negative queue size")
    group_pre.add_argument("--moco_momentum", type=float, default=0.999)
    group_pre.add_argument("--moco_temperature", type=float, default=0.07)
    return parser


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device {}: CUDA is not available (pass "
                           "--device cpu to run the plain versions on the "
                           "CPU)".format(name))
    return device


def _mesh_size(args) -> int:
    """The ranks of the run's mesh, 1 for none: the JAX command line's
    rule (a mesh when more than one device is visible and ``--no_mesh`` is
    off, over ``--n_devices`` of them, all by default). The visible
    devices are the CUDA cards, or on the CPU ``--n_devices``; asking for
    more than are visible raises."""
    if args.no_mesh:
        return 1
    device = _device(args.device)
    visible = (visible_devices(device) if device.type == "cuda"
               else args.n_devices or 1)
    n = args.n_devices or visible
    if n > visible:
        raise ValueError("--n_devices {}: {} CUDA device(s) visible".format(
            n, visible))
    return n if visible > 1 else 1


def _on_mesh(args, fn, *fn_args, here: Optional[Dict] = None):
    """``fn(mesh, *fn_args)`` on every rank of the run's mesh (``here``:
    rank 0's own keyword arguments), or ``fn(None, ...)`` here without
    one; rank 0's result."""
    n = _mesh_size(args)
    if n == 1:
        return fn(None, *fn_args, **(here or {}))
    with make_mesh(n, args.device) as mesh:
        print("mesh: {} devices on 'data'".format(n), file=sys.stderr,
              flush=True)
        return mesh.run(fn, *fn_args, here=here)


def _say(mesh, text: str) -> None:
    """A status line on stderr, from rank 0 only."""
    if mesh is None or mesh.rank == 0:
        print(text, file=sys.stderr, flush=True)


def _hyperparams(args, img1, img2, label_values, ignored_labels):
    hyperparams = {k: v for k, v in vars(args).items() if v is not None}
    hyperparams.update({
        "n_classes": len(label_values),
        "n_bands": (img1.shape[-1], img2.shape[-1]),
        "ignored_labels": list(ignored_labels), "dataset": args.dataset,
    })
    return hyperparams


def run_pretrain(args) -> Dict:
    """MoCo pretraining (``--pretrain``; JAX ``run_pretrain``) on
    ``--device`` in float32, with the reference's moco_based_NNCNet
    defaults (ref: model_utils.py:473-487: patch 9, lr 5e-4, 200 epochs,
    batch 64), flip always on, ``--radiation_augmentation`` /
    ``--mixture_augmentation`` on view 2, the encoder seeded from
    ``--seed``. Best-epoch files under ``./checkpoints/dualmodalencoder/
    <dataset>/pre_train/``. Prints one JSON line (epoch losses, the best
    file) on stdout and returns it as a dict."""
    device = _device(args.device)
    (img1, img2, gt, label_values, ignored_labels, rgb_bands,
     palette) = get_dataset(args.dataset, args.folder)
    hp = {"patch_size": args.patch_size or 9, "lr": args.lr or 5e-4,
          "epoch": args.epoch or 200, "batch_size": args.batch_size or 64,
          "cos": args.cos, "dataset": args.dataset}
    aug = AugmentConfig(flip=True, radiation=args.radiation_augmentation,
                        mixture=args.mixture_augmentation)
    pipe = TwoViewPipeline(img1, img2, gt, hp["patch_size"],
                           list(ignored_labels), len(label_values),
                           augment=aug, device=device)
    encoder = DualModalEncoder(img1.shape[-1], img2.shape[-1], embed_dim=128)
    init_parameters(encoder, args.seed)
    encoder.to(device)
    pre = Pretrainer(encoder, hp, pipe, queue_size=args.queue_size,
                     momentum=args.moco_momentum,
                     temperature=args.moco_temperature, seed=args.seed,
                     savename=args.model)
    pre.fit(run=0, dataset_name=args.dataset, log_every=args.log_every)
    result = {"mode": "pretrain", "dataset": args.dataset,
              "device": str(device), "centers": len(pipe),
              "queue_size": pre.moco.queue.shape[0], "losses": pre.losses,
              "best_checkpoint": pre.best_checkpoint}
    print(json.dumps(result), flush=True)
    return result


def run_serve(args, in_stream=None, out_stream=None,
              state_dict: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """Build the model once, load ``--restore`` into it strictly (or
    ``state_dict``; the seeded random init of ``--seed`` without either)
    before it goes to ``--device``, then answer JSON-line requests until
    EOF or quit, on every rank of the mesh where one engages (this process
    reads the requests and answers). Returns the number of requests
    served."""
    return _on_mesh(args, _serve, args, state_dict,
                    here={"in_stream": in_stream or sys.stdin,
                          "out_stream": out_stream or sys.stdout})


def _serve(mesh, args, state_dict, in_stream=None, out_stream=None) -> int:
    """:func:`run_serve` on one rank of ``mesh`` (or without one)."""
    device = mesh.device if mesh is not None else _device(args.device)
    (img1, img2, gt, label_values, ignored_labels, rgb_bands,
     palette) = get_dataset(args.dataset, args.folder)
    model, spec, hp = get_model(args.model, **_hyperparams(
        args, img1, img2, label_values, ignored_labels))
    if args.restore and state_dict is not None:
        raise ValueError("--restore and a state_dict: pass one")
    if args.restore:
        model.load_state_dict(restore_state_dict(args.restore, model),
                              strict=True)
    elif state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_parameters(model, args.seed)
        _say(mesh, "# --serve without --restore: serving an UNTRAINED "
             "{}".format(args.model))
    model.to(device).eval()

    server = SceneServer(model, hp, ignored_labels=ignored_labels,
                         chunk=args.infer_chunk, mesh=mesh)
    _say(mesh, '# ready: {} on {} ({}) — one JSON request per line, '
         '{{"cmd": "quit"}} ends'.format(args.model, args.dataset, device))
    return server.loop(in_stream, out_stream, img1, img2)


def _load_gt_pair(train_set: Optional[str], test_set: Optional[str],
                  gt: np.ndarray, sampling_mode: str, sample_pct: float,
                  split_seed: int):
    """The train / test ground truths of a run (ref: main.py:379-394,
    the TRLabel / TSLabel fixed-split path)."""
    if train_set is not None and test_set is not None:
        train_gt = np.asarray(open_file(train_set)["TRLabel"])
        test_gt = np.asarray(open_file(test_set)["TSLabel"])
    elif train_set is not None:
        train_gt = np.asarray(open_file(train_set))
        test_gt = np.copy(gt)
        w, h = test_gt.shape
        test_gt[(train_gt > 0)[:w, :h]] = 0
    elif test_set is not None:
        test_gt = np.asarray(open_file(test_set))
        train_gt, _ = sample_gt(gt, sample_pct, mode=sampling_mode,
                                seed=split_seed)
    else:
        train_gt, test_gt = sample_gt(gt, sample_pct, mode=sampling_mode,
                                      seed=split_seed)
    return train_gt.astype(np.int64), test_gt.astype(np.int64)


class _Setup:
    """What every run of :func:`run_experiments` shares: the mesh and the
    device, the scene, the palette, the artifact writer (which has written
    the scene's own artifacts; rank 0's alone writes) and the command
    line's hyperparameters."""

    def __init__(self, args, mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else \
            _device(args.device)
        (self.img1, self.img2, self.gt, self.label_values,
         self.ignored_labels, rgb_bands, palette) = get_dataset(
            args.dataset, args.folder)
        self.palette = palette or build_palette(len(self.label_values))
        self.writer = ArtifactWriter(os.path.join(
            args.out_dir, "{}_{}".format(args.dataset, args.model)),
            enabled=mesh is None or mesh.rank == 0)
        self.writer.save_dataset_rgb(self.img1, rgb_bands)
        self.writer.save_lidar(self.img2)
        self.writer.save_map(convert_to_color(self.gt, self.palette),
                             "Ground truth")
        if args.with_exploration:
            self.writer.explore_spectrums(self.img1, self.gt,
                                          self.label_values,
                                          self.ignored_labels)
        self.hyperparams = _hyperparams(args, self.img1, self.img2,
                                        self.label_values,
                                        self.ignored_labels)


def _run_seeds(args, run: int):
    """(model seed, split seed) of run ``run`` (ref: main.py:378): with
    ``--strict_seed_parity`` every run's model seed is seeds[2] (the last
    seed for fewer than 3 runs, where the reference fails)."""
    seeds = list(range(args.runs))
    parity_seed = seeds[2] if len(seeds) > 2 else seeds[-1]
    return (parity_seed if args.strict_seed_parity else seeds[run]), \
        seeds[run]


def run_train(args, state_dict: Optional[Dict[str, torch.Tensor]] = None,
              run: int = 0) -> Dict:
    """Run ``run`` of :func:`run_experiments`: seed everything with the
    run's model seed, split with its split seed, build the model (from
    ``state_dict``, else the seeded random init of the model seed; then
    ``--restore`` over it), train on ``--device`` writing the checkpoint
    files, map the scene with the best weights in a model of their own,
    score it against the test split, write the artifacts and the report,
    on every rank of the mesh where one engages. Prints one JSON line on
    stdout and returns it as a dict."""
    return _on_mesh(args, _train_one, args, state_dict, run)


def _train_one(mesh, args, state_dict, run: int) -> Dict:
    """:func:`run_train` on one rank of ``mesh`` (or without one)."""
    return _run(args, state_dict, run, _Setup(args, mesh))[0]


def _run(args, state_dict, run: int, setup: _Setup):
    """:func:`run_train` on a given setup; returns (the JSON dict, the
    run's metrics dict)."""
    img1, img2, gt = setup.img1, setup.img2, setup.gt
    n_classes = len(setup.label_values)
    writer, palette, mesh = setup.writer, setup.palette, setup.mesh
    lead = mesh is None or mesh.rank == 0
    model_seed, split_seed = _run_seeds(args, run)
    seed_everything(model_seed)
    train_gt, test_gt = _load_gt_pair(
        args.train_set, args.test_set, gt, args.sampling_mode,
        args.training_sample, split_seed=split_seed)
    _say(mesh, "{} samples selected (over {})".format(
        np.count_nonzero(train_gt), np.count_nonzero(gt)))
    _say(mesh, "Running an experiment with the {} model run {}/{}".format(
        args.model, run + 1, args.runs))
    writer.save_map(convert_to_color(train_gt, palette),
                    "Train ground truth", run=run)
    writer.save_map(convert_to_color(test_gt, palette), "Test ground truth",
                    run=run)

    hp = dict(setup.hyperparams)
    if args.class_balancing:
        hp["weights"] = compute_imf_weights(train_gt, n_classes,
                                            setup.ignored_labels)
    model, spec, hp = get_model(args.model, **hp)
    if args.train_val_split != 1:
        train_gt, val_gt = sample_gt(train_gt, args.train_val_split,
                                     mode="random")
    else:
        val_gt = sample_gt(train_gt, 0.95, mode="random")[1]

    device = setup.device
    # a PCA model trains on the whitened PCA of the HSI; the full-scene
    # map below reduces the scene itself (infer/fullscene.py)
    img1_model = (apply_pca(img1, int(hp["pca_components"]))
                  if hp.get("applyPCA") else img1)
    aug = AugmentConfig(flip=hp.get("flip_augmentation", False),
                        radiation=hp.get("radiation_augmentation", False),
                        mixture=hp.get("mixture_augmentation", False))
    pipe = PatchPipeline(img1_model, img2, train_gt, hp["patch_size"],
                         hp["ignored_labels"], n_classes, augment=aug,
                         supervision=hp.get("supervision", "full"),
                         device=device)
    val_pipe = PatchPipeline(img1_model, img2, val_gt, hp["patch_size"],
                             hp["ignored_labels"], n_classes, device=device)
    if state_dict is None:
        init_parameters(model, model_seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    if args.restore:
        model.load_state_dict(restore_state_dict(args.restore, model),
                              strict=True)
    model.to(device)
    trainer = Trainer(model, hp, pipe, val_pipeline=val_pipe,
                      seed=model_seed, savename=args.model, mesh=mesh)

    trace = args.profile_dir and run == 0 and lead
    prof = profiling.start_trace(args.profile_dir) if trace else None

    def on_epoch_end(epoch, loss, metric):
        nonlocal prof
        writer.log_scalars(epoch, {"loss": loss, "val_metric": metric},
                           run=run)
        if prof is not None:                  # the trace covers epoch 1
            profiling.stop_trace(prof, args.profile_dir)
            prof = None

    try:
        best = trainer.fit(run=run, dataset_name=args.dataset,
                           log_every=args.log_every,
                           on_epoch_end=on_epoch_end)
    except KeyboardInterrupt:
        best = {k: v.detach().to("cpu", copy=True)
                for k, v in model.state_dict().items()}
    finally:
        if prof is not None:
            profiling.stop_trace(prof, args.profile_dir)

    served, _, _ = get_model(args.model, **hp)
    served.load_state_dict(best, strict=True)
    served.to(device).eval()
    if args.debug_nans:
        nancheck.watch(served)
    probabilities = full_scene_probabilities(served, img1, img2, hp,
                                             chunk=args.infer_chunk,
                                             mesh=mesh)
    prediction = np.argmax(probabilities, axis=-1)
    run_metrics = metrics(prediction, test_gt,
                          ignored_labels=hp["ignored_labels"],
                          n_classes=n_classes)

    writer.save_map(convert_to_color(prediction, palette),
                    "Prediction_All run{}".format(run))
    mask = np.isin(gt, setup.ignored_labels)
    prediction[mask] = 0
    writer.save_map(convert_to_color(prediction, palette),
                    "Prediction run{}".format(run))
    writer.save_confusion_matrix(run_metrics["Confusion matrix"], run=run)
    if lead:
        writer.save_report(show_results(run, run_metrics,
                                        label_values=setup.label_values,
                                        file=sys.stderr))

    log = trainer.log
    result = {
        "run": run, "model": args.model, "dataset": args.dataset,
        "device": str(device), "model_seed": model_seed,
        "train_samples": len(pipe), "epochs": len(log.losses),
        "losses": log.losses, "val_accuracies": log.val_accuracies,
        "patches_per_s": len(pipe) * len(log.losses)
        / max(sum(log.epoch_seconds), 1e-9),
        "OA": float(run_metrics["Accuracy"]), "AA": float(run_metrics["AA"]),
        "Kappa": float(run_metrics["Kappa"]),
        "best_checkpoint": trainer.best_checkpoint,
        "final_checkpoint": trainer.final_checkpoint,
    }
    if lead:
        print(json.dumps(result), flush=True)
    return result, run_metrics


def run_experiments(args, state_dict: Optional[Dict[str, torch.Tensor]] = None
                    ) -> List[Dict]:
    """The reference's run loop (ref: main.py:377-552): ``--runs`` runs of
    :func:`run_train`, then with more than one the aggregated report and
    one JSON line with the mean and std of OA, AA and Kappa, on every rank
    of the mesh where one engages. Returns the runs' result dicts."""
    return _on_mesh(args, _experiments, args, state_dict)


def _experiments(mesh, args, state_dict) -> List[Dict]:
    """:func:`run_experiments` on one rank of ``mesh`` (or without one)."""
    setup = _Setup(args, mesh)
    results, all_metrics = zip(*[_run(args, state_dict, run, setup)
                                 for run in range(args.runs)])
    if args.runs > 1 and (mesh is None or mesh.rank == 0):
        setup.writer.save_report(show_results(
            args.runs - 1, list(all_metrics),
            label_values=setup.label_values,
            agregated=True, file=sys.stderr))
        summary = {"runs": args.runs, "model": args.model,
                   "dataset": args.dataset}
        for key in ("OA", "AA", "Kappa"):
            values = [r[key] for r in results]
            summary[key + "_mean"] = float(np.mean(values))
            summary[key + "_std"] = float(np.std(values))
        print(json.dumps(summary), flush=True)
    return list(results)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.pretrain:
        return run_pretrain(args)
    if args.serve:
        return run_serve(args)
    return run_experiments(args)
