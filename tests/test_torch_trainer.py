"""The port's Trainer and training CLI against the JAX package, on the CPU.

A two-epoch loss trajectory: the port's ``Trainer`` and the JAX
``Trainer`` start from the same seeded flax variables, shuffle with the
same ``np.random.RandomState`` and train the flagship (patch 9, 20 bands,
5 classes) on a tiny Synthetic scene, augmentation off, with a padded
last batch each epoch. Then ``run_train`` through the CLI, and the
best-epoch rule of ``fit``.

Both sides run the trajectory in float64 (JAX under ``enable_x64``, the
port's plain path in float64). In float32 the flagship's gradients are
ill-conditioned (tests/test_torch_train_step.py), and AdamW's first steps
move every weight by about the learning rate whatever the size of its
gradient, so a rounding-level difference in a vanishing gradient becomes
a full step: the two float32 trajectories part by ~1e-2 within two
epochs. In float64 they agree to rtol 1e-6 on each epoch's mean loss
(rounding through ~10 AdamW steps, with margin).
"""

import json

import flax
import jax
import numpy as np
import pytest
import torch

from vit_cnn_tpu.data.registry import get_dataset
from vit_cnn_tpu.models.registry import get_model as jax_get_model
from vit_cnn_tpu.pipeline.patches import PatchPipeline as JaxPipeline
from vit_cnn_tpu.train.loop import Trainer as JaxTrainer
from vit_cnn_tpu_torch.cli import build_parser, main, run_train
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_variables
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.pipeline.patches import PatchPipeline
from vit_cnn_tpu_torch.train.loop import Trainer

SCENE = {"VCT_SYN_H": "17", "VCT_SYN_W": "21", "VCT_SYN_BANDS": "20",
         "VCT_SYN_CLASSES": "5"}
TRAJ_RTOL = 1e-6


@pytest.fixture
def scene(monkeypatch, tmp_path):
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    img1, img2, gt = get_dataset("Synthetic", str(tmp_path))[:3]
    return img1, img2, gt


def test_two_epoch_trajectory_matches_jax(scene):
    img1, img2, gt = scene
    kw = dict(dataset="Synthetic", n_classes=5, n_bands=(20, 1),
              ignored_labels=[0], batch_size=32, epoch=2, lr=1e-3)
    with jax.enable_x64(True):
        jm, _, jhp = jax_get_model("Multimodality_Mamba", **kw)
        jpipe = JaxPipeline(img1, img2, gt, 9, [0], 5)
        jpipe.to_compute_dtype(jax.numpy.float64)
        jtrainer = JaxTrainer(jm, jhp, jpipe, seed=3, save_checkpoints=False)
        tree = seeded_variables(flax.core.unfreeze(jax.device_get(
            jtrainer.state.variables)), seed=0)
        as64 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), t)
        jtrainer.state = jtrainer.state.replace(
            params=as64(tree["params"]), batch_stats=as64(tree["batch_stats"]))
        jtrainer.fit()

    model, _, hp = get_model("Multimodality_Mamba", **kw)
    model.load_state_dict(flax_to_state_dict(tree, model))
    pipe = PatchPipeline(img1, img2, gt, 9, [0], 5)
    pipe.to_compute_dtype(torch.float64)
    assert len(pipe) % 32                         # a padded last batch
    trainer = Trainer(model.double(), hp, pipe, seed=3,
                      save_checkpoints=False)
    trainer.fit()
    assert len(trainer.log.losses) == 2
    np.testing.assert_allclose(trainer.log.losses, jtrainer.log.losses,
                               rtol=TRAJ_RTOL)
    assert trainer.log.losses[1] < trainer.log.losses[0]


def test_fit_keeps_the_best_epoch_with_ties_to_the_later(scene):
    """``abs(metric) >= best``: the best state is the later of two equal
    val accuracies, and fit returns host copies of it."""
    img1, img2, gt = scene
    model, _, hp = get_model("Multimodality_Mamba", n_classes=5,
                             n_bands=(20, 1), ignored_labels=[0],
                             batch_size=32, epoch=2)
    from vit_cnn_tpu_torch.nn.layers import init_parameters

    init_parameters(model, 0)
    pipe = PatchPipeline(img1, img2, gt, 9, [0], 5)
    trainer = Trainer(model, hp, pipe, val_pipeline=pipe, seed=0,
                      save_checkpoints=False)
    trainer.validate = lambda: 0.5                # a tie every epoch
    states = []
    best = trainer.fit(on_epoch_end=lambda e, loss, m: states.append(
        {k: v.clone() for k, v in model.state_dict().items()}))
    assert all(v.device.type == "cpu" for v in best.values())
    for k, v in best.items():
        torch.testing.assert_close(v, states[-1][k], rtol=0, atol=0)


def test_cli_trains_on_the_cpu(scene, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)           # ./checkpoints and ./results
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--epoch", "1", "--batch_size", "32", "--training_sample",
        "30", "--flip_augmentation", "--bf16", "--infer_chunk", "128",
        "--log_every", "1"])
    result = run_train(args)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    assert result["epochs"] == 1 and np.isfinite(result["losses"]).all()
    assert 0.0 <= result["OA"] <= 100.0 and result["patches_per_s"] > 0
    assert len(result["val_accuracies"]) == 1


def test_cli_without_serve_trains(monkeypatch):
    seen = []
    monkeypatch.setattr("vit_cnn_tpu_torch.cli.run_experiments",
                        lambda args: seen.append(args.epoch) or [])
    main(["--dataset", "Synthetic", "--device", "cpu", "--epoch", "3"])
    assert seen == [3]


def test_cli_train_refuses_a_missing_card(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = build_parser().parse_args(["--dataset", "Synthetic"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_train(args)
