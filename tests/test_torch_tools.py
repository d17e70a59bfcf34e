"""The port's measurement scripts (vit_cnn_tpu_torch.tools) on the CPU, at
a tiny Synthetic scene: 24 x 40, 20 bands, 6 classes.

The conditioning script's CPU pair (default threads against one thread)
must run and report a spread; on this tiny step it stays below 1e-3 of
each gradient's scale. The profiler's family names must sort the kernel
names the profile meets.
"""

import json

import pytest
import torch

from vit_cnn_tpu_torch import tools
from vit_cnn_tpu_torch.tools import profile_train, train_conditioning

TINY = {"VCT_SYN_H": "24", "VCT_SYN_W": "40", "VCT_SYN_BANDS": "20",
        "VCT_SYN_CLASSES": "6"}


@pytest.fixture
def tiny_scene(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(tools.SCENE, k, v)
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(train_conditioning, "BATCH", 8)


def test_train_conditioning_cpu(tiny_scene, capsys):
    train_conditioning.main()
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0]["losses"]["cpu"] == pytest.approx(
        lines[0]["losses"]["cpu 1 thread"], rel=1e-5)
    (pair,) = lines[1:]
    assert pair["pair"] == "cpu 1 thread vs cpu"
    assert pair["gradients"] > 50
    assert pair["max_rel"] < 1e-3 and pair["norm_rel"] < 1e-3


def test_flagship_step_cpu(tiny_scene):
    scene = tools.load_scene(crop=(20, 30))
    assert scene[0].shape == (20, 30, 20) and scene[2].shape == (20, 30)
    trainer, args = tools.flagship_step(scene, tools.flagship_state(scene),
                                        "cpu", 4, flip=True)
    before = {k: p.detach().clone() for k, p in
              trainer.model.named_parameters()}
    loss = trainer._step(*args)
    assert torch.isfinite(loss)
    moved = [k for k, p in trainer.model.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(before)


@pytest.mark.parametrize("kernel,family", [
    ("selective_scan_bwd_kernel<16>", "K5 scan backward"),
    ("selective_scan_kernel<float>", "K1 scan forward"),
    ("dir_conv_silu_bwd_kernel", "K6 dir_conv backward"),
    ("inv_perm_weighted_sum_bwd_kernel", "K7 inv-sum backward"),
    ("sum_partials_kernel", "K5-K7 partial sums"),
    ("nvjet_tst_128x64", "GEMM"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise/copy/cast"),
    ("multi_tensor_apply_kernel", "optimizer"),
])
def test_profile_families(kernel, family):
    assert profile_train.family(kernel) == family
