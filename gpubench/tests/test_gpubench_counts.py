"""The frozen counts equal a recount at a small batch, from the program's
state_dict shapes."""

import pytest

from gpubench import layout

CONFIGS = [c["name"] for c in layout.benchmark()["configs"]]


def shapes(config):
    from vit_cnn_tpu_torch.models.registry import get_model

    cfg = layout.cell([w for w in layout.benchmark()["workloads"]
                       if w["config"] == config][0]["name"])["config"]
    net = get_model(cfg["model"], n_classes=cfg["n_classes"],
                    n_bands=(cfg["hsi_bands"], cfg["lidar_bands"]),
                    ignored_labels=[0])[0]
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("batch", [1, 2])
def test_frozen_counts_equal_a_recount(config, batch):
    counts = layout.module("counts", config)
    got = counts.recount(layout.module("reference", config), shapes(config),
                         batch=batch)
    for key, value in got.items():
        assert getattr(counts, key) == pytest.approx(value, rel=1e-12), key


def test_k1_bound_of_a_band():
    counts = layout.module("counts", "mamba-h13")
    # stage 1 forward, 6 streams: exps bound it at the table's 1.012 ms
    assert counts.k1_least_seconds(7588) == pytest.approx(
        counts.K1_LEAST_S_PER_BAND)
    assert 3.4e-3 < counts.K1_LEAST_S_PER_BAND < 3.6e-3
    assert counts.k1_least_seconds(2 * 7588) == pytest.approx(
        2 * counts.K1_LEAST_S_PER_BAND, rel=1e-6)
