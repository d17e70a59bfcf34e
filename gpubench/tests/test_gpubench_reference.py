"""Each reference against the port's plain path, float32 on the CPU, on
seeded weights and a few windows at the configuration's widths."""

import pytest
import torch

from gpubench import layout, weights


def serving_cells():
    """Each configuration of ``BENCHMARK.json`` that has a reference, with
    its first serving cell."""
    bench, out = layout.benchmark(), {}
    for w in bench["workloads"]:
        ref = layout.HERE / "reference" / (w["config"] + ".py")
        if (w["config"] not in out and ref.exists()
                and layout.cell(w["name"], bench)["traffic"]["kind"]
                == "serve"):
            out[w["config"]] = w["name"]
    return out


CELLS = serving_cells()


def program(config):
    from vit_cnn_tpu_torch.models.registry import get_model

    cfg = layout.cell(CELLS[config])["config"]
    net = get_model(cfg["model"], n_classes=cfg["n_classes"],
                    n_bands=(cfg["hsi_bands"], cfg["lidar_bands"]),
                    ignored_labels=[0])[0]
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    sd = weights.seeded_state(shapes, 3, "cpu")
    net.load_state_dict(sd)
    return cfg, net, sd


def windows(cfg, batch, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = cfg["patch_size"]
    return (torch.rand((batch, p, p, cfg["hsi_bands"]), generator=g),
            torch.rand((batch, p, p, cfg["lidar_bands"]), generator=g))


@pytest.mark.parametrize("config", sorted(CELLS))
def test_reference_equals_the_plain_path(config):
    torch.manual_seed(0)
    cfg, net, sd = program(config)
    x1, x2 = windows(cfg, 3)
    with torch.no_grad():
        want = net.eval()(x1, x2)
    got = layout.module("reference", config).forward(sd, x1, x2)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_fusatnet_train_reference_equals_the_plain_step():
    cfg, net, sd = program("fusatnet-h13")
    x1, x2 = windows(cfg, 4, seed=1)
    net.train()
    want = net(x1, x2)
    want.square().sum().backward()
    ref = layout.module("reference", "fusatnet-h13")
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    params = {k: v.clone().requires_grad_() for k, v in sd.items()
              if k not in stats}
    got, new_stats = ref.train_forward({**sd, **params}, x1, x2)
    grads = torch.autograd.grad(got.square().sum(), list(params.values()))
    got, want = got.detach(), want.detach()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(
        want.abs().max()))
    state = net.state_dict()
    for k in stats:
        assert torch.allclose(new_stats[k], state[k], rtol=1e-5, atol=1e-6)
    named = dict(net.named_parameters())
    for k, g in zip(params, grads):
        w = named[k].grad
        assert float((g - w).norm()) <= 1e-4 * max(float(w.norm()), 1e-3), k
