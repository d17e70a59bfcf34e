"""Model registry: name -> (constructor, default hyperparameters).

Port of :mod:`vit_cnn_tpu.models.registry` for the models ported so far.
``get_model`` fills hyperparameters with the same setdefault semantics
and returns (module, spec, filled hyperparameters); the module's
parameters are empty until :func:`vit_cnn_tpu_torch.nn.layers.
init_parameters` or ``load_state_dict`` fills them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    build: Callable  # (hp: dict) -> nn.Module
    loss: str = "cross_entropy"
    patch_size: int = 7
    lr: float = 1e-3
    optimizer: str = "adam"
    weight_decay: float = 0.0
    epochs: int = 150
    batch_size: int = 64
    apply_pca: bool = False
    pca_components: int = 3
    center_pixel: bool = True
    supervision: str = "full"


def _build_mm_mamba(hp):
    from .mm_mamba import MultimodalityMamba

    return MultimodalityMamba(img_size=hp["patch_size"],
                              in_channels1=hp["n_bands"][0],
                              in_channels2=hp["n_bands"][1],
                              dim_embedding=32,
                              n_classes=hp["n_classes"])


MODELS: Dict[str, ModelSpec] = {
    "Multimodality_Mamba": ModelSpec("Multimodality_Mamba", _build_mm_mamba,
                                     patch_size=9, lr=8e-4,
                                     optimizer="adamw", epochs=200),
}


def model_names():
    return list(MODELS.keys())


def get_model(name: str, **kwargs):
    if name not in MODELS:
        raise KeyError(
            "{} is not ported to PyTorch yet (ported: {}); the rest of the "
            "zoo is ROADMAP Queue 1, items 9-11".format(name, model_names()))
    spec = MODELS[name]
    kwargs.setdefault("patch_size", spec.patch_size)
    kwargs.setdefault("lr", spec.lr)
    kwargs.setdefault("epoch", spec.epochs)
    kwargs.setdefault("batch_size", spec.batch_size)
    kwargs.setdefault("applyPCA", spec.apply_pca)
    kwargs.setdefault("pca_components", spec.pca_components)
    kwargs.setdefault("optimizer", spec.optimizer)
    kwargs.setdefault("weight_decay", spec.weight_decay)
    kwargs.setdefault("loss", spec.loss)
    kwargs.setdefault("supervision", spec.supervision)
    kwargs["center_pixel"] = spec.center_pixel
    return spec.build(kwargs), spec, kwargs
