"""Model registry: name -> (constructor, default hyperparameters).

Port of :mod:`vit_cnn_tpu.models.registry` for the models ported so far:
the flagship and the transformer zoo (SpectralFormer, S2EFT, MHST,
GLT_Net), each with its registry loss and optimizer.
``get_model`` fills hyperparameters with the same setdefault semantics
and returns (module, spec, filled hyperparameters); the module's
parameters are empty until :func:`vit_cnn_tpu_torch.nn.layers.
init_parameters` or ``load_state_dict`` fills them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np


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


def _build_spectralformer(hp):
    from .spectralformer import SpectralFormer

    return SpectralFormer(num_patches=hp["n_bands"][0] + hp["n_bands"][1],
                          n_classes=hp["n_classes"], dim=64, depth=5,
                          heads=4, mlp_dim=8, dropout=0.1, emb_dropout=0.1,
                          mode="ViT")


def _build_s2eft(hp):
    from .s2eft import S2EFT

    return S2EFT(num_patches=hp["n_bands"][0], patch_size=hp["patch_size"],
                 n_classes=hp["n_classes"], dim=64, depth=5, heads=4,
                 mlp_dim=8, dropout=0.1, emb_dropout=0.1, mode="CAF",
                 near_band=3)


def _build_mhst(hp):
    from .mhst import MHST

    return MHST(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                patch_size=hp["patch_size"], n_classes=hp["n_classes"],
                encoder_embed_dim=64, en_depth=5, en_heads=4, mlp_dim=8,
                dropout=0.1, emb_dropout=0.1, coefficient_hsi=0.6,
                coefficient_vit=0.7, hsp_vit_depth=8, hsp_vit_num_heads=16,
                head_tau=5.0)


def _build_glt(hp):
    from .glt_net import GLTNet

    return GLTNet(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                  patch_size=hp["patch_size"], n_classes=hp["n_classes"],
                  encoder_embed_dim=64,
                  decoder_embed_dim=32, en_depth=5, en_heads=4, de_depth=5,
                  de_heads=4, mlp_dim=8, dropout=0.1, emb_dropout=0.1)


# defaults cited from ref: model_utils.py (line ranges per entry)
MODELS: Dict[str, ModelSpec] = {
    "SpectralFormer": ModelSpec("SpectralFormer", _build_spectralformer,
                                patch_size=1, lr=5e-4,
                                epochs=300),                        # :377-399
    "S2EFT": ModelSpec("S2EFT", _build_s2eft, patch_size=7, lr=5e-4,
                       epochs=600),                                 # :400-423
    "MHST": ModelSpec("MHST", _build_mhst, patch_size=8, lr=8e-4,
                      optimizer="adamw", epochs=1000),              # :314-335
    "GLT_Net": ModelSpec("GLT_Net", _build_glt, loss="glt", patch_size=8,
                         lr=5e-4, optimizer="adamw", epochs=200),   # :336-350
    "Multimodality_Mamba": ModelSpec("Multimodality_Mamba", _build_mm_mamba,
                                     patch_size=9, lr=8e-4,
                                     optimizer="adamw",
                                     epochs=200),                   # :297-313
}


def model_names():
    return list(MODELS.keys())


def get_model(name: str, **kwargs):
    if name not in MODELS:
        raise KeyError(
            "{} is not ported to PyTorch yet (ported: {}); the CNN zoo "
            "is ROADMAP Queue 1, 'CNN zoo'".format(name, model_names()))
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
    kwargs.setdefault("flip_augmentation", False)
    kwargs.setdefault("radiation_augmentation", False)
    kwargs.setdefault("mixture_augmentation", False)
    kwargs["center_pixel"] = spec.center_pixel

    # class weights zeroing ignored labels (ref: model_utils.py:60-66)
    n_classes = kwargs["n_classes"]
    if "weights" not in kwargs:
        weights = np.ones(n_classes, dtype=np.float32)
        for label in kwargs.get("ignored_labels", []):
            if 0 <= label < n_classes:
                weights[label] = 0.0
        kwargs["weights"] = weights
    return spec.build(kwargs), spec, kwargs
