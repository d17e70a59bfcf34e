"""Model registry: name -> (constructor, default hyperparameters).

Port of :mod:`vit_cnn_tpu.models.registry`, every model of it: the
flagship, the transformer zoo (SpectralFormer, S2EFT, MHST, GLT_Net) and
the CNN zoo (EndNet, the four Hong fusion CNNs, FusAtNet, S2ENet, MFT,
HCTnet), each with its registry loss, optimizer and PCA policy.
``get_model`` fills hyperparameters with the same setdefault semantics
and returns (module, spec, filled hyperparameters), the module built for
``pca_components`` HSI bands where ``applyPCA`` is set; the module's
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


def _build_endnet(hp):
    from .endnet import EndNet

    return EndNet(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                  n_classes=hp["n_classes"])


def _build_mdl_hong(kind):
    def build(hp):
        from . import mdl_hong

        cls = getattr(mdl_hong, kind + "_fusion_CNN")
        return cls(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                   n_classes=hp["n_classes"])

    return build


def _build_fusatnet(hp):
    from .fusatnet import FusAtNet

    return FusAtNet(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                    n_classes=hp["n_classes"])


def _build_s2enet(hp):
    from .s2enet import S2ENet

    return S2ENet(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                  n_classes=hp["n_classes"], patch_size=hp["patch_size"])


def _build_mft(hp):
    from .mft import MFT

    return MFT(patch_size=hp["patch_size"], fm=16, n_bands1=hp["n_bands"][0],
               n_bands2=hp["n_bands"][1], n_classes=hp["n_classes"])


def _build_hctnet(hp):
    from .hctnet import HCTnet

    return HCTnet(n_bands1=hp["n_bands"][0], n_bands2=hp["n_bands"][1],
                  n_classes=hp["n_classes"], num_tokens=6, heads=8)


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
    "EndNet": ModelSpec("EndNet", _build_endnet, loss="endnet", patch_size=1,
                        lr=1e-3, epochs=150),                       # :119-128
    "Early_fusion_CNN": ModelSpec("Early_fusion_CNN",
                                  _build_mdl_hong("Early"), patch_size=7,
                                  lr=1e-3, epochs=150),             # :69-78
    "Middle_fusion_CNN": ModelSpec("Middle_fusion_CNN",
                                   _build_mdl_hong("Middle"), patch_size=7,
                                   lr=1e-3, epochs=150),            # :79-88
    "Late_fusion_CNN": ModelSpec("Late_fusion_CNN",
                                 _build_mdl_hong("Late"), patch_size=7,
                                 lr=1e-3, epochs=150),              # :89-98
    "Cross_fusion_CNN": ModelSpec("Cross_fusion_CNN",
                                  _build_mdl_hong("Cross"),
                                  loss="cross_fusion", patch_size=7,
                                  lr=1e-3, epochs=150),             # :99-108
    "FusAtNet": ModelSpec("FusAtNet", _build_fusatnet, patch_size=11,
                          lr=1e-3, epochs=150),                     # :109-118
    "S2ENet": ModelSpec("S2ENet", _build_s2enet, patch_size=7, lr=1e-3,
                        epochs=128),                                # :129-138
    "MFT": ModelSpec("MFT", _build_mft, patch_size=11, lr=5e-4,
                     optimizer="adam", weight_decay=5e-3,
                     epochs=500),                                   # :364-376
    "HCTnet": ModelSpec("HCTnet", _build_hctnet, patch_size=11, lr=1e-4,
                        epochs=100, apply_pca=True,
                        pca_components=30),                         # :351-363
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
        raise KeyError("{} model is unknown.".format(name))
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
    # a PCA model is built for the reduced HSI, as the JAX CLI inits it at
    # pca_components channels (vit_cnn_tpu/cli/__init__.py:219-222)
    built = (dict(kwargs, n_bands=(int(kwargs["pca_components"]),
                                   kwargs["n_bands"][1]))
             if kwargs["applyPCA"] else kwargs)
    return spec.build(built), spec, kwargs
