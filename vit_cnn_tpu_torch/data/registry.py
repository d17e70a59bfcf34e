"""Dataset registry and loaders (the port's copy of
:mod:`vit_cnn_tpu.data.registry`, ref: datasets.py:24-458).

``get_dataset`` returns the reference's 7-tuple ``(img1, img2, gt,
label_values, ignored_labels, rgb_bands, palette)`` with img1 / img2
(H, W, C) float32 in [0, 1] and gt (H, W) int64. The built-in
``Synthetic`` scene needs no files; its size comes from the environment
(``VCT_SYN_{H,W,BANDS,CLASSES}``), read when the scene is loaded.

Left out of the copy: downloading missing files (the port runs without a
network; place the files in ``<folder>/<name>/``) and the
``custom_datasets`` plugin hook.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .io import open_file
from .normalize import filter_nan, minmax_global, minmax_per_band

LoaderFn = Callable[[str], Tuple[np.ndarray, np.ndarray, np.ndarray]]


@dataclasses.dataclass
class DatasetSpec:
    """Static description of one dataset (file names, .mat keys, classes).
    ``label_values`` may be a callable that returns them at load time."""

    name: str
    label_values: Union[List[str], Callable[[], List[str]]]
    rgb_bands: Tuple[int, int, int]
    # (filename, mat key) for each raster; ignored when `loader` is given
    hsi_file: Optional[Tuple[str, str]] = None
    lidar_file: Optional[Tuple[str, str]] = None
    gt_file: Optional[Tuple[str, str]] = None
    # per-band minmax for LiDAR instead of global (MUUFL, ref:
    # datasets.py:328-332; all others use one global min/max)
    lidar_per_band: bool = False
    ignored_labels: Tuple[int, ...] = (0,)
    loader: Optional[LoaderFn] = None  # custom loader(folder) -> rasters


def _muufl_loader(folder: str):
    """MUUFL ships one nested MATLAB struct (ref: datasets.py:309-319)."""
    mat = open_file(os.path.join(folder, "muufl.mat"))["hsi"]
    img1 = mat["Data"][0][0].astype(np.float32)
    img2 = mat["Lidar"][0, 0][0, 0]["z"][0, 0][:, :, 0].astype(np.float32)
    img2 = np.expand_dims(img2, axis=2)
    gt = np.array(mat["sceneLabels"][0][0]["labels"][0][0])
    gt[gt == -1] = 0
    return img1, img2, gt


def _synthetic_classes() -> int:
    return int(os.environ.get("VCT_SYN_CLASSES", 15))


def _synthetic_loader(folder: str):
    """Deterministic synthetic scene (no files): spatially coherent class
    blobs, class-dependent spectra plus noise. Defaults to a small
    Houston2013-like scene (64 x 64, 144 bands, 15 classes)."""
    h = int(os.environ.get("VCT_SYN_H", 64))
    w = int(os.environ.get("VCT_SYN_W", 64))
    bands = int(os.environ.get("VCT_SYN_BANDS", 144))
    n_cls = _synthetic_classes()
    rng = np.random.RandomState(0)
    # n_cls counts label 0 ("Unclassified"): real classes are 1..n_cls-1
    yy, xx = np.mgrid[0:h, 0:w]
    n_real = max(n_cls - 1, 1)
    gt = (1 + ((xx * n_real) // w + (yy * 3) // h) % n_real).astype(np.int64)
    gt[rng.rand(h, w) < 0.1] = 0
    means = rng.rand(n_cls, bands).astype(np.float32)
    img1 = means[gt] + 0.05 * rng.randn(h, w, bands).astype(np.float32)
    img2 = (gt[..., None].astype(np.float32) / n_cls
            + 0.05 * rng.randn(h, w, 1).astype(np.float32))
    return img1, img2, gt


_H2013_LABELS = [
    "Unclassified", "Healthy grass", "Stressed grass", "Synthetic grass",
    "Trees", "Soil", "Water", "Residential", "Commercial", "Road", "Highway",
    "Railway", "Parking Lot 1", "Parking Lot 2", "Tennis Court",
    "Running Track",
]

_H2018_LABELS = [
    "Unclassified", "Healthy grass", "Stressed grass", "Artificial turf",
    "Evengreen trees", "Deciduous trees", "Bare earth", "Water",
    "Residential buildings", "Non-residential buildings ", "Roads",
    "Sidewalks", "Crosswalks", "Major thoroughfares", "Highway", "Railway",
    "Paved parking lots", "Unpaved parking lots", "Cars", "Trains",
    "Stadium seats",
]

_TRENTO_LABELS = [
    "Unclassified", "Apple trees", "Buildings", "Ground", "Wood", "Vineyard",
    "Roads",
]

_AUGSBURG_LABELS = [
    "Unclassified", "Forest", "Residential Area", "Industrial Area",
    "Low Plants", "Allotment", "Commercial Area", "Water",
]

_MUUFL_LABELS = [
    "Unclassified", "Trees", "Mostly grass", "Mixed ground surface",
    "Dirt and sand", "Road", "Water", "Buildings shadow", "Buildings",
    "Sidewalk", "Yellow curb", "Cloth panels",
]

_IP_LABELS = [
    "Unclassified", "Alfalfa", "Corn-notill", "Corn-mintill", "Corn",
    "Grass-pasture", "Grass-trees", "Grass-pasture-mowed", "Hay-windrowed",
    "Oats", "Soybean-notill", "Soybean-mintill", "Soybean-clean", "Wheat",
    "Woods", "Buildings-Grass-Trees-Drives", "Stone-Steel-Towers",
]

_SALINAS_LABELS = [
    "Undefined", "Brocoli_green_weeds_1", "Brocoli_green_weeds_2", "Fallow",
    "Fallow_rough_plow", "Fallow_smooth", "Stubble", "Celery",
    "Grapes_untrained", "Soil_vinyard_develop", "Corn_senesced_green_weeds",
    "Lettuce_romaine_4wk", "Lettuce_romaine_5wk", "Lettuce_romaine_6wk",
    "Lettuce_romaine_7wk", "Vinyard_untrained", "Vinyard_vertical_trellis",
]

_PAVIAU_LABELS = [
    "Undefined", "Asphalt", "Meadows", "Gravel", "Trees",
    "Painted metal sheets", "Bare Soil", "Bitumen", "Self-Blocking Bricks",
    "Shadows",
]

DATASETS: Dict[str, DatasetSpec] = {
    "Houston2013": DatasetSpec(
        name="Houston2013", label_values=_H2013_LABELS, rgb_bands=(59, 40, 23),
        hsi_file=("HSI.mat", "HSI"), lidar_file=("LiDAR.mat", "LiDAR"),
        gt_file=("gt.mat", "gt"),
    ),
    "Houston2018": DatasetSpec(
        name="Houston2018", label_values=_H2018_LABELS, rgb_bands=(49, 30, 23),
        hsi_file=("houston_hsi.mat", "houston_hsi"),
        lidar_file=("houston_lidar.mat", "houston_lidar"),
        gt_file=("houston_gt.mat", "houston_gt"),
    ),
    "Trento": DatasetSpec(
        name="Trento", label_values=_TRENTO_LABELS, rgb_bands=(40, 20, 10),
        hsi_file=("HSI.mat", "HSI"), lidar_file=("LiDAR.mat", "LiDAR"),
        gt_file=("trento_data.mat", "ground"),
    ),
    "Augsburg": DatasetSpec(
        name="Augsburg", label_values=_AUGSBURG_LABELS, rgb_bands=(22, 17, 9),
        hsi_file=("data_HS_LR.mat", "data_HS_LR"),
        lidar_file=("data_DSM.mat", "data_DSM"), gt_file=("gt.mat", "gt"),
    ),
    "MUUFL": DatasetSpec(
        name="MUUFL", label_values=_MUUFL_LABELS, rgb_bands=(28, 15, 10),
        lidar_per_band=True, loader=_muufl_loader,
    ),
    "IP": DatasetSpec(
        name="IP", label_values=_IP_LABELS, rgb_bands=(59, 40, 23),
        hsi_file=("Indian_pines_corrected.mat", "indian_pines_corrected"),
        lidar_file=("houston2013_LiDAR.mat", "LiDAR"),
        gt_file=("Indian_pines_gt.mat", "indian_pines_gt"),
    ),
    "Salinas": DatasetSpec(
        name="Salinas", label_values=_SALINAS_LABELS, rgb_bands=(59, 40, 23),
        hsi_file=("Salinas_corrected.mat", "salinas_corrected"),
        lidar_file=("LiDAR.mat", "LiDAR"),
        gt_file=("Salinas_gt.mat", "salinas_gt"),
    ),
    "PaviaU": DatasetSpec(
        name="PaviaU", label_values=_PAVIAU_LABELS, rgb_bands=(59, 40, 23),
        hsi_file=("PaviaU.mat", "paviaU"), lidar_file=("LiDAR.mat", "LiDAR"),
        gt_file=("PaviaU_gt.mat", "paviaU_gt"),
    ),
    "Synthetic": DatasetSpec(
        name="Synthetic",
        label_values=lambda: ["Unclassified"] + [
            "Class {}".format(i) for i in range(1, _synthetic_classes())],
        rgb_bands=(0, 1, 2), loader=_synthetic_loader,
    ),
}


def dataset_names() -> List[str]:
    return list(DATASETS.keys())


def get_dataset(dataset_name: str, target_folder: str = "./",
                datasets: Dict[str, DatasetSpec] = DATASETS):
    """Load a dataset by name: per-band [0, 1] normalisation of the HSI,
    global (MUUFL: per-band) of the LiDAR, NaN pixels zeroed with their
    labels, label 0 ignored (ref: datasets.py:76-458)."""
    if dataset_name not in datasets:
        raise ValueError("{} dataset is unknown.".format(dataset_name))
    spec = datasets[dataset_name]
    folder = os.path.join(target_folder, dataset_name)

    if spec.loader is not None:
        img1, img2, gt = spec.loader(folder)
    else:
        hsi_fn, hsi_key = spec.hsi_file
        lidar_fn, lidar_key = spec.lidar_file
        gt_fn, gt_key = spec.gt_file
        img1 = open_file(os.path.join(folder, hsi_fn))[hsi_key].astype(
            np.float32)
        img2 = open_file(os.path.join(folder, lidar_fn))[lidar_key].astype(
            np.float32)
        if img2.ndim == 2:
            img2 = np.expand_dims(img2, axis=2)
        # paired-modality datasets crop the co-raster to the HSI footprint
        h, w = img1.shape[:2]
        img2 = img2[:h, :w]
        gt = open_file(os.path.join(folder, gt_fn))[gt_key]

    img1 = minmax_per_band(img1)
    img2 = (minmax_per_band(img2) if spec.lidar_per_band
            else minmax_global(img2))

    gt = np.asarray(gt).astype(np.int64)
    img1, gt, had_nan = filter_nan(img1, gt)
    if had_nan:
        print("Warning: NaN have been found in the data. It is preferable to "
              "remove them beforehand. Learning on NaN data is disabled.")

    labels = spec.label_values
    labels = list(labels() if callable(labels) else labels)
    ignored_labels = sorted(set(list(spec.ignored_labels) + [0]))
    return img1, img2, gt, labels, ignored_labels, spec.rgb_bands, None
