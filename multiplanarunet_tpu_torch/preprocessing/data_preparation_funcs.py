"""Data preparation for `mp train`: hparams -> audited loaders -> queues ->
sequences.

Port of `multiplanarunet_tpu/preprocessing/data_preparation_funcs.py` for
the 2D UNet and the UNet3D: the train/val ImagePairLoaders, the
Auditor's fill of the hparams the YAML leaves Null, the aug-data merge with its sample weight,
--just_one / --no_val, the queues (`get_data_queues`: a LimitationQueue
for training when fit.max_loaded is set, cycling images every
fit.num_access accesses, else eager; eager for validation), the views
(sampled with the 60-degree restriction and weighted by the median voxel
size, saved to views.npz; reloaded on --continue_training) and the
train/val sequences on the training device (for the UNet3D no views: its
samplers draw boxes or patches). The multi-task preparation is not
ported.
"""

from __future__ import annotations

import os

import numpy as np

from multiplanarunet_tpu_torch.image.auditor import Auditor
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import get_data_queues
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.ops.geometry import (
    sample_random_views_with_angle_restriction,
)
from multiplanarunet_tpu_torch.sequences import get_sequence


def _base_loader_func(hparams, just_one, no_val, logger, mtype):
    """Load and audit the datasets; returns (train_queue, val_queue or
    None, logger, auditor)."""
    logger = logger or ScreenLogger()
    logger("Looking for images...")
    train_data = ImagePairLoader(logger=logger, **hparams["train_data"])
    val_data = ImagePairLoader(logger=logger, **hparams["val_data"])

    lab_paths = (list(train_data.label_paths or [])
                 + list(val_data.label_paths or []))
    auditor = Auditor(
        [str(p) for p in list(train_data.image_paths)
         + list(val_data.image_paths)],
        nii_lab_paths=[str(p) for p in lab_paths] or None,
        logger=logger, dim_3d=hparams.get_from_anywhere("dim") or 64,
        hparams=hparams)
    auditor.fill(hparams, mtype)

    aug_data = hparams.get("aug_data")
    if aug_data:
        if "include" not in aug_data:
            logger.warn("'aug_data' group found without the required "
                        "'include' key; NOT including augmented data.")
        elif aug_data["include"]:
            logger(f"\n[*] Adding augmented data with weight "
                   f"{aug_data['sample_weight']}")
            train_data.add_images(ImagePairLoader(logger=logger, **aug_data))

    if just_one:
        logger("[**NOTICE**] Only running on first train & val samples.")
        train_data.images = [train_data.images[0]]
        val_data.images = [val_data.images[0]]
        train_data._id_to_image = train_data.get_id_to_images_dict()
        val_data._id_to_image = val_data.get_id_to_images_dict()
    if no_val:
        val_data.images = []
        val_data._id_to_image = {}

    for dataset in (train_data, val_data):
        logger(f"Preparing dataset {dataset}")
        dataset.set_scaler_and_bg_values(
            bg_value=hparams.get_from_anywhere("bg_value"),
            scaler=hparams.get_from_anywhere("scaler"),
            compute_now=False)
    max_loaded = hparams["fit"].get("max_loaded")
    train_queue, val_queue = get_data_queues(
        train_dataset=train_data,
        val_dataset=val_data if len(val_data) else None,
        train_queue_type="limitation" if max_loaded else "eager",
        val_queue_type="eager",
        max_loaded=max_loaded,
        num_access_before_reload=hparams["fit"].get("num_access"),
        logger=logger)
    return train_queue, val_queue, logger, auditor


def load_or_create_views(hparams, continue_training, logger, base_path,
                         auditor=None):
    """Resolve fit.views: an int -> freshly sampled restricted views, a
    list -> those, continue_training -> views.npz reloaded; new views go to
    views.npz. views.png is not drawn (the port has no matplotlib). The
    JAX package's pre-noising of listed views for styles other than
    iso_live is not needed: the port samples iso_live only."""
    views = hparams["fit"]["views"]
    view_path = os.path.join(base_path, "views.npz")
    if continue_training:
        hparams["fit"]["views"] = np.load(view_path)["arr_0"]
        return
    if isinstance(views, (int, np.integer)):
        weights = None
        if auditor is not None:
            weights = np.median(auditor.info["pixdims"], axis=0)
            logger(f"[OBS] Weighting random views by median res: {weights}")
        views = sample_random_views_with_angle_restriction(
            int(views), 60, weights=weights, logger=logger)
    elif not isinstance(views, (list, tuple, np.ndarray)):
        raise ValueError(f"Invalid 'views' value {views!r}; must be an int "
                         f"or a list of vectors")
    hparams["fit"]["views"] = np.asarray(views, np.float64)
    logger(f"View SD:     {hparams['fit'].get('noise_sd')}")
    np.savez(os.path.join(base_path, "views"), hparams["fit"]["views"])
    logger.warn("Could not plot views: matplotlib is not available to the "
                "PyTorch port (views.npz holds them)")


def get_sequencers(train_queue, val_queue, logger, hparams, device=None):
    logger("Preparing sequence objects...")
    out = []
    for queue, is_val in ((train_queue, False), (val_queue, True)):
        if not queue:
            out.append(None)
            continue
        out.append(get_sequence(
            data_queue=queue, is_validation=is_val, logger=logger,
            dim=hparams["build"]["dim"],
            n_classes=hparams["build"]["n_classes"], device=device,
            **hparams["fit"]))
    return out[0], out[1]


def prepare_for_multi_view_unet(hparams, just_one=False, no_val=False,
                                continue_training=False, logger=None,
                                base_path="./", device=None):
    train_queue, val_queue, logger, auditor = _base_loader_func(
        hparams, just_one, no_val, logger, "2d")
    load_or_create_views(hparams, continue_training, logger, base_path,
                         auditor)
    return get_sequencers(train_queue, val_queue, logger, hparams, device)


def prepare_for_3d_unet(hparams, just_one=False, no_val=False,
                        continue_training=False, logger=None,
                        base_path="./", device=None):
    train_queue, val_queue, logger, _ = _base_loader_func(
        hparams, just_one, no_val, logger, "3d")
    return get_sequencers(train_queue, val_queue, logger, hparams, device)


PREPARATION_FUNCS = {"UNet": prepare_for_multi_view_unet,
                     "UNet3D": prepare_for_3d_unet}
