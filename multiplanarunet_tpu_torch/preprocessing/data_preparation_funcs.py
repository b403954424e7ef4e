"""Data preparation for `mp train`: hparams -> audited loaders -> queues ->
sequences.

Port of `multiplanarunet_tpu/preprocessing/data_preparation_funcs.py` for
the 2D UNet, the UNet3D and the MultiTaskUNet2D (and the port's
SwinUNETR, which trains on the UNet3D's boxes): the train/val
ImagePairLoaders, the
Auditor's fill of the hparams the YAML leaves Null, the aug-data merge with its sample weight,
--just_one / --no_val, the queues (`get_data_queues`: a LimitationQueue
for training when fit.max_loaded is set, cycling images every
fit.num_access accesses, else eager; eager for validation), the views
(sampled with the 60-degree restriction and weighted by the median voxel
size, saved to views.npz; reloaded on --continue_training) and the
train/val sequences on the training device (for the UNet3D no views: its
samplers draw boxes or patches). A multi-task project does all of this
once per task YAML (`prepare_for_multi_task_2d`), with views_<task>.npz
per task, and writes the per-task lists into the main build group.
"""

from __future__ import annotations

import os

import numpy as np

from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
from multiplanarunet_tpu_torch.image.auditor import Auditor
from multiplanarunet_tpu_torch.image.image_pair_loader import ImagePairLoader
from multiplanarunet_tpu_torch.image.queue.queues import get_data_queues
from multiplanarunet_tpu_torch.logging.loggers import ScreenLogger
from multiplanarunet_tpu_torch.parallel.distributed import (
    broadcast_from_main,
    is_main_process,
)
from multiplanarunet_tpu_torch.ops.geometry import (
    sample_random_views_with_angle_restriction,
)
from multiplanarunet_tpu_torch.sequences import MultiTaskSequence, get_sequence


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


def add_noise_to_views(views, sd, rng=None):
    """Each view vector plus normal(scale=sd, size=3) noise, renormalised
    (float64 (N, 3)); rng: a numpy RandomState, numpy's global stream if
    None."""
    rng = rng or np.random
    out = []
    for v in np.asarray(views, np.float64):
        noisy = v + rng.normal(scale=sd, size=3)
        out.append(noisy / np.linalg.norm(noisy))
    return np.asarray(out)


def load_or_create_views(hparams, continue_training, logger, base_path,
                         auditor=None, name="views", pre_noise=True):
    """The views of fit.views: an int -> freshly sampled restricted views,
    a list -> those, continue_training -> <name>.npz reloaded; new views
    go to <name>.npz (a multi-task project keeps views_<task>.npz per
    task) and are drawn to views.png, where matplotlib is there (a
    plotting failure logs one warning). With pre_noise (as the JAX
    package's single-task path), listed views get fit.noise_sd of
    orientation noise once, here, for an intrp_style other than iso_live,
    and fit.noise_sd is set to False (the JAX package's per-task views
    take no pre-noise: pre_noise=False). In a process group the main
    process's views are broadcast to every process, and only the main
    process writes the files."""
    views = hparams["fit"]["views"]
    view_path = os.path.join(base_path, f"{name}.npz")
    if continue_training:
        return np.load(view_path)["arr_0"]
    if isinstance(views, (int, np.integer)):
        weights = None
        if auditor is not None:
            weights = np.median(auditor.info["pixdims"], axis=0)
            logger(f"[OBS] Weighting random views by median res: {weights}")
        views = sample_random_views_with_angle_restriction(
            int(views), 60, weights=weights, logger=logger)
    elif isinstance(views, (list, tuple, np.ndarray)):
        views = np.asarray(views, np.float64)
        if pre_noise and hparams["fit"]["intrp_style"] != "iso_live":
            logger(f"[Note] Pre-adding noise to views "
                   f"(SD: {hparams['fit']['noise_sd']})")
            views = add_noise_to_views(views, hparams["fit"]["noise_sd"])
            hparams["fit"]["noise_sd"] = False
    else:
        raise ValueError(f"Invalid 'views' value {views!r}; must be an int "
                         f"or a list of vectors")
    views = np.asarray(views, np.float64)
    logger(f"View SD:     {hparams['fit'].get('noise_sd')}")
    # Every process of a group trains on the main process's draw, and
    # only that process writes the shared files
    views = np.asarray(broadcast_from_main(views), np.float64)
    if not is_main_process():
        return views
    np.savez(view_path, views)
    try:
        from multiplanarunet_tpu_torch.utils.plotting import plot_views

        plot_views(views, os.path.join(base_path, "views.png"))
    except Exception as e:  # plotting must not block training
        logger.warn(f"Could not plot views: {e}")
    return views


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
    hparams["fit"]["views"] = load_or_create_views(
        hparams, continue_training, logger, base_path, auditor)
    return get_sequencers(train_queue, val_queue, logger, hparams, device)


def prepare_for_3d_unet(hparams, just_one=False, no_val=False,
                        continue_training=False, logger=None,
                        base_path="./", device=None):
    train_queue, val_queue, logger, _ = _base_loader_func(
        hparams, just_one, no_val, logger, "3d")
    return get_sequencers(train_queue, val_queue, logger, hparams, device)


def prepare_for_multi_task_2d(hparams, just_one=False, no_val=False,
                              continue_training=False, logger=None,
                              base_path="./", device=None):
    """Per task of the 'tasks' group: its YAML (read without version
    stamps, the main fit group grafted on in memory), the audited
    loaders and queues, its views and its train/val sequences; the task
    names and per-task n_classes, n_channels and dim written into the main
    build group (and file). Returns (train, val) MultiTaskSequences (val
    None with no_val or a task without validation data)."""
    logger = logger or ScreenLogger()
    tasks = hparams.get("tasks")
    if not tasks or "task_names" not in tasks:
        raise ValueError(
            "MultiTask training needs a 'tasks' group with 'task_names' and "
            "'hparam_files' in train_hparams.yaml (see the MultiTask "
            "preset).")
    names = list(tasks["task_names"])
    files = list(tasks["hparam_files"])
    if len(names) != len(files):
        raise ValueError("tasks.task_names and tasks.hparam_files must have "
                         "equal length")

    train_seqs, val_seqs = [], []
    n_classes, n_channels, dims = [], [], []
    for name, fname in zip(names, files):
        logger(f"\n[*] Preparing task '{name}' ({fname})")
        task_hp = YAMLHParams(os.path.join(base_path, fname), logger=logger,
                              no_version_control=True)
        # The shared fit settings (bg_value, scaler, max_loaded, ...) come
        # from the main file; the task file's text is not touched
        task_hp["fit"] = dict(hparams["fit"])
        train_queue, val_queue, logger, auditor = _base_loader_func(
            task_hp, just_one, no_val, logger, "multi_task_2d")
        spec = task_hp["task_specifics"]
        fit_kwargs = dict(hparams["fit"])
        fit_kwargs["views"] = load_or_create_views(
            hparams, continue_training, logger, base_path, auditor,
            name=f"views_{name}", pre_noise=False)
        fit_kwargs["real_space_span"] = spec["real_space_span"]
        for queue, is_val, out in ((train_queue, False, train_seqs),
                                   (val_queue, True, val_seqs)):
            if not queue:
                out.append(None)
                continue
            out.append(get_sequence(
                data_queue=queue, is_validation=is_val, logger=logger,
                dim=spec["dim"], n_classes=spec["n_classes"], device=device,
                **fit_kwargs))
        n_classes.append(int(spec["n_classes"]))
        n_channels.append(int(spec["n_channels"]))
        dims.append(int(spec["dim"]))

    # The per-task lists MultiTaskUNet2D is built from
    for key, value in (("task_names", names), ("n_classes", n_classes),
                       ("n_channels", n_channels), ("dim", dims)):
        hparams.set_value(subdir="build", name=key, value=value,
                          overwrite=True, log=False)
    hparams.save_current()

    train = MultiTaskSequence(train_seqs, names, logger=logger)
    val = None
    if not no_val and all(s is not None for s in val_seqs):
        val = MultiTaskSequence(val_seqs, names, logger=logger, no_log=True)
    return train, val


PREPARATION_FUNCS = {"UNet": prepare_for_multi_view_unet,
                     "UNet3D": prepare_for_3d_unet,
                     "SwinUNETR": prepare_for_3d_unet,
                     "MultiTaskUNet2D": prepare_for_multi_task_2d}
