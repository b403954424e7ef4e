"""`mp predict_3D` on the PyTorch port: inference with a 3D model.

Port of `multiplanarunet_tpu/bin/predict_3D.py`: isotropic scanner-space
box inference (`pred_3D_iso`: the base tiling and --extra_boxes random
boxes, scatter-added onto the voxel grid; the iso_live_3d style) or
voxel-space patch inference (`predict_3D_patches`: patches_3d, or
sliding_patches_3d with --strides), the per-class dice written to
csv/results.csv and csv/detailed.csv, and PRED.nii.gz per image (optionally
beside the input image and labels). Only the uint8 class map leaves the
device.

The cohort runs as a three-stage pipeline, as in the JAX script: an
input thread decodes and scales the next image on the host, the main
thread stages the current one on the device and predicts it, and an
output thread evaluates and saves the previous result.

Under a launch marker (MPUNET_* or torchrun's) each process is one rank
of a gloo group and predicts a round-robin share of the cohort on its
card (cuda:LOCAL_RANK, or the --device named); ranks > 0 write their
share of the tables to <out_dir>/.rank<r>.json, and after a barrier rank
0 merges them and writes csv/ and txt/ once (JAX :245-280); logs go to
predict_log_rank<r>.txt on ranks > 0. --num_devices N > 1 checks that N
cards are visible and runs on one, as the JAX script does.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp predict_3D
--project_dir <project> [--device cpu] ...``.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


def get_argparser():
    parser = ArgumentParser(description="Predict with a 3D model")
    parser.add_argument("--project_dir", type=str, default="./")
    parser.add_argument("-f", type=str, default="",
                        help="Predict on a single file")
    parser.add_argument("-l", type=str, default="",
                        help="Label file for single-file mode")
    parser.add_argument("--out_dir", type=str, default="predictions_3D")
    parser.add_argument("--num_devices", "--num_GPUs", dest="num_devices",
                        type=int, default=0,
                        help="Devices to check for; inference runs on one "
                             "device per process (launch several processes "
                             "to split a cohort)")
    parser.add_argument("--extra_boxes", type=str, default="2x",
                        help="Extra random boxes: an int or 'Nx' multiplier "
                             "of the base-tile count")
    parser.add_argument("--min_coverage", type=float, default=None)
    parser.add_argument("--N_extra_patches", type=int, default=0,
                        help="Extra random patches in voxel-patch mode")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--no_eval", action="store_true")
    parser.add_argument("--on_val", action="store_true")
    parser.add_argument("--save_input_files", action="store_true")
    parser.add_argument("--save_only_pred", action="store_true",
                        help="Save only the PRED file (no IMAGE/LABELS)")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="Predict on all images of this folder instead "
                             "of the configured test set")
    parser.add_argument("--strides", type=int, default=None,
                        help="Stride for sliding-window patch mode")
    parser.add_argument("--wait_for", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: 'cuda' (default) or 'cuda:N' "
                             "(raises when no card is visible), or 'cpu'")
    return parser


def get_loader(args, hparams, logger):
    from multiplanarunet_tpu_torch.image.image_pair import ImagePair
    from multiplanarunet_tpu_torch.image.image_pair_loader import (
        ImagePairLoader,
    )

    if args.f:
        loader = ImagePairLoader(predict_mode=not args.l,
                                 initialize_empty=True, logger=logger)
        loader.add_image(ImagePair(args.f, args.l or None, logger=logger))
    elif args.data_dir:
        loader = ImagePairLoader(
            base_dir=args.data_dir, logger=logger, predict_mode=args.no_eval,
            img_subdir=hparams["test_data"]["img_subdir"],
            label_subdir=hparams["test_data"]["label_subdir"])
    else:
        group = "val_data" if args.on_val else "test_data"
        loader = ImagePairLoader(logger=logger, predict_mode=args.no_eval,
                                 **hparams[group])
    loader.set_scaler_and_bg_values(
        bg_value=hparams.get_from_anywhere("bg_value"),
        scaler=hparams.get_from_anywhere("scaler"), compute_now=False)
    return loader


def merge_rank_results_3D(results, detailed, image_ids, out_dir, n_procs,
                          rank):
    """Write the tables once for a process group: ranks > 0 dump their
    images' entries to <out_dir>/.rank<r>.json, and after a barrier rank
    0 folds them into its tables (each image's per-class dice in its own
    dtype) and writes csv/ and txt/."""
    import json

    from multiplanarunet_tpu_torch.logging import log_results as lr
    from multiplanarunet_tpu_torch.parallel.distributed import (
        process_barrier,
    )

    if rank:
        cols = [detailed.columns.index(im) for im in image_ids]
        part = {"results": {im: results.get(im, "0") for im in image_ids},
                "detailed": {im: detailed.values[:, c].tolist()
                             for im, c in zip(image_ids, cols)},
                "f32": [im for im in image_ids if im in detailed.f32_columns]}
        with open(os.path.join(out_dir, f".rank{rank}.json"), "w") as f:
            json.dump(part, f)
    process_barrier("mp-predict3d-results")
    if rank:
        return
    for r in range(1, n_procs):
        path = os.path.join(out_dir, f".rank{r}.json")
        with open(path) as f:
            part = json.load(f)
        for im, value in part["results"].items():
            results.set(im, "0", value)
        for im, values in part["detailed"].items():
            detailed.set_column(im, np.asarray(
                values, np.float32 if im in part["f32"] else np.float64))
        os.remove(path)
    lr.save_all_3D(results, detailed, out_dir)


def run_predictions(loader, seq, predict_fn, args, out_dir, n_classes,
                    logger):
    """Predict, evaluate and save every image of the loader; returns one
    dict of wall seconds per image: 'load' (decode and scale on the input
    thread), 'predict' (staging, the boxes or patches and the class map's
    fetch), 'save' (dice and the NIfTI files on the output thread). On a
    card, each image's peak allocated device memory is logged."""
    import torch

    from multiplanarunet_tpu_torch.evaluate.metrics import dice_all
    from multiplanarunet_tpu_torch.io import nifti
    from multiplanarunet_tpu_torch.logging import log_results as lr
    from multiplanarunet_tpu_torch.parallel.distributed import (
        process_barrier,
        process_count,
        process_index,
    )
    from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
        pred_3D_iso,
        predict_3D_patches,
    )

    iso_mode = hasattr(seq, "real_box_dim")
    on_card = seq.device.type == "cuda"
    all_ids = sorted(loader.id_to_image)
    results, detailed = lr.init_result_dict_3D(all_ids, n_classes)
    # Images are independent: a round-robin share per rank
    n_procs, rank = process_count(), process_index()
    image_ids = all_ids[rank::n_procs]
    if n_procs > 1:
        logger(f"Multi-process predict_3D: process {rank + 1}/{n_procs} "
               f"handles {len(image_ids)}/{len(all_ids)} images")
    nii_dir = os.path.join(out_dir, "nii_files")
    timings = {i: {} for i in image_ids}
    io_pool = ThreadPoolExecutor(max_workers=1)
    out_pool = ThreadPoolExecutor(max_workers=1)

    def _preload(idx):
        if idx >= len(image_ids):
            return None
        t0 = time.perf_counter()
        img = loader.get_by_id(image_ids[idx])
        img.load()
        img.interpolator.prepare_host()  # the scaled volume, on the host
        timings[image_ids[idx]]["load"] = time.perf_counter() - t0
        return img

    def _finalize(image, pred_cls):
        image_id = image.identifier
        t0 = time.perf_counter()
        try:
            if not args.no_eval and image.labels is not None:
                dices = dice_all(image.labels, pred_cls, n_classes=n_classes,
                                 ignore_zero=True)
                detailed.set_column(image_id, dices)
                results.set(image_id, "0", float(np.nanmean(dices)))
                logger(f"[{image_id}] Mean dice: {np.nanmean(dices):.4f} "
                       f"(per-class {np.round(dices, 4)})")
            img_out = Path(nii_dir) / image_id
            img_out.mkdir(parents=True, exist_ok=True)
            nifti.save(pred_cls, img_out / "PRED.nii.gz",
                       affine=image.affine)
            if args.save_input_files and not args.save_only_pred:
                nifti.save(image.image.squeeze().astype(np.float32),
                           img_out / "IMAGE.nii.gz", affine=image.affine)
                if image.labels is not None:
                    nifti.save(image.labels.astype(np.uint8),
                               img_out / "LABELS.nii.gz",
                               affine=image.affine)
        finally:
            image.unload()
            timings[image_id]["save"] = time.perf_counter() - t0

    next_future = io_pool.submit(_preload, 0)
    out_future = None
    try:
        for i, image_id in enumerate(image_ids):
            image = next_future.result()
            next_future = io_pool.submit(_preload, i + 1)
            try:
                logger(f"\n--- Predicting on {image_id} ---")
                if on_card:
                    torch.cuda.reset_peak_memory_stats(seq.device)
                t0 = time.perf_counter()
                if iso_mode:
                    pred_cls = pred_3D_iso(
                        predict_fn, seq, image, extra_boxes=args.extra_boxes,
                        min_coverage=args.min_coverage, logger=logger,
                        want_argmax=True)
                else:
                    pred_cls = predict_3D_patches(
                        predict_fn, seq, image, n_extra=args.N_extra_patches,
                        n_classes=n_classes, logger=logger,
                        want_argmax=True)
                timings[image_id]["predict"] = time.perf_counter() - t0
                if on_card:
                    peak = torch.cuda.max_memory_allocated(seq.device)
                    logger(f"[{image_id}] Peak device memory: "
                           f"{peak / 2**30:.2f} GiB")
                if out_future is not None:
                    # One result in flight: finalize(i-1) overlapped this
                    # image's inference
                    pending_out, out_future = out_future, None
                    pending_out.result()
                out_future = out_pool.submit(_finalize, image, pred_cls)
            except BaseException:
                image.unload()
                raise
        if out_future is not None:
            out_future.result()
    finally:
        # Drain the in-flight preload so an aborted run does not leak its
        # loaded volume
        try:
            pending = next_future.result(timeout=300)
            if pending is not None:
                pending.unload()
        except Exception as e:  # noqa: BLE001 - the run's own error wins
            logger.warn(f"Preload failed while shutting down: {e!r}")
        io_pool.shutdown(wait=False)
        out_pool.shutdown(wait=True)
    if not args.no_eval:
        if n_procs > 1:
            merge_rank_results_3D(results, detailed, image_ids, out_dir,
                                  n_procs, rank)
        else:
            lr.save_all_3D(results, detailed, out_dir)
    process_barrier("mp-predict3d-done")
    for image_id, t in timings.items():
        logger(f"Timing {image_id}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in t.items()))
    return timings


def entry_func(args=None):
    import torch

    from multiplanarunet_tpu_torch._device import require_devices
    from multiplanarunet_tpu_torch.parallel.distributed import (
        data_group_active,
        is_main_process,
        maybe_initialize_distributed,
        process_index,
        rank_device,
        shutdown_distributed,
    )

    args = get_argparser().parse_args(args)
    if args.num_devices > 1 and torch.device(args.device).type == "cuda":
        require_devices(args.num_devices)
    device = rank_device(args.device)
    project_dir = os.path.abspath(args.project_dir)
    out_dir = os.path.abspath(os.path.join(project_dir, args.out_dir))
    if os.path.exists(out_dir) and not args.overwrite:
        raise RuntimeError(f"{out_dir} exists; pass --overwrite")
    os.makedirs(out_dir, exist_ok=True)

    from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
    from multiplanarunet_tpu_torch.logging.loggers import Logger
    from multiplanarunet_tpu_torch.models.model_init import (
        build_model,
        load_unet_weights,
    )
    from multiplanarunet_tpu_torch.sequences import get_sequence
    from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
        unet_predict_fn,
    )
    from multiplanarunet_tpu_torch.utils.utils import (
        await_PIDs,
        get_best_model,
    )

    # Host coordination only: a gloo group, never NCCL
    started = not data_group_active()
    maybe_initialize_distributed(device=device, backend="gloo")
    logger = Logger(out_dir,
                    active_file="predict_log" if is_main_process()
                    else f"predict_log_rank{process_index()}",
                    overwrite_existing=True, no_sub_folder=True)
    try:
        hparams = YAMLHParams(Path(project_dir) / "train_hparams.yaml",
                              logger=logger, no_version_control=True)
        n_classes = hparams["build"]["n_classes"]
        if args.wait_for:
            await_PIDs(args.wait_for)
        loader = get_loader(args, hparams, logger)

        model = build_model(
            hparams["build"],
            mixed_precision=bool(hparams["fit"].get("mixed_precision",
                                                    False)),
            logger=logger)
        weights = get_best_model(Path(project_dir) / "model")
        model = load_unet_weights(model, weights).to(device)
        logger(f"Loaded weights from {weights}")

        fit_kwargs = dict(hparams["fit"])
        if args.strides:
            fit_kwargs["intrp_style"] = "sliding_patches_3d"
            fit_kwargs["strides"] = args.strides
        seq = get_sequence(data_queue=loader, is_validation=True,
                           logger=logger, dim=hparams["build"]["dim"],
                           n_classes=n_classes, no_log=True, device=device,
                           **fit_kwargs)
        timings = run_predictions(loader, seq,
                                  unet_predict_fn(model, device), args,
                                  out_dir, n_classes, logger)
        logger("3D prediction complete.")
        return timings
    finally:
        logger.close()
        if started:
            shutdown_distributed()


if __name__ == "__main__":
    entry_func()
