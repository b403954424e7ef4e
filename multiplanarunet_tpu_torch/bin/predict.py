"""`mp predict` on the PyTorch port: multi-planar inference + evaluation
over a test set.

Port of `multiplanarunet_tpu/bin/predict.py` for one CUDA device: per-view
whole-volume prediction through `MultiViewPredictor`, fusion (learned
fusion weights or --sum_fusion), per-view and fused dice written to the
csv/txt result tables, PRED.nii.gz saving (optionally beside the input
image/labels), --continue resume, single-file mode via -f/-l, --on_val
and --dataset. It reads the project the JAX package wrote:
train_hparams.yaml, views.npz, model/*.npz and
model/fusion_weights/*fusion_weights*.npz.

The cohort runs as a three-stage pipeline: an input thread decodes,
scales (and for --stage_dtype u8 quantises) the next image on the host,
the main thread copies the current one to the device and predicts it,
and an output thread fetches and saves the previous result.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp predict
--project_dir <project> [--device cpu] ...``.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np


class MultiDeviceNotPortedError(NotImplementedError):
    """View-parallel inference over several devices is not ported yet."""


def get_argparser():
    parser = ArgumentParser(
        description="Predict (and evaluate) using a trained project model")
    parser.add_argument("--project_dir", type=str, default="./")
    parser.add_argument("-f", type=str, default="",
                        help="Predict on a single image file")
    parser.add_argument("-l", type=str, default="",
                        help="Label file for single-image mode (optional)")
    parser.add_argument("--out_dir", type=str, default="predictions")
    parser.add_argument("--num_devices", "--num_GPUs", dest="num_devices",
                        type=int, default=0,
                        help="Devices to use: 0 or 1 (multi-device "
                             "inference is not ported yet)")
    parser.add_argument("--sum_fusion", action="store_true",
                        help="Average the per-view softmaxes instead of "
                             "applying the learned fusion model")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--no_eval", action="store_true",
                        help="Do not evaluate against labels")
    parser.add_argument("--eval_prob", type=float, default=1.0,
                        help="Evaluate only this fraction of images")
    parser.add_argument("--on_val", action="store_true",
                        help="Predict on the validation set instead of test")
    parser.add_argument("--dataset", type=str, default=None,
                        help="Predict on an arbitrary hparams data group, "
                             "e.g. 'train' (overrides --on_val)")
    parser.add_argument("--wait_for", type=str, default="",
                        help="Wait for these PIDs before starting")
    parser.add_argument("--continue", action="store_true", dest="continue_",
                        help="Skip images already predicted in out_dir")
    parser.add_argument("--save_input_files", action="store_true",
                        help="Save image/labels alongside predictions")
    parser.add_argument("--no_argmax", action="store_true",
                        help="Save the full softmax volume instead of the "
                             "argmax class map")
    parser.add_argument("--resampler", type=str, default="auto",
                        choices=("auto", "shear", "gather"),
                        help="Plane-extraction/remap kernel: 'gather' is the "
                             "exact trilinear/nearest path; 'shear' the "
                             "faster shear-decomposed path; 'auto' (default) "
                             "uses shear when the view affines factor within "
                             "the memory guard")
    parser.add_argument("--n_planes", type=str, default="same+20",
                        help="Planes per view: 'same', 'same+N', "
                             "'by_radius' or an integer")
    parser.add_argument("--stage_dtype", type=str, default="bf16",
                        choices=("bf16", "u8"),
                        help="Host->device volume staging: 'u8' ships "
                             "per-channel affine uint8 codes (half the bf16 "
                             "transfer, dequantized on device; max intensity "
                             "error = channel range/510)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: 'cuda' (default) or 'cuda:N' "
                             "(raises when no card is visible), or 'cpu'")
    return parser


def validate_folders(project_dir, out_dir, overwrite, continue_):
    if not (Path(project_dir) / "train_hparams.yaml").exists():
        raise RuntimeError(f"No train_hparams.yaml in {project_dir}")
    if not (Path(project_dir) / "views.npz").exists():
        raise RuntimeError(f"No views.npz in {project_dir} - was the model "
                           f"trained with 'mp train'?")
    if not (Path(project_dir) / "model").is_dir():
        raise RuntimeError(f"No model/ folder in {project_dir}")
    if Path(out_dir).exists() and not (overwrite or continue_):
        raise RuntimeError(
            f"Output dir {out_dir} exists; pass --overwrite or --continue")


def get_image_pair_loader(args, hparams, logger):
    from multiplanarunet_tpu_torch.image.image_pair import ImagePair
    from multiplanarunet_tpu_torch.image.image_pair_loader import (
        ImagePairLoader,
    )

    if args.f:
        loader = ImagePairLoader(predict_mode=not args.l,
                                 initialize_empty=True, logger=logger)
        loader.add_image(ImagePair(args.f, args.l or None, logger=logger))
        return loader
    if args.dataset:
        group = args.dataset if args.dataset.endswith("_data") \
            else f"{args.dataset}_data"
    else:
        group = "val_data" if args.on_val else "test_data"
    return ImagePairLoader(logger=logger, predict_mode=args.no_eval,
                           **hparams[group])


def load_fusion_params(project_dir, sum_fusion, logger):
    """The newest model/fusion_weights/*fusion_weights*.npz as fusion
    params, or None (sum fusion) with --sum_fusion or when there is
    none."""
    from multiplanarunet_tpu_torch.models import checkpoint

    if sum_fusion:
        return None
    fusion_dir = Path(project_dir) / "model" / "fusion_weights"
    candidates = sorted(fusion_dir.glob("*fusion_weights*.npz")) \
        if fusion_dir.is_dir() else []
    if not candidates:
        logger.warn("No fusion weights found - falling back to sum "
                    "fusion. Run 'mp train_fusion' to train them.")
        return None
    fusion_params, _, _ = checkpoint.load_weights(candidates[-1])
    logger(f"Loaded fusion weights from {candidates[-1]}")
    return fusion_params


def save_nii_files(merged, image_pair, nii_res_dir, save_input_files,
                   logger):
    from multiplanarunet_tpu_torch.io import nifti

    out_dir = Path(nii_res_dir) / image_pair.identifier
    out_dir.mkdir(parents=True, exist_ok=True)
    if np.issubdtype(np.asarray(merged).dtype, np.floating):
        # Full softmax volume (--no_argmax)
        nifti.save(merged.astype(np.float32), out_dir / "PRED.nii.gz",
                   affine=image_pair.affine)
    else:
        nifti.save(merged.astype(np.uint8), out_dir / "PRED.nii.gz",
                   affine=image_pair.affine)
    if save_input_files:
        nifti.save(image_pair.image.squeeze().astype(np.float32),
                   out_dir / "IMAGE.nii.gz", affine=image_pair.affine)
        if image_pair.labels is not None:
            nifti.save(image_pair.labels.astype(np.uint8),
                       out_dir / "LABELS.nii.gz", affine=image_pair.affine)
    logger(f"Saved prediction for {image_pair.identifier} to {out_dir}")


def run_predictions_and_eval(loader, predictor, views, fusion_params, args,
                             out_dir, n_classes, logger):
    """Predict (and evaluate) every image of the loader not yet done.
    Returns one dict of wall seconds per predicted image: 'load' (decode,
    scale and quantise on the input thread), 'predict' (predict_image:
    device staging, views, fusion and the fetch of the class map; its
    fetch is deferred to the output thread when not evaluating), 'save'
    (writing the NIfTI files)."""
    from multiplanarunet_tpu_torch.evaluate.metrics import (
        dice_all,
        dice_from_counts,
    )
    from multiplanarunet_tpu_torch.logging import log_results as lr

    image_ids = sorted(loader.id_to_image)
    csv_dir = os.path.join(out_dir, "csv")
    nii_dir = os.path.join(out_dir, "nii_files")

    already_done = set()
    if args.continue_ and os.path.isdir(nii_dir):
        already_done = set(os.listdir(nii_dir))
        logger(f"[--continue] {len(already_done)} images already predicted")
    if args.continue_ and os.path.isdir(csv_dir):
        results, pc_results = lr.load_result_dicts(csv_dir, views)
    else:
        results, pc_results = lr.init_result_dicts(views, image_ids,
                                                   n_classes)
    rng = np.random.RandomState(0)
    todo = [i for i in image_ids if i not in already_done]
    for image_id in image_ids:
        if image_id in already_done:
            logger(f"Skipping {image_id} (already predicted)")

    timings = {i: {} for i in todo}
    io_pool = ThreadPoolExecutor(max_workers=1)
    out_pool = ThreadPoolExecutor(max_workers=1)

    def _preload(idx):
        if idx >= len(todo):
            return None
        t0 = time.perf_counter()
        img = loader.get_by_id(todo[idx])
        img.load()
        predictor.prestage(img)
        timings[todo[idx]]["load"] = time.perf_counter() - t0
        return img

    def _save(image, fused):
        t0 = time.perf_counter()
        save_nii_files(fused, image, nii_dir, args.save_input_files, logger)
        timings[image.identifier]["save"] = time.perf_counter() - t0

    def _finalize(image, fused):
        try:
            t0 = time.perf_counter()
            fused = fused()
            timings[image.identifier]["predict"] += time.perf_counter() - t0
            _save(image, fused)
        finally:
            # Never leak the staged volume (host + device) on a failed
            # fetch or save; the error surfaces at out_future.result()
            image.unload()

    next_future = io_pool.submit(_preload, 0)
    out_future = None
    try:
        for i, image_id in enumerate(todo):
            image = next_future.result()
            next_future = io_pool.submit(_preload, i + 1)
            try:
                if out_future is not None:
                    # One result in flight at a time; cleared BEFORE
                    # .result() so a save error still unloads this image
                    pending_out, out_future = out_future, None
                    pending_out.result()
                logger(f"\n--- Predicting on {image_id} "
                       f"(shape {tuple(image.shape)}) ---")
                evaluate = (not args.no_eval and image.labels is not None
                            and rng.rand() <= args.eval_prob)
                t0 = time.perf_counter()
                fused, per_view = predictor.predict_image(
                    image, views, fusion_params=fusion_params,
                    n_planes=args.n_planes, return_per_view=evaluate,
                    return_probs=args.no_argmax,
                    defer_fetch=not evaluate and not args.no_argmax,
                    # Per-view dice from on-device confusion counts: only
                    # (3, n_classes) counts leave the device per view
                    eval_labels=image.labels if evaluate else None)
                timings[image_id]["predict"] = time.perf_counter() - t0
                if not evaluate and not args.no_argmax:
                    out_future = out_pool.submit(_finalize, image, fused)
                    continue
                fused_cls = (fused.argmax(-1).astype(np.uint8)
                             if args.no_argmax else fused)
                if evaluate:
                    for v, view in enumerate(views):
                        dices = dice_from_counts(per_view[v],
                                                 ignore_zero=True)
                        pc_results[str(view)].set_column(image_id, dices)
                        results.set(image_id, str(view), np.nanmean(dices))
                        logger(f"View {v}: mean dice {np.nanmean(dices):.4f}")
                    merged_dices = dice_all(image.labels, fused_cls,
                                            n_classes=n_classes,
                                            ignore_zero=True)
                    pc_results["MJ"].set_column(image_id, merged_dices)
                    results.set(image_id, "MJ", np.nanmean(merged_dices))
                    logger(f"Fused: mean dice {np.nanmean(merged_dices):.4f} "
                           f"(per-class {np.round(merged_dices, 4)})")
                    lr.save_all(results, pc_results, out_dir)
                _save(image, fused if args.no_argmax else fused_cls)
            finally:
                if out_future is None:
                    image.unload()
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
        lr.save_all(results, pc_results, out_dir)
    for image_id, t in timings.items():
        logger(f"Timing {image_id}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in t.items()))
    return timings


def entry_func(args=None):
    from multiplanarunet_tpu_torch._device import resolve_device

    args = get_argparser().parse_args(args)
    if args.num_devices > 1:
        raise MultiDeviceNotPortedError(
            f"--num_devices {args.num_devices}: view-parallel inference "
            f"over several GPUs is not ported yet; use 0 or 1")
    device = resolve_device(args.device)
    if args.wait_for:
        from multiplanarunet_tpu_torch.utils.utils import await_PIDs

        await_PIDs(args.wait_for)
    project_dir = os.path.abspath(args.project_dir)
    out_dir = os.path.abspath(os.path.join(project_dir, args.out_dir))
    validate_folders(project_dir, out_dir, args.overwrite, args.continue_)
    os.makedirs(out_dir, exist_ok=True)

    from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
    from multiplanarunet_tpu_torch.logging.loggers import Logger
    from multiplanarunet_tpu_torch.models.model_init import (
        build_model,
        load_unet_weights,
    )
    from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
        MultiViewPredictor,
    )
    from multiplanarunet_tpu_torch.utils.utils import get_best_model

    logger = Logger(out_dir, active_file="predict_log",
                    overwrite_existing=True, no_sub_folder=True)
    try:
        hparams = YAMLHParams(Path(project_dir) / "train_hparams.yaml",
                              logger=logger, no_version_control=True)
        loader = get_image_pair_loader(args, hparams, logger)
        loader.set_scaler_and_bg_values(
            bg_value=hparams.get_from_anywhere("bg_value"),
            scaler=hparams.get_from_anywhere("scaler"),
            compute_now=False)
        views = np.load(Path(project_dir) / "views.npz")["arr_0"]
        logger(f"Using {len(views)} views")

        model = build_model(
            hparams["build"],
            mixed_precision=bool(hparams.get("fit", {}).get(
                "mixed_precision", False)),
            logger=logger)
        weights = get_best_model(Path(project_dir) / "model")
        logger(f"Loading model weights from {weights}")
        model = load_unet_weights(model, weights).to(device)
        fusion_params = load_fusion_params(project_dir, args.sum_fusion,
                                           logger)
        predictor = MultiViewPredictor(
            model, sample_dim=hparams["build"]["dim"],
            real_space_span=hparams["fit"]["real_space_span"],
            n_classes=hparams["build"]["n_classes"], device=device,
            logger=logger, resampler=args.resampler,
            stage_dtype=args.stage_dtype)
        timings = run_predictions_and_eval(
            loader, predictor, views, fusion_params, args, out_dir,
            hparams["build"]["n_classes"], logger)
        logger("Prediction complete.")
        return timings
    finally:
        logger.close()


if __name__ == "__main__":
    entry_func()
