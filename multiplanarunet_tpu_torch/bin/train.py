"""`mp train` on the PyTorch port: train a project's model on one device.

Port of `multiplanarunet_tpu/bin/train.py`: the same arguments (plus
--device), the hparams checks (and the file's version stamps), data
preparation (Auditor fill of the YAML; for the 2D UNet views.npz; the
queues: eager, or with --max_loaded_images N a LimitationQueue holding
at most N training images, each swapped out after --num_access accesses;
train/val sequences: oblique slices, or for the UNet3D the iso_live_3d
boxes or the voxel patches, pooled by default; for the MultiTaskUNet2D
one slice sampler per task YAML, with views_<task>.npz), the model from
the build group (UNet, UNet3D or MultiTaskUNet2D; glorot init,
--continue_training, --initialize_from, the class-frequency output bias,
which a multi-task model skips, as the JAX package does), the Trainer
over the default callbacks, and model/model_weights.npz at the end
(JAX-format .npz files, which either package reads). Training runs on the
card unless --device cpu.

Not ported yet, each raising a named error: --num_devices > 1, a model
class other than UNet, UNet3D and MultiTaskUNet2D; QuantileTransformer
scaling raises when the images load.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp train --project_dir
<project> [--device cpu] ...``.
"""

from __future__ import annotations

import os
import shutil
from argparse import ArgumentParser
from pathlib import Path


def get_argparser():
    parser = ArgumentParser(
        description="Fit a model defined in a project folder. Invoke "
                    "'mp init_project' to start a new project.")
    parser.add_argument("--project_dir", type=str, default="./",
                        help="Path to a project directory (default: cwd)")
    parser.add_argument("--num_devices", "--num_GPUs", dest="num_devices",
                        type=int, default=0,
                        help="Devices to use: 0 or 1 (multi-device "
                             "training is not ported yet)")
    parser.add_argument("--continue_training", action="store_true",
                        help="Continue the last training session")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite previous session in the project path")
    parser.add_argument("--initialize_from", type=str, default=None,
                        help="Path to a weights file to (partially) "
                             "initialize the model from")
    parser.add_argument("--just_one", action="store_true",
                        help="Run on only the first train/val image (testing)")
    parser.add_argument("--no_val", action="store_true",
                        help="Do not perform validation")
    parser.add_argument("--no_images", action="store_true",
                        help="Do not save sample images during training")
    parser.add_argument("--wait_for", type=str, default="",
                        help="Wait for these PIDs to terminate before "
                             "starting")
    parser.add_argument("--train_images_per_epoch", type=int, default=2500)
    parser.add_argument("--val_images_per_epoch", type=int, default=3500)
    parser.add_argument("--max_loaded_images", type=int, default=None,
                        help="Bound the training images resident on the "
                             "host and the device; cycled every "
                             "--num_access accesses")
    parser.add_argument("--epochs", type=int, default=None,
                        help="Override the configured number of epochs")
    parser.add_argument("--num_access", type=int, default=50,
                        help="Accesses of a loaded image before "
                             "--max_loaded_images swaps it for another")
    parser.add_argument("--debug", action="store_true",
                        help="Enable autograd anomaly detection (stops at "
                             "the first op producing a NaN in backward)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: 'cuda' (default) or 'cuda:N' "
                             "(raises when no card is visible), or 'cpu'")
    return parser


def validate_args(args):
    from multiplanarunet_tpu_torch.bin.predict import (
        MultiDeviceNotPortedError,
    )

    if args.continue_training and args.overwrite:
        raise ValueError("Cannot both --continue_training and --overwrite.")
    if args.train_images_per_epoch <= 0:
        raise ValueError("train_images_per_epoch must be positive")
    if args.val_images_per_epoch <= 0:
        raise ValueError("val_images_per_epoch must be positive "
                         "(use --no_val to disable validation)")
    if args.num_devices > 1:
        raise MultiDeviceNotPortedError(
            f"--num_devices {args.num_devices}: data-parallel training over "
            f"several GPUs is not ported yet; use 0 or 1")


def validate_project_dir(project_dir):
    if not (Path(project_dir) / "train_hparams.yaml").exists():
        raise RuntimeError(
            f"'{project_dir}' is not a valid project folder (no "
            f"train_hparams.yaml). Run 'mp init_project' first.")


def validate_hparams(hparams):
    loss_kwargs = hparams["fit"].get("loss_kwargs") or {}
    if hparams["fit"].get("class_weights") and \
            "class_weights" not in loss_kwargs:
        if "Focal" not in str(hparams["fit"]["loss"]):
            raise ValueError(
                "class_weights are only supported with SparseFocalLoss")


def remove_previous_session(project_dir):
    for sub in ("images", "logs", "tensorboard", "views.npz", "views.png",
                "model"):
        path = Path(project_dir) / sub
        if path.is_dir():
            shutil.rmtree(path)
        elif path.exists():
            path.unlink()


def get_data_sequences(project_dir, hparams, logger, args, device):
    from multiplanarunet_tpu_torch.models.model_init import (
        UnsupportedModelError,
    )
    from multiplanarunet_tpu_torch.preprocessing.data_preparation_funcs \
        import PREPARATION_FUNCS

    model_name = hparams["build"]["model_class_name"]
    if model_name not in PREPARATION_FUNCS:
        raise UnsupportedModelError(
            f"model_class_name {model_name!r} is not ported to PyTorch yet "
            f"(the port trains {sorted(PREPARATION_FUNCS)})")
    hparams["fit"]["max_loaded"] = args.max_loaded_images
    hparams["fit"]["num_access"] = args.num_access
    return PREPARATION_FUNCS[model_name](
        hparams=hparams, just_one=args.just_one, no_val=args.no_val,
        continue_training=args.continue_training, logger=logger,
        base_path=project_dir, device=device)


def get_model(project_dir, train_seq, hparams, logger, args):
    from multiplanarunet_tpu_torch.models.model_init import model_initializer
    from multiplanarunet_tpu_torch.utils.utils import (
        estimate_class_frequencies,
        set_bias_weights,
    )

    model, init_epoch, restored_lr = model_initializer(
        hparams=hparams, continue_training=args.continue_training,
        project_dir=project_dir, logger=logger,
        initialize_from=args.initialize_from)
    if isinstance(hparams["build"].get("n_classes"), (list, tuple)):
        # Multi-task: per-task output layers, which the shared class
        # frequency estimate cannot bias
        return model, init_epoch, restored_lr
    if not args.continue_training and \
            hparams["build"].get("biased_output_layer"):
        counts = estimate_class_frequencies(
            train_seq.image_pair_queue, hparams["build"]["n_classes"],
            logger=logger)
        set_bias_weights(model, counts, logger=logger)
    return model, init_epoch, restored_lr


def run(project_dir, logger, args, device):
    import torch

    from multiplanarunet_tpu_torch.callbacks.funcs import (
        remove_validation_callbacks,
    )
    from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
    from multiplanarunet_tpu_torch.train.trainer import Trainer

    if args.debug:
        torch.autograd.set_detect_anomaly(True)
        logger("--debug: autograd anomaly detection enabled")
    hparams = YAMLHParams(Path(project_dir) / "train_hparams.yaml",
                          logger=logger)
    validate_hparams(hparams)
    train, val = get_data_sequences(project_dir, hparams, logger, args,
                                    device)
    model, init_epoch, restored_lr = get_model(project_dir, train, hparams,
                                               logger, args)
    logger(f"Using device {device}")
    trainer = Trainer(model, logger=logger, device=device)
    fit = hparams["fit"]
    loss_kwargs = dict(fit.get("loss_kwargs") or {})
    if fit.get("class_weights") is True and "class_weights" not in loss_kwargs:
        from multiplanarunet_tpu_torch.utils.utils import (
            compute_class_weights,
            estimate_class_frequencies,
        )

        counts = estimate_class_frequencies(
            train.image_pair_queue, hparams["build"]["n_classes"],
            logger=logger)
        loss_kwargs["class_weights"] = [
            round(float(w), 5) for w in compute_class_weights(counts)]
        logger(f"Auto class weights: {loss_kwargs['class_weights']}")
    trainer.compile_model(
        optimizer=fit["optimizer"],
        optimizer_kwargs=fit.get("optimizer_kwargs"),
        loss=fit["loss"], metrics=fit.get("metrics"),
        loss_kwargs=loss_kwargs,
        l1_reg=hparams["build"].get("l1_reg") or 0.0,
        l2_reg=hparams["build"].get("l2_reg") or 0.0)
    if restored_lr:
        trainer.set_learning_rate(restored_lr)
        logger(f"Restored learning rate: {restored_lr}")

    callbacks = fit.get("callbacks", [])
    if args.no_val:
        callbacks = remove_validation_callbacks(callbacks, logger)
    try:
        trainer.fit(
            train, val, batch_size=fit["batch_size"],
            n_epochs=args.epochs or fit["n_epochs"], callbacks=callbacks,
            train_im_per_epoch=args.train_images_per_epoch,
            val_im_per_epoch=args.val_images_per_epoch,
            init_epoch=init_epoch, verbose=fit.get("verbose", True),
            no_im=args.no_images)
    finally:
        path = Path(project_dir) / "model" / "model_weights.npz"
        logger(f"Saving current model to: {path}")
        trainer.save_checkpoint(path)
    hparams.save_current()
    return trainer


def entry_func(args=None):
    from multiplanarunet_tpu_torch._device import resolve_device
    from multiplanarunet_tpu_torch.logging.loggers import Logger
    from multiplanarunet_tpu_torch.utils.utils import await_PIDs

    args = get_argparser().parse_args(args)
    validate_args(args)
    device = resolve_device(args.device)
    project_dir = os.path.abspath(args.project_dir)
    validate_project_dir(project_dir)
    os.chdir(project_dir)
    if args.overwrite:
        remove_previous_session(project_dir)
    logger = Logger(project_dir, active_file="train",
                    overwrite_existing=args.overwrite
                    or args.continue_training)
    try:
        logger(f"Project directory: {project_dir}")
        if args.wait_for:
            await_PIDs(args.wait_for, logger=logger)
        return run(project_dir, logger, args, device)
    finally:
        logger.close()


if __name__ == "__main__":
    entry_func()
