"""`mp train` on the PyTorch port: train a project's model on one device.

Port of `multiplanarunet_tpu/bin/train.py`: the same arguments (plus
--device), the hparams checks (and the file's version stamps), data
preparation (Auditor fill of the YAML; for the 2D UNet views.npz; the
queues: eager, or with --max_loaded_images N a LimitationQueue holding
at most N training images, each swapped out after --num_access accesses;
train/val sequences: oblique slices, or for the UNet3D and the
SwinUNETR the iso_live_3d boxes or the voxel patches, pooled by
default; for the MultiTaskUNet2D one slice sampler per task YAML, with
views_<task>.npz), the model from the build group (UNet, UNet3D,
MultiTaskUNet2D or SwinUNETR; glorot init, a SwinUNETR's `swin_init`,
--continue_training, --initialize_from, the class-frequency output bias,
which a multi-task model skips, as the JAX package does), the Trainer
over the default callbacks, and model/model_weights.npz at the end
(JAX-format .npz files, which either package reads). Training runs on the
card unless --device cpu. A model class other than UNet, UNet3D,
MultiTaskUNet2D and SwinUNETR raises a named error.

Data-parallel training, one process per card:

  * under a launch marker (MPUNET_COORDINATOR_ADDRESS /
    MPUNET_NUM_PROCESSES / MPUNET_PROCESS_ID, or torchrun's), this
    process is one rank: it starts the process group before it touches
    the project folder, the main process alone does the --overwrite
    cleanup (the others wait at a barrier), logs go to logs/train.txt on
    the main process and logs/train_rank<r>.txt on the others, and only
    the main process writes checkpoints, the CSV, views.npz and the YAML;
  * --num_devices N without a marker starts N such ranks itself, on
    localhost (rank r on cuda:r, or on the CPU under --device cpu), after
    checking that N cards are visible (TooFewDevicesError otherwise,
    before any process starts). Their global batch is padded to a
    multiple of N where N does not divide it, as the JAX package's
    N-device mesh pads it; under an external launcher it must divide.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp train --project_dir
<project> [--device cpu] [--num_devices N] ...``.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import time
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
                        help="Train data-parallel over N devices, one "
                             "process each (started here unless a launch "
                             "marker is set); 0 or 1: one device")
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
    import torch

    from multiplanarunet_tpu_torch._device import require_devices
    from multiplanarunet_tpu_torch.parallel.distributed import launch_config

    if args.continue_training and args.overwrite:
        raise ValueError("Cannot both --continue_training and --overwrite.")
    if args.train_images_per_epoch <= 0:
        raise ValueError("train_images_per_epoch must be positive")
    if args.val_images_per_epoch <= 0:
        raise ValueError("val_images_per_epoch must be positive "
                         "(use --no_val to disable validation)")
    if args.num_devices > 1:
        device = torch.device(args.device)
        if device.type == "cuda" and device.index is not None:
            raise ValueError(
                f"--num_devices {args.num_devices} trains one rank per card; "
                f"use --device cuda (rank r on cuda:r) or --device cpu, not "
                f"{args.device}")
        cfg = launch_config()
        if cfg is not None and cfg[1] != args.num_devices:
            raise ValueError(
                f"--num_devices {args.num_devices} under a launch of "
                f"{cfg[1]} processes")
        if cfg is None and device.type == "cuda":
            require_devices(args.num_devices)


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


def get_model(project_dir, train_seq, hparams, logger, args, device=None):
    from multiplanarunet_tpu_torch.models.model_init import model_initializer
    from multiplanarunet_tpu_torch.utils.utils import (
        estimate_class_frequencies,
        set_bias_weights,
    )

    model, init_epoch, restored_lr = model_initializer(
        hparams=hparams, continue_training=args.continue_training,
        project_dir=project_dir, logger=logger,
        initialize_from=args.initialize_from, device=device)
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


def save_final_weights(trainer, project_dir, logger=None):
    """The trainer's model to <project_dir>/model/model_weights.npz (the
    JAX package's format)."""
    path = Path(project_dir) / "model" / "model_weights.npz"
    if logger:
        logger(f"Saving current model to: {path}")
    trainer.save_checkpoint(path)


def run(project_dir, logger, args, device):
    import torch

    from multiplanarunet_tpu_torch.callbacks.funcs import (
        remove_validation_callbacks,
    )
    from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
    from multiplanarunet_tpu_torch.ops import prng
    from multiplanarunet_tpu_torch.ops.unet_epilogue import unet_epilogue
    from multiplanarunet_tpu_torch.parallel.distributed import is_main_process
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
                                               logger, args, device)
    logger(f"Using device {device}")
    trainer = Trainer(model, logger=logger, device=device,
                      pad_global_batch=args.num_devices > 1)
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
        if is_main_process():
            save_final_weights(trainer, project_dir, logger)
    hparams.save_current()  # the main process only
    # The random draws' kernel launches of this process (weights and
    # augmentation; 0 on the CPU, where the plain version draws)
    logger(f"threefry2x32 launches: {prng.threefry2x32.launches}")
    # The U-Net's conv epilogue launches of this process (validation's
    # forwards; 0 on the CPU, where the plain version runs)
    logger(f"unet_epilogue launches: {unet_epilogue.launches}")
    return trainer


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv, n):
    """Run `mp train <argv>` as n ranks on localhost (the MPUNET_* markers
    with LOCAL_RANK = rank) and wait for them; a rank that fails ends the
    others and raises. Returns the exit codes."""
    import multiplanarunet_tpu_torch

    repo = str(Path(multiplanarunet_tpu_torch.__file__).resolve().parents[1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, env.get("PYTHONPATH", "")) if p)
    env["MPUNET_COORDINATOR_ADDRESS"] = f"localhost:{_free_port()}"
    env["MPUNET_NUM_PROCESSES"] = str(n)
    procs = []
    for rank in range(n):
        env.update(MPUNET_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "multiplanarunet_tpu_torch.bin.mp",
             "train", *argv], env=dict(env)))
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"mp train rank {failed[0]} exited "
                    f"{procs[failed[0]].returncode}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"mp train ranks exited {codes}")
    return codes


def entry_func(args=None):
    from multiplanarunet_tpu_torch.logging.loggers import Logger
    from multiplanarunet_tpu_torch.parallel.distributed import (
        data_group_active,
        is_main_process,
        launch_config,
        maybe_initialize_distributed,
        process_barrier,
        process_index,
        rank_device,
        shutdown_distributed,
    )
    from multiplanarunet_tpu_torch.utils.utils import await_PIDs

    argv = list(sys.argv[1:] if args is None else args)
    args = get_argparser().parse_args(argv)
    validate_args(args)
    if args.num_devices > 1 and launch_config() is None:
        return launch_ranks(argv, args.num_devices)
    device = rank_device(args.device)
    project_dir = os.path.abspath(args.project_dir)
    validate_project_dir(project_dir)
    os.chdir(project_dir)
    # The group starts before the shared project folder is touched: the
    # overwrite cleanup must finish before another rank opens its log
    # file inside logs/
    started = not data_group_active()
    maybe_initialize_distributed(device=device)
    try:
        if args.overwrite and is_main_process():
            remove_previous_session(project_dir)
        process_barrier("mp-train-overwrite")
        logger = Logger(project_dir,
                        active_file="train" if is_main_process()
                        else f"train_rank{process_index()}",
                        overwrite_existing=args.overwrite
                        or args.continue_training)
        try:
            logger(f"Project directory: {project_dir}")
            if args.wait_for:
                await_PIDs(args.wait_for, logger=logger)
            trainer = run(project_dir, logger, args, device)
            process_barrier("mp-train-done")
            return trainer
        finally:
            logger.close()
    finally:
        if started:
            shutdown_distributed()


if __name__ == "__main__":
    entry_func()
