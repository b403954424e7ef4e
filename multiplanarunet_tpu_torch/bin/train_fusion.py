"""`mp train_fusion` on the PyTorch port: train the per-class-per-view
FusionModel of a trained project.

Port of `multiplanarunet_tpu/bin/train_fusion.py`, with the same
arguments (plus --device): map every view over the validation images
(topped up with random training images to >= --min_val_images) in rounds
of --images_per_round, stack the per-voxel (n_views, n_classes)
probability points, fit the fusion layer with Adam + Sparse Generalized
Dice Loss and early stopping, and save
model/fusion_weights/<weights>_fusion_weights.npz (JAX format) after each
round. Points, targets, the split, the batches and the validation stay on
the device; one small tensor (the mean loss and the (3, n_classes)
confusion counts) is fetched per epoch.

The numpy draws are the JAX package's, in its order (the image top-up,
the 80/20 split, one draw per round that seeds the epoch shuffles), so
--seed leaves numpy's stream where the JAX package leaves it. The epoch
shuffles and the --max_points_per_image subsets are the JAX package's
jax.random draws, through `ops.prng`: each epoch splits the round's key
PRNGKey(that draw) and shuffles with `permutation(epoch key, n_train)`;
the subset of image i of round r is the first max_points of
`permutation(PRNGKey(r * 1000 + i), n_voxels)`.

Under a launch marker (MPUNET_* or torchrun's) each process is one rank
of a gloo group: the main process's draw of the image set is broadcast,
each round's images are mapped round-robin over the ranks (an image's
points depend on (round, index) alone, so which rank maps it changes no
value) and exchanged through model/fusion_weights/.points_tmp/
r<round>_i<index>.npz; rank 0 fits on the round's points in image order
and writes the one checkpoint, the other ranks reload it, and
.points_tmp is removed at the end. Logs go to logs/train_fusion.txt on
rank 0 and logs/train_fusion_rank<r>.txt on the others. --num_devices N
> 1 checks that N cards are visible; each process maps on one.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp train_fusion
--project_dir <project> [--device cpu] ...``.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def get_argparser():
    parser = ArgumentParser(description="Train the view-fusion model")
    parser.add_argument("--project_dir", type=str, default="./")
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--num_devices", "--num_GPUs", dest="num_devices",
                        type=int, default=0,
                        help="Devices to check for; each process maps on "
                             "one device (launch several processes to "
                             "split the mapping)")
    parser.add_argument("--images_per_round", type=int, default=5,
                        help="Images to map per fusion training round")
    parser.add_argument("--min_val_images", type=int, default=15,
                        help="Top up the validation image set to this many "
                             "images using random training images")
    parser.add_argument("--batch_size", type=int, default=2 ** 17,
                        help="Voxel batch size for fusion training")
    parser.add_argument("--epochs", type=int, default=30,
                        help="Epochs per training round")
    parser.add_argument("--early_stopping", type=int, default=3)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--dice_weight", type=str, default="Simple",
                        help="GDL weight type: Simple/Square/Uniform")
    parser.add_argument("--n_planes", type=str, default="same+20")
    parser.add_argument("--max_points_per_image", type=int, default=2 ** 22,
                        help="Train the fusion layer on at most this many "
                             "uniformly-sampled voxels per image (0 = all; "
                             "the layer has only (V+1)*C parameters, so a "
                             "few million points match training on every "
                             "voxel while bounding device memory)")
    parser.add_argument("--continue_training", action="store_true",
                        help="Resume fusion training from saved fusion "
                             "weights")
    parser.add_argument("--eval_prob", type=float, default=1.0)
    parser.add_argument("--wait_for", type=str, default="")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed numpy's global RNG, which drives the "
                             "fusion fit's split and shuffles "
                             "(reproducible fits)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: 'cuda' (default) or 'cuda:N' "
                             "(raises when no card is visible), or 'cpu'")
    return parser


def _class_counts(values, n_classes):
    """(n_classes,) int64 counts of the values in [0, n_classes); larger
    values are dropped, as jnp.bincount(length=n_classes) drops them."""
    import torch

    values = values.long()
    spare = torch.where(values < n_classes, values, n_classes)
    counts = torch.zeros(n_classes + 1, dtype=torch.int64,
                         device=values.device)
    counts.index_add_(0, spare, torch.ones_like(spare))
    return counts[:n_classes]


def val_counts(model, Xval, yval, n_classes):
    """(3, n_classes) int64 (tp, rel, sel) of the fusion model's argmax on
    the validation points, on their device."""
    import torch

    with torch.no_grad():
        pred = model(Xval).argmax(dim=-1)
    tp = _class_counts(torch.where(pred == yval, yval, n_classes), n_classes)
    return torch.stack([tp, _class_counts(yval, n_classes),
                        _class_counts(pred, n_classes)])


def _fit_fusion(points, targets, n_views, n_classes, args, logger,
                init_params=None):
    """Fit the fusion layer on stacked voxel points with early stopping,
    on the device the points lie on. Returns the best epoch's weights as
    a {"fusion": {"W", "b"}} tree of numpy arrays.

    The loss treats the whole voxel batch as ONE element of the GDL (a sum
    over voxels), plus the layer's mean-square regulariser; Adam is
    optax.adam's update (`train/optimizers.Adam`)."""
    import torch

    from multiplanarunet_tpu_torch.evaluate.losses import (
        SparseGeneralizedDiceLoss,
    )
    from multiplanarunet_tpu_torch.models.fusion_model import (
        FusionModel,
        params_tree,
    )
    from multiplanarunet_tpu_torch.ops import prng
    from multiplanarunet_tpu_torch.train.optimizers import Adam

    points = torch.as_tensor(points).to(torch.float32)
    dev = points.device
    targets = torch.as_tensor(targets).to(dev, torch.int32)
    fm = FusionModel(n_views, n_classes, params=init_params).to(dev)
    opt = Adam(fm.parameters(), args.learning_rate)
    loss_obj = SparseGeneralizedDiceLoss(type_weight=args.dice_weight)

    # Shuffle + 20% validation split (host permutation, device gather)
    n = int(points.shape[0])
    perm = torch.from_numpy(np.random.permutation(n)).to(dev)
    n_val = max(1, int(0.2 * n))
    Xtr, ytr = points[perm[n_val:]], targets[perm[n_val:]]
    Xval, yval = points[perm[:n_val]], targets[perm[:n_val]]
    del points, targets, perm

    n_tr = int(Xtr.shape[0])
    bs = min(args.batch_size, n_tr)
    n_batches = max(n_tr // bs, 1)

    def step(x, y):
        loss = loss_obj(y[None, :, None], fm(x)[None]) + fm.regularizer()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    key = prng.PRNGKey(np.random.randint(2 ** 31))
    best_dice, wait = -1.0, 0
    best = (fm.W.detach().clone(), fm.b.detach().clone())
    t0, epochs_run = time.perf_counter(), 0
    for epoch in range(args.epochs):
        key, epoch_key = prng.split(key)
        idx = prng.permutation(epoch_key, n_tr, device=dev)
        idx = idx[: n_batches * bs].reshape(n_batches, bs)
        mean_loss = torch.stack([step(Xtr[b], ytr[b]) for b in idx]).mean()
        counts = val_counts(fm, Xval, yval, n_classes)
        fetched = torch.cat([mean_loss.double()[None],
                             counts.double().reshape(-1)]).cpu().numpy()
        epochs_run += 1
        tp, rel, sel = fetched[1:].reshape(3, n_classes)
        # dice_all semantics: NaN for absent classes, fg-only mean
        denom = rel + sel
        with np.errstate(invalid="ignore"):
            dice = np.where(denom > 0, 2.0 * tp / denom, np.nan)
        val_dice = float(np.nanmean(dice[1:] if n_classes > 1 else dice))
        logger(f"  epoch {epoch + 1}/{args.epochs}: "
               f"loss={float(fetched[0]):.5f} val_dice={val_dice:.5f}")
        if val_dice > best_dice:
            # A copy: the optimizer updates W and b in place
            best_dice, wait = val_dice, 0
            best = (fm.W.detach().clone(), fm.b.detach().clone())
        else:
            wait += 1
            if wait >= args.early_stopping:
                logger("  early stopping.")
                break
    secs = time.perf_counter() - t0
    logger(f"  best fusion val_dice: {best_dice:.5f}")
    logger(f"  fit: {epochs_run} epochs in {secs:.3f} s "
           f"({secs / max(epochs_run, 1):.4f} s per epoch, {n_batches} "
           f"batches of {bs})")
    return params_tree(*best)


def _fusion_image_set(hparams, args, logger):
    """The val images, topped up with random training images (numpy's
    global RNG, before --seed is applied, as in the JAX package; the main
    process's draw in a process group), with the project's bg value and
    scaler set."""
    from multiplanarunet_tpu_torch.image.image_pair_loader import (
        ImagePairLoader,
    )

    from multiplanarunet_tpu_torch.parallel.distributed import (
        broadcast_from_main,
    )

    val_loader = ImagePairLoader(logger=logger, **hparams["val_data"])
    images = list(val_loader.images)
    if len(images) < args.min_val_images:
        train_loader = ImagePairLoader(logger=logger, **hparams["train_data"])
        need = args.min_val_images - len(images)
        extra = list(train_loader.get_random(
            min(need, len(train_loader)), unique=True))
        # Every process of a group maps the main process's draw
        ids = broadcast_from_main(np.asarray([im.identifier for im in extra]))
        extra = [train_loader.get_by_id(str(i)) for i in ids]
        logger(f"Adding {len(extra)} random training images to the fusion "
               f"set")
        images += extra
    for im in images:
        im.set_bg_value(hparams.get_from_anywhere("bg_value"))
        im.set_scaler(hparams.get_from_anywhere("scaler"))
    return images


def run(project_dir, args, device, logger):
    import torch

    from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams
    from multiplanarunet_tpu_torch.models import checkpoint
    from multiplanarunet_tpu_torch.models.model_init import (
        build_model,
        load_unet_weights,
    )
    from multiplanarunet_tpu_torch.ops import prng
    from multiplanarunet_tpu_torch.parallel.distributed import (
        process_barrier,
        process_count,
        process_index,
    )
    from multiplanarunet_tpu_torch.utils.fusion.fuse_and_predict import (
        MultiViewPredictor,
    )
    from multiplanarunet_tpu_torch.utils.utils import get_best_model

    hparams = YAMLHParams(Path(project_dir) / "train_hparams.yaml",
                          logger=logger, no_version_control=True)
    views = np.load(Path(project_dir) / "views.npz")["arr_0"]
    n_classes = hparams["build"]["n_classes"]
    n_views = len(views)

    weights_path = get_best_model(Path(project_dir) / "model")
    weights_name = Path(weights_path).stem
    fusion_dir = Path(project_dir) / "model" / "fusion_weights"
    fusion_dir.mkdir(parents=True, exist_ok=True)
    fusion_out = fusion_dir / f"{weights_name}_fusion_weights.npz"
    if fusion_out.exists() and not (args.overwrite or args.continue_training):
        raise RuntimeError(f"{fusion_out} exists; pass --overwrite or "
                           f"--continue_training")

    # Unet with best weights
    model = build_model(
        hparams["build"],
        mixed_precision=bool(hparams.get("fit", {}).get("mixed_precision",
                                                        False)),
        logger=logger)
    model = load_unet_weights(model, weights_path).to(device)
    logger(f"Loaded U-Net weights from {weights_path}")
    predictor = MultiViewPredictor(
        model, sample_dim=hparams["build"]["dim"],
        real_space_span=hparams["fit"]["real_space_span"],
        n_classes=n_classes, device=device, logger=logger)

    images = _fusion_image_set(hparams, args, logger)
    fusion_params = None
    if args.continue_training and fusion_out.exists():
        fusion_params, _, _ = checkpoint.load_weights(fusion_out)
        logger(f"Resuming fusion training from {fusion_out}")
    if args.seed is not None:
        np.random.seed(args.seed)

    n_procs, rank = process_count(), process_index()
    points_tmp = fusion_dir / ".points_tmp"
    if n_procs > 1:
        points_tmp.mkdir(parents=True, exist_ok=True)

    n_rounds = -(-len(images) // args.images_per_round)
    for rnd in range(n_rounds):
        batch = images[rnd * args.images_per_round:
                       (rnd + 1) * args.images_per_round]
        logger(f"\n=== Fusion round {rnd + 1}/{n_rounds} "
               f"({len(batch)} images) ===")
        points_coll, targets_coll = [], []
        for i, image in enumerate(batch):
            if i % n_procs != rank:
                continue
            with image.loaded_in_context():
                logger(f"Mapping views over {image.identifier}...")
                # Each image's subset depends on (round, index) alone
                pts, tgt = predictor.predict_views_points(
                    image, views, n_planes=args.n_planes,
                    max_points=args.max_points_per_image or None,
                    key=prng.PRNGKey(rnd * 1000 + i))
                if n_procs > 1:
                    np.savez(points_tmp / f"r{rnd}_i{i:04d}.npz",
                             pts=pts.cpu().numpy(), tgt=tgt.cpu().numpy())
                else:
                    points_coll.append(pts)
                    targets_coll.append(tgt)
        if n_procs > 1:
            process_barrier(f"mp-fusion-r{rnd}-points")
            if rank == 0:
                for i in range(len(batch)):
                    with np.load(points_tmp / f"r{rnd}_i{i:04d}.npz") as f:
                        points_coll.append(torch.from_numpy(f["pts"]).to(
                            device))
                        targets_coll.append(torch.from_numpy(f["tgt"]).to(
                            device))
        if rank == 0:
            X = torch.cat(points_coll)
            y = torch.cat(targets_coll)
            del points_coll, targets_coll
            logger(f"Training fusion on {len(X)} voxel points "
                   f"(device-resident)")
            fusion_params = _fit_fusion(X, y, n_views, n_classes, args,
                                        logger, init_params=fusion_params)
            del X, y
            checkpoint.save_weights(
                fusion_out, fusion_params,
                meta={"round": rnd + 1, "n_views": n_views})
            logger(f"Saved fusion weights to {fusion_out}")
        if n_procs > 1:
            process_barrier(f"mp-fusion-r{rnd}-fit")
            if rank:
                fusion_params, _, _ = checkpoint.load_weights(fusion_out)
    if n_procs > 1:
        process_barrier("mp-fusion-done")
        if rank == 0:
            import shutil

            shutil.rmtree(points_tmp, ignore_errors=True)
    logger("Fusion training complete.")
    logger(f"Final fusion W:\n"
           f"{np.asarray(fusion_params['fusion']['W'])}")
    if device.type == "cuda":
        logger(f"Peak allocated device memory: "
               f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    # The random draws' kernel launches of this process (shuffles and
    # point subsets; 0 on the CPU, where the plain version draws)
    logger(f"threefry2x32 launches: {prng.threefry2x32.launches}")
    return fusion_params


def entry_func(args=None):
    import torch

    from multiplanarunet_tpu_torch._device import require_devices
    from multiplanarunet_tpu_torch.logging.loggers import Logger
    from multiplanarunet_tpu_torch.parallel.distributed import (
        data_group_active,
        is_main_process,
        maybe_initialize_distributed,
        process_index,
        rank_device,
        shutdown_distributed,
    )
    from multiplanarunet_tpu_torch.utils.utils import await_PIDs

    args = get_argparser().parse_args(args)
    if args.num_devices > 1 and torch.device(args.device).type == "cuda":
        require_devices(args.num_devices)
    device = rank_device(args.device)
    if args.wait_for:
        await_PIDs(args.wait_for)
    project_dir = os.path.abspath(args.project_dir)
    os.chdir(project_dir)
    # Host coordination only: a gloo group, started before the per-rank
    # log file is opened
    started = not data_group_active()
    maybe_initialize_distributed(device=device, backend="gloo")
    logger = Logger(project_dir,
                    active_file="train_fusion" if is_main_process()
                    else f"train_fusion_rank{process_index()}",
                    overwrite_existing=True)
    try:
        return run(project_dir, args, device, logger)
    finally:
        logger.close()
        if started:
            shutdown_distributed()


if __name__ == "__main__":
    entry_func()
