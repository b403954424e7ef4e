"""`mp toy_data` on the PyTorch port: synthetic NIfTI train/val/test data
for tests and smoke runs.

Port of `multiplanarunet_tpu/bin/toy_data.py` (numpy and
scipy.ndimage.gaussian_filter, written through the port's NIfTI writer):
seeded volumes holding three foreground structures (a sphere, a cube and a
torus) over a noisy background, written as image/label .nii.gz pairs
under train/val/test sub-folders. For the same --seed it draws the same
numbers in the same order, so it writes the JAX package's arrays.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp toy_data --out_dir
<folder> ...``.
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np
from scipy.ndimage import gaussian_filter

from multiplanarunet_tpu_torch.io import nifti


def get_argparser():
    parser = ArgumentParser(description="Create a toy dataset of synthetic "
                                        "segmentation volumes.")
    parser.add_argument("--out_dir", type=str, required=True,
                        help="Directory in which the toy data will be stored")
    parser.add_argument("--N_train", type=int, default=10)
    parser.add_argument("--N_val", type=int, default=5)
    parser.add_argument("--N_test", type=int, default=5)
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--N_channels", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--pixdim", type=str, default="1,1,1",
                        help="Comma-separated voxel sizes (mm), e.g. "
                             "'1,0.7,1.3' for anisotropic volumes")
    parser.add_argument("--vary_size", action="store_true",
                        help="Draw each subject's shape independently per "
                             "axis in [0.75, 1.25] x image_size (realistic "
                             "per-subject shape variation)")
    return parser


def _sphere_mask(xx, yy, zz, center, radius):
    return ((xx - center[0]) ** 2 + (yy - center[1]) ** 2
            + (zz - center[2]) ** 2) <= radius ** 2


def _cube_mask(xx, yy, zz, center, half):
    return (
        (np.abs(xx - center[0]) <= half)
        & (np.abs(yy - center[1]) <= half)
        & (np.abs(zz - center[2]) <= half)
    )


def _torus_mask(xx, yy, zz, center, R, r):
    dx, dy, dz = xx - center[0], yy - center[1], zz - center[2]
    ring = np.sqrt(dx ** 2 + dy ** 2) - R
    return (ring ** 2 + dz ** 2) <= r ** 2


def create_toy_image(size=64, n_channels=1, rng=None, shape=None):
    """One synthetic (image, labels) volume pair.

    Labels: 0 background, 1 sphere, 2 cube, 3 torus. Image intensity is a
    smoothed, noisy function of the label map with per-structure contrast, so
    a segmentation model has real signal to learn."""
    rng = rng or np.random.RandomState()
    shape = tuple(int(s) for s in (shape or (size, size, size)))
    ax = [np.arange(n, dtype=np.float32) for n in shape]
    xx, yy, zz = np.meshgrid(*ax, indexing="ij")
    labels = np.zeros(shape, np.uint8)

    def rand_center(margin):
        return np.array([
            rng.uniform(margin, n - margin) for n in shape
        ])

    s = size / 64.0  # scale structure sizes with the volume
    sphere_r = rng.uniform(6, 10) * s
    cube_h = rng.uniform(5, 8) * s
    torus_R, torus_r = rng.uniform(8, 12) * s, rng.uniform(2.5, 4) * s

    labels[_sphere_mask(xx, yy, zz, rand_center(sphere_r + 4), sphere_r)] = 1
    labels[_cube_mask(xx, yy, zz, rand_center(cube_h + 4), cube_h)] = 2
    labels[_torus_mask(xx, yy, zz, rand_center(torus_R + torus_r + 4),
                       torus_R, torus_r)] = 3

    # Mild random elastic warp of the label map for shape variability
    disp = [
        gaussian_filter(rng.normal(scale=1.0, size=labels.shape), 6) * 10 * s
        for _ in range(3)
    ]
    warped_idx = [
        np.clip(g + d, 0, n - 1).astype(np.int32)
        for g, d, n in zip((xx, yy, zz), disp, shape)
    ]
    labels = labels[warped_idx[0], warped_idx[1], warped_idx[2]]

    contrasts = np.array([0.0, 1.0, 1.6, 2.4], np.float32)
    base = contrasts[labels]
    image = np.empty(shape + (n_channels,), np.float32)
    for c in range(n_channels):
        chan = base * rng.uniform(0.8, 1.2) + rng.normal(
            scale=0.35, size=base.shape
        )
        image[..., c] = gaussian_filter(chan, 0.8)
    if n_channels == 1:
        image = image[..., 0]
    return image.astype(np.float32), labels.astype(np.uint8)


def create_dataset(out_dir, n_images, size, n_channels, rng, prefix,
                   pixdim=(1.0, 1.0, 1.0), vary_size=False):
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "labels").mkdir(parents=True, exist_ok=True)
    affine = np.diag(list(pixdim) + [1.0])
    for i in range(n_images):
        shape = None
        if vary_size:
            shape = tuple(
                int(rng.uniform(0.75, 1.25) * size) for _ in range(3)
            )
        image, labels = create_toy_image(size, n_channels, rng, shape=shape)
        name = f"{prefix}_{i:03d}.nii.gz"
        nifti.save(image, out_dir / "images" / name, affine=affine)
        nifti.save(labels, out_dir / "labels" / name, affine=affine)


def entry_func(args=None):
    args = get_argparser().parse_args(args)
    rng = np.random.RandomState(args.seed)
    out = Path(args.out_dir)
    pixdim = tuple(float(p) for p in args.pixdim.split(","))
    for split, n in (("train", args.N_train), ("val", args.N_val),
                     ("test", args.N_test)):
        print(f"Creating {n} '{split}' images of size {args.image_size} "
              f"(pixdim {pixdim})...")
        create_dataset(out / split, n, args.image_size, args.N_channels,
                       rng, prefix=split, pixdim=pixdim,
                       vary_size=args.vary_size)
    print(f"Toy data written to {out}")


if __name__ == "__main__":
    entry_func()
