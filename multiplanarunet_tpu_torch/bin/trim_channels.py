"""`mp trim_channels`: strip channels from NIfTI files in place.

Port of `multiplanarunet_tpu/bin/trim_channels.py`, on the port's own
NIfTI io (numpy only)."""

from __future__ import annotations

from argparse import ArgumentParser
from glob import glob
from pathlib import Path

import numpy as np

from multiplanarunet_tpu_torch.io import nifti


def get_argparser():
    parser = ArgumentParser(description="Keep only selected channels of "
                                        ".nii files (in place)")
    parser.add_argument("--folder", type=str, required=True,
                        help="Folder of .nii/.nii.gz files")
    parser.add_argument("--channels", type=str, default="0",
                        help="Comma-separated channel indices to KEEP")
    return parser


def entry_func(args=None):
    args = get_argparser().parse_args(args)
    keep = [int(c) for c in args.channels.split(",")]
    files = sorted(glob(str(Path(args.folder) / "*.nii*")))
    for f in files:
        img = nifti.load(f)
        data = img.get_raw_data()
        if data.ndim != 4:
            print(f"{f}: not 4D, skipping")
            continue
        trimmed = np.ascontiguousarray(data[..., keep])
        if trimmed.shape[-1] == 1:
            trimmed = trimmed[..., 0]
        nifti.save(trimmed, f, affine=img.affine)
        print(f"{f}: {data.shape} -> {trimmed.shape}")


if __name__ == "__main__":
    entry_func()
