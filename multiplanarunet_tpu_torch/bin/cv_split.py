"""`mp cv_split` on the PyTorch port: split a dataset folder into N
cross-validation splits.

Port of `multiplanarunet_tpu/bin/cv_split.py`: creates
<out_dir>/split_i/{train,val,test}/{images,labels} with members linked
(symlink default), copied, or listed in LIST_OF_FILES.txt; images and
labels are paired by filename and shuffled with random.Random(--seed),
so the splits are the JAX package's.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp cv_split --data_dir
<folder> [--CV 5] ...``.
"""

from __future__ import annotations

import os
import random
import shutil
from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def get_argparser():
    parser = ArgumentParser(description="Create CV splits of a data folder")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Folder containing images/ and labels/ subdirs")
    parser.add_argument("--CV", type=int, default=5,
                        help="Number of splits (default 5)")
    parser.add_argument("--out_dir", type=str, default="views",
                        help="Output folder (created inside data_dir unless "
                             "absolute)")
    parser.add_argument("--im_sub_dir", type=str, default="images")
    parser.add_argument("--lab_sub_dir", type=str, default="labels")
    parser.add_argument("--copy", action="store_true",
                        help="Copy files instead of symlinking")
    parser.add_argument("--file_list", action="store_true",
                        help="Write LIST_OF_FILES.txt instead of links")
    parser.add_argument("--validation_fraction", type=float, default=0.20,
                        help="Fraction of each split's train set used for "
                             "validation")
    parser.add_argument("--test_fraction", type=float, default=None,
                        help="(Only with --CV=1) test fraction")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def add_images(file_paths, out_folder, link_func):
    out_folder.mkdir(parents=True, exist_ok=True)
    for f in file_paths:
        link_func(f, out_folder / f.name)


def _linker(args):
    if args.file_list:
        def write_list(src, dst):
            list_file = dst.parent / "LIST_OF_FILES.txt"
            with open(list_file, "a") as f:
                f.write(str(src.absolute()) + "\n")
        return write_list
    if args.copy:
        return lambda src, dst: shutil.copy(src, dst)
    return lambda src, dst: dst.exists() or os.symlink(src.absolute(), dst)


def pair_by_names(images, labels):
    """Pair image and label files by filename prefix."""
    lab_by_id = {p.name.split(".")[0]: p for p in labels}
    pairs = []
    for im in images:
        key = im.name.split(".")[0]
        if key not in lab_by_id:
            raise ValueError(f"No label found for image {im.name}")
        pairs.append((im, lab_by_id[key]))
    return pairs


def entry_func(args=None):
    args = get_argparser().parse_args(args)
    data_dir = Path(args.data_dir).absolute()
    out_dir = Path(args.out_dir)
    if not out_dir.is_absolute():
        out_dir = data_dir / out_dir

    images = sorted((data_dir / args.im_sub_dir).glob("*.nii*"))
    labels = sorted((data_dir / args.lab_sub_dir).glob("*.nii*"))
    if not images:
        raise OSError(f"No images found in {data_dir / args.im_sub_dir}")
    pairs = pair_by_names(images, labels) if labels else [(im, None)
                                                          for im in images]
    rng = random.Random(args.seed)
    rng.shuffle(pairs)

    n = len(pairs)
    cv = args.CV
    if cv == 1:
        test_n = int(round((args.test_fraction or 0.2) * n))
        folds = [pairs[:test_n]]
        rest = pairs[test_n:]
    else:
        folds = [list(f) for f in np.array_split(pairs, cv)]

    link = _linker(args)
    for i in range(cv):
        split_dir = out_dir / f"split_{i}"
        test_pairs = folds[i]
        if cv == 1:
            train_pool = rest
        else:
            train_pool = [p for j, f in enumerate(folds) if j != i for p in f]
        n_val = int(round(args.validation_fraction * len(train_pool)))
        val_pairs = train_pool[:n_val]
        train_pairs = train_pool[n_val:]
        for split, members in (("train", train_pairs), ("val", val_pairs),
                               ("test", test_pairs)):
            ims = [p[0] for p in members]
            labs = [p[1] for p in members if p[1] is not None]
            add_images(ims, split_dir / split / args.im_sub_dir, link)
            if labs:
                add_images(labs, split_dir / split / args.lab_sub_dir, link)
        print(f"split_{i}: train={len(train_pairs)} val={len(val_pairs)} "
              f"test={len(test_pairs)}")
    print(f"CV splits written to {out_dir}")


if __name__ == "__main__":
    entry_func()
