"""`mp init_project` on the PyTorch port: create a project folder from a
preset YAML.

Port of `multiplanarunet_tpu/bin/init_project.py`: copies the chosen
preset (MultiPlanar / 3D / MultiTask, the port's own copies under
bin/defaults/) into <root>/<name>/ and sets the data sub-directories
(<data_dir>/train, /val, /test, /aug, or Null without --data_dir).

Run as ``python -m multiplanarunet_tpu_torch.bin.mp init_project --name
<name> [--root <folder>] [--data_dir <folder>]``.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser
from glob import glob
from pathlib import Path


def defaults_dir():
    return Path(__file__).parent / "defaults"


def copy_yaml_and_set_data_dirs(in_path, out_path, data_dir):
    from multiplanarunet_tpu_torch.hyperparameters.hparams import YAMLHParams

    hparams = YAMLHParams(in_path, no_log=True, no_version_control=True)
    for split in ("train", "val", "test", "aug"):
        group = f"{split}_data"
        if group == "aug_data" and not hparams.get(group):
            continue
        path = f"{data_dir}/{split}" if data_dir else "Null"
        if not hparams.get(group) or not hparams[group].get("base_dir"):
            try:
                hparams.set_value(group, "base_dir", path, overwrite=True,
                                  add_if_missing=True, log=False)
            except AttributeError:
                print(f"[!] Subdir {group} does not exist in preset.")
    hparams.save_current(out_path)


def get_parser():
    presets = sorted(
        p.name for p in defaults_dir().iterdir() if p.is_dir()
    )
    parser = ArgumentParser(description="Create a new project folder")
    parser.add_argument("--name", type=str, required=True,
                        help="name of the project folder")
    parser.add_argument("--root", type=str, default=os.path.abspath("./"),
                        help="root folder in which to create the project")
    parser.add_argument("--model", type=str, default="MultiPlanar",
                        choices=presets,
                        help=f"preset parameter file ({', '.join(presets)})")
    parser.add_argument("--data_dir", type=str, default=None,
                        help="root data folder for the project")
    parser.add_argument("--overwrite", action="store_true",
                        help="replace parameter files in an existing folder "
                             "without asking")
    return parser


def entry_func(args=None):
    args = get_parser().parse_args(args)
    root = os.path.abspath(args.root)
    if not os.path.exists(root):
        raise OSError(f"root path '{args.root}' does not exist.")
    folder = os.path.join(root, args.name)
    if os.path.exists(folder) and not args.overwrite:
        if sys.stdin.isatty():
            response = input(
                f"Folder '{folder}' already exists. Overwrite parameter "
                f"files? (y/n) "
            )
            if response.lower() == "n":
                raise OSError(f"Folder '{folder}' already exists")
        else:
            raise OSError(
                f"Folder '{folder}' already exists (pass --overwrite)"
            )
    os.makedirs(folder, exist_ok=True)

    data_dir = os.path.abspath(args.data_dir) if args.data_dir else None
    for preset_yaml in glob(str(defaults_dir() / args.model / "*.yaml")):
        out = os.path.join(folder, os.path.basename(preset_yaml))
        copy_yaml_and_set_data_dirs(preset_yaml, out, data_dir)
    print(f"Project initialized at {folder}")


if __name__ == "__main__":
    entry_func()
