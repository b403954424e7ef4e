"""`mp` dispatcher of the PyTorch port: ``python -m
multiplanarunet_tpu_torch.bin.mp <script> [script args...]`` forwards the
script's arguments to its `entry_func`, as `multiplanarunet_tpu/bin/mp.py`
does. The scripts are the modules of this package (`get_scripts`): the
same fifteen as the JAX package's."""

from __future__ import annotations

import argparse
import importlib
import pkgutil
import sys

import multiplanarunet_tpu_torch.bin


def get_scripts():
    return sorted(
        m.name for m in pkgutil.iter_modules(
            multiplanarunet_tpu_torch.bin.__path__)
        if m.name not in ("mp", "defaults") and not m.ispkg)


def get_parser():
    scripts = get_scripts()
    usage = ("mp <script> [script args...]\n\n"
             "Available scripts:\n  " + "\n  ".join(scripts))
    parser = argparse.ArgumentParser(prog="mp", usage=usage)
    parser.add_argument("script", choices=scripts, help="script to run")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    return parser


def entry_func(args=None):
    parsed = get_parser().parse_args(args)
    module = importlib.import_module(
        f"multiplanarunet_tpu_torch.bin.{parsed.script}")
    return module.entry_func(parsed.args)


if __name__ == "__main__":
    entry_func(sys.argv[1:])
