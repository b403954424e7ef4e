"""`mp` dispatcher of the PyTorch port: ``python -m
multiplanarunet_tpu_torch.bin.mp <script> [script args...]`` forwards the
script's arguments to its `entry_func`, as `multiplanarunet_tpu/bin/mp.py`
does. The port has the project workflow (toy_data, init_project, train,
train_fusion, predict, predict_3D, summary), branch (a MultiTask project
into per-task projects), the CV tools (cv_split, cv_experiment) and
version; the JAX package's other scripts raise `ScriptNotPortedError`."""

from __future__ import annotations

import argparse
import importlib
import sys

PORTED = ("branch", "cv_experiment", "cv_split", "init_project", "predict",
          "predict_3D", "summary", "toy_data", "train", "train_fusion",
          "version")


class ScriptNotPortedError(NotImplementedError):
    """An `mp` script that the PyTorch port does not have yet."""


def get_parser():
    usage = ("mp <script> [script args...]\n\n"
             "Available scripts:\n  " + "\n  ".join(PORTED))
    parser = argparse.ArgumentParser(prog="mp", usage=usage)
    parser.add_argument("script", help="script to run")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    return parser


def entry_func(args=None):
    parsed = get_parser().parse_args(args)
    if parsed.script not in PORTED:
        raise ScriptNotPortedError(
            f"'mp {parsed.script}' is not ported to the PyTorch package yet "
            f"(ported: {', '.join(PORTED)}); run it with "
            f"'python -m multiplanarunet_tpu.bin.mp {parsed.script}'")
    module = importlib.import_module(
        f"multiplanarunet_tpu_torch.bin.{parsed.script}")
    return module.entry_func(parsed.args)


if __name__ == "__main__":
    entry_func(sys.argv[1:])
