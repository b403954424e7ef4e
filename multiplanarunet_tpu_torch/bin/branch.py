"""`mp branch` on the PyTorch port: split a MultiTask project into one
single-task project per task.

Port of `multiplanarunet_tpu/bin/branch.py`, with the same flags: for each
task of the project's 'tasks' group, <project>/<out_dir>/<task>/
train_hparams.yaml holds the task's data groups, the main build group as
a UNet with the task's n_classes, n_channels, dim, out_activation and
biased_output_layer from its task_specifics, and the main fit group with
the task's real_space_span. views.npz is copied when the project has one,
as the JAX script does (multi-task training writes views_<task>.npz
instead, so a trained project's branches get no views), and
--copy_weights copies model/. The YAML is read with the port's reader
and written with its writer (no PyYAML).

Run as ``python -m multiplanarunet_tpu_torch.bin.mp branch --project_dir
<project> [--out_dir branches] [--copy_weights]``.
"""

from __future__ import annotations

import shutil
from argparse import ArgumentParser
from pathlib import Path

from multiplanarunet_tpu_torch.hyperparameters.yaml_reader import safe_load
from multiplanarunet_tpu_torch.hyperparameters.yaml_writer import safe_dump


def get_argparser():
    parser = ArgumentParser(description="Branch a MultiTask project into "
                                        "per-task projects")
    parser.add_argument("--project_dir", type=str, default="./")
    parser.add_argument("--out_dir", type=str, default="branches")
    parser.add_argument("--copy_weights", action="store_true",
                        help="Copy model weights into each branch")
    return parser


def build_branch_yaml(main_hparams, task_hparams):
    """The merged single-task hparams dict of one task."""
    merged = {}
    for group in ("train_data", "val_data", "test_data", "aug_data"):
        if group in task_hparams:
            merged[group] = task_hparams[group]
    build = dict(main_hparams.get("build", {}))
    build["model_class_name"] = "UNet"
    specifics = task_hparams.get("task_specifics", {})
    for key in ("n_classes", "n_channels", "dim", "out_activation",
                "biased_output_layer"):
        if key in specifics:
            build[key] = specifics[key]
    merged["build"] = build
    fit = dict(main_hparams.get("fit", {}))
    if "real_space_span" in specifics:
        fit["real_space_span"] = specifics["real_space_span"]
    merged["fit"] = fit
    return merged


def entry_func(args=None):
    args = get_argparser().parse_args(args)
    project_dir = Path(args.project_dir).absolute()
    main_path = project_dir / "train_hparams.yaml"
    if not main_path.exists():
        raise RuntimeError(f"No train_hparams.yaml in {project_dir}")
    main = safe_load(main_path.read_text())
    tasks = main.get("tasks")
    if not tasks:
        raise RuntimeError("Not a MultiTask project (no 'tasks' group)")

    out_root = project_dir / args.out_dir
    for name, hfile in zip(tasks["task_names"], tasks["hparam_files"]):
        task_conf = safe_load((project_dir / hfile).read_text())
        branch_dir = out_root / name
        branch_dir.mkdir(parents=True, exist_ok=True)
        merged = build_branch_yaml(main, task_conf)
        (branch_dir / "train_hparams.yaml").write_text(safe_dump(merged))
        views = project_dir / "views.npz"
        if views.exists():
            shutil.copy(views, branch_dir / "views.npz")
        model_dir = project_dir / "model"
        if args.copy_weights and model_dir.is_dir():
            shutil.copytree(model_dir, branch_dir / "model",
                            dirs_exist_ok=True)
        print(f"Branched task '{name}' -> {branch_dir}")


if __name__ == "__main__":
    entry_func()
