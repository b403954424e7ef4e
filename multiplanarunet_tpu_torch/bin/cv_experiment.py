"""`mp cv_experiment` on the PyTorch port: run a command script over every
CV split.

Port of `multiplanarunet_tpu/bin/cv_experiment.py`: one sub-experiment
per split_N folder (from `mp cv_split`): the hparams prototype copied into
the split's project with the split's data folders (the port's
`init_project.copy_yaml_and_set_data_dirs`), then the lines of a command
script run in order as subprocesses in the project folder, the split's
remaining commands aborted when one fails. --jobs splits run at once.

Run as ``python -m multiplanarunet_tpu_torch.bin.mp cv_experiment
--CV_dir <splits> --script_prototype <script> ...``.
"""

from __future__ import annotations

import subprocess
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def get_argparser():
    parser = ArgumentParser(description="Run a command script on each CV "
                                        "split")
    parser.add_argument("--CV_dir", type=str, required=True,
                        help="Directory of split_N subfolders (from "
                             "'mp cv_split')")
    parser.add_argument("--out_dir", type=str, default="./splits",
                        help="Folder to store per-split projects")
    parser.add_argument("--script_prototype", type=str, default="script",
                        help="File of commands to run per split; the "
                             "placeholder [split_dir] is replaced with the "
                             "split's data folder")
    parser.add_argument("--hparams_prototype", type=str,
                        default="train_hparams.yaml",
                        help="hparams file copied into each split project")
    parser.add_argument("--jobs", type=int, default=1,
                        help="Number of splits to run concurrently")
    parser.add_argument("--start_from", type=int, default=0,
                        help="Skip splits below this index")
    parser.add_argument("--wait_for", type=str, default="",
                        help="Wait for these PIDs before starting")
    return parser


def get_cv_folders(cv_dir):
    folders = sorted(
        p for p in Path(cv_dir).iterdir()
        if p.is_dir() and p.name.startswith("split")
    )
    if not folders:
        raise OSError(f"No split_N folders found in {cv_dir}")
    return folders


def parse_script(script_file, split_data_dir, project_dir):
    commands = []
    for line in Path(script_file).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        line = line.replace("[split_dir]", str(split_data_dir))
        line = line.replace("[project_dir]", str(project_dir))
        commands.append(line)
    return commands


def prepare_split_project(split_data_dir, project_dir, hparams_proto):
    from multiplanarunet_tpu_torch.bin.init_project import (
        copy_yaml_and_set_data_dirs,
    )

    project_dir.mkdir(parents=True, exist_ok=True)
    if Path(hparams_proto).exists():
        copy_yaml_and_set_data_dirs(
            hparams_proto, project_dir / "train_hparams.yaml",
            str(split_data_dir),
        )


def run_sub_experiment(split_data_dir, project_dir, script_file,
                       hparams_proto, log_path):
    prepare_split_project(split_data_dir, project_dir, hparams_proto)
    commands = parse_script(script_file, split_data_dir, project_dir)
    with open(log_path, "w") as log_f:
        for cmd in commands:
            print(f"[{split_data_dir.name}] running: {cmd}")
            log_f.write(f"$ {cmd}\n")
            log_f.flush()
            rc = subprocess.call(cmd, shell=True, cwd=project_dir,
                                 stdout=log_f, stderr=subprocess.STDOUT)
            if rc != 0:
                print(f"[{split_data_dir.name}] command failed (rc={rc}); "
                      f"aborting remaining commands for this split.")
                return rc
    return 0


def entry_func(args=None):
    args = get_argparser().parse_args(args)
    if args.wait_for:
        from multiplanarunet_tpu_torch.utils.utils import await_PIDs

        await_PIDs(args.wait_for)
    folders = get_cv_folders(args.CV_dir)[args.start_from:]
    out_root = Path(args.out_dir).absolute()
    out_root.mkdir(parents=True, exist_ok=True)

    def run_one(split_folder):
        project_dir = out_root / split_folder.name
        return run_sub_experiment(
            split_folder, project_dir, args.script_prototype,
            args.hparams_prototype, out_root / f"{split_folder.name}.log",
        )

    if args.jobs <= 1:
        codes = [run_one(f) for f in folders]
    else:
        with ThreadPoolExecutor(max_workers=args.jobs) as pool:
            codes = list(pool.map(run_one, folders))
    failed = [f.name for f, c in zip(folders, codes) if c != 0]
    if failed:
        raise SystemExit(f"Splits failed: {failed}")
    print("All splits completed.")


if __name__ == "__main__":
    entry_func()
