"""Tiny copies of the cells for the CPU tests: the same drivers, traffic
files and BENCHMARK.json structure at sizes a CPU runs in seconds."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench import harness

TINY_BUILD_2D = {"dim": 32, "n_classes": 3, "depth": 2,
                 "complexity_factor": 1, "init_filters": 8}
TINY_BUILD_3D = {"dim": 16, "n_classes": 3, "depth": 2,
                 "complexity_factor": 1, "init_filters": 4}


def write_tiny(root):
    """A BENCHMARK.json and data folder of tiny cells under `root`;
    returns (bench path, data folder)."""
    root = Path(root)
    src = harness.HERE
    bench = harness.load_json(src.parent / "BENCHMARK.json")
    data = root / "data"
    for sub in ("configs", "workloads"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    (data / "drivers").symlink_to(src / "drivers")
    (data / "metrics").symlink_to(src / "metrics")
    for c in bench["configs"]:
        cfg = harness.load_json(src.parent / c["file"])
        three_d = cfg["build"]["model_class_name"] == "UNet3D"
        cfg["build"].update(TINY_BUILD_3D if three_d else TINY_BUILD_2D)
        cfg["fit"]["batch_size"] = 4
        if three_d:
            cfg["fit"]["real_space_span"] = 32
            cfg["fit"]["real_box_dim"] = 16
        else:
            cfg["fit"]["real_space_span"] = 31
        cfg["train_subjects"] = 2
        cfg["train_images_per_epoch"] = 12
        (data / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        wl = harness.load_json(src / "workloads" / f"{w['name']}.json")
        wl = copy.deepcopy(wl)
        tr = wl["traffic"]
        if "protocols" in tr:
            for p in tr["protocols"]:
                p["shape"] = [max(8, s // 10) for s in p["shape"]]
                p["spacing"] = [s * 4 for s in p["spacing"]]
            tr["n_planes"] = "same+2"
        else:
            tr["subject_shape"] = [32, 32, 32]
            tr["warm_steps_per_epoch"] = 3
            tr["trace_steps_before_boundary"] = 1
            tr["trace_steps"] = 2
        (data / "workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path, data
