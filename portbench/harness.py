"""What every cell's run shares: finding a cell's files by name, loading
drivers and metric readers from their files, the traced sub-window, and
the check that the run loaded nothing of JAX."""

from __future__ import annotations

import bisect
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Top-level module names the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "multiplanarunet_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_file_module(path, name):
    """The module in file `path` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_module(name, data_dir=HERE):
    """The module of driver `name` (`portbench/drivers/<name>.py`): its
    `Driver`, and its `FAULTS` for the tests."""
    return load_file_module(Path(data_dir) / "drivers" / f"{name}.py",
                            f"portbench_driver_{name}")


def cell_files(bench, cell, data_dir=HERE):
    """(workload entry, workload file, configuration file) of a cell."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json (known: "
                       f"{sorted(entries)})")
    entry = entries[cell]
    workload = load_json(Path(data_dir) / "workloads" / f"{cell}.json")
    config = load_json(Path(data_dir) / "configs" / f"{entry['config']}.json")
    return entry, workload, config


def metrics_for(bench, cell, per_layer):
    """The metric entries a cell reports: its end-to-end metrics, or with
    per_layer its per-layer ones (an entry with no `workloads` key is
    every cell's)."""
    group = bench["per_layer" if per_layer else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(entries, records, data_dir=HERE):
    """{name: {"value", "unit"}} from each metric's reader
    (`portbench/metrics/<name>.py`, `read(records)`); a reader that finds
    nothing returns None and its metric is left out."""
    out = {}
    for m in entries:
        reader = load_file_module(Path(data_dir) / "metrics"
                                  / f"{m['name']}.py",
                                  f"portbench_metric_{m['name']}")
        value = reader.read(records)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules():
    """The modules of JAX or of the JAX package that this process holds,
    top-level names compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def short_name(name, limit=120):
    """A kernel's or an operation's name without its template and
    function arguments ('void at::native::foo<...>(...)' ->
    'at::native::foo')."""
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "("):
        at = name.find(stop)
        if at > 0:
            name = name[:at]
    return name[:limit]


class TracedWindow:
    """torch.profiler over a stretch of whole volumes or steps, entered
    after a synchronise and left after one; `summary()` gives the busy
    seconds of the card (the union of its operations' intervals), the
    stretch's length, and the breakdown (the operations that took most
    device time, and the longest idle gaps named by the innermost host
    operation running across them)."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None

    def prime(self):
        """Start and stop the profiler once over a small operation, so
        that its one-off start-up (CUPTI's) falls in set-up, not in the
        window."""
        torch = self.torch
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self):
        torch = self.torch
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def active(self):
        return self.prof is not None and self.t1 is None

    def summary(self, n_top=10, n_gaps=400):
        if self.prof is None or self.t1 is None:
            return None
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            kind = str(e.device_type())
            if kind.endswith("CUDA"):
                dev.append((start, end, short_name(e.name())))
            elif kind.endswith("CPU"):
                host.append((start, end, short_name(e.name())))
        if not dev:
            return None
        dev.sort()
        merged = []
        for s, e, _ in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy_us = sum(e - s for s, e in merged)
        by_name = {}
        for s, e, name in dev:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
                 merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        host.sort()
        starts = [s for s, _, _ in host]
        labels = {}
        for length, a, b in gaps[:n_gaps]:
            mid = (a + b) / 2
            label = "(host code outside torch operations)"
            # Nested host operations: the innermost one running across the
            # gap is the latest-starting one that has not ended yet
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 5000), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            labels[label] = labels.get(label, 0.0) + length
        idle = sorted(labels.items(), key=lambda kv: -kv[1])[:n_top]
        window_s = self.t1 - self.t0
        return {"busy_s": busy_us / 1e6, "window_s": window_s,
                "breakdown": {
                    "device_ops": [[n, v / 1e6] for n, v in top],
                    "idle_gaps": [[n, v / 1e6] for n, v in idle]}}
