"""The benchmark of the PyTorch port (multiplanarunet_tpu_torch).

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA card. The
cell's entry in BENCHMARK.json names its configuration; its traffic
lives in portbench/workloads/<cell>.json, which names the driver
(portbench/drivers/<driver>.py) that sets the program up from the seed,
runs the measured window and checks what the window produced against
the plain reference (portbench/reference/). Each metric is read by
portbench/metrics/<metric>.py from the run's records. The last line of
standard output is the result as one JSON object; the numbers compared
with the reference, each beside its limit, are the last lines of
standard error and the result's last key.

Exit codes: 0 with a result; 3 without a card (or with fewer than the
cell asks for), or when the process holds a module of JAX or of the JAX
package once the window has closed; any other failure raises.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402

ROOT = harness.HERE.parent


def cache_dirs(root):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port's nvcc output goes to <root>/build/kernels itself)."""
    base = Path(root) / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def judge(numbers, limits):
    """({name: {value, limit}}, correct): every number with a limit
    compared; a missing or non-finite number fails."""
    compared = {}
    ok = bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        compared[name] = {"value": value, "limit": limit}
        if value is None or not math.isfinite(value) or value > limit:
            ok = False
    return compared, ok


def main(argv=None, bench_path=None, data_dir=None, device=None,
         require_card=True, plant=None, control=None):
    """One run; returns (exit code, result or None). The keyword
    arguments serve the tests: another BENCHMARK.json and data folder, a
    device other than the card (`require_card` False skips the look for
    one); `plant`, a callable that the driver hands itself once the
    program is built and before its first use, which may break the
    program underneath it (the `FAULTS` of the driver's module); and
    `control`, a precision ("fp8") at which the check puts the reference
    in the program's place."""
    args = parse(argv)
    cache_dirs(ROOT)
    bench = harness.load_json(bench_path or ROOT / "BENCHMARK.json")
    data_dir = Path(data_dir or harness.HERE)
    entry, workload, config = harness.cell_files(bench, args.workload,
                                                 data_dir)

    import torch

    if require_card:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(entry["chips"]):
            print(f"portbench: the cell needs {entry['chips']} CUDA "
                  f"card(s); torch sees {n}", file=sys.stderr)
            return 3, None
        device = "cuda"
    driver_mod = harness.driver_module(workload["driver"], data_dir)
    driver = driver_mod.Driver(
        cell=args.workload, config=config, workload=workload,
        seed=args.seed, device=torch.device(device), trace=bool(args.trace),
        plant=plant)
    try:
        driver.setup()
        setup_s = time.perf_counter() - T_PROCESS
        driver.window(args.seconds)
        records = driver.records
        records["setup_s"] = setup_s
        dev = torch.device(device)
        on_card = dev.type == "cuda"
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        driver.release()
        numbers, readings = driver.check(quant=control)
        entries = harness.metrics_for(bench, args.workload,
                                      per_layer=bool(args.trace))
        metrics = harness.read_metrics(entries, records, data_dir)
    finally:
        driver.close()
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run holds modules of JAX or of the JAX "
              f"package: {found}", file=sys.stderr)
        return 3, None
    compared, correct = judge(numbers, workload.get("limits", {}))
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": int(entry["chips"]),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": records["attempted"],
              "failed": records["failed"], "metrics": metrics,
              "device": device_info}
    trace = records.get("trace")
    if args.trace and trace:
        device_info["busy_s"] = trace["busy_s"]
        device_info["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["compared"] = compared
    print(f"portbench: numbers {json.dumps(numbers)} readings "
          f"{json.dumps(readings)}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    if not workload.get("limits"):
        print("portbench: the workload sets no limits", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0, result


if __name__ == "__main__":
    code, _ = main()
    sys.exit(code)
