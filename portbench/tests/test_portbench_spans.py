"""The readers of the program's spans (`portbench/spans.py` and the
metrics whose source is `program_span`) on synthetic records: each
reads its value, and None where its spans are missing or the program
has no recorder; and a tiny CPU run with the recorder on reports the
host-span metrics."""

import json

import pytest

from portbench import harness, run, spans
from portbench.tests.tiny import write_tiny

SPAN_METRICS = {
    "predict.plan_ms": "predict", "predict.plan_candidates": "predict",
    "train.step_device_ms": "train", "train.batch_wait_ms": "train",
    "train.sample_host_ms": "train", "train.sample_device_ms": "train",
    "train.augment_device_ms": "train", "train.epoch_boundary_ms": "train",
    "train.cuda_mallocs_per_epoch": "train"}
# Read on the CPU too: the others need CUDA events or the allocator
HOST_METRICS = {"predict.plan_ms", "predict.plan_candidates",
                "train.batch_wait_ms", "train.sample_host_ms",
                "train.epoch_boundary_ms"}


def _reader(name):
    return harness.load_file_module(
        harness.HERE / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def _span(name, start_ms, host_ms, request=None, device_ms=None,
          counters=None):
    return {"id": 0, "name": name, "parent": None, "thread": "t",
            "request": request, "start_ns": int(start_ms * 1e6),
            "end_ns": int((start_ms + host_ms) * 1e6), "host_ms": host_ms,
            "device_ms": device_ms, "counters": counters or {}}


def _predict_records():
    return {"kind": "predict", "program_spans": {"spans": [
        _span("predict.image", 0, 2400, 1),
        _span("predict.plan", 1, 200, 1,
              counters={"shear_plan.candidates": 400}),
        _span("predict.stage", 210, 1, 1, device_ms=30.0),
        _span("predict.image", 2500, 2400, 2),
        _span("predict.plan", 2501, 210, 2,
              counters={"shear_plan.candidates": 420})],
        "counters": {"shear_plan.candidates": 820}}}


def _train_records():
    steps = [(0, 154), (0, 155), (1, 0), (1, 1)]
    out = []
    for k, (e, s) in enumerate(steps):
        t = 100.0 * k + (40.0 if k >= 2 else 0.0)  # 40 ms more at the edge
        out.append(_span("train.step", t, 80.0, (e, s), device_ms=82.0 + k))
        out.append(_span("train.batch_wait", t - 5, 2.0 + k, (e, s)))
        out.append(_span("train.sample", t, 40.0 + k, (e, s),
                         device_ms=50.0))
        out.append(_span("sampler.augment", t + 30, 5.0, (e, s),
                         device_ms=10.0 + k))
    out.append(_span("train.epoch", 280, 1000, (1, None),
                     counters={"alloc.cuda_mallocs": 12}))
    return {"kind": "train", "steps_per_epoch": 156,
            "program_spans": {"spans": out, "counters": {}}}


WANT = {"predict.plan_ms": 205.0, "predict.plan_candidates": 410.0,
        # the last step to end is left out
        "train.step_device_ms": 83.0, "train.batch_wait_ms": 3.5,
        "train.sample_host_ms": 41.5, "train.sample_device_ms": 50.0,
        "train.augment_device_ms": 11.5,
        # the step (0, 155) ends at 180 ms; (1, 0) starts at 240 ms
        "train.epoch_boundary_ms": 60.0,
        "train.cuda_mallocs_per_epoch": 12.0}


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_value(name):
    rec = (_predict_records() if SPAN_METRICS[name] == "predict"
           else _train_records())
    assert _reader(name).read(rec) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_none_without_its_spans(name):
    other = "train" if SPAN_METRICS[name] == "predict" else "predict"
    reader = _reader(name)
    # the program recorded nothing, or has no recorder
    assert reader.read({"kind": SPAN_METRICS[name],
                        "program_spans": None}) is None
    # spans of the other kind of run only
    assert reader.read({"kind": SPAN_METRICS[name], "program_spans": (
        _predict_records() if other == "predict"
        else _train_records())["program_spans"]}) is None
    # a run of the other kind
    assert reader.read(_predict_records() if other == "predict"
                       else _train_records()) is None


def test_no_boundary_in_the_stretch_reads_none():
    rec = _train_records()
    rec["program_spans"]["spans"] = [
        s for s in rec["program_spans"]["spans"]
        if s["request"] is None or s["request"][0] == 0]
    assert _reader("train.epoch_boundary_ms").read(rec) is None


def test_taken_once_from_the_program():
    from multiplanarunet_tpu_torch.utils import trace

    trace.take()
    trace.enable()
    try:
        with trace.span("predict.plan"):
            trace.count("shear_plan.candidates", 3)
    finally:
        trace.disable()
    rec = {"kind": "predict"}
    first = spans.taken(rec)
    assert [r["name"] for r in first["spans"]] == ["predict.plan"]
    assert spans.taken(rec) is first  # kept for the other readers
    assert _reader("predict.plan_candidates").read(rec) == 3
    assert trace.take() == {"spans": [], "counters": {}}
    assert spans.taken({"kind": "predict"}) is None  # nothing recorded


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("tiny_spans"))


CELLS = [w["name"] for w in harness.load_json(
    harness.HERE.parent / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_traced_run_reports_the_host_spans(tiny, cell, capsys):
    """The cells' drivers leave the recorder alone (on the card the
    traced stretch's profiler records the spans); here it is on for the
    run."""
    from multiplanarunet_tpu_torch.utils import trace

    bench_path, data = tiny
    trace.take()
    trace.enable()
    try:
        code, result = run.main(
            ["--workload", cell, "--seed", str(2 ** 31 + 54321),
             "--seconds", "0.5", "--trace", "1"],
            bench_path=bench_path, data_dir=data, device="cpu",
            require_card=False)
    finally:
        trace.disable()
        trace.take()
    assert code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kind = harness.load_json(data / "workloads" / f"{cell}.json")["driver"]
    want = {m for m in HOST_METRICS if SPAN_METRICS[m] == kind}
    assert want <= set(line["metrics"])
    assert not (set(SPAN_METRICS) - HOST_METRICS) & set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] > 0
