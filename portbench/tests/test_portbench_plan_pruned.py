"""The reader of `predict.plan_pruned` (the shear planner's factorisations
never finished because a lower alias tier won, counter `shear_plan.pruned`
in the `predict.plan` spans): its value on synthetic records, None where
the counter, its spans or the recorder are missing, and a tiny traced CPU
run of each predict cell reports it."""

import json

import pytest

from portbench import harness, run
from portbench.tests.test_portbench_spans import (
    _predict_records, _reader, _span, _train_records)
from portbench.tests.tiny import write_tiny

NAME = "predict.plan_pruned"


def _pruned_records():
    rec = _predict_records()
    plans = [s for s in rec["program_spans"]["spans"]
             if s["name"] == "predict.plan"]
    for s, k in zip(plans, (20, 12)):
        s["counters"]["shear_plan.pruned"] = k
    rec["program_spans"]["counters"]["shear_plan.pruned"] = 32
    return rec


def test_reads_the_mean_per_volume():
    assert _reader(NAME).read(_pruned_records()) == pytest.approx(16.0)


def test_none_without_its_counter():
    """The parent's planner does not prune: the metric is left out,
    and the candidates' reader still reads."""
    rec = _predict_records()
    assert _reader(NAME).read(rec) is None
    assert _reader("predict.plan_candidates").read(rec) == 410.0


def test_none_without_its_spans():
    reader = _reader(NAME)
    assert reader.read({"kind": "predict", "program_spans": None}) is None
    assert reader.read({"kind": "predict", "program_spans":
                        _train_records()["program_spans"]}) is None
    assert reader.read(_train_records()) is None
    rec = {"kind": "predict", "program_spans": {"spans": [
        _span("predict.image", 0, 2400, 1)], "counters": {}}}
    assert reader.read(rec) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("tiny_pruned"))


PREDICT_CELLS = next(
    m for m in harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    ["per_layer"] if m["name"] == NAME)["workloads"]


@pytest.mark.parametrize("cell", PREDICT_CELLS)
def test_tiny_traced_run_reports_it(tiny, cell, capsys):
    from multiplanarunet_tpu_torch.utils import trace

    bench_path, data = tiny
    trace.take()
    trace.enable()
    try:
        code, _ = run.main(
            ["--workload", cell, "--seed", str(2 ** 31 + 54321),
             "--seconds", "0.5", "--trace", "1"],
            bench_path=bench_path, data_dir=data, device="cpu",
            require_card=False)
    finally:
        trace.disable()
        trace.take()
    assert code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metrics"][NAME]["value"] > 0
