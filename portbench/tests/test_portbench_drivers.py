"""Every cell's driver at a tiny size on the CPU, through the whole run:
set-up, window, check and the result line."""

import json

import pytest

from portbench import harness, run
from portbench.tests.tiny import write_tiny

CELLS = [w["name"] for w in
         harness.load_json(harness.HERE.parent / "BENCHMARK.json")["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run(tiny, cell, trace, capsys):
    bench_path, data = tiny
    code, result = run.main(
        ["--workload", cell, "--seed", str(2 ** 31 + 12345), "--seconds",
         "0.5", "--trace", str(trace)],
        bench_path=bench_path, data_dir=data, device="cpu",
        require_card=False)
    assert code == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line == result
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert isinstance(line["correct"], bool)
    bench = harness.load_json(bench_path)
    kind = harness.load_json(data / "workloads" / f"{cell}.json")["driver"]
    if not trace:
        want = {m["name"] for m in harness.metrics_for(bench, cell, False)}
        # Off the card the CUDA-event metrics find nothing to read
        assert {"setup_s"} < set(line["metrics"]) <= want
    else:
        want = {m["name"] for m in harness.metrics_for(bench, cell, True)}
        assert f"mfu.{kind}" in line["metrics"]
        assert set(line["metrics"]) <= want
    limits = harness.load_json(data / "workloads" / f"{cell}.json")["limits"]
    assert set(line["compared"]) == set(limits)
    tail = err.strip().splitlines()[len(err.strip().splitlines())
                                    - len(limits):]
    assert [t.split()[1] for t in tail if limits] == list(limits)

TRAIN_CELLS = [c for c in CELLS if harness.load_json(
    harness.HERE / "workloads" / f"{c}.json")["driver"] == "train"]
# A seed whose tiny checked batches hold deformed samples
TINY_SEED = 2 ** 40 + 17


def _tiny_run(tiny, cell, plant=None, control=None):
    bench_path, data = tiny
    code, result = run.main(
        ["--workload", cell, "--seed", str(TINY_SEED), "--seconds", "0.5",
         "--trace", "0"], bench_path=bench_path, data_dir=data,
        device="cpu", require_card=False, plant=plant, control=control)
    assert code == 0
    return result


@pytest.mark.parametrize("fault",
                         sorted(harness.driver_module("train").FAULTS))
@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_tiny_train_fault_is_not_correct(tiny, cell, fault):
    """Each training fault fails a run at the tiny size, where the same
    seed's sound run is correct."""
    plant = harness.driver_module("train", tiny[1]).FAULTS[fault]
    result = _tiny_run(tiny, cell, plant=plant)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_tiny_train_sound_and_control(tiny, cell):
    """The sound run is correct, with the sampler's numbers at rounding;
    the fp8 control, through the same comparison, is not."""
    result = _tiny_run(tiny, cell)
    assert result["correct"] is True, result["compared"]
    for name in ("plane_err", "elastic_err", "label_err"):
        assert result["compared"][name]["value"] < 1e-5
    control = _tiny_run(tiny, cell, control="fp8")
    assert control["correct"] is False, control["compared"]


def test_gap_ratio():
    from portbench.reference import compare

    assert compare.gap_ratio(1.0, 4.0) == 0.25
    assert compare.gap_ratio(0.0, 0.0) == 0.0
    assert compare.gap_ratio(1e-9, 0.0) == float("inf")


def test_judge():
    compared, ok = run.judge({"a": 0.5, "b": 2.0}, {"a": 1.0, "b": 1.0})
    assert not ok and compared["a"] == {"value": 0.5, "limit": 1.0}
    assert run.judge({"a": 0.5}, {"a": 1.0})[1]
    assert not run.judge({"a": float("nan")}, {"a": 1.0})[1]
    assert not run.judge({}, {"a": 1.0})[1]
    assert not run.judge({"a": 0.0}, {})[1]


def test_same_seed_same_inputs():
    from portbench import traffic

    a = traffic.predict_volume([20, 24, 16], [1.0, 1.2, 0.9], 2 ** 33, 5)
    b = traffic.predict_volume([20, 24, 16], [1.0, 1.2, 0.9], 2 ** 33, 5)
    c = traffic.predict_volume([20, 24, 16], [1.0, 1.2, 0.9], 2 ** 33, 6)
    assert (a == b).all() and not (a == c).all()
    tr = {"protocols": [{"name": n, "spacing": [1, 1, 1]} for n in "xyz"],
          "rotation_max_deg": 15.0}
    first = [traffic.draw_volume(tr, 7, i) for i in range(6)]
    again = [traffic.draw_volume(tr, 7, i) for i in range(6)]
    assert all(a[0] == b[0] and (a[1] == b[1]).all()
               for a, b in zip(first, again))
    # every block of three volumes holds each protocol once
    for seed in (7, 2 ** 40 + 3):
        names = [traffic.draw_volume(tr, seed, i)[0]["name"]
                 for i in range(9)]
        assert all(sorted(names[k:k + 3]) == ["x", "y", "z"]
                   for k in (0, 3, 6))
