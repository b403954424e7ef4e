"""A whole run with the timed path broken underneath (the `FAULTS` of the
cell's driver module) comes out not correct, once for each fault the
cell can have: half of the batch (of the views, for a predict cell) left
out; an answer altered where it is produced; a step that returns its
state unchanged; for a training cell also the augmenter's deformation
skipped and the planes or boxes sampled off their place. On the card, at
the cell's own size, with a short window."""

import pytest

from portbench import harness, run

BENCH = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
CASES = []
for w in BENCH["workloads"]:
    kind = harness.load_json(harness.HERE / "workloads"
                             / f"{w['name']}.json")["driver"]
    CASES += [(w["name"], kind, fault)
              for fault in sorted(harness.driver_module(kind).FAULTS)]


@pytest.mark.card
@pytest.mark.parametrize("cell,kind,fault", CASES)
def test_fault_is_not_correct(card, cell, kind, fault):
    code, result = run.main(
        ["--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds", "2",
         "--trace", "0"], plant=harness.driver_module(kind).FAULTS[fault])
    assert code == 0
    print(cell, fault, result["compared"])
    assert result["correct"] is False, result["compared"]
