"""train.epoch_boundary_ms: host milliseconds from the end of an epoch's
last `train.step` span to the start of the next epoch's first one (the
epoch's log fetch and callbacks, the next epoch's new prefetch and its
first, unprefetched batch), mean over the boundaries the traced stretch
holds."""

from portbench import spans


def read(rec):
    steps = sorted(spans.named(rec, "train.step", "train"),
                   key=lambda r: r["start_ns"])
    last = rec.get("steps_per_epoch", 0) - 1
    gaps = [(b["start_ns"] - a["end_ns"]) / 1e6
            for a, b in zip(steps, steps[1:])
            if a["request"][1] == last and b["request"][1] == 0
            and b["request"][0] == a["request"][0] + 1]
    return spans.mean(gaps)
