"""train.step_device_ms: device milliseconds of the Trainer's `train.step`
span (CUDA events on the caller's stream around each train step call),
mean over the traced steps but the last one to end: the benchmark's step
wrapper stops the profiler inside that call, so its span also holds the
profiler's stop (a second or more with the card idle)."""

from portbench import spans


def read(rec):
    steps = sorted(spans.named(rec, "train.step", "train"),
                   key=lambda r: r["end_ns"])
    return spans.mean([r["device_ms"] for r in steps[:-1]])
