"""train.step_ms: CUDA events on the caller's stream before and after
each train step call, milliseconds, mean over the window's steps."""


def read(rec):
    ms = rec.get("step_ms") if rec.get("kind") == "train" else None
    return sum(ms) / len(ms) if ms else None
