"""train.batch_wait_ms: host milliseconds the Trainer's thread waits for
each batch of the one-deep prefetch (`train.batch_wait`: the worker's
result and the stream's wait on it), mean over the traced steps."""

from portbench import spans


def read(rec):
    return spans.mean([r["host_ms"] for r in
                       spans.named(rec, "train.batch_wait", "train")])
