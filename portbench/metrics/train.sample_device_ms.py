"""train.sample_device_ms: device milliseconds of each sequence[i] on the
prefetch worker's side stream (`train.sample`'s CUDA events), mean over
the batches sampled while the stretch was traced."""

from portbench import spans


def read(rec):
    return spans.mean([r["device_ms"] for r in
                       spans.named(rec, "train.sample", "train")])
