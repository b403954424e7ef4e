"""train.sample_host_ms: host milliseconds of each sequence[i] in the
prefetch worker (`train.sample`), mean over the batches sampled while
the stretch was traced."""

from portbench import spans


def read(rec):
    return spans.mean([r["host_ms"] for r in
                       spans.named(rec, "train.sample", "train")])
