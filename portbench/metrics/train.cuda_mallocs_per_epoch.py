"""train.cuda_mallocs_per_epoch: cudaMalloc calls of torch's caching
allocator in an epoch (counter `alloc.cuda_mallocs` of the Trainer's
`train.epoch` span: the allocator's segment count across it), mean over
the epochs the traced stretch opens (a window that closes first counts
the epoch up to its last step)."""

from portbench import spans


def read(rec):
    return spans.mean([r["counters"].get("alloc.cuda_mallocs") for r in
                       spans.named(rec, "train.epoch", "train")])
