"""train.augment_device_ms: device milliseconds of the sampler's augmenters
(`sampler.augment`: Elastic2D/3D on the side stream) a batch, mean over
the batches sampled while the stretch was traced."""

from portbench import spans


def read(rec):
    return spans.mean([r["device_ms"] for r in
                       spans.named(rec, "sampler.augment", "train")])
