"""train.sampler_ms: host wall of each sequence[i] in the prefetch worker
(timed by the benchmark's wrapper around the sequence that Trainer.fit
gets), milliseconds per batch, mean over the window."""


def read(rec):
    s = rec.get("sampler_s") if rec.get("kind") == "train" else None
    return 1e3 * sum(s) / len(s) if s else None
