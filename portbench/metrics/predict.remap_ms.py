"""predict.remap_ms: the 'remap' (remap and accumulate) plus 'fuse' (bias,
argmax, fetch) stages of MultiViewPredictor.stage_ms() (CUDA events),
milliseconds per volume, mean over the window's volumes."""


def read(rec):
    vols = [v for v in rec.get("volumes") or [] if "remap" in v["stage_ms"]]
    if not vols:
        return None
    return sum(v["stage_ms"]["remap"] + v["stage_ms"].get("fuse", 0.0)
               for v in vols) / len(vols)
