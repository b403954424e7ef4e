"""predict.host_gap_ms: per volume, the host wall of predict_image (which
ends in the class map's fetch) less its working stages (stage, stack,
unet, remap, fuse of MultiViewPredictor.stage_ms()): the time the card
waits on the host's planning and launches. Milliseconds, mean over the
window's volumes."""

WORK = ("stage", "stack", "unet", "remap", "fuse")


def read(rec):
    vols = [v for v in rec.get("volumes") or [] if v["stage_ms"]]
    if not vols:
        return None
    return sum(1e3 * v["wall_s"] - sum(v["stage_ms"].get(k, 0.0)
                                       for k in WORK)
               for v in vols) / len(vols)
