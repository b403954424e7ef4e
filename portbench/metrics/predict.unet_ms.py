"""predict.unet_ms: the 'unet' stage of MultiViewPredictor.stage_ms() (CUDA
events), milliseconds per volume, mean over the window's volumes."""


def read(rec):
    vols = rec.get("volumes") or []
    ms = [v["stage_ms"]["unet"] for v in vols if "unet" in v["stage_ms"]]
    return sum(ms) / len(ms) if ms else None
