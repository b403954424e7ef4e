"""predict.stage_ms: the 'stage' stage of MultiViewPredictor.stage_ms() (CUDA
events), milliseconds per volume, mean over the window's volumes."""


def read(rec):
    vols = rec.get("volumes") or []
    ms = [v["stage_ms"]["stage"] for v in vols if "stage" in v["stage_ms"]]
    return sum(ms) / len(ms) if ms else None
