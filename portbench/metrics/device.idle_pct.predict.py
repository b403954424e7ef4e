"""device.idle_pct.predict: 100 x (1 - the union of the card's operation
intervals over the traced stretch's length), from torch.profiler over
a stretch of whole volumes."""


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "predict" or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
