"""predict_volumes_per_min: volumes completed in the window over the time
from its start to the end of the last volume (host clock; each volume
ends in the fetch of its class map)."""


def read(rec):
    if rec.get("kind") != "predict" or not rec.get("attempted"):
        return None
    return 60.0 * rec["attempted"] / rec["window_s"]
