"""train_samples_per_s: images (2D) or boxes (3D) trained in the window
over the window's time, which ends in a synchronise after the last
step."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("samples"):
        return None
    return rec["samples"] / rec["window_s"]
