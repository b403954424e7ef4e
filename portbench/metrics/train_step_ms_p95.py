"""train_step_ms_p95: the 95th percentile of the intervals between
consecutive steps' completion on the card (CUDA events recorded after
each train step call), over every step of the window, epoch boundaries
included."""

import numpy as np


def read(rec):
    between = rec.get("between_ms") if rec.get("kind") == "train" else None
    if not between:
        return None
    return float(np.percentile(between, 95))
