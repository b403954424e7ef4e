"""setup_s: seconds from the process's start to the window's first
request or step (imports, the kernel library, weights, data, warm-up)."""


def read(rec):
    return rec.get("setup_s")
