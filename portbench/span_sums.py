"""Sums of the program's spans per request (a traced volume, or a traced
step), for the per-layer metrics of the 3D predict and Swin UNETR cells;
the spans come from `portbench/spans.py`."""

from __future__ import annotations

from portbench import spans


def device_ms(rec, name, kind):
    """Mean over the requests (volumes or steps) that hold spans called
    `name` of their summed device milliseconds; None without such spans
    or without device times (off the card)."""
    per = {}
    for r in spans.named(rec, name, kind):
        if r["device_ms"] is None:
            return None
        key = repr(r["request"])
        per[key] = per.get(key, 0.0) + r["device_ms"]
    return sum(per.values()) / len(per) if per else None


def counter(rec, name, kind, counter_name):
    """Mean over the requests that hold spans called `name` of the summed
    counter `counter_name` of those spans; None where no such span carries
    the counter."""
    per, counted = {}, False
    for r in spans.named(rec, name, kind):
        n = r["counters"].get(counter_name)
        counted = counted or n is not None
        key = repr(r["request"])
        per[key] = per.get(key, 0) + (n or 0)
    return sum(per.values()) / len(per) if counted else None
