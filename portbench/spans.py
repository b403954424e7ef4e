"""The program's own spans and counters of a run (the port's recorder,
`multiplanarunet_tpu_torch.utils.trace`), for the per-layer metrics
whose source is `program_span`.

The cells' drivers (`portbench/drivers/`) leave the recorder alone. It
records while a torch.profiler runs, so in a `--trace 1` run on the card
it holds the spans of the traced stretch (`TracedWindow`: two window
volumes, or the window's steps across its first epoch boundary). The first reader takes
them from the recorder once and keeps them in the run's records for the
others. A program without the recorder, or a run that recorded
nothing, gives None, and each reader then returns None.
"""

from __future__ import annotations


def taken(rec):
    """{"spans": [...], "counters": {...}} of the run, or None."""
    if "program_spans" not in rec:
        try:
            from multiplanarunet_tpu_torch.utils import trace
        except ImportError:
            rec["program_spans"] = None
        else:
            records = trace.take()
            rec["program_spans"] = records if records["spans"] else None
    return rec["program_spans"]


def named(rec, name, kind):
    """The records of the spans called `name`, in a run of `kind`
    ("predict" or "train"); [] when there are none."""
    records = taken(rec) if rec.get("kind") == kind else None
    return [r for r in records["spans"] if r["name"] == name] \
        if records else []


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None
