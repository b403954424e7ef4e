"""swin.attn_roofline_pct: the windowed attention's least time over the
device time of the `swin.attn` spans in the traced steps, in percent.
The least time is that of the attention's own work in the forwards the
spans hold (their counter `swin.windows`, windows x heads attended): q
k^T and p v at the bf16 dense peak against q, k, v, the bias and the
output at the HBM bandwidth (`arith_swin.attention_least_seconds`),
counted from the configuration whatever implements it. The spans also
hold the block's LayerNorm, shift, partition and qkv and output
projections, which the least time leaves out."""

from portbench import arith_swin, spans


def read(rec):
    swin = rec.get("swin")
    attn = spans.named(rec, "swin.attn", "train") if swin else []
    if not attn or any(r["device_ms"] is None for r in attn):
        return None
    windows = sum(r["counters"].get("swin.windows", 0) for r in attn)
    spent = sum(r["device_ms"] for r in attn) / 1e3
    if not windows or spent <= 0:
        return None
    least = arith_swin.attention_least_seconds(swin["build"], swin["batch"],
                                               windows)
    return 100.0 * least / spent
