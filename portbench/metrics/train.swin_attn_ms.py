"""train.swin_attn_ms: device milliseconds a traced step of the Swin UNETR
forward's `swin.attn` spans (CUDA events around each Swin block's shift,
partition, qkv, attention, projection and reverse, eight a forward),
summed over the step, mean over the traced steps."""

from portbench import span_sums


def read(rec):
    return span_sums.device_ms(rec, "swin.attn", "train")
