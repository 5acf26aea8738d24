"""The RWKV-6 prefill step's share of the card's bf16 peak: the model FLOPs
of every wave of the window (the eight full-width products a layer and the
head, the two LoRAs, and the scan's 4 H N^2 a token and layer) over the
peak times the window (host clock)."""
from yardstick import counting as N
from yardstick import rwkv6 as R


def read(run):
    if run.kind != "prefill_rwkv6" or not run.steps:
        return None
    flops = R.model_flops(run.model, run.batch, run.seq) * run.steps
    return 100.0 * flops / (N.PEAK_BF16_FLOPS * run.window_s)
