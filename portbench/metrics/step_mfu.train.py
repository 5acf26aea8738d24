"""The training step's share of the card's bf16 peak: 3x the forward's
model FLOPs (no remat recompute) of every step of the window over the peak
times the window (host clock)."""
from yardstick import counting as N


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    flops = N.model_flops(run.model, run.batch, run.seq, "train") * run.steps
    return 100.0 * flops / (N.PEAK_BF16_FLOPS * run.window_s)
