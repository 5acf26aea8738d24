"""The prefill step's share of the card's bf16 peak: the model FLOPs of
every wave of the window over the peak times the window (host clock)."""
from yardstick import counting as N


def read(run):
    if run.kind != "prefill" or not run.steps:
        return None
    flops = N.model_flops(run.model, run.batch, run.seq, "prefill") * run.steps
    return 100.0 * flops / (N.PEAK_BF16_FLOPS * run.window_s)
