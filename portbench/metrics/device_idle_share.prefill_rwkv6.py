"""The share of the RWKV-6 prefill's traced window in which no kernel, copy
or memset ran on the card: 1 - (union of the trace's device rows) / window."""


def read(run):
    if run.kind != "prefill_rwkv6" or run.trace is None:
        return None
    return 100.0 * run.trace.idle_share
