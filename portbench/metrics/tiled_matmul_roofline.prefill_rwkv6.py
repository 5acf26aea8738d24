"""The tiled matmul's share of its roofline over the traced RWKV-6 waves:
the sum of each launch's bound (max of 2mkn over the bf16 peak and the
bytes of A and B read once and C written once over HBM's bandwidth) over
the sum of the kernel's device time (trace).  Launches from the
configuration's eight full-width products a layer and the head."""
from yardstick import counting as N
from yardstick import rwkv6 as R


def read(run):
    if run.kind != "prefill_rwkv6" or run.trace is None:
        return None
    kernel_s = run.trace.by_class_s.get("tiled_matmul", 0.0)
    if kernel_s <= 0.0:
        return None
    sites = R.dense_sites(run.model, run.batch * run.seq)
    return 100.0 * N.dense_bound_s(sites, run.traced_steps) / kernel_s
