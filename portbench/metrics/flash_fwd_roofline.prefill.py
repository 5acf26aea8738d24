"""Flash attention's forward share of its roofline over the traced waves:
each launch's bound (causal pairs only) over the kernel's device time; one
launch a layer a wave."""
from yardstick import counting as N


def read(run):
    if run.kind != "prefill" or run.trace is None:
        return None
    kernel_s = run.trace.by_class_s.get("flash_fwd", 0.0)
    if kernel_s <= 0.0:
        return None
    m = run.model
    flops, nbytes = N.flash_fwd_work(run.batch, run.seq, m["n_heads"], m["n_kv_heads"],
                                     m["d_model"] // m["n_heads"], m["dtype"])
    launches = m["n_layers"] * run.traced_steps
    return 100.0 * launches * N.bound_s(flops, nbytes) / kernel_s
