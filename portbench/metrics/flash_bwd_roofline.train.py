"""Flash attention's backward share of its roofline over the traced steps:
each call's bound from the backward's useful operations (four products
over the causal pairs) and bytes, over the device time of its kernels
(dq and dk/dv); one call a layer a step."""
from yardstick import counting as N


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    kernel_s = run.trace.by_class_s.get("flash_bwd", 0.0)
    if kernel_s <= 0.0:
        return None
    m = run.model
    flops, nbytes = N.flash_bwd_work(run.batch, run.seq, m["n_heads"], m["n_kv_heads"],
                                     m["d_model"] // m["n_heads"], m["dtype"])
    launches = m["n_layers"] * run.traced_steps
    return 100.0 * launches * N.bound_s(flops, nbytes) / kernel_s
