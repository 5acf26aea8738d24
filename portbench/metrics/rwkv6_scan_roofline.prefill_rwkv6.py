"""The RWKV-6 scan's share of its roofline over the traced waves: the count
of the program's ``rwkv6.scan`` spans (one a layer a wave) times one
scan's bound over the spans' summed device time (CUDA events on the
stream around the scan's two launches).  The bound: max of the
recurrence's 4 H N^2 operations a token over the f32 peak and the bytes
(r, k, v read at the model's type, logw at f32, u and the carried state
read, y at f32 and the final state written) over HBM's bandwidth.  None
where the program keeps no such spans."""
from yardstick import counting as N
from yardstick import rwkv6 as R
from yardstick import spans as SP

SCAN = "rwkv6.scan"


def value(records, model, batch, seq):
    scans = [r for r in records if r.name == SCAN]
    if not scans or any(r.device_s is None for r in scans):
        return None
    device_s = sum(r.device_s for r in scans)
    if device_s <= 0.0:
        return None
    flops, nbytes = R.scan_work(model, batch, seq)
    return 100.0 * len(scans) * N.bound_s(flops, nbytes, peak=R.PEAK_F32_FLOPS) / device_s


def read(run):
    if run.kind != "prefill_rwkv6":
        return None
    return value(SP.records(), run.model, run.batch, run.seq)
