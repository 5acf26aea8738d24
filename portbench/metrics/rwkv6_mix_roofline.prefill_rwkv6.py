"""The RWKV-6 time-mix's token shift, ddlerp and decay against their byte
floor over the traced waves: the count of the program's ``rwkv6.mix``
spans (one a layer a wave) times the floor's time over the spans' summed
device time (CUDA events).  The floor: x and the carry read at the model's
type, the LoRAs, mu and w0 read, the five mixed streams written at the
model's type and logw at f32, each once, over HBM's bandwidth (the LoRAs'
operations over the bf16 peak take less).  The RWKV counterpart of the
prefill's elementwise work.  None where the program keeps no such spans."""
from yardstick import counting as N
from yardstick import rwkv6 as R
from yardstick import spans as SP

MIX = "rwkv6.mix"


def value(records, model, batch, seq):
    mixes = [r for r in records if r.name == MIX]
    if not mixes or any(r.device_s is None for r in mixes):
        return None
    device_s = sum(r.device_s for r in mixes)
    if device_s <= 0.0:
        return None
    return 100.0 * len(mixes) * N.bound_s(*R.mix_work(model, batch, seq)) / device_s


def read(run):
    if run.kind != "prefill_rwkv6":
        return None
    return value(SP.records(), run.model, run.batch, run.seq)
