"""AdamW's share of its roofline over the traced steps: the count of the
program's ``optim.adamw`` spans times the optimizer's byte floor over
HBM's bandwidth, over the spans' summed device time (CUDA events on the
stream around the update and its global norm).  The floor, counted from
the configuration's shapes: each element's gradient read twice (the norm
and the update), the f32 first and second moments and master each read
and written, the parameter written; without a master (f32 parameters) the
parameter read and written in its place.  None where the program keeps
no such spans."""
from yardstick import counting as N
from yardstick import spans as SP
from yardstick import weights as W

ADAMW = "optim.adamw"


def floor_bytes(model):
    """Bytes one AdamW step moves at the least, over every leaf."""
    elems = 0
    for shape, _ in W.shapes(model).values():
        n = 1
        for d in shape:
            n *= d
        elems += n
    p = N.DTYPE_BYTES[model["dtype"]]
    state = 16 + 2 * p if model["dtype"] == "float32" else 24 + p
    return float(elems * (2 * p + state))


def value(records, model):
    steps = [r for r in records if r.name == ADAMW]
    if not steps or any(r.device_s is None for r in steps):
        return None
    device_s = sum(r.device_s for r in steps)
    if device_s <= 0.0:
        return None
    bound = N.bound_s(0.0, floor_bytes(model))
    return 100.0 * len(steps) * bound / device_s


def read(run):
    if run.kind != "train":
        return None
    return value(SP.records(), run.model)
