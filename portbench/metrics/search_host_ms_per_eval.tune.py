"""Milliseconds of the tuner's and the searches' host work a measurement
over the traced window: the summed host time of the program's
``tuner.tune`` spans less the summed self time of its ``measure.reward``
spans (each one's host time less that of its ``backend.lower``
children), over the count of ``measure.reward`` spans.  With
``measure_ms_per_eval.tune`` it adds up to the window's cost of one
evaluation.  None where the program keeps no such spans."""
from yardstick import spans as SP

TUNE = "tuner.tune"


def value(records):
    tune_s = sum(r.host_s for r in records if r.name == TUNE)
    rewards = SP.reward_self_s(records)
    if not rewards or tune_s <= 0.0:
        return None
    return 1e3 * (tune_s - sum(rewards.values())) / len(rewards)


def read(run):
    if run.kind != "tune":
        return None
    return value(SP.records())
