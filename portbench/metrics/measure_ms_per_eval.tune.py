"""Milliseconds a measurement spends in the timing loop and its reward
launches over the traced window: the summed self time of the program's
``measure.reward`` spans (each one's host time less that of its
``backend.lower`` children) over their count.  None where the program
keeps no such spans."""
from yardstick import spans as SP


def value(records):
    rewards = SP.reward_self_s(records)
    if not rewards:
        return None
    return 1e3 * sum(rewards.values()) / len(rewards)


def read(run):
    if run.kind != "tune":
        return None
    return value(SP.records())
