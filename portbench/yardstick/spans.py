"""What the program's own spans (``repro_torch.tracing``) say: their records
of the latest traced window, and the self time of the reward spans that the
two tune metrics share."""
from __future__ import annotations

from typing import Dict, List

REWARD, LOWER = "measure.reward", "backend.lower"


def records() -> List:
    """The latest traced window's closed spans; empty on a program without
    the tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def reward_self_s(recs) -> Dict[int, float]:
    """Each ``measure.reward`` span's host seconds less those of its
    ``backend.lower`` children, by the span's index."""
    rewards = {r.index: r.host_s for r in recs if r.name == REWARD}
    for r in recs:
        if r.name == LOWER and r.parent in rewards:
            rewards[r.parent] -= r.host_s
    return rewards
