"""LoopTune action space (paper §III-A, Fig. 3).

Cursor-based, non-parametric actions:

* ``up`` / ``down``          — move the agent cursor (no structural change)
* ``swap_up`` / ``swap_down``— exchange the current loop with its neighbour
                               (cursor follows the loop)
* ``split_<v>``              — split the current loop by ``v``

Illegal actions (cursor at boundary, swap across compute/write-back sections,
split larger than the loop count) are *no-ops* — the environment still
consumes a step and emits zero reward, matching the paper's fixed-length
episodes with implicit stop.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .loop_ir import LoopNest

# Paper's CPU experiments use small power-of-two splits; our TPU environment
# biases toward MXU/VREG-aligned factors (multiples of 8 / 128).
CPU_SPLITS: Sequence[int] = (2, 4, 8, 16, 32, 64)
TPU_SPLITS: Sequence[int] = (8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class Action:
    name: str
    kind: str  # "move" | "swap" | "split"
    param: int = 0  # split factor or move/swap direction (+1 down, -1 up)


def build_action_space(splits: Sequence[int] = CPU_SPLITS) -> List[Action]:
    acts = [
        Action("up", "move", -1),
        Action("down", "move", +1),
        Action("swap_up", "swap", -1),
        Action("swap_down", "swap", +1),
    ]
    for v in splits:
        acts.append(Action(f"split_{v}", "split", v))
    return acts


_FIXED_ACTIONS = {a.name: a for a in build_action_space(())}


def action_from_name(name: str) -> Action:
    """Invert ``Action.name`` (the form checkpoints record)."""
    if name in _FIXED_ACTIONS:
        return _FIXED_ACTIONS[name]
    if name.startswith("split_"):
        return Action(name, "split", int(name[len("split_"):]))
    raise ValueError(f"unknown action name {name!r}")


def actions_from_names(names: Sequence[str]) -> List[Action]:
    """Rebuild an action space, in order, from recorded action names — used
    to restore a checkpoint's exact action space (arbitrary split ladders
    and orderings included, so index i always means what the policy's
    output unit i was trained to mean)."""
    return [action_from_name(n) for n in names]


def is_legal(nest: LoopNest, action: Action) -> bool:
    c = nest.cursor
    if action.kind == "move":
        t = c + action.param
        return 0 <= t < len(nest.loops)
    if action.kind == "swap":
        t = c + action.param
        if not (0 <= t < len(nest.loops)):
            return False
        if nest.in_compute(c) != nest.in_compute(t):
            return False
        # Swapping two levels of the *same* iterator is degenerate (it either
        # changes nothing or inverts an outer/inner split pair, which has no
        # LoopTool equivalent); keep per-iterator levels outer->inner.
        return nest.loops[c].iterator != nest.loops[t].iterator
    if action.kind == "split":
        lv = nest.loops[c]
        return 1 < action.param < lv.count
    raise ValueError(action.kind)


def apply_action(nest: LoopNest, action: Action) -> bool:
    """Apply ``action`` in place.  Returns True iff the nest *structure*
    changed (moves never change structure; illegal actions are no-ops)."""
    if not is_legal(nest, action):
        return False
    if action.kind == "move":
        nest.cursor += action.param
        return False
    if action.kind == "swap":
        t = nest.cursor + action.param
        nest.swap(nest.cursor, t)
        nest.cursor = t
        return True
    if action.kind == "split":
        nest.split(nest.cursor, action.param)
        return True
    raise ValueError(action.kind)


def legal_mask(nest: LoopNest, actions: Sequence[Action]) -> List[bool]:
    return [is_legal(nest, a) for a in actions]
