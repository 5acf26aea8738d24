"""Schedules the tuner measured on the card a second: the executor's
measurement count over the window (``LoopTuner.stats()``'s
``measurements``, read on the executor the tuners share)."""


def read(run):
    if run.kind != "tune" or not run.window_s:
        return None
    return run.counters["measurements"] / run.window_s
