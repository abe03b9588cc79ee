"""serve.tick_ms: the window's seconds over the scheduler's ticks executed
in it (SlotScheduler.ticks)."""


def read(run):
    return run.window_s / run.ticks * 1e3 if run.ticks else None
