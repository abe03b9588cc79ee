"""serve.host_us_per_tick: the scheduler's own host time (SlotScheduler.host_ns:
admission and bookkeeping) over the window, per tick."""


def read(run):
    return run.host_ns / run.ticks / 1e3 if run.ticks else None
