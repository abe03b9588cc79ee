"""idle_share.sample: the share of the traced window in which no operation
ran on the device: 1 - the union of the device intervals / the window."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
