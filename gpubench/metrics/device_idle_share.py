"""``device_idle_share``: one minus the union of the device's operations
over the traced window, in %."""


def read(run):
    if run.trace is None or not run.trace.ops or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
