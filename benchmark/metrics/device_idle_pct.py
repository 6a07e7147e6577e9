"""device_idle_pct: the share of the traced frames' time in which no
operation ran on the device: busy time (the union of the device
operations' intervals in the traced window) over the seconds that the
same frames took just before, untraced.  The profiler's own cost, some
microseconds a launch, stretches the traced window and not that one."""


def read(run):
    if run.trace is None or run.plain_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.plain_s)
