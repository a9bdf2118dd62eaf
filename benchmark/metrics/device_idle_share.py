"""device: the share of the traced steps' wall time in which no operation
ran on the device, in percent."""


def read(r):
    if not r.dev or r.trace_window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.trace_window_s)
