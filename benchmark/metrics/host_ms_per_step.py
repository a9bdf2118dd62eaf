"""env API layer: the host's milliseconds per ``step`` call in the measured
window, on the host's clock around each call, with no synchronize: the
time the host takes to enqueue a step."""


def read(r):
    if not r.host_step_s:
        return None
    return 1e3 * sum(r.host_step_s) / len(r.host_step_s)
