"""narrow phase and glue: device milliseconds per traced step of every
device activity that no kernel stage (``kernels/*.json``) names."""


def read(r):
    if not r.dev or not r.traced_steps:
        return None
    return 1e3 * r.stage_s.get(None, 0.0) / r.traced_steps
