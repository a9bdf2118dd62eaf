"""window layer: device activities (kernels, copies, sets) of the traced
steps over their substeps."""


def read(r):
    if not r.dev or not r.traced_steps:
        return None
    return len(r.dev) / (r.traced_steps * r.n_substeps)
