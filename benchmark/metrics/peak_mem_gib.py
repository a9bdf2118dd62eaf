"""device: the most device memory allocated during the measured window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
the window's start), in GiB."""


def read(r):
    if r.window_peak_bytes is None:
        return None
    return r.window_peak_bytes / 2 ** 30
