"""peak_gb.train: the most device memory the window's steps held, in GB
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(run):
    peak = run.window.get("peak_bytes")
    return peak / 1e9 if peak else None
