"""The card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
