"""peak_gib.batch: the card's peak allocated memory over the window
(``torch.cuda.max_memory_allocated``, reset when the window opens), GiB."""


def read(r):
    return None if r.window_peak_bytes is None else r.window_peak_bytes / 2**30
