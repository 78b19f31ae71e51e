"""device.peak_mem_gib: torch.cuda.max_memory_allocated() over the window
(the peak statistics reset as it opens), in GiB."""


def read(run):
    peak = run.get("memory_peak_window")
    if not peak:
        return None
    return peak / 2**30
