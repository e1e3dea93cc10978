"""device: max_memory_allocated over the traced window (peak statistics
reset at its start), in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
