"""loader (data/loader.py PrefetchLoader): the loader's busy time on its
worker thread, the program's spans ``loader.load`` (reading and collating a
batch) and ``loader.put`` (its copy to the device), per step (one batch a
step), in ms."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "loader.load" not in found:
        return None
    return program_spans.total_ms(found, "loader.load", "loader.put") / run.units
