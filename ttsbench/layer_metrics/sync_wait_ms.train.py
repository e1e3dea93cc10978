"""step (trainer/steps.py): the host's time in the program's
``train.sync.*`` spans (reading a value back from the device, which waits
for the device's queue to drain), mean per step, in ms."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "train.step" not in found:
        return None
    syncs = program_spans.named(found, "train.sync.")
    return program_spans.total_ms(found, *syncs) / run.units
