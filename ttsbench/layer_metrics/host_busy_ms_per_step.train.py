"""step (trainer/steps.py): the host's work in a training step, in ms: the
program's span ``train.step`` less its ``train.sync.*`` spans (where the
host waits for the device), mean per step. It is the main thread's wall
time, so inside ``backward()`` it holds the autograd engine's whole time,
its waits on a full launch queue included: an upper bound of the host's
own work."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "train.step" not in found:
        return None
    syncs = program_spans.named(found, "train.sync.")
    return (program_spans.total_ms(found, "train.step")
            - program_spans.total_ms(found, *syncs)) / run.units
