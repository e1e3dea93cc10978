"""device: the share of the traced window in which no device operation
ran, in %."""


def read(run):
    if run.window_s <= 0 or not run.device:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
