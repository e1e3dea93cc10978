"""loader (data/loader.py PrefetchLoader): the mean time a step waited
in the harness span around the loader's next(), in ms."""


def read(run):
    if not run.units or "loader.next" not in run.spans:
        return None
    return run.span_s("loader.next") * 1e3 / run.units
