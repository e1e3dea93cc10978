"""step (trainer/steps.py): kernel and graph launches the host issued
per step, from the profiler's runtime events."""


def read(run):
    if not run.units or not run.launches:
        return None
    return run.launches / run.units
