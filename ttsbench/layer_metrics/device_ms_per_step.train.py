"""models, training (models/*, losses.py, dsp/*, trainer/optim.py): the
union of the device operations' intervals per step, in ms."""


def read(run):
    if not run.units or not run.device:
        return None
    return run.busy_s * 1e3 / run.units
