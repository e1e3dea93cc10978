"""models, inference: the union of the device operations' intervals
over the seconds of audio the traced lines returned, in ms per second."""


def read(run):
    if run.audio_s <= 0 or not run.device:
        return None
    return run.busy_s * 1e3 / run.audio_s
