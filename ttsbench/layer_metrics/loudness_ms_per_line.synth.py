"""post-processing (tts/loudness.py normalize_loudness): the mean time of
the harness span around it per line, in ms."""


def read(run):
    if not run.units or "loudness" not in run.spans:
        return None
    return run.span_s("loudness") * 1e3 / run.units
