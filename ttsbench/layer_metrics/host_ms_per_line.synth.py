"""programs (export/package.py generate_speech): the host's own work on a
line, in ms: the program's span ``speak.line`` less its ``speak.fetch``
spans (where the host waits for the device and copies the audio back),
mean per line."""

from ttsbench import program_spans


def read(run):
    if not run.units:
        return None
    found = program_spans.spans(run)
    if not found or "speak.line" not in found:
        return None
    return (program_spans.total_ms(found, "speak.line")
            - program_spans.total_ms(found, "speak.fetch")) / run.units
