"""programs (export/programs.py BucketProgram, export/package.py): device
operations (kernels, copies, sets) per line, from the profiler's device
events, those a CUDA graph's replay runs included."""


def read(run):
    if not run.units or not run.device:
        return None
    return len(run.device) / run.units
