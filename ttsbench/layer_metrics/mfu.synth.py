"""whole line against the chip: the reference's matrix-product and
convolution FLOPs of every traced line at its real token and frame count
(bucket padding is not work) over the traced window times the dense bf16
peak, in %."""


def read(run):
    if not run.flops or run.window_s <= 0:
        return None
    return 100.0 * run.flops / (run.window_s * run.peak_flops)
