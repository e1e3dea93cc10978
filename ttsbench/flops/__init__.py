"""The benchmark's FLOP count and the chip's peaks.

``count_flops`` counts the matrix products and convolutions of a call,
forward and backward, with ``torch.utils.flop_counter``; the benchmark
runs it over its frozen reference at the cell's shapes (never over the
program, whose recompute or hand kernels would change the count), so the
numerator of an ``mfu`` reads the same work whatever implements it. A
kernel's roofline share belongs here too: the function of its operations
and bytes beside the peaks below.
"""

from __future__ import annotations

# one H100 SXM, NVIDIA's data sheet, dense rates at 700 W
PEAKS = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "fp32_flops": 67e12,
    "hbm_bytes": 3.35e12,
}


def count_flops(fn) -> float:
    """Matrix-product and convolution FLOPs of ``fn()``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
