"""models (models/f5.py Attention): the reference's attention FLOPs of the
traced chunks, q k^T and p v at each chunk's real frames (4 T^2 x 64 per
head, 16 heads, 22 blocks, both guidance rows, every step:
``reference/f5.py`` ``attention_flops``), over the attention kernels'
union time (``traffic/f5_lines.py`` ``ATTENTION_KERNELS``) times the
dense float16 peak, in %. The count does not depend on the kernel that runs the attention,
nor on the bucket's padding, which is not work."""

from ttsbench.flops import PEAKS
from ttsbench.traffic.f5_lines import attention_ms


def read(run):
    flops = getattr(run, "attention_flops", None)
    if not flops or not run.device:
        return None
    ms = attention_ms(run)
    if not ms:
        return None
    return 100.0 * flops / (ms / 1e3 * PEAKS["bf16_flops"])
