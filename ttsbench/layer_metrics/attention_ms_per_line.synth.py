"""models (models/f5.py Attention: ``F.scaled_dot_product_attention`` over
every frame of a chunk, 16 heads of 64, in each of the 22 DiT blocks of
every guided step): the union of the attention kernels' device intervals,
mean per chunk, in ms. The kernels are told by name
(``traffic/f5_lines.py`` ``ATTENTION_KERNELS``)."""

from ttsbench.traffic.f5_lines import attention_ms


def read(run):
    if not run.units or not run.device:
        return None
    ms = attention_ms(run)
    return None if ms is None else ms / run.units
