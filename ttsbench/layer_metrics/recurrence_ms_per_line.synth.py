"""models (models/kokoro.py LengthLSTM: cuDNN's LSTM, each direction a
unidirectional pass): the union of the device intervals of the LSTM
recurrence kernels, mean per line, in ms. The kernels are told by name, as
the first traced run of ``kokoro.speak_book`` showed them on an H100:
cuDNN's cell kernel ``elemWiseRNNcell`` and cuBLAS's ``gemvx`` (the
recurrent product of each step; about 65 of a line's ~8,000 ``gemvx``
launches are the style projections of the AdaIN and AdaLayerNorm blocks,
products of one row)."""

from ttsbench.harness import union_length

KERNELS = ("elemWiseRNNcell", "gemvx")


def read(run):
    if not run.units or not run.device:
        return None
    spans = [(s, e) for s, e, name in run.device if any(k in name for k in KERNELS)]
    if not spans:
        return None
    return union_length(spans) / 1e6 / run.units
