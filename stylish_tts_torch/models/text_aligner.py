"""CTC text aligner: TDNN conv stack + FFN + log-softmax posteriors.

Counterpart of ``stylish_tts_tpu/models/text_aligner.py``: mel(80) input,
three TDNN layers (k=5,3,3, hidden 640), each ReLU -> Norm1d -> dropout
with the length mask applied before each conv, then a 5-layer FFN with
one outer skip and a linear head over n_tokens + 1 (blank = n_tokens).

The public layout is the JAX one, (B, T, n_mels) in and (B, T, C) out;
the convs run on (B, C, T) inside.

On a model axis (``parallel/sharding_rules.py``) the FFN alternates
column (``ffn_0``, ``ffn_2``, ``ffn_4``) and row (``ffn_1``, ``ffn_3``)
sharding, and the head ``out`` is row-sharded: it reads ``x + h`` with
``h`` column-sharded by ``ffn_4`` and ``x`` alike on every rank, so it
takes this rank's slice of ``x`` (exact). Every rank of a model group
then gets the same full-class log-probabilities, and runs the CTC on them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel import mesh as pmesh
from .common import Conv1d, Linear, Norm1d, dropout, sequence_mask, tp_dim


class TextAligner(nn.Module):
    def __init__(self, n_mels: int = 80, n_tokens: int = 178,
                 hidden_dim: int = 640, dropout: float = 0.1,
                 norm_mode: str = "group"):
        super().__init__()
        self.dropout = dropout
        in_dims = [n_mels, hidden_dim, hidden_dim]
        self.tdnn = nn.ModuleList(
            Conv1d(cin, hidden_dim, k) for cin, k in zip(in_dims, [5, 3, 3])
        )
        # reference BatchNorm1d(affine=False): parameter-free in group mode
        self.tdnn_norm = nn.ModuleList(
            Norm1d(hidden_dim, mode=norm_mode) for _ in range(3)
        )
        self.ffn = nn.ModuleList(
            Linear(hidden_dim, hidden_dim) for _ in range(5)
        )
        self.out = Linear(hidden_dim, n_tokens + 1)

    def forward(self, mel: torch.Tensor, mel_lengths: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """mel: (B, T, n_mels) -> log-probs (B, T, n_tokens + 1).

        Dropout is active in ``train()`` mode and draws from ``generator``."""
        x = mel.transpose(1, 2)  # (B, n_mels, T)
        mask = sequence_mask(mel_lengths, mel.shape[1]).to(x.dtype)[:, None, :]
        for conv, norm in zip(self.tdnn, self.tdnn_norm):
            x = x * mask
            x = norm(torch.relu(conv(x)))
            x = dropout(x, self.dropout, self.training, generator)
        x = x.transpose(1, 2)  # (B, T, hidden)
        # 5-layer FFN with ONE outer skip (reference Ffn)
        h = x
        for layer in self.ffn:
            h = dropout(torch.relu(layer(h)), self.dropout, self.training,
                        generator, shard_dim=-1 if tp_dim(layer) == 0 else None)
        if tp_dim(self.out) == 1:  # h is column-sharded by ffn_4
            x = pmesh.scatter_to_model(x, -1)
        return torch.log_softmax(self.out(x + h), dim=-1)
