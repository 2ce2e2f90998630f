"""Whisper backbone support: the conv-stem stub; the port of the JAX
package's ``repro/models/audio.py``.

The backbone is the transformer only.  The log-mel + two conv1d frontend
is a stub in both packages: a caller hands the encoder precomputed frame
embeddings (B, T_frames, d_model) as ``batch["enc_embeds"]`` (Whisper's
30-second window is 3000 mel frames, which the stride-2 stem halves to
1500 encoder positions).
"""

from __future__ import annotations

import torch


def conv_frontend_stub(batch: int, n_frames: int, d_model: int, dtype=torch.bfloat16,
                       device="cpu") -> torch.Tensor:
    """Stand-in for the log-mel + 2x strided conv1d stem: zeros."""
    return torch.zeros((batch, n_frames, d_model), dtype=dtype, device=device)
