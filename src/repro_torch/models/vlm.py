"""Qwen2-VL backbone support: the M-RoPE position ids and the
patch-embed stub; the port of the JAX package's ``repro/models/vlm.py``.

The modality frontend is a stub: a caller hands ``Model.loss`` precomputed
patch embeddings (B, P, d_model) as ``batch["prefix_embeds"]``.  The
backbone is the dense GQA transformer with multimodal rotary positions:
vision tokens carry (temporal, height, width) ids over the patch grid, text
tokens carry equal t/h/w ids continuing after the vision prefix
(degenerates to 1-D RoPE).  As in the reference, serving (``prefill``,
``decode_step``) reads only tokens, so the served model is text only.
"""

from __future__ import annotations

import torch


def mrope_positions(batch: int, prefix: int, seq: int, grid_w: int = 16,
                    device="cpu") -> torch.Tensor:
    """(3, B, prefix+seq) int32 position ids for [vision prefix | text].

    The prefix's P patches lie on a grid ``grid_w`` wide, row by row: t = 0,
    h = p // grid_w, w = p % grid_w.  The text starts at the prefix's
    largest id plus one (not at P), each token's three ids equal.  The base
    is worked out on the host from P and ``grid_w``, so no id is read back
    from ``device``."""
    if prefix:
        vp = torch.arange(prefix, device=device)
        t_v = torch.zeros((prefix,), dtype=torch.int32, device=device)
        h_v = (vp // grid_w).to(torch.int32)
        w_v = (vp % grid_w).to(torch.int32)
        # max(t_v.max(), h_v.max(), w_v.max()) + 1, as the reference takes it
        base = max(0, (prefix - 1) // grid_w, min(prefix, grid_w) - 1) + 1
    else:
        t_v = h_v = w_v = torch.zeros((0,), dtype=torch.int32, device=device)
        base = 0
    txt = base + torch.arange(seq, dtype=torch.int32, device=device)
    pos = torch.stack([torch.cat([t_v, txt]), torch.cat([h_v, txt]),
                       torch.cat([w_v, txt])])  # (3, P+S)
    return pos[:, None, :].expand(3, batch, prefix + seq)


def patch_embed_stub(batch: int, n_patches: int, d_model: int, dtype=torch.bfloat16,
                     device="cpu") -> torch.Tensor:
    """Stand-in for the ViT frontend: precomputed patch embeddings (zeros)."""
    return torch.zeros((batch, n_patches, d_model), dtype=dtype, device=device)
