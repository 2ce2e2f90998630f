"""Sliding Window Unit (SWU): FINN's on-the-fly im2col, in plain PyTorch.

Lowers a convolution input (B, H, W, C) into the GEMM activation matrix of
paper Fig. 1: each output pixel becomes one row of K = Kd^2 * C features,
ordered (ky, kx, c) -- the same order the weight matrix rows are packed in
(see :func:`pack_conv_weights`).  :func:`sliding_window` materialises that
matrix: it is the interpreter's path and the plain version of the fused
conv kernel (``kernels/swu_mvu.py``), whose CUDA kernel never builds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def out_dim(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def sliding_window(x: torch.Tensor, kernel: int, stride: int = 1,
                   pad: int = 0) -> torch.Tensor:
    """(B, H, W, C) -> (B, OH*OW, Kd^2*C) in (ky, kx, c) feature order;
    out-of-image taps read as 0."""
    b, h, w, c = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    oh = out_dim(h, kernel, stride, pad)
    ow = out_dim(w, kernel, stride, pad)
    # (B, OH, OW, C, ky, kx) windows as a view, then (ky, kx, c) per pixel
    win = x.unfold(1, kernel, stride).unfold(2, kernel, stride)
    return win.permute(0, 1, 2, 4, 5, 3).reshape(b, oh * ow, kernel * kernel * c)


def pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """Conv weights (Kd, Kd, Cin, Cout) -> MVU matrix (Cout, Kd^2*Cin)."""
    kd, kd2, cin, cout = w.shape
    if kd != kd2:
        raise ValueError(f"conv weights must be square, got {tuple(w.shape)}")
    return w.permute(3, 0, 1, 2).reshape(cout, kd * kd * cin).contiguous()


def conv_via_swu_mvu(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     pad: int = 0) -> torch.Tensor:
    """Reference conv = SWU + dense MVU matmul (for testing the lowering),
    in float32: (B, H, W, C) x (Kd, Kd, C, N) -> (B, OH, OW, N)."""
    b, h, ww, _ = x.shape
    kd = w.shape[0]
    cols = sliding_window(x, kd, stride, pad)  # (B, P, K)
    wm = pack_conv_weights(w)  # (N, K)
    out = torch.einsum("bpk,nk->bpn", cols.to(torch.float32), wm.to(torch.float32))
    oh = out_dim(h, kd, stride, pad)
    ow = out_dim(ww, kd, stride, pad)
    return out.reshape(b, oh, ow, w.shape[-1])
