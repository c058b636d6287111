"""Shared layers of the LM prefill path — the port of the parts of
``repro.layers.core`` that the prefill step runs: ``rms_norm`` (Gemma's
``1 + weight``), ``rope`` with positions shared over the batch, and
``swiglu``.

Attention is not here: the prefill step calls kernel A4 through
``repro_torch.kernels.flash_attention.ops.attention``.  The JAX module's
``chunked_attention``, ``decode_attention`` and ``_make_flash_train``
serve the decode and train steps, which are later slices of the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, H, S, Dh); positions: (S,), shared by every sequence."""
    if positions.dim() != 1:
        raise ValueError("the port's rope takes shared (S,) positions; "
                         "per-sequence positions serve decode, a later slice")
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs             # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)
