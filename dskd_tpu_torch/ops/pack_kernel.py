"""Packed bilinear-corner tables (port of dskd_tpu/ops/pack_kernel.py
``pack_corners_fused`` and of the table layout of dskd_tpu/ops/msda.py
``_pack_corners(head_major=False)``).

``pack_corners(v, h, w)`` maps (B, h*w, H, D) level features to a
(B, (h+2)*(w+2), H, 4D) table whose row ``yp*(w+2)+xp`` holds
``[v(yp-1,xp-1), v(yp-1,xp), v(yp,xp-1), v(yp,xp)]`` per head, zeros outside
the map. On a CUDA tensor it launches ``csrc/pack_corners.cu``; on a CPU
tensor it runs ``pack_corners_plain``, the same function in plain PyTorch.

``PackCorners`` makes it differentiable in ``v``: its backward,
``pack_corners_bwd``, is the port of ``_pack_bwd``. Every v[y, x] was copied
to four table cells, so its cotangent is the sum of four shifted slices of
the table's. The JAX package computes this VJP in XLA, not in Pallas, so it
stays plain PyTorch on both devices.

Unlike the Pallas kernel, which rounds the table up to whole 8-line tiles and
leaves the tail rows as garbage, the port allocates exactly (h+2)*(w+2) rows.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))

_SIGNATURES = {
    "pack_corners": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                     ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p),
}


def pack_corners_plain(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain PyTorch version of ``pack_corners``, on any device."""
    B, _, H, D = v.shape
    vp = F.pad(v.reshape(B, h, w, H, D), (0, 0, 0, 0, 1, 1, 1, 1))
    packed = torch.cat([vp[:, dy:dy + h + 1, dx:dx + w + 1]
                        for dy, dx in CORNERS], dim=-1)
    packed = F.pad(packed, (0, 0, 0, 0, 0, 1, 0, 1))   # (B, h+2, w+2, H, 4D)
    return packed.reshape(B, (h + 2) * (w + 2), H, 4 * D)


def pack_corners_bwd(g: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Cotangent of the (B, (h+2)*(w+2), H, 4D) table -> that of the
    (B, h*w, H, D) level features: table[yp, xp, :, c] = v[yp+dy-1, xp+dx-1]
    for corner c = (dy, dx), so v[y, x] receives table[y+1-dy, x+1-dx, :, c].
    """
    B, _, H, D4 = g.shape
    D = D4 // 4
    gt = g.reshape(B, h + 2, w + 2, H, D4)
    dv = None
    for c, (dy, dx) in enumerate(CORNERS):
        sl = gt[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w, :, c * D:(c + 1) * D]
        dv = sl if dv is None else dv + sl
    return dv.reshape(B, h * w, H, D)


class PackCorners(torch.autograd.Function):
    """``pack_corners`` with the ``_pack_bwd`` backward."""

    @staticmethod
    def forward(ctx, v, h, w):
        ctx.hw = (h, w)
        if v.device.type == "cpu":
            return pack_corners_plain(v, h, w)
        return _pack_corners_cuda(v, h, w)

    @staticmethod
    def backward(ctx, g):
        return pack_corners_bwd(g, *ctx.hw), None, None


def pack_corners(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h*w, H, D) level features -> (B, (h+2)*(w+2), H, 4D) table.

    ``v`` may be a slice along the token axis of a contiguous (B, S, H, D)
    tensor: the kernel takes its batch stride and reads it in place.
    """
    return PackCorners.apply(v, h, w)


def _pack_corners_cuda(v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    if v.device.type != "cuda":
        raise ValueError(f"pack_corners: unsupported device {v.device}")
    B, S, H, D = v.shape
    if S != h * w:
        raise ValueError(f"pack_corners: {S} tokens for a {h}x{w} level")
    if v.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack_corners: unsupported dtype {v.dtype}")
    es = v.element_size()
    if (D * es) % 16:
        raise ValueError(f"pack_corners: D={D} is not a whole number of "
                         f"16-byte vectors in {v.dtype}")
    if B > 1 and v.stride(0) * es % 16:
        raise ValueError("pack_corners: batch stride not 16-byte aligned")
    if v.stride()[1:] != (H * D, D, 1):
        raise ValueError("pack_corners: each image's (h*w, H, D) block "
                         "must be contiguous")
    if v.data_ptr() % 16:
        raise ValueError("pack_corners: input not 16-byte aligned")
    d_vecs = D * es // 16
    if B > 65535 or h + 2 > 65535 \
            or (h + 2) * (w + 2) * H * 4 * d_vecs >= 2 ** 31:
        raise ValueError(f"pack_corners: {B} images of {h}x{w} exceed the "
                         "kernel's grid or its 32-bit offsets")
    out = torch.empty((B, (h + 2) * (w + 2), H, 4 * D), dtype=v.dtype,
                      device=v.device)
    lib = _build.load("pack_corners", _SIGNATURES)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _build.check(lib.pack_corners(v.data_ptr(), out.data_ptr(), B,
                                  v.stride(0) * es // 16, h, w, H,
                                  d_vecs, stream), "pack_corners")
    pack_corners.launches += 1
    return out


pack_corners.launches = 0
