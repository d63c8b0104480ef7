"""Weighted gather of packed corner rows (port of dskd_tpu/ops/mxu_gather.py
``mxu_gather_weighted``, forward).

``gather_weighted(table, idx, w)`` computes
``out[..., q, :] = sum_p table[row idx[..., q, p]] * expand(w[..., q, p, 0:4])``
where each of the four corner weights spans its D-lane chunk of the 4D-wide
row. Sums run in f32 and the result has ``table.dtype``. An index outside
[0, S) contributes a zero row, as the TPU kernel's one-hot gives it; the CUDA
kernel never reads it.

Two layouts, one kernel:
  * ``mxu_gather_weighted``'s own: table (N, S, 4D), idx (N, Q, P),
    w (N, Q, P, 4) -> (N, Q, 4D);
  * MSDA's, with the head axis in the middle: table (B, S, H, 4D),
    idx (B, Q, H, P), w (B, Q, H, P, 4) -> (B, Q, H, 4D). The kernel takes the
    table's strides, so it reads ``pack_corners``' output in place.

On a CUDA tensor the wrapper launches ``csrc/gather_weighted.cu``; on a CPU
tensor it runs ``gather_weighted_plain``. The TPU needed a one-hot matmul
because its gather is a scalar loop; the GPU gathers rows directly, so the
port has no ``mxu_gather_max_rows`` cutoff.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 9 + (ctypes.c_void_p,)
_SIGNATURES = {"gather_weighted_f32": _ARGS, "gather_weighted_bf16": _ARGS}
_ENTRY = {torch.float32: "gather_weighted_f32",
          torch.bfloat16: "gather_weighted_bf16"}


def gather_weighted_plain(table: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_weighted`` (MSDA layout), on any
    device."""
    B, S, H, D4 = table.shape
    valid = (idx >= 0) & (idx < S)
    rows = idx.clamp(0, S - 1).long()
    bi = torch.arange(B, device=table.device)[:, None, None, None]
    hi = torch.arange(H, device=table.device)[None, None, :, None]
    g = table[bi, rows, hi].float()                  # (B, Q, H, P, 4D)
    wx = (w.float() * valid[..., None]).repeat_interleave(D4 // 4, dim=-1)
    return (g * wx).sum(dim=3).to(table.dtype)


def gather_weighted(table: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted corner-row gather; see the module docstring for layouts."""
    if table.dim() == 3:                             # (N, S, 4D) layout
        return gather_weighted(table[:, :, None], idx[:, :, None],
                               w[:, :, None])[:, :, 0]
    if table.device.type == "cpu":
        return gather_weighted_plain(table, idx, w)
    if table.device.type != "cuda":
        raise ValueError(f"gather_weighted: unsupported device "
                         f"{table.device}")
    B, S, H, D4 = table.shape
    Q, P = idx.shape[1], idx.shape[3]
    if idx.shape != (B, Q, H, P) or w.shape != (B, Q, H, P, 4):
        raise ValueError(f"gather_weighted: shapes table {tuple(table.shape)}"
                         f" idx {tuple(idx.shape)} w {tuple(w.shape)}")
    if table.dtype not in _ENTRY:
        raise TypeError(f"gather_weighted: unsupported dtype {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError("gather_weighted: idx must be int32")
    if D4 % 16:
        raise ValueError(f"gather_weighted: row width {D4} is not 4 corner "
                         "chunks of a multiple of 4 elements")
    if table.stride(3) != 1 or any(s % 4 for s in table.stride()[:3]):
        raise ValueError("gather_weighted: table rows must be contiguous "
                         "with strides a multiple of 4 elements")
    if table.data_ptr() % 16:
        raise ValueError("gather_weighted: table not 16-byte aligned")
    if not (idx.device == w.device == table.device):
        raise ValueError("gather_weighted: tensors on different devices")
    idx = idx.contiguous()
    w = w.to(torch.float32).contiguous()
    out = torch.empty((B, Q, H, D4), dtype=table.dtype, device=table.device)
    lib = _build.load("gather_weighted", _SIGNATURES)
    fn = getattr(lib, _ENTRY[table.dtype])
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                    out.data_ptr(), B, Q, H, P, S, D4, table.stride(0),
                    table.stride(1), table.stride(2), stream),
                 "gather_weighted")
    gather_weighted.launches += 1
    return out


gather_weighted.launches = 0
