"""Weighted gather of packed corner rows, forward and backward (port of
dskd_tpu/ops/mxu_gather.py ``mxu_gather_weighted``: ``_fwd_w_kernel`` and
``_bwd_w_kernel``).

``gather_weighted(table, idx, w)`` computes
``out[..., q, :] = sum_p table[row idx[..., q, p]] * expand(w[..., q, p, 0:4])``
where each of the four corner weights spans its D-lane chunk of the 4D-wide
row. Sums run in f32 and the result has ``table.dtype``. An index outside
[0, S) contributes a zero row, as the TPU kernel's one-hot gives it; the CUDA
kernel never reads it.

It is differentiable in ``table`` and ``w`` through ``GatherWeighted``:
``dtable`` is the scatter-add of ``dout * expand(w)`` at ``idx`` and
``dw[..., c]`` the dot of chunk c of ``dout`` with chunk c of the gathered
row; an index outside [0, S) adds nothing to ``dtable`` and gets ``dw = 0``.
``dtable`` is summed in f32 (the TPU kernel sums in the table's type) and
``dw`` has ``w``'s type.

Two layouts, one kernel:
  * ``mxu_gather_weighted``'s own: table (N, S, 4D), idx (N, Q, P),
    w (N, Q, P, 4) -> (N, Q, 4D);
  * MSDA's, with the head axis in the middle: table (B, S, H, 4D),
    idx (B, Q, H, P), w (B, Q, H, P, 4) -> (B, Q, H, 4D). The kernels take the
    table's strides, so they read ``pack_corners``' output in place.

On CUDA tensors the forward launches ``csrc/gather_weighted.cu`` and the
backward ``csrc/gather_weighted_bwd.cu``; on CPU tensors they run
``gather_weighted_plain`` and ``gather_weighted_bwd_plain``. The TPU needed a
one-hot matmul because its gather is a scalar loop; the GPU gathers rows
directly, so the port has no ``mxu_gather_max_rows`` cutoff.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 9 + (ctypes.c_void_p,)
_SIGNATURES = {"gather_weighted_f32": _ARGS, "gather_weighted_bf16": _ARGS}
_BWD_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 9 + (
    ctypes.c_void_p,)
_BWD_SIGNATURES = {"gather_weighted_bwd_f32": _BWD_ARGS,
                   "gather_weighted_bwd_bf16": _BWD_ARGS}
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def gather_weighted_plain(table: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward (MSDA layout), on any device."""
    B, S, H, D4 = table.shape
    valid = (idx >= 0) & (idx < S)
    rows = idx.clamp(0, S - 1).long()
    bi = torch.arange(B, device=table.device)[:, None, None, None]
    hi = torch.arange(H, device=table.device)[None, None, :, None]
    g = table[bi, rows, hi].float()                  # (B, Q, H, P, 4D)
    wx = (w.float() * valid[..., None]).repeat_interleave(D4 // 4, dim=-1)
    return (g * wx).sum(dim=3).to(table.dtype)


def gather_weighted_bwd_plain(table: torch.Tensor, idx: torch.Tensor,
                              w: torch.Tensor, dout: torch.Tensor):
    """Plain PyTorch version of the backward (MSDA layout), on any device:
    an f32 ``index_add_`` of ``dout * expand(w)`` into ``dtable`` and the
    per-corner dots of ``dout`` with the gathered rows. Returns
    ``(dtable in table.dtype, dw in w.dtype)``."""
    B, S, H, D4 = table.shape
    D = D4 // 4
    valid = (idx >= 0) & (idx < S)
    rows = idx.clamp(0, S - 1).long()
    bi = torch.arange(B, device=table.device)[:, None, None, None]
    hi = torch.arange(H, device=table.device)[None, None, :, None]
    g = dout.float()[:, :, :, None, :]               # (B, Q, H, 1, 4D)
    wx = (w.float() * valid[..., None]).repeat_interleave(D, dim=-1)
    dtable = torch.zeros((B * S * H, D4), dtype=torch.float32,
                         device=table.device)
    dtable.index_add_(0, ((bi * S + rows) * H + hi).reshape(-1),
                      (g * wx).reshape(-1, D4))
    rows_read = table[bi, rows, hi].float()          # (B, Q, H, P, 4D)
    dw = (rows_read * g).reshape(idx.shape + (4, D)).sum(-1)
    dw = dw * valid[..., None]
    return dtable.reshape(B, S, H, D4).to(table.dtype), dw.to(w.dtype)


def _check(name, table, idx, w):
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    B, S, H, D4 = table.shape
    Q, P = idx.shape[1], idx.shape[3]
    if idx.shape != (B, Q, H, P) or w.shape != (B, Q, H, P, 4):
        raise ValueError(f"{name}: shapes table {tuple(table.shape)}"
                         f" idx {tuple(idx.shape)} w {tuple(w.shape)}")
    if table.dtype not in _DTYPE_TAG:
        raise TypeError(f"{name}: unsupported dtype {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32")
    if D4 % 16:
        raise ValueError(f"{name}: row width {D4} is not 4 corner "
                         "chunks of a multiple of 4 elements")
    if table.stride(3) != 1 or any(s % 4 for s in table.stride()[:3]):
        raise ValueError(f"{name}: table rows must be contiguous "
                         "with strides a multiple of 4 elements")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: table not 16-byte aligned")
    if not (idx.device == w.device == table.device):
        raise ValueError(f"{name}: tensors on different devices")
    return B, S, H, D4, Q, P


def _gather_weighted_cuda(table, idx, w):
    B, S, H, D4, Q, P = _check("gather_weighted", table, idx, w)
    idx = idx.contiguous()
    w = w.to(torch.float32).contiguous()
    out = torch.empty((B, Q, H, D4), dtype=table.dtype, device=table.device)
    lib = _build.load("gather_weighted", _SIGNATURES)
    fn = getattr(lib, f"gather_weighted_{_DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                    out.data_ptr(), B, Q, H, P, S, D4, table.stride(0),
                    table.stride(1), table.stride(2), stream),
                 "gather_weighted")
    gather_weighted.launches += 1
    return out


def gather_weighted_bwd(table: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, dout: torch.Tensor):
    """(dtable, dw) of ``gather_weighted`` for the cotangent ``dout``
    (MSDA layout). Launches ``csrc/gather_weighted_bwd.cu`` on CUDA tensors
    and runs ``gather_weighted_bwd_plain`` on CPU tensors."""
    if table.device.type == "cpu":
        return gather_weighted_bwd_plain(table, idx, w, dout)
    B, S, H, D4, Q, P = _check("gather_weighted_bwd", table, idx, w)
    if dout.shape != (B, Q, H, D4) or dout.device != table.device:
        raise ValueError(f"gather_weighted_bwd: dout {tuple(dout.shape)} "
                         f"on {dout.device}")
    idx = idx.contiguous()
    w32 = w.to(torch.float32).contiguous()
    dout = dout.to(table.dtype).contiguous()
    dtable = torch.zeros((B, S, H, D4), dtype=torch.float32,
                         device=table.device)
    dw = torch.empty((B, Q, H, P, 4), dtype=torch.float32,
                     device=table.device)
    lib = _build.load("gather_weighted_bwd", _BWD_SIGNATURES)
    fn = getattr(lib, f"gather_weighted_bwd_{_DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), w32.data_ptr(),
                    dout.data_ptr(), dtable.data_ptr(), dw.data_ptr(), B, Q,
                    H, P, S, D4, table.stride(0), table.stride(1),
                    table.stride(2), stream), "gather_weighted_bwd")
    gather_weighted_bwd.launches += 1
    return dtable.to(table.dtype), dw.to(w.dtype)


gather_weighted_bwd.launches = 0


class GatherWeighted(torch.autograd.Function):
    """``gather_weighted`` (MSDA layout) with its backward; the CUDA kernels
    on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, table, idx, w):
        ctx.save_for_backward(table, idx, w)
        if table.device.type == "cpu":
            return gather_weighted_plain(table, idx, w)
        return _gather_weighted_cuda(table, idx, w)

    @staticmethod
    def backward(ctx, dout):
        table, idx, w = ctx.saved_tensors
        dtable, dw = gather_weighted_bwd(table, idx, w, dout)
        return dtable, None, dw


def gather_weighted(table: torch.Tensor, idx: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted corner-row gather; see the module docstring for layouts."""
    if table.dim() == 3:                             # (N, S, 4D) layout
        return gather_weighted(table[:, :, None], idx[:, :, None],
                               w[:, :, None])[:, :, 0]
    return GatherWeighted.apply(table, idx, w)


gather_weighted.launches = 0
