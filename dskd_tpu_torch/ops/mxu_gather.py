"""Gathers of packed corner rows, forward and backward (port of
dskd_tpu/ops/mxu_gather.py ``mxu_gather_weighted``: ``_fwd_w_kernel`` and
``_bwd_w_kernel``, and of ``mxu_gather``: ``_fwd_kernel`` and
``_bwd_kernel``; the second half of this module, below).

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
directly, so these kernels take a table of any size: MSDA's
``mxu_gather_max_rows`` only chooses between the variants the JAX package
switches with it. The forward reads ``w`` in its own type, f32 or bf16
(bf16 to f32 is exact, so the sums are those of an f32 ``w``): a bf16 step
launches no cast. It moves the table's rows in 16-byte vectors, so in bf16
the corner chunks and the table's strides must be multiples of 8 elements.
The backward casts ``w`` to f32, keeps four table rows in flight per warp
and adds each lane's four products into ``dtable`` with one 16-byte vector
f32 atomic, so the table, ``dout`` and ``dtable`` must be 16-byte aligned
with row widths and strides a multiple of 4 elements (``check_aligned``;
the wrappers raise otherwise).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 10 + (ctypes.c_void_p,)
_SIGNATURES = {"gather_weighted_f32": _ARGS, "gather_weighted_bf16": _ARGS}
_BWD_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 9 + (
    ctypes.c_void_p,)
# the windowed entry point adds the window starts and the escape counter,
# tile_q and the window's rows (ops/fused_window.py windowed_weighted_bwd)
_WIN_BWD_ARGS = (ctypes.c_void_p,) * 8 + (ctypes.c_int64,) * 11 + (
    ctypes.c_void_p,)
_BWD_SIGNATURES = {"gather_weighted_bwd_f32": _BWD_ARGS,
                   "gather_weighted_bwd_bf16": _BWD_ARGS,
                   "window_weighted_bwd_f32": _WIN_BWD_ARGS,
                   "window_weighted_bwd_bf16": _WIN_BWD_ARGS}
_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _head_index(B, H, device):
    """Batch and head indices that broadcast against (B, Q, H, P)."""
    return (torch.arange(B, device=device)[:, None, None, None],
            torch.arange(H, device=device)[None, None, :, None])


def gather_weighted_plain(table: torch.Tensor, idx: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward (MSDA layout), on any device."""
    B, S, H, D4 = table.shape
    valid = (idx >= 0) & (idx < S)
    rows = idx.clamp(0, S - 1).long()
    bi, hi = _head_index(B, H, table.device)
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
    bi, hi = _head_index(B, H, table.device)
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
    check_aligned(name, table=table)
    if not (idx.device == w.device == table.device):
        raise ValueError(f"{name}: tensors on different devices")
    return B, S, H, D4, Q, P


def check_aligned(name, **tensors):
    """Raise unless each tensor starts on a 16-byte boundary: the kernels
    move its rows in 16-byte vectors (the backward's bf16 rows in 8-byte
    ones) and add into an f32 ``dtable`` with 16-byte vector atomics."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} not 16-byte aligned")


def _gather_weighted_cuda(table, idx, w):
    B, S, H, D4, Q, P = _check("gather_weighted", table, idx, w)
    es = table.element_size()
    if D4 // 4 * es % 16 or any(s * es % 16 for s in table.stride()[:3]):
        raise ValueError("gather_weighted: corner chunks and table strides "
                         "must be whole 16-byte vectors")
    if w.dtype not in _DTYPE_TAG:
        raise TypeError(f"gather_weighted: unsupported weight dtype "
                        f"{w.dtype}")
    idx, w = idx.contiguous(), w.contiguous()
    out = torch.empty((B, Q, H, D4), dtype=table.dtype, device=table.device)
    lib = _build.load("gather_weighted", _SIGNATURES)
    fn = getattr(lib, f"gather_weighted_{_DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                    out.data_ptr(), B, Q, H, P, S, D4, table.stride(0),
                    table.stride(1), table.stride(2),
                    int(w.dtype == torch.bfloat16), stream),
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
    out = weighted_bwd_cuda("gather_weighted_bwd", table, idx, w, dout)
    gather_weighted_bwd.launches += 1
    return out


def weighted_bwd_cuda(name, table, idx, w, dout, window=None):
    """Launch ``csrc/gather_weighted_bwd.cu`` on CUDA tensors: ``(dtable in
    table.dtype, dw in w.dtype)``. With ``window = (starts, tile_q, rows,
    escapes)`` (an int32 tensor of one start per tile of ``tile_q`` queries,
    and the device int32 counter) its windowed entry point, which also adds
    the samples outside their tile's window of ``rows`` rows to
    ``escapes``."""
    B, S, H, D4, Q, P = _check(name, table, idx, w)
    if dout.shape != (B, Q, H, D4) or dout.device != table.device:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} on "
                         f"{dout.device}")
    idx = idx.contiguous()
    w32 = w.to(torch.float32).contiguous()
    dout = dout.to(table.dtype).contiguous()
    dtable = torch.zeros((B, S, H, D4), dtype=torch.float32,
                         device=table.device)
    check_aligned(name, dout=dout, dtable=dtable)
    dw = torch.empty((B, Q, H, P, 4), dtype=torch.float32,
                     device=table.device)
    lib = _build.load("gather_weighted_bwd", _BWD_SIGNATURES)
    tag = _DTYPE_TAG[table.dtype]
    stream = torch.cuda.current_stream(table.device).cuda_stream
    ptrs = (table.data_ptr(), idx.data_ptr(), w32.data_ptr(),
            dout.data_ptr())
    strides = (table.stride(0), table.stride(1), table.stride(2))
    if window is None:
        code = getattr(lib, f"gather_weighted_bwd_{tag}")(
            *ptrs, dtable.data_ptr(), dw.data_ptr(), B, Q, H, P, S, D4,
            *strides, stream)
    else:
        starts, tile_q, rows, escapes = window
        code = getattr(lib, f"window_weighted_bwd_{tag}")(
            *ptrs, starts.data_ptr(), dtable.data_ptr(), dw.data_ptr(),
            escapes.data_ptr(), B, Q, H, P, tile_q, rows, S, D4, *strides,
            stream)
    _build.check(code, name)
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


# --- mxu_gather: the plain row gather --------------------------------------
#
# Port of ``mxu_gather`` (``_fwd_kernel`` and ``_bwd_kernel``):
# ``out[n, m] = table[n, idx[n, m]]`` for table (N, S, D) and idx (N, M); an
# index outside [0, S) gives a zero row, as the TPU one-hot does. The
# backward scatter-adds ``g`` into ``dtable`` (nothing for an index outside
# [0, S)) and gives no gradient for ``idx``. MSDA calls it in its own layout,
# table (B, S, H, D) with the head axis in the middle and idx (B, Q, H, P),
# -> (B, Q, H, P, D): the kernels take the table's strides and read
# ``pack_corners``' output in place. On CUDA tensors the forward and the
# backward launch ``csrc/mxu_gather.cu``; on CPU tensors they run
# ``mxu_gather_plain`` and ``mxu_gather_bwd_plain``. ``dtable`` is summed in
# f32 and cast once to the table's type (the TPU kernel sums in the table's
# type).

_MG_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 9 + (ctypes.c_void_p,)
_MG_BWD_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 6 + (
    ctypes.c_void_p,)
MXU_GATHER_SIGNATURES = {
    "mxu_gather_f32": _MG_ARGS, "mxu_gather_bf16": _MG_ARGS,
    "mxu_gather_bwd_f32": _MG_BWD_ARGS, "mxu_gather_bwd_bf16": _MG_BWD_ARGS}


def mxu_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward (MSDA layout), on any device."""
    B, S, H, _ = table.shape
    valid = (idx >= 0) & (idx < S)
    bi, hi = _head_index(B, H, table.device)
    rows = table[bi, idx.clamp(0, S - 1).long(), hi]    # (B, Q, H, P, D)
    return torch.where(valid[..., None], rows, rows.new_zeros(()))


def mxu_gather_bwd_plain(idx: torch.Tensor, g: torch.Tensor,
                         table_rows: int) -> torch.Tensor:
    """Plain PyTorch version of the backward (MSDA layout), on any device:
    an f32 ``index_add_`` of ``g`` (B, Q, H, P, D) into the (B, S, H, D)
    ``dtable``, returned in ``g``'s type."""
    B, _, H, _, D = g.shape
    S = table_rows
    valid = (idx >= 0) & (idx < S)
    bi, hi = _head_index(B, H, g.device)
    dest = ((bi * S + idx.clamp(0, S - 1).long()) * H + hi).reshape(-1)
    dtable = torch.zeros((B * S * H, D), dtype=torch.float32, device=g.device)
    dtable.index_add_(0, dest, (g.float() * valid[..., None]).reshape(-1, D))
    return dtable.reshape(B, S, H, D).to(g.dtype)


def _check_idx(name, idx, B, H, device):
    if idx.dim() != 4 or idx.shape[0] != B or idx.shape[2] != H:
        raise ValueError(f"{name}: idx {tuple(idx.shape)} is not (B={B}, Q, "
                         f"H={H}, P)")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32")
    if idx.device != device:
        raise ValueError(f"{name}: tensors on different devices")


def _mxu_gather_cuda(table, idx):
    if table.device.type != "cuda":
        raise ValueError(f"mxu_gather: unsupported device {table.device}")
    B, S, H, D = table.shape
    _check_idx("mxu_gather", idx, B, H, table.device)
    if table.dtype not in _DTYPE_TAG:
        raise TypeError(f"mxu_gather: unsupported dtype {table.dtype}")
    if table.stride(3) != 1:
        raise ValueError("mxu_gather: table rows must be contiguous")
    Q, P = idx.shape[1], idx.shape[3]
    idx = idx.contiguous()
    out = torch.empty((B, Q, H, P, D), dtype=table.dtype, device=table.device)
    lib = _build.load("mxu_gather", MXU_GATHER_SIGNATURES)
    fn = getattr(lib, f"mxu_gather_{_DTYPE_TAG[table.dtype]}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    _build.check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, Q, H,
                    P, S, D, table.stride(0), table.stride(1),
                    table.stride(2), stream), "mxu_gather")
    mxu_gather.launches += 1
    return out


def mxu_gather_bwd(idx: torch.Tensor, g: torch.Tensor,
                   table_rows: int) -> torch.Tensor:
    """``dtable`` (B, S, H, D) of ``mxu_gather`` for the cotangent ``g``
    (B, Q, H, P, D), in ``g``'s type. Launches ``csrc/mxu_gather.cu`` on
    CUDA tensors and runs ``mxu_gather_bwd_plain`` on CPU tensors."""
    if g.device.type == "cpu":
        return mxu_gather_bwd_plain(idx, g, table_rows)
    if g.device.type != "cuda":
        raise ValueError(f"mxu_gather_bwd: unsupported device {g.device}")
    B, Q, H, P, D = g.shape
    _check_idx("mxu_gather_bwd", idx, B, H, g.device)
    if idx.shape != (B, Q, H, P):
        raise ValueError(f"mxu_gather_bwd: idx {tuple(idx.shape)}, g "
                         f"{tuple(g.shape)}")
    if g.dtype not in _DTYPE_TAG:
        raise TypeError(f"mxu_gather_bwd: unsupported dtype {g.dtype}")
    idx, g = idx.contiguous(), g.contiguous()
    dtable = torch.zeros((B, table_rows, H, D), dtype=torch.float32,
                         device=g.device)
    lib = _build.load("mxu_gather", MXU_GATHER_SIGNATURES)
    fn = getattr(lib, f"mxu_gather_bwd_{_DTYPE_TAG[g.dtype]}")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(fn(idx.data_ptr(), g.data_ptr(), dtable.data_ptr(), B, Q, H,
                    P, table_rows, D, stream), "mxu_gather_bwd")
    mxu_gather_bwd.launches += 1
    return dtable.to(g.dtype)


mxu_gather_bwd.launches = 0


class MxuGather(torch.autograd.Function):
    """``mxu_gather`` (MSDA layout) with its backward; the CUDA kernels on
    CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_rows, ctx.dtype = table.shape[1], table.dtype
        if table.device.type == "cpu":
            return mxu_gather_plain(table, idx)
        return _mxu_gather_cuda(table, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return mxu_gather_bwd(idx, g.to(ctx.dtype), ctx.table_rows), None


def mxu_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather: table (N, S, D), idx (N, M) -> (N, M, D), or in MSDA's
    layout table (B, S, H, D), idx (B, Q, H, P) -> (B, Q, H, P, D)."""
    if table.dim() == 3:                             # (N, S, D) layout
        return MxuGather.apply(table[:, :, None],
                               idx[:, :, None, None])[:, :, 0, 0]
    return MxuGather.apply(table, idx)


mxu_gather.launches = 0
