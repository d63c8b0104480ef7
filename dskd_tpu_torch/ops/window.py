"""What the windowed MSDA sampling family shares (port of
dskd_tpu/ops/window_gather.py ``SUBLANE_ALIGN`` and ``tile_window_starts``,
and of dskd_tpu/ops/fused_window.py ``segment_window_starts``).

The encoder's queries are the flattened tokens of its levels in raster order,
and each samples near its own pixel. So the samples of a tile of ``tile_q``
consecutive queries land in a narrow band of image rows of the level they
sample, and the JAX package gives each tile a static window of ``window``
packed-table rows, ``[starts[t], starts[t] + window)``. The helpers below
compute those starts exactly as the JAX package does: the windows, and so
which segment takes a window kernel, are the same in both packages.

On the TPU a window was what made a one-hot matmul affordable, and a sample
outside its tile's window (an "escape") made the caller fall back to the
plain path for the whole segment. On the GPU the kernels read and add an
escaped row in the table in device memory directly, so a windowed function
equals its plain gather for every input; each kernel counts its escapes in a
device int32 (``escape_counter``) that a caller may read after a
synchronize.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

# the two entry points of csrc/window_sample.cu, in f32 and bf16: pointers
# (with the escape counter), then int64 shapes and strides, then the stream
# (the windowed weighted forward and backward are gather_weighted's, bound in
# ops/mxu_gather.py)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int64
SIGNATURES = {f"{name}_{tag}": (_PTR,) * n_ptr + (_INT,) * n_int + (_PTR,)
              for name, n_ptr, n_int in (("window_gather", 5, 11),
                                         ("window_gather_bwd", 5, 8))
              for tag in ("f32", "bf16")}
DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}

# Mosaic's sublane alignment of a window start on the TPU; the starts keep
# it so that they equal the JAX package's
SUBLANE_ALIGN = 16

_STARTS: Dict[Tuple[Tuple[int, ...], str], torch.Tensor] = {}


def tile_window_starts(n_queries: int, tile_q: int, w: int, w_pad: int,
                       s_pad: int, window: int) -> Tuple[int, ...]:
    """Window start row per tile of ``tile_q`` raster level-0 queries of an
    (h, w) map whose packed table has ``w_pad`` columns and ``s_pad`` rows:
    centred on the tile's middle image row, aligned down to SUBLANE_ALIGN."""
    starts = []
    for t in range(n_queries // tile_q):
        mid_q = t * tile_q + tile_q // 2
        row = mid_q // w + 1                       # +1: padded-grid offset
        center = row * w_pad + w_pad // 2
        ws = min(max(center - window // 2, 0), max(s_pad - window, 0))
        starts.append(ws - ws % SUBLANE_ALIGN)
    return tuple(starts)


def segment_window_starts(n_tokens: int, tile_q: int, src_hw, lvl0_hw,
                          s_pad: int, window: int) -> Tuple[int, ...]:
    """Window start per tile of ``tile_q`` consecutive raster tokens of a
    source level of size ``src_hw`` sampling the packed table of a level of
    size ``lvl0_hw`` (``s_pad`` rows): centred on the tile's middle image
    row scaled into the sampled level, aligned down to SUBLANE_ALIGN. The
    last tile may be partial."""
    hs, ws = src_hw
    h0, w0 = lvl0_hw
    w0p = w0 + 2
    starts = []
    for t in range(-(-n_tokens // tile_q)):
        j0 = t * tile_q
        j1 = min((t + 1) * tile_q, n_tokens) - 1
        y_mid = ((j0 // ws) + (j1 // ws)) / 2.0
        row0 = (y_mid + 0.5) / hs * h0 + 1.0
        center = int(row0 * w0p + w0p // 2)
        st = min(max(center - window // 2, 0), max(s_pad - window, 0))
        starts.append(st - st % SUBLANE_ALIGN)
    return tuple(starts)


def pallas_pack_rows(h: int, w: int) -> int:
    """Rows of the JAX package's ``pack_corners_fused`` table of an (h, w)
    level, ``ceil((h+2)/8)*8*(w+2)`` (whole tiles of 8 lines): the ``spk``
    its DSKD_WINBWD branch sizes its windows by. The port's ``pack_corners``
    writes exactly (h+2)*(w+2) rows; a window may reach past them, and the
    kernels never touch a row past the table."""
    return -(-(h + 2) // 8) * 8 * (w + 2)


def check_window(name: str, starts: Sequence[int], queries: int,
                 tile_q: int, window: int) -> Tuple[int, ...]:
    """The starts as a tuple of ints, one per tile of ``tile_q`` queries."""
    starts = tuple(int(s) for s in starts)
    if tile_q <= 0 or window <= 0:
        raise ValueError(f"{name}: tile_q {tile_q} and window {window} must "
                         "be positive")
    if len(starts) != -(-queries // tile_q):
        raise ValueError(f"{name}: {len(starts)} window starts for {queries} "
                         f"queries in tiles of {tile_q}")
    return starts


def starts_tensor(starts: Tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    """The starts as an int32 tensor on ``device``, made once per device:
    a host-to-device copy on every call would wait for the stream."""
    key = (starts, str(device))
    t = _STARTS.get(key)
    if t is None:
        t = torch.tensor(starts, dtype=torch.int32, device=device)
        _STARTS[key] = t
    return t


def window_escapes(idx: torch.Tensor, starts: Sequence[int], tile_q: int,
                   window: int) -> torch.Tensor:
    """The number of samples of ``idx`` (B, Q, H, P) outside their tile's
    window, as a 0-d tensor on ``idx``'s device: what a kernel's escape
    counter must read after its launch."""
    q = torch.arange(idx.shape[1], device=idx.device) // tile_q
    start = torch.tensor(tuple(starts), device=idx.device)[q]
    local = idx.long() - start[None, :, None, None]
    return ((local < 0) | (local >= window)).sum()


def escape_counter(fn, device: torch.device) -> torch.Tensor:
    """``fn.escapes``, the device int32 a windowed kernel adds its escapes
    to, made zero on ``device`` at its first use there. A caller resets it
    by setting ``fn.escapes = None``."""
    if fn.escapes is None or fn.escapes.device != device:
        fn.escapes = torch.zeros((), dtype=torch.int32, device=device)
    return fn.escapes

