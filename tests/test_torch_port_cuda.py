"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports no JAX, so on a machine without JAX it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``.
"""
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops.msda import ms_deform_attn_core
from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
    gather_weighted_plain
from dskd_tpu_torch.ops.pack_kernel import pack_corners, pack_corners_plain

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_twins(cuda_device, dtype):
    rng = np.random.RandomState(3)
    B, H, D, (h, w), Q, P = 2, 8, 32, (20, 24), 300, 4
    value = torch.from_numpy(rng.randn(B, 50 + h * w, H, D)
                             .astype(np.float32)).to(cuda_device)
    v = value.to(_TORCH[dtype])[:, 50:]            # a level slice, in place
    table = pack_corners(v, h, w)
    assert torch.equal(table, pack_corners_plain(v, h, w))
    S = table.shape[1]
    # indices outside [0, S) must contribute zero and never be read
    idx = torch.from_numpy(rng.randint(-2, S + 2, (B, Q, H, P))
                           .astype(np.int32)).to(cuda_device)
    cw = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32)
                          ).to(cuda_device)
    got = gather_weighted(table, idx, cw)
    want = gather_weighted_plain(table.float(), idx, cw).to(got.dtype)
    torch.cuda.synchronize()
    # f32: summation order only; bf16: one rounding of the f32 sum
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=1e-5)


@pytest.mark.cuda
def test_msda_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(4)
    shapes = [(20, 24), (10, 12), (5, 6)]
    B, H, D, Q, P = 2, 8, 32, 120, 4
    S = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
    locs = torch.from_numpy((rng.rand(B, Q, H, len(shapes), P, 2) * 1.3
                             - 0.15).astype(np.float32))
    weights = torch.from_numpy(rng.rand(B, Q, H, len(shapes), P)
                               .astype(np.float32))
    want = ms_deform_attn_core(value, shapes, locs, weights)
    got = ms_deform_attn_core(value.to(cuda_device), shapes,
                              locs.to(cuda_device), weights.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_twin(cuda_device, dtype):
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted_bwd, \
        gather_weighted_bwd_plain

    rng = np.random.RandomState(5)
    B, H, D, (h, w), Q, P = 2, 8, 32, (10, 8), 700, 4
    v = torch.from_numpy(rng.randn(B, h * w, H, D).astype(np.float32)).to(
        cuda_device, _TORCH[dtype])
    table = pack_corners(v, h, w)
    S = table.shape[1]
    # indices outside [0, S): no dtable contribution, dw = 0, never read
    idx = torch.from_numpy(rng.randint(-2, S + 2, (B, Q, H, P))
                           .astype(np.int32)).to(cuda_device)
    cw = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32)).to(
        cuda_device)
    dout = torch.from_numpy(rng.randn(B, Q, H, 4 * D).astype(np.float32)
                            ).to(cuda_device, _TORCH[dtype])
    before = gather_weighted_bwd.launches
    dt, dw = gather_weighted_bwd(table, idx, cw, dout)
    assert gather_weighted_bwd.launches == before + 1
    want_dt, want_dw = gather_weighted_bwd_plain(table.float(), idx, cw,
                                                 dout.float())
    torch.cuda.synchronize()
    assert dt.dtype == table.dtype and dw.dtype == torch.float32
    # f32 atomics in run-to-run order over up to ~700 adds per element;
    # bf16: one rounding of the f32 sum
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(dt.float(), want_dt, **tol)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-5)
    assert (dw[(idx < 0) | (idx >= S)] == 0).all()


@pytest.mark.cuda
def test_msda_grads_on_card_match_cpu(cuda_device):
    """Autograd reaches value, locations and attention through both
    kernels on the card, and agrees with the plain twins on the CPU."""
    rng = np.random.RandomState(6)
    shapes = [(20, 24), (10, 12), (5, 6)]
    B, H, D, Q, P = 2, 8, 32, 120, 4
    S = sum(h * w for h, w in shapes)
    host = [torch.from_numpy(a) for a in (
        rng.randn(B, S, H, D).astype(np.float32),
        (rng.rand(B, Q, H, len(shapes), P, 2) * 1.3 - 0.15).astype(
            np.float32),
        rng.rand(B, Q, H, len(shapes), P).astype(np.float32))]
    cot = torch.from_numpy(rng.randn(B, Q, H * D).astype(np.float32))

    def grads(dev):
        args = [t.to(dev).requires_grad_(True) for t in host]
        out = ms_deform_attn_core(args[0], shapes, args[1], args[2])
        return [g.cpu() for g in torch.autograd.grad(out, args, cot.to(dev))]

    for name, got, want in zip(("value", "locations", "attention"),
                               grads(cuda_device), grads("cpu")):
        assert got.abs().max() > 0, name
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mxu_gather_kernels_match_twins(cuda_device, dtype):
    from dskd_tpu_torch.ops.mxu_gather import mxu_gather, mxu_gather_bwd, \
        mxu_gather_bwd_plain, mxu_gather_plain

    rng = np.random.RandomState(7)
    B, H, D, (h, w), Q, P = 2, 8, 32, (10, 8), 700, 4
    v = torch.from_numpy(rng.randn(B, h * w, H, D).astype(np.float32)).to(
        cuda_device, _TORCH[dtype])
    table = pack_corners(v, h, w)                  # read in place, strided
    S = table.shape[1]
    # indices outside [0, S): a zero row, no dtable contribution, never read
    idx = torch.from_numpy(rng.randint(-2, S + 2, (B, Q, H, P))
                           .astype(np.int32)).to(cuda_device)
    g = torch.from_numpy(rng.randn(B, Q, H, P, 4 * D).astype(np.float32)
                         ).to(cuda_device, _TORCH[dtype])
    before = (mxu_gather.launches, mxu_gather_bwd.launches)
    got = mxu_gather(table, idx)
    dt = mxu_gather_bwd(idx, g, S)
    assert (mxu_gather.launches, mxu_gather_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = mxu_gather_plain(table, idx)
    want_dt = mxu_gather_bwd_plain(idx, g.float(), S)
    torch.cuda.synchronize()
    assert torch.equal(got, want)                  # a row copy: bit for bit
    # f32 atomics in run-to-run order; bf16: one rounding of the f32 sum
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(dt.float(), want_dt, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sample_kernels_match_twins(cuda_device, dtype):
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample, \
        fused_msda_sample_bwd, fused_msda_sample_bwd_plain, \
        fused_msda_sample_plain
    from dskd_tpu_torch.ops.msda import fused_index_and_weights

    rng = np.random.RandomState(8)
    B, H, D, (h, w), Q, P = 2, 8, 32, (10, 8), 700, 4
    value = torch.from_numpy(rng.randn(B, 30 + h * w, H, D)
                             .astype(np.float32)).to(cuda_device)
    v = value.to(_TORCH[dtype])[:, 30:]            # a level slice, in place
    loc = torch.from_numpy((rng.rand(B, Q, H, P, 2) * 1.3 - 0.15)
                           .astype(np.float32)).to(cuda_device)
    attn = torch.from_numpy(rng.rand(B, Q, H, P).astype(np.float32)).to(
        cuda_device)
    # unclipped corners: negative, past the table and wrapped taps
    idx, wts = fused_index_and_weights(loc, attn, h, w, _TORCH[dtype])
    assert (idx < 0).any() and (idx + w + 1 >= h * w).any()
    g = torch.from_numpy(rng.randn(B, Q, H, D).astype(np.float32)).to(
        cuda_device, _TORCH[dtype])
    got = fused_msda_sample(v, idx, wts, w)
    dt, dw = fused_msda_sample_bwd(v, idx, wts, g, w)
    want = fused_msda_sample_plain(v.float(), idx, wts, w)
    want_dt, want_dw = fused_msda_sample_bwd_plain(v.float(), idx, wts,
                                                   g.float(), w)
    torch.cuda.synchronize()
    assert dt.dtype == v.dtype and dw.dtype == torch.float32
    # f32: summation order and atomics; bf16: one rounding of the f32 sum
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(got.float(), want, **tol)
    torch.testing.assert_close(dt.float(), want_dt, **tol)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-5)
    rows = idx[..., None].long() + torch.tensor([0, 1, w, w + 1],
                                                device=cuda_device)
    assert (dw[(rows < 0) | (rows >= h * w)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("env", [{"DSKD_WGATHER": "0"},
                                 {"DSKD_FUSED_ROWS": "200"}])
def test_msda_switch_grads_on_card_match_cpu(cuda_device, monkeypatch, env):
    """Each sampling switch on the card against the plain versions on the
    CPU, forward and gradients."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(9)
    shapes = [(20, 24), (10, 12), (5, 6)]
    B, H, D, Q, P = 2, 8, 32, 120, 4
    S = sum(h * w for h, w in shapes)
    host = [torch.from_numpy(a) for a in (
        rng.randn(B, S, H, D).astype(np.float32),
        (rng.rand(B, Q, H, len(shapes), P, 2) * 1.3 - 0.15).astype(
            np.float32),
        rng.rand(B, Q, H, len(shapes), P).astype(np.float32))]
    cot = torch.from_numpy(rng.randn(B, Q, H * D).astype(np.float32))

    def run(dev):
        args = [t.to(dev).requires_grad_(True) for t in host]
        out = ms_deform_attn_core(args[0], shapes, args[1], args[2])
        return [out.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(
            out, args, cot.to(dev))]

    for name, got, want in zip(("out", "value", "locations", "attention"),
                               run(cuda_device), run("cpu")):
        assert got.abs().max() > 0, name
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                                   msg=name)


def _window_case(rng, dev, dtype, B, H, D4, S, Q, P, tile_q, window,
                 escape):
    """A table of S rows, tiles of tile_q queries with windows spread over
    it, indices inside each tile's window, or a share of them escaped."""
    table = torch.from_numpy(rng.randn(B, S + 3, H, D4).astype(np.float32)
                             ).to(dev, _TORCH[dtype])[:, 3:]   # strided
    n_tiles = -(-Q // tile_q)
    starts = tuple(int(s) for s in np.linspace(0, S - window, n_tiles))
    lo = np.repeat(np.asarray(starts), tile_q)[:Q][None, :, None, None]
    idx = lo + rng.randint(0, window, (B, Q, H, P))
    if escape:
        far = rng.rand(B, Q, H, P) < 0.05
        idx = np.where(far, rng.randint(0, S, idx.shape), idx)
    return (table, torch.from_numpy(idx.astype(np.int32)).to(dev), starts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [64, 1000])
@pytest.mark.parametrize("escape", [False, True])
def test_window_kernels_match_twins(cuda_device, dtype, window, escape):
    from dskd_tpu_torch.ops.fused_window import fused_window_sample, \
        fused_window_sample_plain, windowed_weighted_bwd, \
        windowed_weighted_bwd_plain
    from dskd_tpu_torch.ops.window import window_escapes
    from dskd_tpu_torch.ops.window_gather import window_gather, \
        window_gather_bwd, window_gather_bwd_plain, window_gather_plain

    rng = np.random.RandomState(10)
    B, H, D4, S, Q, P, tile_q = 2, 8, 128, 3000, 700, 4, 128
    table, idx, starts = _window_case(rng, cuda_device, dtype, B, H, D4, S,
                                      Q, P, tile_q, window, escape)
    want_esc = int(window_escapes(idx, starts, tile_q, window))
    assert (want_esc > 0) == escape
    cw = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32)).to(
        cuda_device)
    g_rows = torch.from_numpy(rng.randn(B, Q, H, P, D4).astype(np.float32)
                              ).to(cuda_device, _TORCH[dtype])
    g = torch.from_numpy(rng.randn(B, Q, H, D4).astype(np.float32)).to(
        cuda_device, _TORCH[dtype])
    fns = (window_gather, window_gather_bwd, fused_window_sample,
           windowed_weighted_bwd)
    for fn in fns:
        fn.escapes = None
    rows = window_gather(table, idx, starts, tile_q * P, window)
    dt_rows = window_gather_bwd(idx, g_rows, starts, tile_q, window, S)
    out = fused_window_sample(table, idx, cw, starts, window, tile_q)
    dt, dw = windowed_weighted_bwd(table, idx, cw, g, starts, window, tile_q)
    torch.cuda.synchronize()
    assert [int(fn.escapes) for fn in fns] == [want_esc] * 4
    # a row copy: bit for bit
    assert torch.equal(rows, window_gather_plain(table, idx, starts, tile_q,
                                                 window))
    want_rows = window_gather_bwd_plain(idx, g_rows.float(), starts, tile_q,
                                        window, S)
    want = fused_window_sample_plain(table.float(), idx, cw, starts, window,
                                     tile_q)
    want_dt, want_dw = windowed_weighted_bwd_plain(
        table.float(), idx, cw, g.float(), starts, window, tile_q)
    # f32: summation order and atomics; bf16: one rounding of the f32 sum
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-4)
    torch.testing.assert_close(dt_rows.float(), want_rows, **tol)
    torch.testing.assert_close(out.float(), want, **tol)
    torch.testing.assert_close(dt.float(), want_dt, **tol)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-4)


_WINDOW_SWITCHES = {
    "window_rows": {"DSKD_WINDOW_ROWS": "1024"},
    "fwin": {"DSKD_FWIN": "1"},
    "winbwd": {"DSKD_WINBWD": "1"},
}


@pytest.mark.cuda
@pytest.mark.parametrize("switch", sorted(_WINDOW_SWITCHES))
def test_msda_window_switch_grads_on_card_match_cpu(cuda_device, monkeypatch,
                                                    switch):
    """Each windowed switch on the card against the plain versions on the
    CPU, forward and gradients, for raster queries of a 512x512 canvas's
    levels (level 0 64x64: every windowed branch is taken)."""
    for k, v in _WINDOW_SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(11)
    shapes = [(64, 64), (32, 32), (16, 16), (8, 8)]
    B, H, D, P = 2, 8, 32, 4
    S = sum(h * w for h, w in shapes)
    own = np.concatenate([np.stack(np.meshgrid(
        (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1).reshape(
            -1, 2) for h, w in shapes], 0)
    locs = own[None, :, None, None, None] + rng.randn(
        B, S, H, len(shapes), P, 2) * 0.01
    host = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(B, S, H, D), locs, rng.rand(B, S, H, len(shapes), P))]
    cot = torch.from_numpy(rng.randn(B, S, H * D).astype(np.float32))

    def run(dev):
        args = [t.to(dev).requires_grad_(True) for t in host]
        out = ms_deform_attn_core(args[0], shapes, args[1], args[2],
                                  raster_queries=True)
        return [out.detach().cpu()] + [g.cpu() for g in torch.autograd.grad(
            out, args, cot.to(dev))]

    for name, got, want in zip(("out", "value", "locations", "attention"),
                               run(cuda_device), run("cpu")):
        assert got.abs().max() > 0, name
        # f32 summation order, relative to the tensor's scale: the location
        # gradients of 64-pixel maps reach 2e3 (the default branch differs
        # card vs CPU by 3.7e-4 there, on an H100)
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=2e-6 * float(want.abs().max()),
                                   msg=name)


# The scatter backwards under adversarial indices: every sample on one row
# of each (b, head) (the most atomics on one address), samples on the
# table's first and last rows, indices outside [0, S), and for the windowed
# ones every sample in its tile's window or every sample escaped. The fused
# backward's taps: corners below 0 and past S, c00 + 1 wrapping into the
# next image row, a batch-strided level slice, and P and D other than the
# flagship's 4 and 32 (D = 6 takes the generic kernel).
_SCATTER_CASES = [("gather_weighted_bwd", case) for case in
                  ("one_row", "ends", "outside")] + \
                 [("window_gather_bwd", case) for case in
                  ("one_row", "ends", "outside", "in_window", "escaped")] + \
                 [("window_weighted_bwd", case) for case in
                  ("outside", "in_window", "escaped")] + \
                 [("fused_sample_bwd", case) for case in
                  ("one_row", "ends", "outside", "wrap", "strided", "P1",
                   "P3", "P8", "D16", "D24", "D64", "D6")]


def _scatter_indices(rng, case, B, Q, H, P, S, tile_q, window):
    """(idx int32 numpy, window starts) of an adversarial case."""
    shape = (B, Q, H, P)
    n_tiles = -(-Q // tile_q)
    starts = tuple(int(s) for s in np.linspace(0, S - window, n_tiles))
    if case == "one_row":
        idx = np.full(shape, S // 3)
    elif case == "ends":
        idx = np.where(rng.rand(*shape) < 0.5, 0, S - 1)
    elif case == "outside":
        wild = np.array([-10 ** 6, -1, S, S + 10 ** 6])
        idx = np.where(rng.rand(*shape) < 0.5, rng.randint(0, S, shape),
                       wild[rng.randint(0, 4, shape)])
    elif case == "in_window":
        lo = np.repeat(np.asarray(starts), tile_q)[:Q][None, :, None, None]
        idx = lo + rng.randint(0, window, shape)
    else:                                     # escaped: below every window
        starts = (S - window,) * n_tiles
        idx = rng.randint(0, S - window, shape)
    return idx.astype(np.int32), starts


def _fused_taps(rng, case, B, Q, H, P, h, w):
    """c00 (int32 numpy) of an adversarial case of the fused backward on an
    (h, w) level: unclipped top-left corners, taps c00 + (0, 1, w, w+1)."""
    S, shape = h * w, (B, Q, H, P)
    if case == "one_row":                   # the four taps on four rows
        c00 = np.full(shape, S // 3)
    elif case == "ends":                    # taps on the first and last rows
        c00 = np.array([-(w + 1), 0, S - w - 2, S - 1])[
            rng.randint(0, 4, shape)]
    elif case == "outside":                 # corners below 0 and past S
        wild = np.array([-10 ** 6, -w - 2, -w - 1, -1, S - 1, S, 10 ** 6])
        c00 = np.where(rng.rand(*shape) < 0.5, rng.randint(0, S, shape),
                       wild[rng.randint(0, len(wild), shape)])
    elif case == "wrap":                    # x0 = w - 1: c00 + 1 wraps
        c00 = rng.randint(-1, h, shape) * w + w - 1
    else:
        c00 = rng.randint(-w - 1, S, shape)
    return c00.astype(np.int32)


def _check_fused_sample_bwd(dev, dt_type, case, tol):
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample_bwd, \
        fused_msda_sample_bwd_plain

    rng = np.random.RandomState(16)
    B, H, Q, (h, w) = 2, 8, 64, (10, 8)     # the 80 rows of 640x480's level 3
    P = int(case[1:]) if case[0] == "P" else 4
    D = int(case[1:]) if case[0] == "D" else 32
    extra = 7 if case == "strided" else 0
    value = torch.from_numpy(rng.randn(B, extra + h * w, H, D).astype(
        np.float32)).to(dev, dt_type)
    v = value[:, extra:]
    c00 = torch.from_numpy(_fused_taps(rng, case, B, Q, H, P, h, w)).to(dev)
    wts = rng.rand(B, Q, H, P, 4).astype(np.float32)
    wts[rng.rand(*wts.shape) < 0.125] = 0.0     # zero-weight taps keep dw
    wts = torch.from_numpy(wts).to(dev)
    g = torch.from_numpy(rng.randn(B, Q, H, D).astype(np.float32)).to(
        dev, dt_type)
    before = fused_msda_sample_bwd.launches
    dt, dw = fused_msda_sample_bwd(v, c00, wts, g, w)
    assert fused_msda_sample_bwd.launches == before + 1
    want_dt, want_dw = fused_msda_sample_bwd_plain(v.float(), c00, wts,
                                                   g.float(), w)
    torch.cuda.synchronize()
    assert dt.dtype == dt_type and dw.dtype == torch.float32
    torch.testing.assert_close(dt.float(), want_dt.float(), **tol)
    torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-5)
    rows = c00[..., None].long() + torch.tensor([0, 1, w, w + 1], device=dev)
    inside = (rows >= 0) & (rows < h * w)
    assert (dw[~inside] == 0).all()
    if case == "outside":
        assert (~inside).any() and inside.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,case", _SCATTER_CASES)
def test_scatter_backwards_adversarial_indices(cuda_device, dtype, kernel,
                                                case):
    from dskd_tpu_torch.ops.fused_window import windowed_weighted_bwd
    from dskd_tpu_torch.ops.mxu_gather import gather_weighted_bwd, \
        gather_weighted_bwd_plain
    from dskd_tpu_torch.ops.window import window_escapes
    from dskd_tpu_torch.ops.window_gather import window_gather_bwd, \
        window_gather_bwd_plain

    # f32: atomics in run-to-run order, up to Q * P = 512 adds per element;
    # bf16: one rounding of the f32 sum
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-4)
    if kernel == "fused_sample_bwd":
        _check_fused_sample_bwd(cuda_device, _TORCH[dtype], case, tol)
        return
    rng = np.random.RandomState(12)
    B, H, D4, S, Q, P, tile_q, window = 2, 8, 128, 3000, 128, 4, 32, 64
    idx_np, starts = _scatter_indices(rng, case, B, Q, H, P, S, tile_q,
                                      window)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    dt_type = _TORCH[dtype]
    want_esc = int(window_escapes(idx, starts, tile_q, window))
    if kernel in ("gather_weighted_bwd", "window_weighted_bwd"):
        table = torch.from_numpy(rng.randn(B, S + 3, H, D4).astype(
            np.float32)).to(cuda_device, dt_type)[:, 3:]     # strided view
        cw = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32)
                              ).to(cuda_device)
        dout = torch.from_numpy(rng.randn(B, Q, H, D4).astype(np.float32)
                                ).to(cuda_device, dt_type)
        windowed = kernel == "window_weighted_bwd"
        fn = windowed_weighted_bwd if windowed else gather_weighted_bwd
        if windowed:
            fn.escapes = None
        before = fn.launches
        dt, dw = fn(table, idx, cw, dout,
                    *((starts, window, tile_q) if windowed else ()))
        assert fn.launches == before + 1
        want_dt, want_dw = gather_weighted_bwd_plain(table.float(), idx, cw,
                                                     dout.float())
        torch.cuda.synchronize()
        torch.testing.assert_close(dt.float(), want_dt, **tol)
        torch.testing.assert_close(dw, want_dw, rtol=1e-5, atol=1e-5)
        assert (dw[(idx < 0) | (idx >= S)] == 0).all()
        if windowed:
            assert int(fn.escapes) == want_esc
    else:
        g = torch.from_numpy(rng.randn(B, Q, H, P, D4).astype(np.float32)
                             ).to(cuda_device, dt_type)
        window_gather_bwd.escapes = None
        before = window_gather_bwd.launches
        dt = window_gather_bwd(idx, g, starts, tile_q, window, S)
        assert window_gather_bwd.launches == before + 1
        want = window_gather_bwd_plain(idx, g.float(), starts, tile_q,
                                       window, S)
        torch.cuda.synchronize()
        assert dt.dtype == dt_type
        torch.testing.assert_close(dt.float(), want, **tol)
        assert int(window_gather_bwd.escapes) == want_esc
    if case == "in_window":
        assert want_esc == 0
    if case == "escaped":
        assert want_esc == idx.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what", ["table", "dout", "g", "dtable",
                                  "window_table", "window_dout",
                                  "fused_table", "fused_g", "fused_strides"])
def test_scatter_backwards_refuse_misaligned(cuda_device, dtype, what):
    """The vector loads and atomics need 16-byte aligned rows: a view one
    element off, or a fused table whose head stride is not a whole vector,
    raises, and launches nothing."""
    from dskd_tpu_torch.ops.fused_sample import fused_msda_sample_bwd
    from dskd_tpu_torch.ops.fused_window import windowed_weighted_bwd
    from dskd_tpu_torch.ops.mxu_gather import check_aligned, \
        gather_weighted_bwd
    from dskd_tpu_torch.ops.window_gather import window_gather_bwd

    B, H, D4, S, Q, P = 2, 8, 128, 40, 16, 4
    dt_type = _TORCH[dtype]

    def off_by_one(*shape, dtype=dt_type):
        n = int(np.prod(shape))
        return torch.zeros(n + 8, dtype=dtype, device=cuda_device)[
            1:1 + n].view(shape)

    def aligned(*shape):
        return torch.zeros(shape, dtype=dt_type, device=cuda_device)

    idx = torch.zeros((B, Q, H, P), dtype=torch.int32, device=cuda_device)
    cw = torch.zeros((B, Q, H, P, 4), device=cuda_device)
    D, w = D4 // 4, 8                       # the fused backward's level
    fns = (gather_weighted_bwd, window_gather_bwd, windowed_weighted_bwd,
           fused_msda_sample_bwd)
    launches = [fn.launches for fn in fns]
    with pytest.raises(ValueError, match="16-byte aligned|multiples of 4"):
        if what == "table":
            gather_weighted_bwd(off_by_one(B, S, H, D4), idx, cw,
                                aligned(B, Q, H, D4))
        elif what == "dout":
            gather_weighted_bwd(aligned(B, S, H, D4), idx, cw,
                                off_by_one(B, Q, H, D4))
        elif what == "g":
            window_gather_bwd(idx, off_by_one(B, Q, H, P, D4), (0,), Q, 8, S)
        elif what == "window_table":
            windowed_weighted_bwd(off_by_one(B, S, H, D4), idx, cw,
                                  aligned(B, Q, H, D4), (0,), 8, Q)
        elif what == "window_dout":
            windowed_weighted_bwd(aligned(B, S, H, D4), idx, cw,
                                  off_by_one(B, Q, H, D4), (0,), 8, Q)
        elif what == "fused_table":
            fused_msda_sample_bwd(off_by_one(B, S, H, D), idx, cw,
                                  aligned(B, Q, H, D), w)
        elif what == "fused_g":
            fused_msda_sample_bwd(aligned(B, S, H, D), idx, cw,
                                  off_by_one(B, Q, H, D), w)
        elif what == "fused_strides":       # head stride D + 2
            fused_msda_sample_bwd(aligned(B, S, H, D + 2)[..., :D], idx, cw,
                                  aligned(B, Q, H, D), w)
        else:                # the f32 buffer the wrappers allocate
            check_aligned("gather_weighted_bwd",
                          dtable=off_by_one(B, S, H, D4, dtype=torch.float32))
    assert [fn.launches for fn in fns] == launches


# gather_weighted (B1) beyond the flagship's shapes: P other than 4 and row
# widths other than 32, 64, 128 and 256 elements take the generic kernel;
# indices outside [0, S), all points on one row, the table's first and last
# rows, and a table read in place through a strided view.
_GATHER_CASES = {
    "outside": dict(idx="outside"), "one_row": dict(idx="one_row"),
    "ends": dict(idx="ends"), "strided": dict(strided=True),
    "P1": dict(P=1), "P3": dict(P=3), "P8": dict(P=8),
    "D16": dict(D=16), "D24": dict(D=24), "D64": dict(D=64)}


def _gather_case(rng, dev, dtype, P=4, D=32, idx="random", strided=False):
    B, H, S, Q = 2, 8, 300, 257
    table = torch.from_numpy(rng.randn(B, S + 5, H, 4 * D).astype(np.float32)
                             ).to(dev, _TORCH[dtype])
    table = table[:, 5:] if strided else table[:, :S]   # batch-strided
    shape = (B, Q, H, P)
    if idx == "outside":
        wild = np.array([-10 ** 6, -1, S, S + 10 ** 6])
        rows = np.where(rng.rand(*shape) < 0.5, rng.randint(0, S, shape),
                        wild[rng.randint(0, 4, shape)])
    elif idx == "one_row":
        rows = np.full(shape, S // 3)
    elif idx == "ends":
        rows = np.where(rng.rand(*shape) < 0.5, 0, S - 1)
    else:
        rows = rng.randint(0, S, shape)
    cw = rng.rand(B, Q, H, P, 4).astype(np.float32)
    return (table, torch.from_numpy(rows.astype(np.int32)).to(dev),
            torch.from_numpy(cw).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_GATHER_CASES))
def test_gather_weighted_cases(cuda_device, dtype, case):
    rng = np.random.RandomState(13)
    table, idx, cw = _gather_case(rng, cuda_device, dtype,
                                  **_GATHER_CASES[case])
    before = gather_weighted.launches
    got = gather_weighted(table, idx, cw)
    assert gather_weighted.launches == before + 1
    want = gather_weighted_plain(table.float(), idx, cw).to(got.dtype)
    torch.cuda.synchronize()
    # f32: summation order only; bf16: one rounding of the f32 sum
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=1e-5)
    if case == "outside":          # nothing read: exactly the valid points
        keep = (idx >= 0) & (idx < table.shape[1])
        torch.testing.assert_close(
            got, gather_weighted(table, idx.clamp(0, table.shape[1] - 1),
                                 cw * keep[..., None]), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [4, 3])
def test_gather_weighted_reads_bf16_weights(cuda_device, dtype, P):
    """bf16 weights are read as they are, with no cast: bf16 to f32 is
    exact, so the output is that of the same weights in f32, bit for
    bit."""
    rng = np.random.RandomState(14)
    table, idx, cw = _gather_case(rng, cuda_device, dtype, P=P)
    w16 = cw.to(torch.bfloat16)
    assert torch.equal(gather_weighted(table, idx, w16),
                       gather_weighted(table, idx, w16.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_weighted_refuses_misaligned(cuda_device, dtype):
    B, S, H, D4, Q, P = 2, 40, 8, 128, 16, 4
    n = B * S * H * D4
    table = torch.zeros(n + 8, dtype=_TORCH[dtype], device=cuda_device)[
        1:1 + n].view(B, S, H, D4)
    idx = torch.zeros((B, Q, H, P), dtype=torch.int32, device=cuda_device)
    cw = torch.zeros((B, Q, H, P, 4), device=cuda_device)
    before = gather_weighted.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather_weighted(table, idx, cw)
    assert gather_weighted.launches == before


# pack_corners (B2), bit for bit: maps one pixel high or wide, odd widths, a
# level sliced out of a (B, S, H, D) value tensor, one and three images, and
# D-chunks of 12 and 6 vectors (the runtime-width kernel).
_PACK_CASES = {"h1": (2, 1, 7, 8, 32, False), "w1": (2, 5, 1, 8, 32, False),
               "odd": (2, 7, 9, 8, 32, False),
               "sliced": (2, 10, 12, 8, 32, True),
               "B1": (1, 6, 5, 8, 32, True), "B3": (3, 4, 6, 8, 32, False),
               "D48": (2, 5, 6, 3, 48, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_PACK_CASES))
def test_pack_corners_cases(cuda_device, dtype, case):
    B, h, w, H, D, sliced = _PACK_CASES[case]
    rng = np.random.RandomState(15)
    extra = 11 if sliced else 0
    value = torch.from_numpy(rng.randn(B, extra + h * w, H, D).astype(
        np.float32)).to(cuda_device, _TORCH[dtype])
    v = value[:, extra:]
    before = pack_corners.launches
    got = pack_corners(v, h, w)
    assert pack_corners.launches == before + 1
    assert torch.equal(got, pack_corners_plain(v, h, w))
