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
