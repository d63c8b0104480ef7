"""The port's kernels (dskd_tpu_torch/ops) against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch twin; these tests hold the
twins against ``pack_corners_fused`` and ``mxu_gather_weighted`` run in
Pallas interpret mode, on the same numpy inputs. The CUDA kernels are held
against the twins in test_torch_port_cuda.py and in chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops.mxu_gather import gather_weighted
from dskd_tpu_torch.ops.pack_kernel import pack_corners, pack_corners_plain

torch.set_num_threads(1)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _with_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("h,w,dtype", [(12, 16, "float32"),
                                       (15, 20, "float32"),
                                       (5, 7, "float32"),
                                       (10, 10, "bfloat16")])
def test_pack_corners_matches_pallas(monkeypatch, h, w, dtype):
    _with_interpret(monkeypatch)
    from dskd_tpu.ops.pack_kernel import pack_corners_fused

    rng = np.random.RandomState(0)
    B, H, D = 2, 8, 32
    v = rng.randn(B, h * w, H, D).astype(np.float32)
    sp = (h + 2) * (w + 2)
    want = np.asarray(pack_corners_fused(jnp.asarray(v, dtype), h, w)
                      )[:, :sp].astype(np.float32)
    got = pack_corners(torch.from_numpy(v).to(_TORCH[dtype]), h, w)
    assert got.shape == (B, sp, H, 4 * D)
    # pure data movement: exact; the Pallas tail rows past sp are garbage
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_pack_corners_reads_a_level_slice():
    """A level sliced out of the (B, S, H, D) value packs like a copy."""
    rng = np.random.RandomState(1)
    value = torch.from_numpy(rng.randn(2, 12 * 16 + 6 * 8, 8, 32)
                             .astype(np.float32))
    lvl = value[:, 12 * 16:]
    assert not lvl.is_contiguous()
    torch.testing.assert_close(pack_corners(lvl, 6, 8),
                               pack_corners_plain(lvl.contiguous(), 6, 8),
                               rtol=0, atol=0)


@pytest.mark.parametrize("S,Q,P", [(80, 40, 4), (300, 700, 4),
                                   (144, 513, 3)])
def test_gather_weighted_matches_pallas(monkeypatch, S, Q, P):
    _with_interpret(monkeypatch)
    from dskd_tpu.ops.mxu_gather import mxu_gather_weighted

    rng = np.random.RandomState(S + Q)
    N, D4 = 3, 128
    table = rng.randn(N, S, D4).astype(np.float32)
    # a few indices outside [0, S): zero rows on both sides
    idx = rng.randint(-3, S + 3, (N, Q, P)).astype(np.int32)
    w = rng.rand(N, Q, P, 4).astype(np.float32)
    want = np.asarray(mxu_gather_weighted(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), 256))
    got = gather_weighted(torch.from_numpy(table), torch.from_numpy(idx),
                          torch.from_numpy(w))
    assert got.shape == (N, Q, D4) and got.dtype == torch.float32
    # f32 sums in another order; atol covers sums that cancel to ~0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_gather_weighted_head_layout_matches_per_head():
    """The (B, S, H, 4D) layout gathers each head from its own column."""
    rng = np.random.RandomState(2)
    B, S, H, D4, Q, P = 2, 50, 3, 16, 7, 4
    table = torch.from_numpy(rng.randn(B, S, H, D4).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-2, S + 2, (B, Q, H, P))
                           .astype(np.int32))
    w = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32))
    got = gather_weighted(table, idx, w)
    for hd in range(H):
        want = gather_weighted(table[:, :, hd].contiguous(), idx[:, :, hd],
                               w[:, :, hd])
        torch.testing.assert_close(got[:, :, hd], want, rtol=0, atol=0)


def test_wrappers_raise_off_cpu_and_count_only_launches():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device with no kernel raises instead of falling back to the twin, and
    CPU calls launch nothing."""
    before = (pack_corners.launches, gather_weighted.launches)
    pack_corners(torch.zeros(1, 4, 1, 4), 2, 2)
    gather_weighted(torch.zeros(1, 5, 1, 16), torch.zeros(1, 2, 1, 1,
                                                           dtype=torch.int32),
                    torch.zeros(1, 2, 1, 1, 4))
    assert (pack_corners.launches, gather_weighted.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        pack_corners(torch.zeros(1, 4, 1, 4, device="meta"), 2, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        gather_weighted(torch.zeros(1, 5, 1, 16, device="meta"),
                        torch.zeros(1, 2, 1, 1, dtype=torch.int32,
                                    device="meta"),
                        torch.zeros(1, 2, 1, 1, 4, device="meta"))
