"""Gradients of the port's MSDA kernels against the JAX package's.

``GatherWeighted`` and ``PackCorners`` (on the CPU their backwards run the
plain versions the CUDA backward is held against on the card) against
``jax.vjp`` of ``mxu_gather_weighted`` and ``pack_corners_fused`` run in
Pallas interpret mode, and ``ms_deform_attn_core``'s gradients in value,
locations and attention against ``jax.grad`` of both JAX branches: XLA, and
Pallas with ``DSKD_FORCE_MXU=1``. Inputs are numpy arrays from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dskd_tpu_torch.ops.msda import ms_deform_attn_core
from dskd_tpu_torch.ops.mxu_gather import gather_weighted, \
    gather_weighted_bwd, gather_weighted_bwd_plain
from dskd_tpu_torch.ops.pack_kernel import pack_corners

torch.set_num_threads(1)

SHAPES = [(12, 16), (6, 8)]        # packed tables of 252 and 80 rows
# f32 sums in another order than XLA / the interpreter; atol covers sums
# that cancel to ~0
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("S,Q,P", [(80, 40, 4), (300, 130, 4),
                                   (144, 70, 3)])
def test_gather_weighted_bwd_matches_pallas_vjp(S, Q, P):
    from dskd_tpu.ops.mxu_gather import mxu_gather_weighted

    rng = np.random.RandomState(S + Q)
    N, D4 = 3, 128
    table = rng.randn(N, S, D4).astype(np.float32)
    # indices outside [0, S): no dtable contribution and dw = 0 on both
    # sides (the TPU one-hot row matches no table row)
    idx = rng.randint(-3, S + 3, (N, Q, P)).astype(np.int32)
    w = rng.rand(N, Q, P, 4).astype(np.float32)
    cot = rng.randn(N, Q, D4).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda t, ww: mxu_gather_weighted(
            t, jnp.asarray(idx), ww, 128), jnp.asarray(table),
            jnp.asarray(w))
        want_dt, want_dw = vjp(jnp.asarray(cot))
    t_table, t_w = _t(table, True), _t(w, True)
    out = gather_weighted(t_table, _t(idx), t_w)
    got_dt, got_dw = torch.autograd.grad(out, [t_table, t_w], _t(cot))
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(want_dt), **TOL)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **TOL)
    bad = (idx < 0) | (idx >= S)
    assert bad.any() and (got_dw.numpy()[bad] == 0).all()


def test_gather_weighted_bwd_dtypes_and_no_launch_on_cpu():
    """dtable comes back in the table's type, dw in w's; the CPU wrapper
    runs the plain version and launches nothing."""
    rng = np.random.RandomState(5)
    B, S, H, D4, Q, P = 2, 30, 2, 16, 9, 4
    table = torch.from_numpy(rng.randn(B, S, H, D4).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-2, S + 2, (B, Q, H, P))
                           .astype(np.int32))
    w = torch.from_numpy(rng.rand(B, Q, H, P, 4).astype(np.float32))
    dout = torch.from_numpy(rng.randn(B, Q, H, D4).astype(np.float32))
    before = gather_weighted_bwd.launches
    dt, dw = gather_weighted_bwd(table.bfloat16(), idx, w.bfloat16(),
                                 dout.bfloat16())
    assert gather_weighted_bwd.launches == before
    assert dt.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    want_dt, want_dw = gather_weighted_bwd_plain(
        table.bfloat16().float(), idx, w.bfloat16().float(),
        dout.bfloat16().float())
    # one bf16 rounding of the f32 sums
    torch.testing.assert_close(dt.float(), want_dt, rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(dw.float(), want_dw, rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("h,w", [(12, 16), (5, 7)])
def test_pack_corners_bwd_matches_pallas_vjp(h, w):
    from dskd_tpu.ops.pack_kernel import pack_corners_fused

    rng = np.random.RandomState(h * w)
    B, H, D = 2, 8, 32
    v = rng.randn(B, h * w, H, D).astype(np.float32)
    sp = (h + 2) * (w + 2)
    cot = rng.randn(B, sp, H, 4 * D).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda x: pack_corners_fused(x, h, w),
                           jnp.asarray(v))
        # the Pallas table's tail rows past sp are garbage: zero cotangent
        cot_j = np.zeros(out.shape, np.float32)
        cot_j[:, :sp] = cot
        (want,) = vjp(jnp.asarray(cot_j))
    tv = _t(v, True)
    (got,) = torch.autograd.grad(pack_corners(tv, h, w), [tv], _t(cot))
    # four shifted slices summed in the same order on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _msda_inputs(seed, Q, B=2, H=8, D=32, P=4):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in SHAPES)
    L = len(SHAPES)
    value = rng.randn(B, S, H, D).astype(np.float32)
    logits = rng.randn(B, Q, H, L * P).astype(np.float32)
    weights = np.exp(logits - logits.max(-1, keepdims=True))
    weights = (weights / weights.sum(-1, keepdims=True)).reshape(
        B, Q, H, L, P)
    # out-of-bounds locations exercise the zero-corner gates
    locs = (rng.rand(B, Q, H, L, P, 2) * 1.3 - 0.15).astype(np.float32)
    cot = rng.randn(B, Q, H * D).astype(np.float32)
    return value, locs, weights, cot


def _port_grads(value, locs, weights, cot):
    args = [_t(value, True), _t(locs, True), _t(weights, True)]
    out = ms_deform_attn_core(args[0], SHAPES, args[1], args[2])
    return [g.numpy() for g in torch.autograd.grad(out, args, _t(cot))]


def _jax_grads(fn, value, locs, weights, cot):
    f = jax.jit(jax.grad(lambda v, l, w: (fn(v, l, w) * cot).sum(),
                         argnums=(0, 1, 2)))
    return [np.asarray(g) for g in f(jnp.asarray(value), jnp.asarray(locs),
                                     jnp.asarray(weights))]


@pytest.mark.parametrize("seed,Q", [(0, 40), (1, 7)])
def test_msda_grads_match_jax_xla_branch(monkeypatch, seed, Q):
    from dskd_tpu.ops.msda import ms_deform_attn_core as jax_core

    monkeypatch.setenv("DSKD_FORCE_MXU", "0")
    inputs = _msda_inputs(seed, Q)
    want = _jax_grads(lambda v, l, w: jax_core(v, SHAPES, l, w), *inputs)
    got = _port_grads(*inputs)
    for name, g, wnt in zip(("value", "locations", "attention"), got, want):
        # the location gradient carries the map size (x * w): 1e-4
        np.testing.assert_allclose(g, wnt, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("seed,Q", [(3, 40)])
def test_msda_grads_match_jax_pallas_branches(monkeypatch, seed, Q):
    from dskd_tpu.ops.msda import ms_deform_attn_core as jax_core

    monkeypatch.setenv("DSKD_FORCE_MXU", "1")
    monkeypatch.setenv("DSKD_PACK_KERNEL", "1")
    inputs = _msda_inputs(seed, Q)
    # 100 rows: level 0 (252 rows) -> pack_corners_fused + XLA gather,
    # level 1 (80 rows) -> _pack_corners + mxu_gather_weighted
    with pltpu.force_tpu_interpret_mode():
        want = _jax_grads(lambda v, l, w: jax_core(
            v, SHAPES, l, w, mxu_gather_max_rows=100), *inputs)
    got = _port_grads(*inputs)
    for name, g, wnt in zip(("value", "locations", "attention"), got, want):
        np.testing.assert_allclose(g, wnt, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
