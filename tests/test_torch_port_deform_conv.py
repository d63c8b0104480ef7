"""Deformable convolution on the port (``ops/deform_conv.py``) against
dskd_tpu/ops/deform_conv.py on the CPU, on the same numpy-seeded inputs:
DCN v1 and v2 (sigmoided mask), stride 1 and 2, dilation 2, offsets that
put taps outside the map (some corners in, some out, some taps wholly
out) and offsets exactly zero (every sample on a pixel, where the offset
gradient is the one-sided slope toward corner (y0 + 1, x0 + 1)).
Forwards in f32 within 1e-4 relative / 1e-5 absolute; in f64 the output
and the gradients of x, offsets, mask and weight within 1e-8 relative
(and 1e-12 absolute, for the elements that are 0 in both). The
``DeformConv2d`` block with a redrawn offset conv, v1 and v2, likewise;
the port's weight is torch's (Cout, Cin, kh, kw) of JAX's (kh, kw, Cin,
Cout)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops import deform_conv as P

torch.set_num_threads(1)

B, H, W, CIN, COUT = 2, 9, 11, 6, 5
F32_TOL = dict(rtol=1e-4, atol=1e-5)
F64_TOL = dict(rtol=1e-8, atol=1e-12)


def _out_hw(stride, dilation, k=3, pad=1):
    return ((H + 2 * pad - dilation * (k - 1) - 1) // stride + 1,
            (W + 2 * pad - dilation * (k - 1) - 1) // stride + 1)


def _inputs(seed, stride, dilation, offsets, modulated, dtype):
    """numpy (x, offsets, weight (JAX layout), mask or None, cotangent)."""
    rng = np.random.RandomState(seed)
    Ho, Wo = _out_hw(stride, dilation)
    x = rng.randn(B, H, W, CIN)
    w = rng.randn(3, 3, CIN, COUT) / np.sqrt(9 * CIN)
    if offsets == "zero":
        off = np.zeros((B, Ho, Wo, 18))
    else:
        off = rng.randn(B, Ho, Wo, 18) * 3.0
        # whole taps beyond the map on each side, and corners half in
        off[0, 0, 0, :4] = (-30.0, 2.5, 0.5, 40.0)
        off[1, -1, -1, 16:] = (25.0, -25.0)
        off[0, 1, 2, 8:10] = (-1.5, -0.25)
    mask = (1 / (1 + np.exp(-rng.randn(B, Ho, Wo, 9))) if modulated
            else None)
    cot = rng.randn(B, Ho, Wo, COUT)
    cast = (lambda a: None if a is None else a.astype(dtype))
    return tuple(map(cast, (x, off, w, mask, cot)))


def _jax(x, off, w, mask, cot, stride, dilation):
    """JAX's output and its gradients of x, offsets, weight, mask."""
    from dskd_tpu.ops.deform_conv import deform_conv2d

    def loss(x, off, w, mask):
        out = deform_conv2d(x, off, w, stride=stride, padding=1,
                            dilation=dilation, mask=mask)
        return (out * cot).sum(), out

    argnums = (0, 1, 2, 3) if mask is not None else (0, 1, 2)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(x, off, w, mask)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(x, off, w, mask, cot, stride, dilation):
    ts = [None if a is None else torch.from_numpy(a).requires_grad_()
          for a in (x, off, w.transpose(3, 2, 0, 1).copy(), mask)]
    out = P.deform_conv2d(ts[0], ts[1], ts[2], stride=stride, padding=1,
                          dilation=dilation, mask=ts[3])
    (out * torch.from_numpy(cot)).sum().backward()
    grads = [ts[0].grad, ts[1].grad,
             ts[2].grad.permute(2, 3, 1, 0)] + ([ts[3].grad]
                                                if mask is not None else [])
    return out.detach().numpy(), [g.numpy() for g in grads]


CASES = [(1, 1, "random"), (2, 1, "random"), (1, 2, "random"),
         (1, 1, "zero"), (2, 1, "zero")]


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("stride,dilation,offsets", CASES)
def test_forward_f32_matches_jax(stride, dilation, offsets, modulated):
    x, off, w, mask, cot = _inputs(0, stride, dilation, offsets, modulated,
                                   np.float32)
    want, _ = _jax(x, off, w, mask, cot, stride, dilation)
    got, _ = _port(x, off, w, mask, cot, stride, dilation)
    assert got.shape == want.shape == (B, *_out_hw(stride, dilation), COUT)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("stride,dilation,offsets", CASES)
def test_grads_f64_match_jax(stride, dilation, offsets, modulated):
    x, off, w, mask, cot = _inputs(1, stride, dilation, offsets, modulated,
                                   np.float64)
    with jax.enable_x64(True):
        want, wgrads = _jax(x, off, w, mask, cot, stride, dilation)
    got, grads = _port(x, off, w, mask, cot, stride, dilation)
    np.testing.assert_allclose(got, want, **F64_TOL)
    names = ["x", "offsets", "weight", "mask"]
    for name, g, wg in zip(names, grads, wgrads):
        assert g.shape == wg.shape, name
        assert np.abs(wg).max() > 0, name
        np.testing.assert_allclose(g, wg, err_msg=name, **F64_TOL)


def test_zero_offsets_take_the_upper_slope():
    """At zero offsets the sample is on a pixel: the offset gradient is the
    slope toward (y0 + 1, x0 + 1), so for a ramp rising by 1 a row and 2 a
    column, an identity weight on tap 4 (the centre) gives d/ddy = 1 and
    d/ddx = 2 wherever the next row and column are in the map, and the
    drop to 0 past the map's last row and column."""
    ramp = (np.arange(H)[:, None] + 2.0 * np.arange(W)[None])
    x = torch.from_numpy(np.broadcast_to(ramp[None, :, :, None],
                                         (1, H, W, 1)).copy())
    off = torch.zeros(1, H, W, 18, dtype=torch.float64, requires_grad=True)
    w = torch.zeros(1, 1, 3, 3, dtype=torch.float64)
    w[0, 0, 1, 1] = 1.0
    out = P.deform_conv2d(x, off, w)
    np.testing.assert_array_equal(out[0, :, :, 0].detach().numpy(), ramp)
    out.sum().backward()
    g = off.grad[0].numpy()
    dy, dx = g[..., 8], g[..., 9]
    np.testing.assert_array_equal(dy[:-1], 1.0)
    np.testing.assert_array_equal(dx[:, :-1], 2.0)
    np.testing.assert_array_equal(dy[-1], -ramp[-1])
    np.testing.assert_array_equal(dx[:, -1], -ramp[:, -1])


@pytest.mark.parametrize("hw,step", [((9, 11), 1), ((5, 6), 2)])
def test_strided_offsets_and_mask(hw, step):
    """Offsets and mask sliced from an NCHW conv output's NHWC view (DyHead's
    layout, every second position for the high branch) give the output and
    gradients of their contiguous copies (f64, 1e-12: the sums may run in
    another order)."""
    rng = np.random.RandomState(6)
    H, W = hw
    x = torch.from_numpy(rng.randn(B, H, W, CIN))
    w = torch.from_numpy(rng.randn(COUT, CIN, 3, 3))
    om = torch.from_numpy(rng.randn(B, 27, 9, 11)).permute(0, 2, 3, 1)
    om = om[:, ::step, ::step]
    res = []
    for o in (om, om.contiguous()):
        o = o.detach().requires_grad_()
        out = P.deform_conv2d(x, o[..., :18], w, mask=torch.sigmoid(
            o[..., 18:]))
        out.sum().backward()
        res.append((out.detach(), o.grad))
    for a, b in zip(*res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv2d_block_matches_jax(modulated):
    """JAX's ``DeformConv2d`` and the port's on the same weights, the offset
    conv redrawn so that the offsets spread over a few pixels: the forward
    in f64 (1e-8)."""
    from dskd_tpu.ops.deform_conv import DeformConv2d as JDCN

    rng = np.random.RandomState(4)
    x = rng.randn(B, H, W, CIN)
    jm = JDCN(COUT, stride=2, modulated=modulated, use_bias=True)
    with jax.enable_x64(True):
        v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), x))
        v = jax.tree.map(lambda a: rng.randn(*a.shape) * (
            1.0 if a.ndim == 4 else 0.3), v)
        want = np.asarray(jm.apply(v, x))
    pm = P.DeformConv2d(CIN, COUT, "cpu", stride=2, modulated=modulated,
                        use_bias=True).double()
    p = v["params"]
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1)))
        pm.bias.copy_(torch.from_numpy(p["bias"]))
        pm.conv_offset.weight.copy_(torch.from_numpy(
            p["conv_offset"]["kernel"].transpose(3, 2, 0, 1)))
        pm.conv_offset.bias.copy_(torch.from_numpy(p["conv_offset"]["bias"]))
    got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **F64_TOL)
