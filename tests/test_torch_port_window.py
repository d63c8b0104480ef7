"""The windowed MSDA sampling family of the port against the JAX package:
the window helpers (exact), and the plain versions of ``window_gather``,
``fused_window_sample`` and ``windowed_bwd_sample`` against their Pallas
kernels in interpret mode, forward and gradients, f32 and bf16, on inputs
whose samples stay in their tiles' windows (where the two contracts agree),
and against JAX's plain gather on inputs with escapes (where the Pallas
kernels give zero and JAX's caller falls back to that gather).

Tolerances: f32 differs by summation order only (1e-5, or 1e-4 for a
gradient summed over many samples); a bf16 result within one bf16 rounding
(2^-8 relative) of the exact value for the port, which rounds its f32 sum
once, and within three roundings of the scale against a Pallas backward,
which rounds each tile's sum to bf16 and adds the tiles in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops import window as port_window
from dskd_tpu_torch.ops.fused_window import fused_window_sample, \
    windowed_weighted_bwd
from dskd_tpu_torch.ops.window_bwd import windowed_bwd_sample
from dskd_tpu_torch.ops.window_gather import window_gather

from test_torch_port_sampling import interpret  # noqa: F401 (fixture)

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)      # f32, summation order only
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)     # f32 sums over many samples
DTYPES = ["float32", "bfloat16"]


def _bf16_close(got, want):
    """Within three bf16 roundings (each at most 2^-8 relative) of the
    result's scale: the Pallas kernels round each tile's bf16 sum and add
    the tiles in bf16, the port rounds its f32 sum once."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3 * 2 ** -8 * np.abs(want).max())


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --- the helpers ----------------------------------------------------------

# (h, w, tile_q, window): the flagship's level 0 at 640x640 (B5 at
# DSKD_WINDOW_ROWS=1024) and at 512x512, the JAX tests' shapes, windows past
# the table (clipped starts) and tiles of other sizes
TILE_CASES = [(80, 80, 128, 1024), (64, 64, 128, 1024), (80, 80, 128, 512),
              (16, 16, 32, 128), (16, 16, 16, 64), (8, 16, 16, 400),
              (32, 32, 128, 2048), (10, 12, 4, 30), (40, 30, 8, 96)]


@pytest.mark.parametrize("h,w,tile_q,window", TILE_CASES)
def test_tile_window_starts_match_jax(h, w, tile_q, window):
    from dskd_tpu.ops.window_gather import tile_window_starts

    s_pad = (h + 2) * (w + 2)
    args = (h * w, tile_q, w, w + 2, s_pad, window)
    got = port_window.tile_window_starts(*args)
    assert got == tuple(int(s) for s in tile_window_starts(*args))
    assert len(got) == h * w // tile_q


# the sampled levels and the source levels of the flagship's 640x640
# serving canvas and 640x480 training canvas, and of the JAX tests
SEGMENT_LEVELS = [((80, 80), (40, 40), (20, 20), (10, 10)),
                  ((80, 60), (40, 30), (20, 15), (10, 8)),
                  ((64, 64), (32, 32), (16, 16), (8, 8)),
                  ((32, 32), (16, 16)), ((16, 16), (8, 8))]


@pytest.mark.parametrize("levels", SEGMENT_LEVELS,
                         ids=lambda ls: "x".join(map(str, ls[0])))
@pytest.mark.parametrize("tile_q,margin", [(128, 6), (32, 1), (128, 2)])
def test_segment_window_starts_match_jax(levels, tile_q, margin):
    """Every (sampled level, source level) pair with the window size the
    MSDA branches give it, over both table sizes they use."""
    from dskd_tpu.ops.fused_window import segment_window_starts

    for h, w in levels:
        for s_pad in ((h + 2) * (w + 2), port_window.pallas_pack_rows(h, w)):
            for hs, ws in levels:
                need = int((tile_q / ws) * (h / hs)) + 2 * margin + 2
                k_seg = min(-(-(need * (w + 2)) // 16) * 16, s_pad)
                args = (hs * ws, tile_q, (hs, ws), (h, w), s_pad, k_seg)
                got = port_window.segment_window_starts(*args)
                assert got == tuple(int(s) for s in
                                    segment_window_starts(*args))


@pytest.mark.parametrize("h,w", [(80, 60), (80, 80), (32, 32), (16, 16),
                                 (10, 8), (5, 7)])
def test_pallas_pack_rows_match_jax(h, w):
    """The row count of JAX's ``pack_corners_fused`` table, which sizes
    the DSKD_WINBWD windows."""
    from dskd_tpu.ops.pack_kernel import pack_corners_fused

    shape = jax.eval_shape(lambda v: pack_corners_fused(v, h, w),
                           jax.ShapeDtypeStruct((1, h * w, 2, 8),
                                                jnp.float32)).shape
    assert port_window.pallas_pack_rows(h, w) == shape[1]


def test_window_escapes_counts_samples_outside():
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 200, (2, 50, 3, 4)).astype(np.int32)
    starts, tile_q, window = (0, 40, 90, 150), 16, 48
    start = np.repeat(np.asarray(starts), tile_q)[:50]
    local = idx - start[None, :, None, None]
    want = int(((local < 0) | (local >= window)).sum())
    assert 0 < want < idx.size
    got = port_window.window_escapes(torch.from_numpy(idx), starts, tile_q,
                                     window)
    assert int(got) == want


def test_check_window_refuses_wrong_tiles():
    with pytest.raises(ValueError):
        port_window.check_window("t", (0, 16), 50, 16, 32)   # 4 tiles
    assert port_window.check_window("t", [0, 16], 20, 16, 32) == (0, 16)


# --- B5 window_gather -------------------------------------------------------

def _gather_case(seed, escape=False, N=2, S=256, D=128, M=96, tile_rows=16,
                 window=64):
    """The JAX test's problem: overlapping windows, indices inside each
    tile's window, or with some sent far away."""
    rng = np.random.RandomState(seed)
    table = rng.randn(N, S, D).astype(np.float32)
    starts = tuple(int(s) for s in
                   np.arange(M // tile_rows) * 32 % (S - window))
    idx = np.zeros((N, M), np.int32)
    for t, lo in enumerate(starts):
        idx[:, t * tile_rows:(t + 1) * tile_rows] = rng.randint(
            lo, lo + window, (N, tile_rows))
    idx[:, :3] = rng.randint(0, 4, (N, 3))    # repeated rows for dtable
    if escape:
        idx[0, 20] = (starts[1] + window + 7) % S
        idx[1, 50:54] = S - 1 - np.arange(4)
    g = rng.randn(N, M, D).astype(np.float32)
    return table, idx, starts, tile_rows, window, g


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_gather_matches_pallas(interpret, dtype):
    from dskd_tpu.ops.window_gather import window_gather as jax_wg

    table, idx, starts, tr, K, g = _gather_case(0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(lambda t: jax_wg(t, jnp.asarray(idx),
                                         jnp.asarray(starts), tr, K),
                        jnp.asarray(table).astype(jdt))
    want_dt, = vjp(jnp.asarray(g).astype(jdt))

    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    got = window_gather(t, torch.from_numpy(idx), starts, tr, K)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and t.grad.dtype == tdt
    # a row copy: bit for bit, in f32 and bf16
    np.testing.assert_array_equal(got.detach().float().numpy(), _np(want))
    if dtype == "float32":
        np.testing.assert_allclose(t.grad.numpy(), _np(want_dt), **F32_TOL)
    else:
        _bf16_close(t.grad.float().numpy(), _np(want_dt))


def test_window_gather_escapes_match_plain_gather():
    """An index outside its tile's window reads the table: the result and
    the gradient are the plain gather's (JAX's cond fallback)."""
    table, idx, starts, tr, K, g = _gather_case(1, escape=True)
    assert int(port_window.window_escapes(
        torch.from_numpy(idx)[:, :, None, None], starts, tr, K)) == 5
    want, vjp = jax.vjp(lambda t: jnp.take_along_axis(
        t, jnp.asarray(idx)[..., None], axis=1), jnp.asarray(table))
    want_dt, = vjp(jnp.asarray(g))

    t = torch.from_numpy(table).requires_grad_(True)
    got = window_gather(t, torch.from_numpy(idx), starts, tr, K)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_dt),
                               **F32_TOL)


def test_window_gather_msda_layout():
    """MSDA's layout: tile q // (tile_rows // P), the (N, M) layout's rows
    q * P + p of each (b, head)."""
    table, idx, starts, tr, K, _ = _gather_case(2, N=2 * 3, M=96)
    B, H, P = 2, 3, 4
    t4 = torch.from_numpy(table.reshape(B, H, 256, 128).transpose(0, 2, 1, 3)
                          .copy())
    i4 = torch.from_numpy(idx.reshape(B, H, 24, P).transpose(0, 2, 1, 3)
                          .copy())
    got = window_gather(t4, i4, starts, tr, K)
    want = window_gather(torch.from_numpy(table), torch.from_numpy(idx),
                         starts, tr, K)
    assert got.shape == (B, 24, H, P, 128)
    assert torch.equal(got.permute(0, 2, 1, 3, 4).reshape(B * H, 96, 128),
                       want)
    with pytest.raises(ValueError):
        window_gather(t4, i4, starts, 18, K)        # not whole queries


# --- B6 fused_window_sample, and its backward -------------------------------

def _fused_case(seed, escape=False, N=2, S=256, D4=128, Q=80, P=4, TQ=16,
                K=64):
    rng = np.random.RandomState(seed)
    table = rng.randn(N, S, D4).astype(np.float32)
    starts = tuple(int(s) for s in np.arange(Q // TQ) * 32 % (S - K))
    idx = np.zeros((N, Q, P), np.int32)
    for t, lo in enumerate(starts):
        idx[:, t * TQ:(t + 1) * TQ] = rng.randint(lo, lo + K, (N, TQ, P))
    idx[:, :2, :2] = 5                        # one row many times
    if escape:
        idx[0, 3, 1] = 200
        idx[1, 40:43, 0] = (starts[2] + K + np.arange(3)) % S
    w = rng.rand(N, Q, P, 4).astype(np.float32)
    g = rng.randn(N, Q, D4).astype(np.float32)
    return table, idx, w, starts, K, TQ, g


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_window_sample_matches_pallas(interpret, dtype):
    from dskd_tpu.ops.fused_window import fused_window_sample as jax_fws

    table, idx, w, starts, K, TQ, g = _fused_case(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want, vjp = jax.vjp(lambda t, ww: jax_fws(t, jnp.asarray(idx), ww,
                                              jnp.asarray(starts), K, TQ),
                        jnp.asarray(table).astype(jdt), jnp.asarray(w))
    want_dt, want_dw = vjp(jnp.asarray(g).astype(jdt))

    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = fused_window_sample(t, torch.from_numpy(idx), wt, starts, K, TQ)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and t.grad.dtype == tdt
    assert wt.grad.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), _np(want), **F32_TOL)
        np.testing.assert_allclose(t.grad.numpy(), _np(want_dt), **GRAD_TOL)
    else:
        # one rounding of an f32 sum, in both
        np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                                   rtol=2 ** -7, atol=1e-5)
        _bf16_close(t.grad.float().numpy(), _np(want_dt))
    # dw: f32 dots of exact rows with the same bf16 (or f32) cotangent
    np.testing.assert_allclose(wt.grad.numpy(), _np(want_dw), **GRAD_TOL)


def test_fused_window_sample_escapes_match_plain_gather():
    """Escaped samples read the table: forward and gradients are JAX's
    plain weighted gather's (``window_bwd._plain_sample`` at H = 1)."""
    from dskd_tpu.ops.window_bwd import _plain_sample

    table, idx, w, starts, K, TQ, g = _fused_case(4, escape=True)
    assert int(port_window.window_escapes(
        torch.from_numpy(idx)[:, :, None], starts, TQ, K)) == 4
    want, vjp = jax.vjp(
        lambda t, ww: _plain_sample(t[:, :, None], jnp.asarray(idx)[:, :,
                                                                    None],
                                    ww[:, :, None])[:, :, 0],
        jnp.asarray(table), jnp.asarray(w))
    want_dt, want_dw = vjp(jnp.asarray(g))

    t = torch.from_numpy(table).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = fused_window_sample(t, torch.from_numpy(idx), wt, starts, K, TQ)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_dt),
                               **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               **GRAD_TOL)


# --- B7 windowed_bwd_sample --------------------------------------------------

def _winbwd_case(seed, escape=False, B=2, Q=200, H=2, P=4, S=160, D4=128,
                 tile_q=64, window=64):
    """The JAX test's problem at a Q that ends in a partial tile."""
    rng = np.random.RandomState(seed)
    packed = rng.randn(B, S, H, D4).astype(np.float32)
    n_tiles = -(-Q // tile_q)
    starts = tuple(int(t * 32 - t * 32 % 16) for t in range(n_tiles))
    flat = np.zeros((B, Q, H, P), np.int32)
    for t, lo in enumerate(starts):
        q1 = min((t + 1) * tile_q, Q)
        flat[:, t * tile_q:q1] = rng.randint(
            lo, lo + window, (B, q1 - t * tile_q, H, P))
    if escape:
        flat[0, 5, 1, 2] = S - 1
        flat[1, 150, 0, :] = 0
    cw = rng.rand(B, Q, H, P, 4).astype(np.float32)
    g = rng.randn(B, Q, H, D4).astype(np.float32)
    return packed, flat, cw, starts, window, tile_q, g


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_bwd_sample_matches_pallas(interpret, dtype):
    """``jax.grad`` through the Pallas backward (the test_window_bwd
    pattern), padded to whole tiles as JAX's caller pads: index
    ``starts[-1]``, weight 0."""
    from dskd_tpu.ops.window_bwd import windowed_bwd_sample as jax_wbs

    packed, flat, cw, starts, K, TQ, g = _winbwd_case(5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # JAX's plain forward promotes a bf16 table to an f32 output and the
    # port's keeps bf16, whose cotangent is rounded: give both that one
    g = torch.from_numpy(g).to(tdt).float().numpy()
    B, Q, H, P = flat.shape
    pad = -Q % TQ
    flat_p = np.pad(flat, ((0, 0), (0, pad), (0, 0), (0, 0)),
                    constant_values=starts[-1])
    cw_p = np.pad(cw, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0)))
    g_p = np.pad(g, ((0, 0), (0, pad), (0, 0), (0, 0)))

    def loss(tbl, w):
        out = jax_wbs(tbl, jnp.asarray(flat_p), w, jnp.asarray(starts), K,
                      TQ)
        return (out.astype(jnp.float32) * jnp.asarray(g_p)).sum()

    want_dt, want_dw = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(packed).astype(jdt), jnp.asarray(cw_p))
    want_dw = _np(want_dw)[:, :Q]

    t = torch.from_numpy(packed).to(tdt).requires_grad_(True)
    w = torch.from_numpy(cw).requires_grad_(True)
    out = windowed_bwd_sample(t, torch.from_numpy(flat), w, starts, K, TQ)
    (out.float() * torch.from_numpy(g)).sum().backward()
    if dtype == "float32":
        np.testing.assert_allclose(t.grad.numpy(), _np(want_dt), **GRAD_TOL)
    else:
        _bf16_close(t.grad.float().numpy(), _np(want_dt))
    # dw: f32 dots of exact rows with the same cotangent
    np.testing.assert_allclose(w.grad.numpy(), want_dw, **GRAD_TOL)


def test_windowed_bwd_sample_escapes_match_plain_gather():
    """Escaped samples add into the table directly: the gradients are
    those of JAX's plain gather (``_plain_sample``)."""
    from dskd_tpu.ops.window_bwd import _plain_sample

    packed, flat, cw, starts, K, TQ, g = _winbwd_case(6, escape=True)
    assert int(port_window.window_escapes(torch.from_numpy(flat), starts,
                                          TQ, K)) >= 4
    want, vjp = jax.vjp(lambda t, w: _plain_sample(t, jnp.asarray(flat), w),
                        jnp.asarray(packed), jnp.asarray(cw))
    want_dt, want_dw = vjp(jnp.asarray(g))

    t = torch.from_numpy(packed).requires_grad_(True)
    w = torch.from_numpy(cw).requires_grad_(True)
    out = windowed_bwd_sample(t, torch.from_numpy(flat), w, starts, K, TQ)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_dt),
                               **GRAD_TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dw),
                               **GRAD_TOL)
    # the shared backward, called directly, gives the same
    dt, dw = windowed_weighted_bwd(t.detach(), torch.from_numpy(flat),
                                   w.detach(), torch.from_numpy(g), starts,
                                   K, TQ)
    torch.testing.assert_close(dt, t.grad)
    torch.testing.assert_close(dw, w.grad)
