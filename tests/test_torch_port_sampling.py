"""The non-windowed MSDA sampling variants of the port against the JAX
package: ``mxu_gather`` and ``fused_msda_sample`` (forward and gradients)
against their Pallas kernels run in interpret mode, and
``ms_deform_attn_core`` under ``DSKD_WGATHER=0`` and under
``DSKD_FUSED_ROWS=N`` (test_torch_port_train_switches holds the tiny train
step under each switch).

Inputs come from numpy seeds. JAX runs its Pallas branches as its own tests
run them on the CPU: ``pl.pallas_call`` in interpret mode and
``DSKD_FORCE_MXU=1`` for ``ms_deform_attn_core``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops.fused_sample import fused_msda_sample, \
    fused_msda_sample_plain
from dskd_tpu_torch.ops.msda import fused_index_and_weights, \
    ms_deform_attn_core
from dskd_tpu_torch.ops.mxu_gather import mxu_gather, mxu_gather_plain

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)      # f32, summation order only


@pytest.fixture
def interpret(monkeypatch):
    """Run every Pallas kernel in interpret mode, as the JAX package's own
    kernel tests do."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture
def branch_calls(monkeypatch):
    """Counts the port's MSDA calls of each sampling function (on the CPU
    the kernels' launch counters stay at 0)."""
    import dskd_tpu_torch.ops.msda as msda

    calls = {}
    for name in ("gather_weighted", "mxu_gather", "fused_msda_sample"):
        def counted(*args, _fn=getattr(msda, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(msda, name, counted)
    return calls


def _to_jnp(x, dtype):
    return jnp.asarray(x).astype(dtype)


# --- (a) mxu_gather -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mxu_gather_matches_jax(interpret, dtype):
    from dskd_tpu.ops.mxu_gather import mxu_gather as jax_mxu_gather

    rng = np.random.RandomState(0)
    N, S, D, M = 3, 300, 128, 700            # M is not a multiple of 512
    table = rng.randn(N, S, D).astype(np.float32)
    idx = rng.randint(0, S, (N, M)).astype(np.int32)
    idx[:, :40] = rng.randint(0, 4, (N, 40))     # repeated rows for dtable
    g = rng.randn(N, M, D).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want, vjp = jax.vjp(lambda t: jax_mxu_gather(t, jnp.asarray(idx)),
                        _to_jnp(table, jdt))
    want_dt, = vjp(_to_jnp(g, jdt))

    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    got = mxu_gather(t, torch.from_numpy(idx))
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and t.grad.dtype == tdt
    # a row copy: bit for bit
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    got_dt = t.grad.float().numpy()
    want_dt = np.asarray(want_dt.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got_dt, want_dt, **F32_TOL)
        return
    # bf16: the port sums dtable in f32 and rounds once, so it is within
    # one bf16 rounding (2^-8 relative) of the exact sum of the bf16 g ...
    g16 = torch.from_numpy(g).to(torch.bfloat16).double().numpy()
    exact = np.zeros((N, S, D))
    for n in range(N):
        np.add.at(exact[n], idx[n], g16[n])
    np.testing.assert_allclose(got_dt, exact, rtol=2 ** -8, atol=1e-6)
    # ... while the Pallas kernel rounds each of the two 512-row tiles'
    # sums to bf16 and adds them in bf16: three roundings against the
    # port's one, each at most half a bf16 ulp (2^-8 relative) of a value
    # up to dtable's scale, so within 4 * 2^-8 of that scale
    np.testing.assert_allclose(got_dt, want_dt, rtol=0,
                               atol=2 ** -6 * np.abs(want_dt).max())


def test_mxu_gather_out_of_range_indices(interpret):
    """An index outside [0, S) gives a zero row and adds nothing to
    dtable, in the port's plain version and in the Pallas kernel."""
    from dskd_tpu.ops.mxu_gather import mxu_gather as jax_mxu_gather

    rng = np.random.RandomState(1)
    N, S, D, M = 2, 50, 128, 300
    table = rng.randn(N, S, D).astype(np.float32)
    idx = rng.randint(-30, S + 30, (N, M)).astype(np.int32)
    out_of_range = (idx < 0) | (idx >= S)
    assert out_of_range.sum() > 50
    g = rng.randn(N, M, D).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_mxu_gather(t, jnp.asarray(idx)),
                        jnp.asarray(table))
    want_dt, = vjp(jnp.asarray(g))

    t = torch.from_numpy(table).requires_grad_(True)
    got = mxu_gather(t, torch.from_numpy(idx))
    got.backward(torch.from_numpy(g))
    assert not got.detach().numpy()[out_of_range].any()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_dt),
                               **F32_TOL)
    # the MSDA layout of the plain version: (B, S, H, D), (B, Q, H, P)
    t4 = torch.from_numpy(table.reshape(N, S, 2, D // 2))
    i4 = torch.from_numpy(idx.reshape(N, M // 4, 2, 2))
    rows = mxu_gather_plain(t4, i4)
    assert rows.shape == (N, M // 4, 2, 2, D // 2)
    bad = torch.from_numpy(out_of_range.reshape(N, M // 4, 2, 2))
    assert not rows[bad].any()
    ok = ~bad
    np.testing.assert_array_equal(
        rows[ok].numpy(),
        t4[torch.arange(N)[:, None, None, None].expand_as(i4)[ok],
           i4[ok].long(),
           torch.arange(2)[None, None, :, None].expand_as(i4)[ok]].numpy())


# --- (b) fused_msda_sample ----------------------------------------------------

def _fused_case(seed, N=4, Q=256, P=4, D=32, h=11, w=14):
    """idx and weights as MSDA makes them (unclipped c00, gated weights)
    from locations spilling past the map, plus hand-set edge taps."""
    rng = np.random.RandomState(seed)
    S = h * w
    table = rng.randn(N, S, D).astype(np.float32)
    loc = torch.from_numpy((rng.rand(N, Q, 1, P, 2) * 1.3 - 0.15)
                           .astype(np.float32))
    attn = torch.from_numpy(rng.rand(N, Q, 1, P).astype(np.float32))
    c00, wts = fused_index_and_weights(loc, attn, h, w, torch.float32)
    idx, wts = c00[:, :, 0].numpy().copy(), wts[:, :, 0].numpy().copy()
    # q=0: a negative c00 whose in-range taps carry weight
    idx[:, 0, 0] = -1
    wts[:, 0, 0] = [0.0, 0.3, 0.0, 0.2]
    # q=1: c00 + W + 1 past the table, the taps past it with zero weight
    idx[:, 1, 1] = S - 2
    wts[:, 1, 1] = [0.25, 0.5, 0.0, 0.0]
    # q=2: x0 = w-1 on an inner row: taps +1 and +W+1 wrap to the next
    # image row, in range, with zero weight; their dw is not 0
    idx[:, 2, 2] = 3 * w + w - 1
    wts[:, 2, 2] = [0.4, 0.0, 0.6, 0.0]
    g = rng.randn(N, Q, D).astype(np.float32)
    return table, idx, wts, g, w


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_msda_sample_matches_jax(interpret, seed):
    from dskd_tpu.ops.fused_sample import fused_msda_sample as jax_fused

    table, idx, wts, g, W = _fused_case(seed)
    S = table.shape[1]
    assert (idx < 0).any() and (idx + W + 1 >= S).any()
    want, vjp = jax.vjp(lambda t, w: jax_fused(t, jnp.asarray(idx), w, W),
                        jnp.asarray(table), jnp.asarray(wts))
    want_dt, want_dw = vjp(jnp.asarray(g))

    t = torch.from_numpy(table).requires_grad_(True)
    w = torch.from_numpy(wts).requires_grad_(True)
    got = fused_msda_sample(t, torch.from_numpy(idx), w, W)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_dt),
                               **F32_TOL)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_dw),
                               **F32_TOL)
    # the wrapped in-range taps of q=2 have zero weight and a nonzero dw,
    # as the Pallas backward gives them
    dw_wrapped = w.grad.numpy()[:, 2, 2, [1, 3]]
    assert (np.abs(dw_wrapped) > 1e-3).all()
    # taps outside [0, S) get dw = 0
    rows = idx[..., None] + np.array([0, 1, W, W + 1])
    assert not w.grad.numpy()[(rows < 0) | (rows >= S)].any()


def test_fused_msda_sample_bf16_table():
    """A bf16 table: f32 weights and sums, output in bf16 (one rounding of
    the f32 sum), against the plain version on the f32 table."""
    table, idx, wts, _, W = _fused_case(2, Q=50)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    got = fused_msda_sample(t16, torch.from_numpy(idx),
                            torch.from_numpy(wts), W)
    assert got.dtype == torch.bfloat16
    want = fused_msda_sample_plain(t16.float()[:, :, None],
                                   torch.from_numpy(idx)[:, :, None],
                                   torch.from_numpy(wts)[:, :, None],
                                   W)[:, :, 0]
    torch.testing.assert_close(got.float(), want, rtol=2 ** -8, atol=1e-6)


# --- (c) ms_deform_attn_core under each switch --------------------------------

# packed tables of 252, 80 and 30 rows; raw levels of 192, 48 and 12 rows
SHAPES = [(12, 16), (6, 8), (3, 4)]
# the environment, and the calls it gives one ms_deform_attn_core
SWITCHES = {
    # level 0 (252 > 100 rows): pack_corners + the weighted gather;
    # levels 1-2: pack_corners + mxu_gather
    "wgather0": {"DSKD_WGATHER": "0", "DSKD_MXU_GATHER_ROWS": "100"},
    # level 0 (192 > 48): the default branch; levels 1-2 fused_msda_sample
    "fused48": {"DSKD_FUSED_ROWS": "48", "DSKD_MXU_GATHER_ROWS": "100"},
}


BRANCH_CALLS = {"wgather0": {"gather_weighted": 1, "mxu_gather": 2},
                "fused48": {"gather_weighted": 1, "fused_msda_sample": 2}}


def _msda_inputs(seed, Q, B=2, H=4, D=32, P=4):
    rng = np.random.RandomState(seed)
    S = sum(h * w for h, w in SHAPES)
    L = len(SHAPES)
    value = rng.randn(B, S, H, D).astype(np.float32)
    logits = rng.randn(B, Q, H, L * P).astype(np.float32)
    weights = np.exp(logits - logits.max(-1, keepdims=True))
    weights = (weights / weights.sum(-1, keepdims=True)).reshape(
        B, Q, H, L, P)
    locs = (rng.rand(B, Q, H, L, P, 2) * 1.3 - 0.15).astype(np.float32)
    cot = rng.randn(B, Q, H * D).astype(np.float32)
    return value, locs, weights, cot


@pytest.mark.parametrize("switch,seed,Q", [("wgather0", 0, 40),
                                           ("wgather0", 1, 130),
                                           ("fused48", 2, 40),
                                           ("fused48", 3, 130)])
def test_msda_switch_matches_jax(interpret, branch_calls, monkeypatch,
                                 switch, seed, Q):
    from dskd_tpu.ops.msda import ms_deform_attn_core as jax_core

    monkeypatch.setenv("DSKD_FORCE_MXU", "1")
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, v)
    value, locs, weights, cot = _msda_inputs(seed, Q)

    want, vjp = jax.vjp(lambda v, l, w: jax_core(v, SHAPES, l, w),
                        *(jnp.asarray(a) for a in (value, locs, weights)))
    want_grads = vjp(jnp.asarray(cot))

    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (value, locs, weights)]
    got = ms_deform_attn_core(targs[0], SHAPES, targs[1], targs[2])
    got.backward(torch.from_numpy(cot))
    assert branch_calls == BRANCH_CALLS[switch]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5,
                               atol=2e-5)
    for name, t, ref, scale in zip(("value", "locations", "attention"),
                                   targs, want_grads, (1, 16, 1)):
        # f32; a location's gradient carries the map size (up to 16 px per
        # unit), so its tolerance scales with it
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=2e-5 * scale,
                                   err_msg=name)


def test_msda_switches_change_no_result(monkeypatch):
    """On the port's own plain versions, the three branches compute the
    same function: each switch against the default branch, f32."""
    value, locs, weights, _ = _msda_inputs(4, 30)
    args = (torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
            torch.from_numpy(weights))
    want = ms_deform_attn_core(*args)
    for env in SWITCHES.values():
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            torch.testing.assert_close(ms_deform_attn_core(*args), want,
                                       rtol=1e-5, atol=1e-5)
