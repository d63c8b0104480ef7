"""``ms_deform_attn_core`` under the windowed sampling switches,
``DSKD_WINDOW_ROWS``, ``DSKD_FWIN`` and ``DSKD_WINBWD``, against the JAX
package's under the same environment (``DSKD_FORCE_MXU=1``, Pallas kernels
in interpret mode): the output and the gradients in value, locations and
attention weights, with every sample in its window and with one sample sent
far away (JAX's ``lax.cond`` then takes the plain path; the port's kernels
read the escaped row directly). Then the tiny train step of
test_torch_port_train_step under each switch, on a 256x256 canvas, where the
windowed branches are taken. The counts of the port's calls show the
windowed branch ran.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops.msda import ms_deform_attn_core

from test_torch_port_sampling import interpret  # noqa: F401 (fixture)
from test_torch_port_tiny import tiny_batch
from test_torch_port_train_step import assert_gradients_match, \
    assert_losses_match, jax_step_run

torch.set_num_threads(1)

_COUNTED = ("gather_weighted", "mxu_gather", "fused_msda_sample",
            "window_gather", "fused_window_sample", "windowed_bwd_sample")


@pytest.fixture
def window_calls(monkeypatch):
    """Counts the port's MSDA calls of each sampling function (on the CPU
    the kernels' launch counters stay at 0)."""
    import dskd_tpu_torch.ops.msda as msda

    calls = {}
    for name in _COUNTED:
        def counted(*args, _fn=getattr(msda, name), _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args)
        monkeypatch.setattr(msda, name, counted)
    return calls


def _raster_case(seed, shapes, noise, escape):
    """test_msda's problem: B=1, H=2, D=64, P=2; every token a query, each
    sampling near its own pixel (level 0's tokens, and level 1's where
    ``own1``), or one sample sent to the far corner."""
    rng = np.random.RandomState(seed)
    B, H, D, P = 1, 2, 64, 2
    S = sum(h * w for h, w in shapes)
    value = rng.randn(B, S, H, D).astype(np.float32)
    logits = rng.randn(B, S, H, len(shapes) * P).astype(np.float32)
    weights = np.exp(logits - logits.max(-1, keepdims=True))
    weights = (weights / weights.sum(-1, keepdims=True)).reshape(
        B, S, H, len(shapes), P)
    own = []
    for h, w in shapes:
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        own.append(np.stack([(xs.ravel() + 0.5) / w,
                             (ys.ravel() + 0.5) / h], -1))
    own = np.concatenate(own, 0)
    locs = (own[None, :, None, None, None, :]
            + rng.randn(B, S, H, len(shapes), P, 2) * noise)
    locs = locs.astype(np.float32)
    if escape:
        locs[0, 5, 0, 0, 0] = (0.99, 0.99)
    cot = rng.randn(B, S, H * D).astype(np.float32)
    return value, locs, weights, cot


# name -> (environment, keyword arguments, shapes, location noise, the
# port's calls); the cases of tests/test_msda.py and tests/test_window_bwd.py
CASES = {
    # level 0 (324 rows > 100): window_gather for its 256 queries,
    # gather_weighted for level 1's 64; level 1 (100 rows): gather_weighted
    "window_rows": ({}, dict(mxu_gather_max_rows=100, window_tile_q=32,
                             window_rows=128), [(16, 16), (8, 8)], 0.01,
                    {"window_gather": 1, "gather_weighted": 2}),
    # level 0: level 0's queries in windows, level 1's (K 224 > 162) not
    "fwin": ({"DSKD_FWIN": "1", "DSKD_FWIN_MARGIN": "1"},
             dict(mxu_gather_max_rows=100, fwin_tile_q=32),
             [(16, 16), (8, 8)], 0.01,
             {"fused_window_sample": 1, "gather_weighted": 2}),
    # levels 0 and 1 (1156 and 324 rows): level 0's queries in windows of
    # 352 and 144 rows, level 1's (752 > 680, 256 > 216) not
    "winbwd": ({"DSKD_WINBWD": "1", "DSKD_FWIN_MARGIN": "2"},
               dict(mxu_gather_max_rows=100), [(32, 32), (16, 16)], 0.005,
               {"windowed_bwd_sample": 2, "gather_weighted": 2}),
}


@pytest.mark.parametrize("escape", [False, True], ids=["inside", "escape"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_msda_window_switch_matches_jax(interpret, window_calls, monkeypatch,
                                        case, escape):
    from dskd_tpu.ops.msda import ms_deform_attn_core as jax_core

    env, kw, shapes, noise, calls = CASES[case]
    monkeypatch.setenv("DSKD_FORCE_MXU", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    value, locs, weights, cot = _raster_case(7, shapes, noise, escape)
    want, vjp = jax.vjp(
        lambda v, l, w: jax_core(v, shapes, l, w, raster_queries=True, **kw),
        *(jnp.asarray(a) for a in (value, locs, weights)))
    want_grads = vjp(jnp.asarray(cot))

    targs = [torch.from_numpy(a).requires_grad_(True)
             for a in (value, locs, weights)]
    got = ms_deform_attn_core(targs[0], shapes, targs[1], targs[2],
                              raster_queries=True, **kw)
    got.backward(torch.from_numpy(cot))
    assert window_calls == calls
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for name, t, ref, scale in zip(("value", "locations", "attention"),
                                   targs, want_grads, (1, 32, 1)):
        # f32; a location's gradient carries the map size (up to 32 px per
        # unit), so its tolerance scales with it
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=2e-5 * scale,
                                   err_msg=name)


def test_msda_window_switches_change_no_result(monkeypatch):
    """On the port's own plain versions each windowed branch computes the
    default branch's function, escapes included."""
    for case in sorted(CASES):
        env, kw, shapes, noise, _ = CASES[case]
        value, locs, weights, _ = _raster_case(8, shapes, noise, True)
        args = (torch.from_numpy(value), shapes, torch.from_numpy(locs),
                torch.from_numpy(weights))
        want = ms_deform_attn_core(*args)
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            got = ms_deform_attn_core(*args, raster_queries=True, **kw)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_decoder_keeps_default_branch(window_calls, monkeypatch):
    """Queries that are not the raster tokens (the decoder's) take no
    windowed branch under any switch."""
    monkeypatch.setenv("DSKD_FWIN", "1")
    monkeypatch.setenv("DSKD_WINBWD", "1")
    monkeypatch.setenv("DSKD_WINDOW_ROWS", "128")
    value, locs, weights, _ = _raster_case(9, [(16, 16), (8, 8)], 0.01,
                                           False)
    ms_deform_attn_core(torch.from_numpy(value), [(16, 16), (8, 8)],
                        torch.from_numpy(locs[:, :40]),
                        torch.from_numpy(weights[:, :40]),
                        mxu_gather_max_rows=100)
    assert window_calls == {"gather_weighted": 2}


# --- the tiny train step under each switch --------------------------------

CANVAS = 256     # levels 32x32 (1156 packed rows), 16x16 (324), 8x8, 4x4
TRAIN_SWITCHES = {
    "window_rows": {"DSKD_WINDOW_ROWS": "512"},
    "fwin": {"DSKD_FWIN": "1", "DSKD_FWIN_MARGIN": "1"},
    "winbwd": {"DSKD_WINBWD": "1", "DSKD_FWIN_MARGIN": "1"},
}
# per step (teacher and student, one encoder and one decoder layer each),
# with levels 1-3 on the small tables (DSKD_MXU_GATHER_ROWS=400): level 0
# of each encoder call takes the switch's kernel once, for its 1024 raster
# level-0 queries (window_rows) or for the segment of source level 0,
# whose 272-row window fits where level 1's 688-row one does not
TRAIN_CALLS = {
    "window_rows": {"window_gather": 2, "gather_weighted": 16},
    "fwin": {"fused_window_sample": 2, "gather_weighted": 20},
    "winbwd": {"windowed_bwd_sample": 2, "gather_weighted": 20},
}


@pytest.fixture(scope="module", params=sorted(TRAIN_SWITCHES))
def switch_run(request):
    """JAX's loss and gradients of the tiny step on the 256x256 canvas, and
    the environment that selects the switch in both packages."""
    from jax.experimental import pallas as pl

    env = {"DSKD_MXU_GATHER_ROWS": "400", **TRAIN_SWITCHES[request.param]}
    with pytest.MonkeyPatch.context() as m:
        orig = pl.pallas_call
        m.setattr(pl, "pallas_call",
                  lambda *a, **k: orig(*a, **{"interpret": True, **k}))
        m.setenv("DSKD_FORCE_MXU", "1")
        for k, v in env.items():
            m.setenv(k, v)
        run = jax_step_run(tiny_batch(hw=CANVAS))
    return request.param, env, run


@pytest.fixture
def switch_env(switch_run, window_calls, monkeypatch):
    name, env, run = switch_run
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    yield run
    assert window_calls == TRAIN_CALLS[name]


def test_train_step_losses_match_jax_under_window_switch(switch_env):
    assert_losses_match(switch_env)


def test_train_step_gradients_match_jax_under_window_switch(switch_env):
    assert_gradients_match(switch_env)
