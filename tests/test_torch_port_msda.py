"""The port's ms_deform_attn_core against dskd_tpu.ops.msda's, on both of
the JAX function's default branches: the XLA gather branch it takes on the
CPU, and the Pallas branches it takes on the TPU (pack_corners_fused for a
large level, mxu_gather_weighted for a small one) run in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.ops.msda import ms_deform_attn_core

torch.set_num_threads(1)

SHAPES = [(12, 16), (6, 8)]        # packed tables of 252 and 80 rows


def _inputs(seed, Q, B=2, H=8, D=32, P=4):
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
    return value, locs, weights


def _port(value, locs, weights):
    return ms_deform_attn_core(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs),
                               torch.from_numpy(weights)).numpy()


@pytest.mark.parametrize("seed,Q", [(0, 40), (1, 7), (2, 240)])
def test_msda_matches_jax_xla_branch(monkeypatch, seed, Q):
    from dskd_tpu.ops.msda import ms_deform_attn_core as jax_core

    monkeypatch.setenv("DSKD_FORCE_MXU", "0")
    value, locs, weights = _inputs(seed, Q)
    want = np.asarray(jax_core(jnp.asarray(value), SHAPES,
                               jnp.asarray(locs), jnp.asarray(weights)))
    got = _port(value, locs, weights)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed,Q", [(3, 40), (4, 130)])
def test_msda_matches_jax_pallas_branches(monkeypatch, seed, Q):
    from jax.experimental.pallas import tpu as pltpu

    from dskd_tpu.ops.msda import ms_deform_attn_core as jax_core

    monkeypatch.setenv("DSKD_FORCE_MXU", "1")
    monkeypatch.setenv("DSKD_PACK_KERNEL", "1")
    value, locs, weights = _inputs(seed, Q)
    # 100 rows: level 0 (252 rows) -> pack_corners_fused + XLA gather,
    # level 1 (80 rows) -> _pack_corners + mxu_gather_weighted
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(
            lambda v, l, w: jax_core(v, SHAPES, l, w,
                                     mxu_gather_max_rows=100))(
            jnp.asarray(value), jnp.asarray(locs), jnp.asarray(weights)))
    got = _port(value, locs, weights)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
