"""The port's batched auction matcher against dskd_tpu.core.matching.

The tie-break hash is compared bit for bit; the auction and the Hungarian
assignment are compared problem by problem with the JAX functions (vmapped)
on seeded costs without exact ties, and the auction's cost with scipy's
exact optimum, within the R * eps its single eps phase promises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from dskd_tpu_torch.core.matching import (_tie_jitter, gfl_match_cost,
                                          hungarian_assign, lap_auction)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(132, 300), (300, 132), (7, 5)])
def test_tie_jitter_is_bit_exact(shape):
    from dskd_tpu.core.matching import _tie_jitter as jax_jitter

    want = np.asarray(jax_jitter(shape))
    got = _tie_jitter(shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("masked", [False, True])
def test_lap_auction_matches_jax_and_scipy(masked):
    from dskd_tpu.core.matching import lap_auction as jax_auction

    rng = np.random.RandomState(4 + masked)
    N, R, C = 5, 20, 40
    cost = (rng.rand(N, R, C) * 10).astype(np.float32)
    mask = (np.arange(R)[None] < rng.randint(8, R + 1, (N, 1))) if masked \
        else np.ones((N, R), bool)
    want, want_fb = jax.vmap(lambda c, m: jax_auction(
        c, with_stats=True, row_mask=m))(jnp.asarray(cost), jnp.asarray(mask))
    got, got_fb = lap_auction(torch.from_numpy(cost),
                              row_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_fb.numpy(), np.asarray(want_fb))
    for n in range(N):
        a = got[n].numpy()
        assert len(set(a.tolist())) == R              # one-to-one
        live = mask[n]
        rows, cols = linear_sum_assignment(cost[n][live])
        best = cost[n][live][rows, cols].sum()
        span = cost[n].max() - cost[n].min()
        total = cost[n][np.arange(R)[live], a[live]].sum()
        assert best - 1e-4 <= total <= best + live.sum() * span / 100 + 1e-4


def test_lap_auction_completion_fallback_matches_jax():
    """Cut at a few rounds, the leftover rows take free columns in rank
    order, and the count of fallback rows matches."""
    from dskd_tpu.core.matching import lap_auction as jax_auction

    rng = np.random.RandomState(7)
    cost = np.round(rng.rand(3, 12, 15) * 2).astype(np.float32)  # contested
    want, want_fb = jax.vmap(lambda c: jax_auction(
        c, max_iters=3, with_stats=True))(jnp.asarray(cost))
    got, got_fb = lap_auction(torch.from_numpy(cost), max_iters=3)
    assert np.asarray(want_fb).sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_fb.numpy(), np.asarray(want_fb))


def _assign_inputs(seed, N, Q, G, K=10):
    rng = np.random.RandomState(seed)
    logits = rng.randn(N, Q, K).astype(np.float32) * 2
    cxcy = rng.rand(N, Q, 2) * 0.8 + 0.1
    wh = rng.rand(N, Q, 2) * 0.3 + 0.02
    pred = np.concatenate([cxcy, wh], -1).astype(np.float32)
    hw = np.tile(np.array([[64, 60]], np.int32), (N, 1))
    xy = rng.rand(N, G, 2) * 40
    gwh = rng.rand(N, G, 2) * 20 + 3
    gt = np.concatenate([xy, xy + gwh], -1).astype(np.float32)
    labels = rng.randint(0, K, (N, G)).astype(np.int32)
    valid = np.arange(G)[None] < rng.randint(1, G + 1, (N, 1))
    return logits, pred, gt, labels, valid, hw


@pytest.mark.parametrize("Q,G", [(16, 9), (8, 14)])   # G <= Q and G > Q
def test_hungarian_assign_matches_jax(Q, G):
    from dskd_tpu.core.matching import gfl_match_cost as jax_cost
    from dskd_tpu.core.matching import hungarian_assign as jax_assign

    inputs = _assign_inputs(Q * G, 6, Q, G)
    logits, pred, gt, labels, valid, hw = inputs

    def one(lg, pr, g, lb, v, h):
        return jax_assign(jax_cost(lg, pr, g, lb, h), v, lb,
                          solver="auction")

    want = jax.vmap(one)(*(jnp.asarray(a) for a in inputs))
    want_cost = jax.vmap(jax_cost)(*(jnp.asarray(a) for a in (
        logits, pred, gt, labels, hw)))
    t = [torch.from_numpy(a) for a in inputs]
    cost = gfl_match_cost(t[0], t[1], t[2], t[3], t[5])
    np.testing.assert_allclose(cost.numpy(), np.asarray(want_cost),
                               rtol=1e-5, atol=1e-5)
    got = hungarian_assign(cost, t[4], t[3], solver="auction")
    for name in ("assigned_gt", "assigned_labels", "pos_mask", "num_pos",
                 "num_fallback"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # every valid GT is matched, or every query when GT outnumber them
    np.testing.assert_array_equal(got.pos_mask.sum(1).numpy(),
                                  np.minimum(valid.sum(1), Q))
