"""The port's exact JV matcher against scipy and dskd_tpu.core.matching.

``native/lap_jv.cpp`` (through ``lap_jv_native``) and the plain-torch
``lap_jv`` are held against scipy's ``linear_sum_assignment`` and JAX's
``lap_jv`` on square, rectangular and tie-heavy costs by total cost (1e-5
relative: ties admit several optimal assignments), and by assignment where
the optimum is unique (random continuous costs). ``hungarian_assign(solver=
"jv")``, ``gfl_hungarian_assign``, ``distill_hungarian_assign``, the DETR
cost stacks and ``assign_all_layers`` under ``matcher="jv"`` are compared
with the JAX functions, vmapped over the problems.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from dskd_tpu_torch.core import matching as M
from dskd_tpu_torch.models.gfl_detr_loss import DetLossConfig, \
    assign_all_layers

from test_torch_port_matching import _assign_inputs

torch.set_num_threads(1)


def _costs(kind):
    """(N, R, C) f32 costs of one kind."""
    rng = np.random.RandomState({"square": 0, "rect": 1, "ties": 2,
                                 "flat": 3}[kind])
    if kind == "square":
        return (rng.rand(4, 12, 12) * 10).astype(np.float32)
    if kind == "rect":
        return (rng.randn(4, 9, 23) * 3).astype(np.float32)
    if kind == "ties":      # a few integer levels: many optimal assignments
        return rng.randint(0, 3, (4, 14, 20)).astype(np.float32)
    return np.ones((3, 10, 16), np.float32)    # every assignment optimal


def _total(cost, cols):
    return float(cost[np.arange(cost.shape[0]), cols].sum())


@pytest.mark.parametrize("kind", ["square", "rect", "ties", "flat"])
def test_lap_jv_total_cost_matches_scipy_and_jax(kind):
    from dskd_tpu.core.matching import lap_jv as jax_lap_jv

    cost = _costs(kind)
    native = M.lap_jv_native(torch.from_numpy(cost)).numpy()
    want_jax = np.asarray(jax.vmap(jax_lap_jv)(jnp.asarray(cost)))
    for n in range(cost.shape[0]):
        rows, cols = linear_sum_assignment(cost[n])
        best = float(cost[n][rows, cols].sum())
        plain = M.lap_jv(torch.from_numpy(cost[n])).numpy()
        for name, a in (("native", native[n]), ("plain", plain),
                        ("jax", want_jax[n])):
            assert len(set(a.tolist())) == cost.shape[1], name  # one-to-one
            assert a.min() >= 0 and a.max() < cost.shape[2], name
            np.testing.assert_allclose(_total(cost[n], a), best, rtol=1e-5,
                                       atol=1e-6, err_msg=name)
        if kind in ("square", "rect"):       # a unique optimum
            np.testing.assert_array_equal(native[n], cols)
            np.testing.assert_array_equal(plain, cols)
            np.testing.assert_array_equal(plain, want_jax[n])


def test_lap_jv_rejects_more_rows_than_columns():
    with pytest.raises(ValueError, match="R <= C"):
        M.lap_jv_native(torch.zeros(1, 5, 4))
    with pytest.raises(ValueError, match="R <= C"):
        M.lap_jv(torch.zeros(5, 4))


@pytest.mark.parametrize("Q,G", [(16, 9), (8, 14)])   # G <= Q and G > Q
def test_hungarian_assign_jv_matches_jax(Q, G):
    from dskd_tpu.core.matching import gfl_hungarian_assign as jax_gfl
    from dskd_tpu.core.matching import hungarian_assign as jax_assign

    inputs = _assign_inputs(Q * G + 1, 6, Q, G)
    t = [torch.from_numpy(a) for a in inputs]
    cost = M.gfl_match_cost(t[0], t[1], t[2], t[3], t[5])
    got = M.hungarian_assign(cost, t[4], t[3], solver="jv")
    want = jax.vmap(lambda c, v, lb: jax_assign(c, v, lb, solver="jv"))(
        jnp.asarray(cost.numpy()), jnp.asarray(inputs[4]),
        jnp.asarray(inputs[3]))
    want_gfl = jax.vmap(jax_gfl)(*(jnp.asarray(a) for a in inputs))
    got_gfl = M.gfl_hungarian_assign(*t)
    for name in ("assigned_gt", "assigned_labels", "pos_mask", "num_pos",
                 "num_fallback"):
        for g, w in ((got, want), (got_gfl, want_gfl)):
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)),
                                          err_msg=name)
    np.testing.assert_array_equal(got.pos_mask.sum(1).numpy(),
                                  np.minimum(inputs[4].sum(1), Q))
    # the exact solve is never worse than the auction on the same cost
    auc = M.hungarian_assign(cost, t[4], t[3], solver="auction")
    for res in (got, auc):
        assert res.pos_mask.sum() == got.pos_mask.sum()

    def matched_cost(res):
        q = torch.nonzero(res.pos_mask)
        return float(cost[q[:, 0], q[:, 1], res.assigned_gt[res.pos_mask]]
                     .sum())
    assert matched_cost(got) <= matched_cost(auc) + 1e-4


def test_hungarian_assign_rejects_unknown_solver():
    with pytest.raises(ValueError, match="solver"):
        M.hungarian_assign(torch.zeros(1, 4, 2), torch.ones(1, 2, dtype=bool),
                           torch.zeros(1, 2, dtype=torch.int64), solver="x")


def test_detr_costs_and_distill_assign_match_jax():
    from dskd_tpu.core import matching as JM

    Q, G = 12, 7
    logits, pred, gt, labels, valid, hw = _assign_inputs(5, 3, Q, G)
    j = [jnp.asarray(a) for a in (logits, pred, gt, labels, valid, hw)]
    t = [torch.from_numpy(a) for a in (logits, pred, gt, labels, valid, hw)]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        M.focal_loss_cost(t[0], t[3]).numpy(),
        np.asarray(jax.vmap(JM.focal_loss_cost)(j[0], j[3])), **tol)
    np.testing.assert_allclose(
        M.classification_cost(t[0], t[3]).numpy(),
        np.asarray(jax.vmap(JM.classification_cost)(j[0], j[3])), **tol)
    for kind in ("focal", "softmax"):
        want = jax.vmap(lambda *a: JM.detr_match_cost(*a, cls_cost=kind))(
            j[0], j[1], j[2], j[3], j[5])
        np.testing.assert_allclose(
            M.detr_match_cost(t[0], t[1], t[2], t[3], t[5],
                              cls_cost=kind).numpy(), np.asarray(want),
            **tol)
    want = jax.vmap(JM.distill_hungarian_assign)(*j)
    got = M.distill_hungarian_assign(*t)
    for name in ("assigned_gt", "assigned_labels", "pos_mask", "num_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_distribution_focal_loss_cost_matches_jax():
    from dskd_tpu.core.matching import distribution_focal_loss_cost as jdfl

    rng = np.random.RandomState(6)
    N, Q, G, n = 3, 5, 4, 17
    pred = rng.randn(N, Q * 4, n).astype(np.float32)
    target = (rng.rand(N, G * 4) * (n - 1)).astype(np.float32)
    want = jax.vmap(lambda p, tg: jdfl(p, tg, weight=0.5))(
        jnp.asarray(pred), jnp.asarray(target))
    got = M.distribution_focal_loss_cost(torch.from_numpy(pred),
                                         torch.from_numpy(target), 0.5)
    assert got.shape == (N, Q, G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_assign_all_layers_jv_matches_jax():
    from dskd_tpu.models.gfl_detr_loss import DetLossConfig as JDet
    from dskd_tpu.models.gfl_detr_loss import \
        assign_all_layers as jax_assign_all

    nl, B, Q, G, K = 2, 2, 10, 6, 10
    rng = np.random.RandomState(9)
    logits = (rng.randn(nl, B, Q, K) * 2).astype(np.float32)
    cxcy = rng.rand(nl, B, Q, 2) * 0.8 + 0.1
    wh = rng.rand(nl, B, Q, 2) * 0.3 + 0.02
    pred = np.concatenate([cxcy, wh], -1).astype(np.float32)
    _, _, gt, labels, valid, hw = _assign_inputs(11, B, Q, G)
    want, want_fb = jax_assign_all(
        *(jnp.asarray(a) for a in (logits, pred, gt, labels, valid, hw)),
        JDet(num_classes=K, matcher="jv"))
    got, got_fb = assign_all_layers(
        *(torch.from_numpy(a) for a in (logits, pred, gt, labels, valid,
                                        hw)),
        DetLossConfig(num_classes=K, matcher="jv"))
    assert DetLossConfig._fields == JDet._fields
    assert DetLossConfig().matcher == JDet().matcher == "auction"
    for name in ("labels", "pos_mask", "assigned_gt"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), rtol=1e-6)
    assert int(got_fb) == int(want_fb) == 0
