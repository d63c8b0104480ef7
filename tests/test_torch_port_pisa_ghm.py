"""PISA and GHM RetinaNet on the port against dskd_tpu on the CPU, at the
tiny configuration of tests/torch_port_dense_more.py:

- ``isr_p_weights`` on a batch of more than ``MAX_POS`` positives with
  IoU ties (the positives past the cap keep weight 1; 1e-6), and
  ``carl_loss`` with its gradient into the class logits (f64, 1e-9);
- ``ghm_c_loss`` and ``ghm_r_loss`` over four calls of their EMA (loss
  and EMA 1e-6 relative), with the count of elements whose gradient norm
  lies within 1e-6 of a bin edge;
- each arch's losses on JAX's head outputs in f64 (1e-6 relative; GHM's
  EMAs too), one family step in f64 (losses 1e-6, named gradients 1e-5
  relative L2), the registry's eval step;
- the GHM family step's buffers over two steps (lr 0, so the weights
  stay) in f64 against JAX's losses_fn carrying its ``batch_stats``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.core import losses as PL
from dskd_tpu_torch.models import pisa as PP

torch.set_num_threads(1)

GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.retina_cls.weight", "bbox_head.retina_reg.weight",
              "neck.lateral_convs.0.conv.weight")


def _isr_inputs(seed, n_pos):
    """A flattened batch of 1200 anchors, ``n_pos`` of them positive, in 4
    classes and 12 GT; a third of the positives repeat another's box and
    target, so their IoUs tie."""
    rng = np.random.RandomState(seed)
    BN, C = 1200, 4
    pos = np.zeros(BN, bool)
    pos[rng.choice(BN, n_pos, replace=False)] = True
    cls = rng.randn(BN, C) * 2
    deltas = rng.randn(BN, 4) * 0.3
    xy = rng.rand(BN, 2) * 200
    anchors = np.concatenate([xy, xy + 16 + rng.rand(BN, 2) * 48], -1)
    tgt = rng.randn(BN, 4) * 0.3
    gt = rng.randint(0, 12, BN)
    labels = np.where(pos, gt % C, C)
    idx = np.flatnonzero(pos)
    src = idx[: len(idx) // 3]
    dst = idx[len(idx) // 3: 2 * (len(idx) // 3)]
    for a in (deltas, anchors, tgt):
        a[dst] = a[src]
    gt[dst], labels[dst] = gt[src], labels[src]
    f32 = [a.astype(np.float32) for a in (cls, deltas, anchors, tgt)]
    return f32, labels.astype(np.int32), pos, gt.astype(np.int32), C


@pytest.mark.parametrize("n_pos", [150, 300])
def test_isr_p_weights_match_jax(n_pos):
    from dskd_tpu.models import pisa as JP

    (cls, deltas, anchors, tgt), labels, pos, gt, C = _isr_inputs(0, n_pos)
    want = np.asarray(jax.jit(
        lambda *a: JP.isr_p_weights(*a, num_classes=C))(
        cls, deltas, anchors, labels, pos, gt, tgt))
    got = PP.isr_p_weights(*(torch.from_numpy(a) for a in (
        cls, deltas, anchors, labels, pos, gt, tgt)), num_classes=C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    capped = np.argsort(~pos, kind="stable")[:PP.MAX_POS]
    weighted = np.zeros_like(pos)
    weighted[capped] = True
    assert np.all(want[~pos] == 1.0)
    assert np.all(want[pos & ~weighted] == 1.0)
    assert (n_pos > PP.MAX_POS) == bool((pos & ~weighted).any())
    assert np.ptp(want[pos & weighted]) > 0.1


def test_carl_loss_and_its_classifier_gradient_match_jax():
    from dskd_tpu.models import pisa as JP

    (cls, deltas, _, tgt), labels, pos, _, C = _isr_inputs(1, 200)
    cls, deltas, tgt = (a.astype(np.float64) for a in (cls, deltas, tgt))
    with jax.enable_x64(True):
        want, (g_cls, g_d) = jax.jit(jax.value_and_grad(
            lambda c, d: JP.carl_loss(c, labels, pos, d, tgt, 37.0, C),
            argnums=(0, 1)))(cls, deltas)
    c, d = (torch.from_numpy(a).requires_grad_() for a in (cls, deltas))
    got = PP.carl_loss(c, torch.from_numpy(labels), torch.from_numpy(pos), d,
                       torch.from_numpy(tgt), 37.0, C)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-9)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(g_cls), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(g_d), rtol=1e-9,
                               atol=1e-12)
    assert np.abs(np.asarray(g_cls)[pos]).max() > 1e-4


def test_ghm_losses_and_their_ema_over_calls_match_jax():
    """Four calls of each loss, the EMA carried, in f32: the losses and
    the EMA (1e-6 relative); the calls' gradient norms include some within
    1e-6 of a bin edge, where f32 decides the bin."""
    from dskd_tpu.core import losses as JL

    rng = np.random.RandomState(3)
    acc = {"c": (jnp.zeros(30), torch.zeros(30)),
           "r": (jnp.zeros(10), torch.zeros(10))}
    near_edge = 0
    for call in range(4):
        pred = (rng.randn(400, 6) * 3).astype(np.float32)
        target = (rng.rand(400, 6) > 0.9).astype(np.float32)
        lw = (rng.rand(400, 6) > 0.1).astype(np.float32)
        g = np.abs(1 / (1 + np.exp(-pred)) - target)
        near_edge += int((np.abs(g * 30 - np.round(g * 30)) < 3e-5).sum())
        jl, jacc = JL.ghm_c_loss(pred, target, lw, bins=30, momentum=0.75,
                                 acc_sum=acc["c"][0])
        pl, pacc = PL.ghm_c_loss(*(torch.from_numpy(a) for a in (
            pred, target, lw)), bins=30, momentum=0.75, acc_sum=acc["c"][1])
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(pacc.numpy(), np.asarray(jacc), rtol=1e-6)
        acc["c"] = (jacc, pacc)

        rp = (rng.randn(300, 4) * 0.05).astype(np.float32)
        rt = (rng.randn(300, 4) * 0.05).astype(np.float32)
        rw = np.repeat(rng.rand(300, 1) > 0.5, 4, 1).astype(np.float32)
        jl, jacc = JL.ghm_r_loss(rp, rt, rw, mu=0.02, bins=10, momentum=0.7,
                                 acc_sum=acc["r"][0])
        pl, pacc = PL.ghm_r_loss(*(torch.from_numpy(a) for a in (rp, rt, rw)),
                                 mu=0.02, bins=10, momentum=0.7,
                                 acc_sum=acc["r"][1])
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(pacc.numpy(), np.asarray(jacc), rtol=1e-6)
        acc["r"] = (jacc, pacc)
    assert (np.asarray(acc["c"][0]) > 0).sum() > 5
    assert (np.asarray(acc["r"][0]) > 0).sum() > 5
    print(f"{near_edge} GHM-C elements within 1e-6 of a bin edge")


@pytest.mark.parametrize("arch", ["pisa_retinanet", "retinanet_ghm"])
def test_losses_match_jax_in_f64(arch):
    losses = M.check_losses_f64(arch)
    assert ("loss_carl" in losses) == (arch == "pisa_retinanet")


@pytest.mark.parametrize("arch", ["pisa_retinanet", "retinanet_ghm"])
def test_family_step_matches_jax_grad_in_f64(arch):
    names = GRAD_NAMES if arch == "pisa_retinanet" else GRAD_NAMES[2:]
    model, _, new_bs = M.check_family_step_f64(arch, names)
    if arch == "retinanet_ghm":
        v = M.jax_variables(arch)
        M.assert_buffers_match(model, arch, {"params": v["params"],
                                             "batch_stats": new_bs}, 1e-6)


def test_ghm_step_buffers_over_two_steps_match_jax():
    """Two port family steps in f64 at lr 0 (the weights stay, the EMAs
    move) against JAX's losses_fn applied twice in f64, its new
    batch_stats carried: both EMAs after each step (1e-6; JAX sums a bin's
    count in f32, and a bin count one off parts them by >= 0.19). In f32
    the two packages' forwards part by ~1e-6, which moves a few elements
    across a bin edge (a bin's EMA then parts by (1 - momentum) per
    element)."""
    from dskd_tpu.registry import get_family as jget
    from dskd_tpu.utils import config as jconfig
    from dskd_tpu_torch.train.family import make_family_train_step
    from dskd_tpu_torch.train.optim import make_optimizer
    from dskd_tpu_torch.train.schedule import step_lr_schedule
    from dskd_tpu_torch.train.state import TrainState
    from dskd_tpu_torch.utils import config as pconfig

    arch = "retinanet_ghm"
    v = M.jax_variables(arch)
    fn = jget(arch)["losses"](M.jax_model(arch), jconfig.ExperimentConfig(
        model=M.model_cfg(jconfig, arch)), has_teacher=False,
        use_dropout=False)
    model = M.port_model(arch, v, dtype=torch.float64)
    state = TrainState.create(model, make_optimizer(
        model, step_lr_schedule(0.0)), seed=0)
    step = make_family_train_step(
        arch, model, pconfig.ExperimentConfig(model=M.model_cfg(
            pconfig, arch)), num_prev=0, has_teacher=False)
    with jax.enable_x64(True):
        v64 = D.f64(v)
        bs = v64["batch_stats"]
        jfn = jax.jit(fn)
        for seed in (6, 7):
            arrays = list(M.batch_arrays(arch, seed))
            arrays[0] = arrays[0].astype(np.float64)
            arrays[2] = arrays[2].astype(np.float64)
            _, bs = jfn({"params": v64["params"], "batch_stats": bs},
                        D.jax_batch(arrays), None, jax.random.PRNGKey(0))
            bs = jax.tree.map(np.asarray, bs)
            state, _ = step(state, D.torch_batch(arrays))
            M.assert_buffers_match(model, arch, {"params": v["params"],
                                                 "batch_stats": bs}, 1e-6)
    assert not np.allclose(bs["ghm_acc_c"], v["batch_stats"]["ghm_acc_c"])


@pytest.mark.parametrize("arch", ["pisa_retinanet", "retinanet_ghm"])
def test_eval_step_matches_jax(arch):
    M.check_eval_step(arch)


def test_ghm_init_zeroes_the_emas():
    from dskd_tpu_torch import registry
    from dskd_tpu_torch.utils import config as pconfig

    spec = registry.get_family("retinanet_ghm")
    model = spec["build"](M.model_cfg(pconfig, "retinanet_ghm"), "cpu")
    model.ghm_acc_c.fill_(3.0)
    spec["init_weights"](model, 0)
    assert tuple(model.ghm_acc_c.shape) == (30,)
    assert tuple(model.ghm_acc_r.shape) == (10,)
    assert not model.ghm_acc_c.any() and not model.ghm_acc_r.any()
