"""The port's incremental train step against dskd_tpu.train, at the tiny
configuration of test_torch_port_tiny (dropout 0, f32 on the CPU).

With the same student and teacher weights (``state_dict_from_jax``) and the
same batch: every loss key of ``compute_losses``, teacher included, and the
gradients of every parameter against ``jax.grad``; the optimizer alone
against ``make_optimizer``'s optax chain over three updates; and a 3-step
training loop of the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.distill.losses import DistillConfig
from dskd_tpu_torch.models.gfl_detr_loss import DetLossConfig
from dskd_tpu_torch.train.optim import (Optimizer, default_param_labels,
                                        make_optimizer)
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState, frozen_copy
from dskd_tpu_torch.train.step import compute_losses, make_train_step, \
    parse_losses, teacher_info
from dskd_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_tiny import (TINY, port_model, tiny_batch, tiny_variables,
                             torch_batch)

torch.set_num_threads(1)

FLAGS = dict(cates_distill="hard + teacher-first",
             feats_distill="corr + fg_info + decode_v1", num_prev=5)
SCORE_THR, MAX_PER_IMG = 0.3, 20


def jax_step_run(arrays=None):
    """One JAX value_and_grad of the step's loss at the tiny configuration
    on ``arrays`` (default ``tiny_batch()``): the weights, batch, losses and
    gradients the port is held against."""
    from dskd_tpu.distill.losses import DistillConfig as JDistill
    from dskd_tpu.models.detector import GFLDeformableDETR as JaxDETR
    from dskd_tpu.models.gfl_detr_loss import DetLossConfig as JDet
    from dskd_tpu.train.step import Batch as JBatch
    from dskd_tpu.train.step import compute_losses as jcompute
    from dskd_tpu.train.step import parse_losses as jparse

    student = tiny_variables(seed=11)
    teacher = tiny_variables(seed=12, cls_scale=4.0)
    arrays = tiny_batch() if arrays is None else arrays
    jmodel = JaxDETR(**TINY, remat=False)
    jbatch = JBatch(*(jnp.asarray(a) for a in arrays))
    det_cfg = JDet(num_classes=10)
    dcfg = JDistill.from_flags(**FLAGS)

    def loss_fn(params):
        losses = jcompute(jmodel, {"params": params,
                                   "batch_stats": student["batch_stats"]},
                          jbatch, det_cfg, teacher, dcfg, SCORE_THR,
                          MAX_PER_IMG)
        return jparse(losses), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        student["params"])
    return dict(student=student, teacher=teacher, arrays=arrays,
                losses={k: float(v) for k, v in losses.items()},
                grads=grads)


@pytest.fixture(scope="module")
def jax_run():
    """One JAX value_and_grad of the step's loss, shared by the file."""
    return jax_step_run()


def _port_losses(run):
    model = port_model(run["student"], dropout=0.0).train()
    teacher = frozen_copy(port_model(run["teacher"]))
    batch, det_cfg = torch_batch(run["arrays"]), DetLossConfig(num_classes=10)
    tinfo = teacher_info(teacher, batch, det_cfg, SCORE_THR, MAX_PER_IMG)
    losses, _ = compute_losses(model, batch, det_cfg, tinfo,
                               DistillConfig.from_flags(**FLAGS))
    return model, losses


def assert_losses_match(run):
    """Every loss key of the port's ``compute_losses`` against JAX's."""
    _, losses = _port_losses(run)
    want = run["losses"]
    assert set(losses) == set(want)
    assert want["loss_corr"] > 0 and want["loss_fg_feature"] > 0
    for k, v in want.items():
        # f32 through a whole model: 1e-4 relative
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def assert_gradients_match(run):
    """The gradient of every parameter against ``jax.grad``."""
    model, losses = _port_losses(run)
    parse_losses(losses).backward()
    want = state_dict_from_jax({"params": run["grads"],
                                "batch_stats": run["student"][
                                    "batch_stats"]})
    frozen = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        if name.startswith(frozen):
            assert p.grad is None, name        # detached: no gradient
            assert not ref.any(), name         # stop_gradient: zeros
            continue
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        # f32 backward through a whole model: 1e-3 of the tensor's scale
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * scale,
                                   err_msg=name)


def test_compute_losses_match_jax(jax_run):
    assert_losses_match(jax_run)


def test_gradients_match_jax(jax_run):
    assert_gradients_match(jax_run)


def test_optimizer_matches_optax_chain():
    """Three updates from the same gradients: clip (active, then not),
    warmup and the 0.1x and frozen groups, against make_optimizer."""
    import optax

    from dskd_tpu.train.optim import make_optimizer as jax_make_optimizer
    from dskd_tpu.train.schedule import step_lr_schedule as jax_sched

    names = {  # port name -> JAX path
        "backbone.conv1.weight": ("backbone", "stem_conv", "kernel"),
        "backbone.layer2.0.conv1.weight": ("backbone", "layer2_block0",
                                           "conv1", "kernel"),
        "backbone.layer2.0.bn1.weight": ("backbone", "layer2_block0", "bn1",
                                         "scale"),
        "bbox_head.transformer.encoder.layers.0.attentions.0."
        "sampling_offsets.weight": ("bbox_head", "transformer",
                                    "encoder_layer0", "self_attn",
                                    "sampling_offsets", "kernel"),
        "bbox_head.cls_branches.0.weight": ("bbox_head", "cls_branch",
                                            "kernel"),
    }
    rng = np.random.RandomState(0)
    init = {n: rng.randn(4, 3).astype(np.float32) for n in names}
    grads = [{n: (rng.randn(4, 3) * s).astype(np.float32) for n in names}
             for s in (0.5, 0.005, 0.2)]

    def nest(flat):
        tree = {}
        for n, path in names.items():
            d = tree
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = jnp.asarray(flat[n])
        return tree

    def get(tree, n):
        for k in names[n]:
            tree = tree[k]
        return np.asarray(tree)

    params = nest(init)
    tx = jax_make_optimizer(params, jax_sched(1e-2, warmup_iters=2))
    opt_state = tx.init(params)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for n, v in init.items()}
    opt = Optimizer(tparams, step_lr_schedule(1e-2, warmup_iters=2), 1e-4,
                    0.1, default_param_labels())
    assert opt.labels["backbone.layer2.0.bn1.weight"] == "frozen"
    for count, g in enumerate(grads):
        upd, opt_state = tx.update(nest(g), opt_state, params)
        params = optax.apply_updates(params, upd)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step(count)
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), get(params, n),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    assert np.array_equal(tparams["backbone.conv1.weight"].detach().numpy(),
                          init["backbone.conv1.weight"])


def test_three_step_loop_trains():
    variables = tiny_variables(seed=21)
    model = port_model(variables, dropout=0.1)
    teacher = frozen_copy(port_model(tiny_variables(seed=22, cls_scale=4.0)))
    opt = make_optimizer(model, step_lr_schedule(2e-4, warmup_iters=10))
    state = TrainState.create(model, opt, seed=1)
    labels = opt.labels
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(DetLossConfig(num_classes=10),
                           DistillConfig.from_flags(**FLAGS),
                           SCORE_THR, MAX_PER_IMG)
    batch = torch_batch(tiny_batch(seed=3))
    totals = []
    for _ in range(3):
        state, losses = step(state, batch, teacher)
        assert all(torch.isfinite(v) for v in losses.values())
        totals.append(float(losses["loss"]))
    assert state.step == 3 and len(set(totals)) == 3
    for n, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        if labels[n] == "frozen":
            assert not moved, n
        elif n != "bbox_head.prototype.weight":
            # the forward never reads ``prototype``: it gets weight decay
            # alone, 2e-10 of itself in warmup, below f32's resolution
            assert moved, n
