"""The port's incremental training loop against dskd_tpu.train on the CPU.

* the slice: a two-task run of ``run_incremental`` (the tiny model of
  test_torch_port_tiny, dropout 0, two steps per task, eval on) on a
  synthetic COCO, held row by row against JAX's ``train_one_task`` on a
  one-device mesh from the same weights; ``resume_by_task`` from its
  task-1 checkpoint repeats its task-2 rows;
* checkpoints: ``find_latest_checkpoint`` against JAX's on one directory of
  names, and a save/restore round trip that resumes to the next step's
  losses bit for bit;
* hooks: ``ema_update`` and ``check_invalid_loss`` against JAX's;
* the repairs: ``apply_overrides`` (D3) gives JAX's config on the same
  strings, ``make_optimizer`` (D1) takes JAX's arguments and
  ``DistillConfig.from_flags`` (D2) takes the registry's.
"""
import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dskd_tpu.data.coco import COCO_CLASSES_ALPHA_ORDER
from dskd_tpu_torch.train import checkpoint as ckpt
from dskd_tpu_torch.train.family import make_family_train_step
from dskd_tpu_torch.train.hooks import check_invalid_loss, ema_update
from dskd_tpu_torch.train.incremental import run_incremental
from dskd_tpu_torch.train.optim import make_optimizer
from dskd_tpu_torch.train.schedule import step_lr_schedule
from dskd_tpu_torch.train.state import TrainState
from dskd_tpu_torch.utils import config as pconfig

from test_torch_port_tiny import TINY, port_model, tiny_batch, \
    tiny_variables, torch_batch

torch.set_num_threads(1)

# the first ten classes of the alphabetical order: the tiny model's 10
CATS = [cid for _, cid in COCO_CLASSES_ALPHA_ORDER[:10]]
# 48x64 and 64x48 fit the 64x64 scale unresized, so both frameworks see
# the same pixels (the cv2 / F.interpolate gap is the pipeline test's)
SHAPES = ((48, 64), (64, 48))


def _cfg(mod, root, work, num_workers):
    """The tiny two-task experiment in ``mod``'s config classes (the JAX
    package's or the port's copy)."""
    return mod.ExperimentConfig(
        model=mod.ModelConfig(dropout=0.0, **TINY),
        data=mod.DataConfig(
            train_ann=os.path.join(root, "train.json"),
            val_ann=os.path.join(root, "val.json"),
            train_img_prefix=os.path.join(root, "train"),
            val_img_prefix=os.path.join(root, "val"),
            catsplit=(5, 5), samples_per_device=2, num_workers=num_workers,
            max_gt=8, bucket=(64, 64), img_scale=(64, 64)),
        train=mod.TrainConfig(
            base_lr=1e-4, warmup_iters=2, step_epochs=(10,),
            max_iters_per_task=2, eval_interval=1, ckpt_interval=1,
            log_interval=1, use_dropout=False, seed=0, work_dir=work),
        distill=mod.DistillFlags(teacher_score_thr=0.3,
                                 teacher_max_per_img=20))


def _rows(work):
    rows = {}
    for path in glob.glob(os.path.join(work, "*.log.json")):
        for line in open(path):
            r = json.loads(line)
            rows[(r["mode"], r["task"], r["epoch"], r["iter"])] = r
    return rows


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    chip_smoke.write_coco(root, "train", SHAPES * 12, CATS, seed=0)
    chip_smoke.write_coco(root, "val", SHAPES * 3, CATS, seed=1)
    return root


@pytest.fixture(scope="module")
def port_run(coco):
    """The port's two-task run from the tiny JAX weights; its work dir."""
    work = os.path.join(coco, "port")
    run_incremental(_cfg(pconfig, coco, work, num_workers=0),
                    variables=tiny_variables(seed=31, cls_scale=4.0),
                    device="cpu")
    return work


def test_two_task_run_matches_jax_train_one_task(coco, port_run):
    from dskd_tpu.parallel.mesh import make_mesh
    from dskd_tpu.train.incremental import build_model, train_one_task
    from dskd_tpu.utils import config as jconfig

    jwork = os.path.join(coco, "jax")
    jcfg = _cfg(jconfig, coco, jwork, num_workers=2)
    mesh = make_mesh(jax.devices()[:1])
    jmodel = build_model(jcfg)
    v = train_one_task(jmodel, jcfg, 1, 2,
                       tiny_variables(seed=31, cls_scale=4.0), None, mesh)
    train_one_task(jmodel, jcfg, 2, 2, v, jax.tree.map(jnp.copy, v), mesh)

    want, got = _rows(jwork), _rows(port_run)
    assert sorted(got) == sorted(want)
    assert sorted(k[:2] for k in want if k[0] == "val") == [("val", 1),
                                                             ("val", 2)]
    for key, w in want.items():
        g = got[key]
        if key[0] == "val":
            assert set(g) == set(w)
            assert abs(g["bbox_mAP"] - w["bbox_mAP"]) <= 1e-3, key
            continue
        timing = {"img_s", "time"}
        assert set(g) - timing == set(w) - timing, key
        # f32 through a whole model: 1e-4 relative on a task's first step
        # (as test_torch_port_train_step), 1e-3 after one update; 1e-5
        # absolute is the rows' rounding to 5 decimals
        rtol = 1e-4 if key[3] == 1 else 1e-3
        for k in set(w) - timing - {"mode", "task", "epoch", "iter"}:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-5,
                                       err_msg=f"{key} {k}")
    assert want[("train", 2, 1, 1)]["loss_corr"] > 0
    for t in (1, 2):
        assert os.path.isfile(os.path.join(port_run, f"task_{t}_epoch_1",
                                           ckpt.FILE))


def test_resume_by_task_continues_from_the_checkpoint(coco, port_run):
    """resume_by_task=2 from task 1's checkpoint alone: task 1 is skipped
    and task 2 trains from the restored weights, with them as its teacher,
    to the first run's task-2 rows bit for bit (no timing keys)."""
    work = os.path.join(coco, "resume")
    shutil.copytree(os.path.join(port_run, "task_1_epoch_1"),
                    os.path.join(work, "task_1_epoch_1"))
    cfg = _cfg(pconfig, coco, work, num_workers=0)
    cfg.train.resume_by_task = 2
    # random weights: the checkpoint must replace them
    run_incremental(cfg, device="cpu")
    want, got = _rows(port_run), _rows(work)
    assert sorted(got) == sorted(k for k in want if k[1] == 2)
    for key, g in got.items():
        for k in set(g) - {"img_s", "time"}:
            assert g[k] == want[key][k], (key, k)


def test_init_detector_restores_the_task_checkpoint(coco, port_run):
    """init_detector(checkpoint=task_2_epoch_1) loads the weights the run
    saved there, in place of its seeded random ones."""
    from dskd_tpu_torch.apis.inference import init_detector

    path = os.path.join(port_run, "task_2_epoch_1")
    want = torch.load(os.path.join(path, ckpt.FILE),
                      weights_only=True)["model"]
    model, _ = init_detector(_cfg(pconfig, coco, port_run, num_workers=0),
                             path, device="cpu")
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_use_ema_returns_the_averaged_weights(coco):
    """use_ema: after one step the model holds ema_update's average of the
    initial weights and those the same step gives without EMA."""
    from dskd_tpu_torch.train.incremental import build_model, \
        init_variables, train_one_task

    def run(use_ema, work):
        cfg = _cfg(pconfig, coco, os.path.join(coco, work), num_workers=0)
        cfg.train.max_iters_per_task, cfg.train.eval_interval = 1, 0
        cfg.train.use_ema, cfg.train.ema_momentum = use_ema, 0.3
        model = init_variables(build_model(cfg, "cpu"), cfg, 0,
                               tiny_variables(seed=31, cls_scale=4.0))
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        train_one_task(model, cfg, 1, 2, device="cpu")
        return init, {k: p.detach() for k, p in model.named_parameters()}

    init, stepped = run(False, "ema_off")
    _, averaged = run(True, "ema_on")
    want = ema_update(init, stepped, 1, momentum=0.3)
    for k, p in averaged.items():
        assert torch.equal(p, want[k]), k
    assert sum(not torch.equal(p, stepped[k]) for k, p in averaged.items())


def test_find_latest_checkpoint_matches_jax(tmp_path):
    from dskd_tpu.train.checkpoint import find_latest_checkpoint as jfind

    for name in ("task_1_epoch_3", "task_1_epoch_12", "task_2_epoch_2",
                 "task_2_epoch_10", "task_10_epoch_1", "task_3_epoch_x",
                 "task_4_epoch_1.tmp", "other"):
        (tmp_path / name).mkdir()
    (tmp_path / "task_5_epoch_5").write_text("a file")
    for task in (None, 1, 2, 3, 5, 10, 11):
        assert ckpt.find_latest_checkpoint(str(tmp_path), task) == \
            jfind(str(tmp_path), task), task
    assert ckpt.find_latest_checkpoint(str(tmp_path / "none")) is None


def _tiny_step_cfg():
    cfg = pconfig.ExperimentConfig(model=pconfig.ModelConfig(dropout=0.1,
                                                             **TINY))
    cfg.distill.teacher_score_thr, cfg.distill.teacher_max_per_img = 0.3, 20
    return cfg


def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    """Two steps, save, a third step; restore into a fresh model and
    optimizer: the third step's losses and weights are the same bits
    (dropout on: the generator's state is part of the checkpoint)."""
    cfg = _tiny_step_cfg()
    teacher = port_model(tiny_variables(seed=42, cls_scale=4.0)).eval()
    batch = torch_batch(tiny_batch(seed=5))

    def fresh():
        model = port_model(tiny_variables(seed=41), dropout=0.1)
        opt = make_optimizer(model, step_lr_schedule(1e-4, warmup_iters=3))
        state = TrainState.create(model, opt, seed=7)
        step = make_family_train_step(cfg.model.arch, model, cfg, 5, True)
        return state, step

    state, step = fresh()
    for _ in range(2):
        state, _ = step(state, batch, teacher)
    ckpt.save_checkpoint(str(tmp_path), 1, 2, state)
    state, want = step(state, batch, teacher)

    state2, step2 = fresh()
    ckpt.restore_checkpoint(str(tmp_path), 1, 2, state=state2)
    assert state2.step == 2
    state2, got = step2(state2, batch, teacher)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (n, a), b in zip(state.model.named_parameters(),
                         state2.model.parameters()):
        assert torch.equal(a, b), n


def test_ema_update_matches_jax():
    from dskd_tpu.train.hooks import ema_update as jema

    rng = np.random.RandomState(0)
    ema = {"w": rng.randn(5, 3).astype(np.float32),
           "b": rng.randn(3).astype(np.float32),
           "n": np.arange(4, dtype=np.int32)}
    params = {k: (v + 1).astype(v.dtype) for k, v in ema.items()}
    for step in (0, 7, 1999):
        want = jema({k: jnp.asarray(v) for k, v in ema.items()},
                    {k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(step, jnp.int32), momentum=0.0002)
        got = ema_update({k: torch.from_numpy(v.copy())
                          for k, v in ema.items()},
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         step, momentum=0.0002)
        for k in ema:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0, err_msg=k)
        assert got["n"].dtype == torch.int32


@pytest.mark.parametrize("losses,step,interval,raises", [
    ({"loss": 1.0, "loss_cls": 0.5}, 3, 1, False),
    ({"loss": float("nan")}, 3, 1, True),
    ({"loss": float("inf")}, 50, 50, True),
    ({"loss": float("nan")}, 3, 50, False),     # not a checked step
])
def test_check_invalid_loss_matches_jax(losses, step, interval, raises):
    from dskd_tpu.train.hooks import check_invalid_loss as jcheck

    for fn in (jcheck, check_invalid_loss):
        if raises:
            with pytest.raises(FloatingPointError, match="loss"):
                fn(losses, step, interval=interval)
        else:
            fn(losses, step, interval=interval)


OVERRIDES = ["train.base_lr=1e-3", "data.catsplit=(20, 20, 40)",
             "data.aspect_buckets=None", "model.dropout=0.0",
             "data.train_ann=/tmp/a b/x.json", "distill.feats_distill=corr",
             "train.use_ema=True", "data.gt_buckets=(8, 16)"]


def test_apply_overrides_matches_jax():
    """D3: the port's copy of apply_overrides on the flagship config."""
    from dskd_tpu.utils.config import apply_overrides as japply
    from dskd_tpu.utils.config import load_config as jload

    flagship = "configs/gfl_deformable_detr_40_40_il.py"
    want = japply(jload(flagship), OVERRIDES)
    got = pconfig.apply_overrides(pconfig.load_config(flagship), OVERRIDES)
    import dataclasses
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data.catsplit == (20, 20, 40) and got.train.use_ema is True


def test_make_optimizer_takes_jax_arguments():
    """D1: weight decay, clip and frozen stages come from the caller; the
    defaults are the flagship's."""
    model = port_model(tiny_variables(seed=3))
    sched = step_lr_schedule(1e-4)
    opt = make_optimizer(model, sched)
    assert opt.max_norm == 0.1
    assert {g["weight_decay"] for g in opt.adamw.param_groups} == {1e-4}
    assert opt.labels["backbone.layer2.0.conv1.weight"] == "lr01"
    opt = make_optimizer(model, sched, weight_decay=0.05, max_norm=2.0,
                         frozen_stages=2)
    assert opt.max_norm == 2.0
    assert {g["weight_decay"] for g in opt.adamw.param_groups} == {0.05}
    assert opt.labels["backbone.layer2.0.conv1.weight"] == "frozen"
    assert opt.labels["backbone.layer3.0.conv1.weight"] == "lr01"


def test_distill_from_flags_takes_registry_arguments():
    """D2: the JAX registry's from_flags call, reg_max and
    fix_fg_grad_direction included (both values), gives JAX's values on
    the port's fields."""
    from dskd_tpu.distill.losses import DistillConfig as JDistill
    from dskd_tpu_torch.distill.losses import DistillConfig

    flags = dict(cates_distill="hard + teacher-first", locat_distill="",
                 feats_distill="corr + fg_info + decode_v1",
                 memory_distill="", num_prev=40, reg_max=8,
                 fix_fg_grad_direction=False)
    for fix in (False, True):
        kw = dict(flags, fix_fg_grad_direction=fix)
        got, want = DistillConfig.from_flags(**kw), JDistill.from_flags(**kw)
        assert got._fields == want._fields
        for k in got._fields:
            assert getattr(got, k) == getattr(want, k), k


def test_family_step_refuses_what_the_port_lacks():
    cfg = _tiny_step_cfg()
    model = port_model(tiny_variables(seed=3), dropout=0.1)
    with pytest.raises(ValueError, match="dropout 0"):
        make_family_train_step(cfg.model.arch, model, cfg, 5, True,
                               use_dropout=False)
    with pytest.raises(ValueError, match="no train step"):
        make_family_train_step("ssd", model, cfg, 5, True)
    # fix_fg_grad_direction is ported now: the step builds
    cfg.distill.fix_fg_grad_direction = True
    assert callable(make_family_train_step(cfg.model.arch, model, cfg, 5,
                                           True))


def test_entry_points_need_cuda_unless_asked_for_the_cpu(coco):
    """run_incremental and both CLIs run on the card by default: without
    CUDA they raise before any work, and say how to ask for the CPU."""
    from dskd_tpu_torch.tools import test as test_cli
    from dskd_tpu_torch.tools import train_increment

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    cfg = _cfg(pconfig, coco, os.path.join(coco, "nocuda"), num_workers=0)
    flagship = "configs/gfl_deformable_detr_40_40_il.py"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_incremental(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_increment.main([flagship, "--work-dir", cfg.train.work_dir])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main([flagship, "--work-dir", cfg.train.work_dir])
    assert not os.path.exists(cfg.train.work_dir)
