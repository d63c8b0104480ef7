"""A two-task ``run_incremental`` of a tiny GFL (ResNet-18, FPN-256, the
full towers, 10 classes split 5+5, 64x64, one step per task with eval and
checkpoints, lr 1e-5) on the synthetic COCO of the earlier incremental
tests, held row by row against JAX's ``train_one_task`` on a one-device
mesh from the same weights (tests/torch_port_dense.py's numpy draw of the
JAX module's variables), with val mAP equal; ``init_detector`` restores
the task-2 checkpoint through the registry's eval step bit for bit. GFL's
losses read no teacher, so task 2 trains on its GT alone in both; task
2's step follows task 1's update. One step a task keeps JAX's compiles to
one a task (a second step would compile again, its state now sharded);
at 80 classes the 12 synthetic images leave a task too few for one
epoch."""
import torch

import torch_port_dense as D
from test_torch_port_yolof import run_two_tasks_against_jax

torch.set_num_threads(1)


def _cfg(mod, **train):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(arch="gfl", num_classes=D.NC, depth=18),
        train=mod.TrainConfig(**train),
        distill=mod.DistillFlags(cates_distill="", feats_distill=""))


def test_two_task_run_matches_jax_train_one_task(tmp_path):
    rows = run_two_tasks_against_jax(
        str(tmp_path), _cfg, D.jax_variables("gfl"), check_buffers=False,
        iters=1)
    assert {"loss_cls", "loss_bbox", "loss_dfl"} <= set(
        rows[("train", 2, 1, 1)])
