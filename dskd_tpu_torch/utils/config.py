"""Typed experiment configuration (the port's own copy of
dskd_tpu/utils/config.py: ``ModelConfig``, ``DataConfig``, ``TrainConfig``,
``DistillFlags``, ``ExperimentConfig``, ``dskd_flagship_config``,
``update_data_root``, ``load_config`` and ``apply_overrides``, with the same
fields and defaults).

The repository's config files are Python modules that export
``get_config() -> ExperimentConfig`` and import their dataclasses with
``from dskd_tpu.utils.config import ...``. ``load_config`` runs such a file
with an ``__import__`` that resolves exactly that module to this one, so a
config loads without importing the JAX package; any other import of
``dskd_tpu`` or ``dskd_tpu.*`` raises and names the module.
"""
from __future__ import annotations

import builtins
import dataclasses
import os
import sys
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# the module the repository's config files import their dataclasses from
CONFIG_MODULE = "dskd_tpu.utils.config"


@dataclass
class ModelConfig:
    arch: str = "gfl_deformable_detr"
    num_classes: int = 80
    num_query: int = 300
    reg_max: int = 16
    depth: int = 50
    frozen_stages: int = 1
    embed_dims: int = 256
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_levels: int = 4
    dropout: float = 0.1
    dcn_stages: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    gcb_stages: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    gcb_ratio: float = 0.25
    gen_attn_stages: Tuple[bool, bool, bool, bool] = (False, False,
                                                      False, False)
    gen_attn_type: str = "1111"
    groie: bool = False
    rfp: bool = False
    sac: bool = False
    with_box_refine: bool = False
    as_two_stage: bool = False
    dyhead_blocks: int = 0
    ssd_input_size: int = 300
    num_stuff_classes: int = 53
    panoptic: bool = False
    backbone: str = ""
    backbone_ckpt: Optional[str] = None
    teacher_depth: Optional[int] = None
    remat: bool = False


@dataclass
class DataConfig:
    dataset_type: str = "coco"
    classes: Optional[Tuple[str, ...]] = None
    train_ann: str = "data/coco/annotations/instances_train2017.json"
    val_ann: str = "data/coco/annotations/instances_val2017.json"
    train_img_prefix: str = "data/coco/train2017"
    val_img_prefix: str = "data/coco/val2017"
    data_root: str = ""
    train_split: str = "trainval"
    val_split: str = "test"
    voc_year: str = "2007"
    cls_desc_file: str = ""
    hierarchy_file: str = ""
    seg_prefix: str = ""
    catsplit: Tuple[int, ...] = (40, 40)
    catpred: str = "prev-cur"
    cat_split_load: str = "auto"
    imgpercent: float = 1.0
    samples_per_device: int = 8
    num_workers: int = 8
    max_gt: int = 100
    bucket: Tuple[int, int] = (640, 640)
    img_scale: Tuple[int, int] = (640, 640)
    flip_ratio: float = 0.5
    # (portrait_hw, landscape_hw) static canvases; None = single bucket
    aspect_buckets: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
    multi_scales: Optional[Tuple[Tuple[int, int], ...]] = None
    # pad each batch's GT to the smallest bucket >= its valid-GT count
    gt_buckets: Tuple[int, ...] = ()
    photo_metric_distortion: bool = False
    mosaic: bool = False
    mixup: bool = False
    auto_augment: bool = False
    expand: bool = False
    min_iou_crop: bool = False
    resize_ratio_range: Optional[Tuple[float, float]] = None
    random_crop: Optional[Tuple[int, int]] = None


@dataclass
class TrainConfig:
    base_lr: float = 2e-4
    weight_decay: float = 1e-4
    grad_clip: float = 0.1
    warmup_iters: int = 1500
    warmup_ratio: float = 0.01
    step_epochs: Tuple[int, ...] = (8, 11)
    lr_policy: str = "step"
    min_lr_ratio: float = 0.05
    epochs_per_task: int = 12
    max_iters_per_task: int = 0
    seed: int = 42
    log_interval: int = 50
    ckpt_interval: int = 1          # epochs
    eval_interval: int = 1          # epochs; 0 = no eval during training
    resume_by_task: int = 0
    work_dir: str = "work_dirs/dskd"
    use_dropout: bool = True
    use_ema: bool = False
    ema_momentum: float = 0.0002
    no_aug_epochs: int = 0
    fsdp: bool = False


@dataclass
class DistillFlags:
    """The reference's flag-string distill recipe."""
    cates_distill: str = "hard + teacher-first"
    locat_distill: str = ""
    memory_distill: str = ""
    feats_distill: str = "corr + fg_info + decode_v1"
    teacher_score_thr: float = 0.3
    teacher_max_per_img: int = 100
    fix_fg_grad_direction: bool = False


@dataclass
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    distill: DistillFlags = field(default_factory=DistillFlags)
    test_score_thr: float = 0.0
    test_max_per_img: int = 100
    rcnn_num_proposals: int = 512
    rcnn_num_samples: int = 512


def dskd_flagship_config(catsplit=(40, 40),
                         work_dir="work_dirs/dskd") -> ExperimentConfig:
    """The flagship DSKD recipe parameterized by the class split."""
    return ExperimentConfig(
        model=ModelConfig(num_classes=80, depth=50),
        data=DataConfig(catsplit=tuple(catsplit), samples_per_device=8,
                        aspect_buckets=((640, 480), (480, 640)),
                        gt_buckets=(8, 16, 32, 64, 100)),
        train=TrainConfig(base_lr=2e-4, epochs_per_task=12,
                          step_epochs=(8, 11), work_dir=work_dir),
        distill=DistillFlags(
            cates_distill="hard + teacher-first",
            feats_distill="corr + fg_info + decode_v1",
            teacher_score_thr=0.3, teacher_max_per_img=100),
    )


def update_data_root(cfg: ExperimentConfig) -> ExperimentConfig:
    """With ``DSKD_DATASETS`` set, re-root every dataset path that begins
    with ``data/`` there."""
    root = os.environ.get("DSKD_DATASETS")
    if not root:
        return cfg
    root = root.rstrip("/") + "/"

    def rw(p: str) -> str:
        return root + p[len("data/"):] if p.startswith("data/") else p

    cfg.data = dataclasses.replace(
        cfg.data, train_ann=rw(cfg.data.train_ann),
        val_ann=rw(cfg.data.val_ann),
        train_img_prefix=rw(cfg.data.train_img_prefix),
        val_img_prefix=rw(cfg.data.val_img_prefix),
        data_root=rw(cfg.data.data_root),
        seg_prefix=rw(cfg.data.seg_prefix),
        cls_desc_file=rw(cfg.data.cls_desc_file),
        hierarchy_file=rw(cfg.data.hierarchy_file))
    return cfg


def _config_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` for config files: ``from dskd_tpu.utils.config import
    ...`` gets this module; any other import of the JAX package raises."""
    if level == 0 and name.split(".")[0] == "dskd_tpu":
        if name == CONFIG_MODULE and fromlist:
            return sys.modules[__name__]
        raise ImportError(f"a config file loaded by the port may import "
                          f"only 'from {CONFIG_MODULE} import ...' of the "
                          f"JAX package; it imports {name!r}")
    return builtins.__import__(name, globals, locals, fromlist, level)


def load_config(path: str) -> ExperimentConfig:
    """Run the config file at ``path`` and return its ``get_config()``,
    re-rooted by ``update_data_root``."""
    with open(path) as f:
        source = f.read()
    namespace = {"__name__": "exp_config", "__file__": str(path),
                 "__builtins__": {**vars(builtins),
                                  "__import__": _config_import}}
    exec(compile(source, str(path), "exec"), namespace)
    return update_data_root(namespace["get_config"]())


def apply_overrides(cfg: ExperimentConfig, overrides: Sequence[str]):
    """'a.b.c=value' dotted assignment with literal-eval values (the
    ``--set`` flag of the CLIs)."""
    import ast
    for ov in overrides:
        path, _, raw = ov.partition("=")
        keys = path.strip().split(".")
        obj = cfg
        for k in keys[:-1]:
            obj = getattr(obj, k)
        try:
            val = ast.literal_eval(raw)
        except (SyntaxError, ValueError):
            val = raw
        setattr(obj, keys[-1], val)
    return cfg
