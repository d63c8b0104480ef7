"""Image preprocessing (port of dskd_tpu/data/pipeline.py ``preprocess``,
with the port's own copies of its ``PipelineConfig``, ``rescale_size`` and
``load_image``), on two routes:

* ``preprocess``: the test path of one image on the device, for
  ``apis.inference``;
* ``preprocess_sample``: JAX's ``preprocess(img, boxes, labels, cfg, rng,
  train)`` on the host, for the data loader's workers. With ``train=True``
  it draws from the numpy ``RandomState`` the same values in the same
  order as JAX's (flip, then the ``multi_scales`` choice), prepares the
  flipped image through ``preprocess`` on the CPU at the drawn scale,
  rescales the boxes, clips them to the valid size and pads the GT to
  ``max_gt``. The flagship recipe's options are ported, and Mosaic and
  MixUp, which the data loader applies before this (``mix_transforms``);
  every other augmentation raises NotImplementedError, naming the
  option.

Rescale to ``img_scale`` keeping the aspect ratio (``rescale_size``),
bilinear resize, normalize with the COCO mean/std, pad into the static
``bucket`` canvas. The JAX package resizes with OpenCV on the host; the port
resizes with ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` (``resize_bilinear``), on the device or on the host's
CPU, which is the same half-pixel bilinear map; it does not count on OpenCV.
A uint8 image is rounded back to whole grey levels after the resize, as
OpenCV's uint8 output is; OpenCV's fixed-point weights put it within one
grey level of this.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclass
class PipelineConfig:
    """The port's copy of dskd_tpu/data/pipeline.py ``PipelineConfig``
    (same fields and defaults); the test path reads ``img_scale``, ``mean``,
    ``std`` and ``bucket``."""
    img_scale: Tuple[int, int] = (640, 640)   # (max_long, max_short) bucket
    multi_scales: Optional[Tuple[Tuple[int, int], ...]] = None
    keep_ratio: bool = True
    flip_ratio: float = 0.5
    mean: np.ndarray = field(default_factory=lambda: IMAGENET_MEAN.copy())
    std: np.ndarray = field(default_factory=lambda: IMAGENET_STD.copy())
    max_gt: int = 100
    bucket: Tuple[int, int] = (640, 640)      # static padded canvas (H, W)
    photo_metric_distortion: bool = False
    mosaic: bool = False
    mosaic_center_ratio: Tuple[float, float] = (0.5, 1.5)
    mixup: bool = False
    mixup_ratio_range: Tuple[float, float] = (0.5, 1.5)
    expand: bool = False
    expand_ratio_range: Tuple[float, float] = (1.0, 4.0)
    min_iou_crop: bool = False
    min_ious: Tuple[float, ...] = (0.1, 0.3, 0.5, 0.7, 0.9)
    min_crop_size: float = 0.3
    resize_ratio_range: Optional[Tuple[float, float]] = None
    random_crop: Optional[Tuple[int, int]] = None   # (h, w) crop_size
    corruption: Optional[Tuple[str, int]] = None
    auto_augment: object = False
    with_mask: bool = False
    mask_stride: int = 4
    with_semantic: bool = False


def rescale_size(h: int, w: int, scale: Tuple[int, int]
                 ) -> Tuple[int, int, float]:
    """mmdet Resize keep_ratio semantics: fit (h, w) into ``scale``."""
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5), f


def load_image(path: str) -> np.ndarray:
    """Image file -> (h, w, 3) uint8 RGB array (the reference's
    to_rgb=True): the port's copy of dskd_tpu/data/pipeline.py
    ``load_image``. Decodes with OpenCV (BGR, turned to RGB) where it
    imports, else with PIL; decoding is host work, so the choice changes no
    device path. Raises FileNotFoundError for a file neither can read and
    ImportError when neither is installed."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError("load_image needs OpenCV (cv2) or PIL to decode "
                          "an image file") from None
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except OSError as err:
        raise FileNotFoundError(path) from err


def resize_bilinear(img: torch.Tensor, new_h: int, new_w: int
                    ) -> torch.Tensor:
    """(h, w, 3) image -> (new_h, new_w, 3) f32."""
    x = img.permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(new_h, new_w), mode="bilinear",
                      align_corners=False, antialias=False)[0]
    if img.dtype == torch.uint8:
        y = y.round().clamp(0, 255)
    return y.permute(1, 2, 0)


def preprocess(img: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig,
               device="cuda") -> Dict[str, torch.Tensor]:
    """One RGB (h0, w0, 3) image -> dict(image (H, W, 3) f32 normalized and
    zero-padded, img_hw (2,) int32 valid size, scale_factor (4,) f32), all on
    ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(img) if isinstance(
        img, np.ndarray) else img).to(device)
    h0, w0 = x.shape[:2]
    new_h, new_w, _ = rescale_size(h0, w0, cfg.img_scale)
    x = resize_bilinear(x, new_h, new_w)
    mean = torch.as_tensor(cfg.mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(cfg.std, dtype=torch.float32, device=device)
    x = (x - mean) / std
    H, W = cfg.bucket
    canvas = torch.zeros((H, W, 3), dtype=torch.float32, device=device)
    canvas[:new_h, :new_w] = x[:H, :W]
    w_scale, h_scale = new_w / w0, new_h / h0
    return dict(
        image=canvas,
        img_hw=torch.tensor([new_h, new_w], dtype=torch.int32, device=device),
        scale_factor=torch.tensor([w_scale, h_scale, w_scale, h_scale],
                                  dtype=torch.float32, device=device))


# PipelineConfig fields of augmentations the port lacks, with the value that
# turns each off
_UNPORTED = {"photo_metric_distortion": False,
             "expand": False, "min_iou_crop": False,
             "resize_ratio_range": None, "random_crop": None,
             "corruption": None, "auto_augment": False, "with_mask": False,
             "with_semantic": False}


def check_ported(cfg: PipelineConfig) -> None:
    """Raise NotImplementedError on an augmentation the port lacks."""
    for name, off in _UNPORTED.items():
        if getattr(cfg, name) != off:
            raise NotImplementedError(f"the pipeline option {name}="
                                      f"{getattr(cfg, name)!r} is not ported")


def preprocess_sample(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                      cfg: PipelineConfig,
                      rng: Optional[np.random.RandomState],
                      train: bool = True) -> Dict[str, np.ndarray]:
    """One sample -> static-shape numpy arrays on the host (JAX's
    ``preprocess``): dict(image (H, W, 3) f32, img_hw (2,) i32 valid shape,
    gt_bboxes (max_gt, 4), gt_labels (max_gt,), gt_valid (max_gt,),
    scale_factor (4,) f32, ori_hw (2,) i32, flip bool)."""
    check_ported(cfg)
    h0, w0 = img.shape[:2]
    flip = bool(train and rng is not None
                and rng.rand() < cfg.flip_ratio)
    if flip:
        img = img[:, ::-1]
        if len(boxes):
            x1 = w0 - boxes[:, 2]
            x2 = w0 - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], -1)

    scale = cfg.img_scale
    if train and rng is not None and cfg.multi_scales:
        scale = cfg.multi_scales[rng.randint(len(cfg.multi_scales))]
    out = {k: v.numpy() for k, v in preprocess(
        img, replace(cfg, img_scale=scale), "cpu").items()}
    new_h, new_w = (int(v) for v in out["img_hw"])
    if len(boxes):
        boxes = boxes * out["scale_factor"]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, new_w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, new_h)

    n = min(len(boxes), cfg.max_gt)
    gt_bboxes = np.zeros((cfg.max_gt, 4), np.float32)
    gt_labels = np.zeros((cfg.max_gt,), np.int32)
    gt_valid = np.zeros((cfg.max_gt,), bool)
    gt_bboxes[:n] = boxes[:n]
    gt_labels[:n] = labels[:n]
    gt_valid[:n] = True
    return dict(out, gt_bboxes=gt_bboxes, gt_labels=gt_labels,
                gt_valid=gt_valid, ori_hw=np.array([h0, w0], np.int32),
                flip=flip)
