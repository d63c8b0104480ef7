"""Mosaic and MixUp on the host (port of dskd_tpu/data/mix_transforms.py
``_keep_ratio_resize``, ``mosaic`` and ``mixup``), numpy with OpenCV's
linear resize.

* ``mosaic``: four samples, each resized to fit ``img_scale`` keeping its
  aspect, pasted around a random centre of a (2H, 2W) canvas of grey 114;
  each sub-image's boxes shifted by its paste offset, clipped to the
  canvas, and those not wider and taller than ``min_bbox_size`` dropped.
* ``mixup``: the retrieved sample resized into ``dynamic_scale`` (padded
  with 114), scaled by a random jitter, flipped at random, cropped at a
  random offset to the target's size and blended 0.5 / 0.5 into it (the
  mean truncated to uint8); its boxes follow, clipped, and the empty ones
  dropped.

Both draw from the numpy ``RandomState`` the same values in the same order
as the JAX module, so that the same seed gives the same output. The resize
is OpenCV's ``INTER_LINEAR``, the JAX module's, so the outputs are equal bit
for bit; without OpenCV both transforms raise.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

PAD_VAL = 114


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """uint8 (h, w, 3) ``img`` resized to (w, h) = ``size_wh``."""
    import cv2

    return cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR)


def _keep_ratio_resize(img: np.ndarray, scale_hw: Tuple[int, int]):
    h, w = img.shape[:2]
    r = min(scale_hw[0] / h, scale_hw[1] / w)
    return resize_linear(img, (int(w * r), int(h * r))), r


def mosaic(samples: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
           img_scale: Tuple[int, int], rng: np.random.RandomState,
           center_ratio_range=(0.5, 1.5), min_bbox_size: float = 0.0):
    """Four (image, boxes (n, 4) xyxy, labels (n,)) samples -> one (2H,
    2W) mosaic (img, boxes, labels)."""
    H, W = img_scale
    canvas = np.full((2 * H, 2 * W, 3), PAD_VAL, np.uint8)
    cx = int(rng.uniform(*center_ratio_range) * W)
    cy = int(rng.uniform(*center_ratio_range) * H)

    out_boxes, out_labels = [], []
    for i, (img, boxes, labels) in enumerate(samples[:4]):
        im, r = _keep_ratio_resize(img, (H, W))
        h, w = im.shape[:2]
        if i == 0:      # top left: right and bottom edges at the centre
            x1, y1 = max(cx - w, 0), max(cy - h, 0)
            x2, y2 = cx, cy
            cx1, cy1 = w - (x2 - x1), h - (y2 - y1)
        elif i == 1:    # top right
            x1, y1 = cx, max(cy - h, 0)
            x2, y2 = min(cx + w, 2 * W), cy
            cx1, cy1 = 0, h - (y2 - y1)
        elif i == 2:    # bottom left
            x1, y1 = max(cx - w, 0), cy
            x2, y2 = cx, min(2 * H, cy + h)
            cx1, cy1 = w - (x2 - x1), 0
        else:           # bottom right
            x1, y1 = cx, cy
            x2, y2 = min(cx + w, 2 * W), min(2 * H, cy + h)
            cx1, cy1 = 0, 0
        canvas[y1:y2, x1:x2] = im[cy1:cy1 + (y2 - y1), cx1:cx1 + (x2 - x1)]
        if len(boxes):
            b = boxes.astype(np.float32) * r
            b[:, 0::2] += x1 - cx1
            b[:, 1::2] += y1 - cy1
            out_boxes.append(b)
            out_labels.append(labels)

    if out_boxes:
        boxes = np.concatenate(out_boxes, 0)
        labels = np.concatenate(out_labels, 0)
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, 2 * W)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, 2 * H)
        wh_ok = ((boxes[:, 2] - boxes[:, 0] > min_bbox_size)
                 & (boxes[:, 3] - boxes[:, 1] > min_bbox_size))
        boxes, labels = boxes[wh_ok], labels[wh_ok]
    else:
        boxes = np.empty((0, 4), np.float32)
        labels = np.empty((0,), np.int32)
    return canvas, boxes, labels


def mixup(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
          r_img: np.ndarray, r_boxes: np.ndarray, r_labels: np.ndarray,
          rng: np.random.RandomState, dynamic_scale=(640, 640),
          ratio_range=(0.5, 1.5), flip_ratio: float = 0.5):
    """Blend the retrieved sample (``r_*``) into ``img`` 0.5 / 0.5 and
    append its boxes; a retrieved sample without boxes leaves ``img`` as it
    is and draws nothing."""
    if len(r_boxes) == 0:
        return img, boxes, labels

    jit = rng.uniform(*ratio_range)
    do_flip = rng.uniform(0, 1) > flip_ratio

    out, r = _keep_ratio_resize(r_img, dynamic_scale)
    pad = np.full((dynamic_scale[0], dynamic_scale[1], 3), PAD_VAL, np.uint8)
    pad[:out.shape[0], :out.shape[1]] = out
    out = resize_linear(pad, (int(pad.shape[1] * jit),
                              int(pad.shape[0] * jit)))
    r *= jit
    if do_flip:
        out = out[:, ::-1]

    oh, ow = out.shape[:2]
    th, tw = img.shape[:2]
    padded = np.zeros((max(oh, th), max(ow, tw), 3), np.uint8)
    padded[:oh, :ow] = out
    y_off = rng.randint(0, padded.shape[0] - th + 1) \
        if padded.shape[0] > th else 0
    x_off = rng.randint(0, padded.shape[1] - tw + 1) \
        if padded.shape[1] > tw else 0
    crop = padded[y_off:y_off + th, x_off:x_off + tw]

    b = r_boxes.astype(np.float32) * r
    b[:, 0::2] = np.clip(b[:, 0::2], 0, ow)
    b[:, 1::2] = np.clip(b[:, 1::2], 0, oh)
    if do_flip:
        b[:, 0::2] = ow - b[:, 0::2][:, ::-1]
    b[:, 0::2] = np.clip(b[:, 0::2] - x_off, 0, tw)
    b[:, 1::2] = np.clip(b[:, 1::2] - y_off, 0, th)
    keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])

    mixed = (0.5 * img.astype(np.float32)
             + 0.5 * crop.astype(np.float32)).astype(img.dtype)
    return (mixed, np.concatenate([boxes.reshape(-1, 4), b[keep]], 0),
            np.concatenate([labels.reshape(-1), r_labels[keep]], 0))
