"""The tiny flagship configuration the port's training tests share: ResNet-18,
one encoder and one decoder layer, 16 queries, 10 classes, a 64x64 canvas,
B=2, GT padded to 8. Weights are the synthetic mmdet state of
test_mmdet_convert, converted for JAX by ``convert_mmdet_gfl_ddetr`` and
carried to the port by ``state_dict_from_jax``."""
import numpy as np
import torch

from dskd_tpu.utils.torch_weights import convert_mmdet_gfl_ddetr
from dskd_tpu_torch.data.batch import Batch
from dskd_tpu_torch.models.detector import GFLDeformableDETR
from dskd_tpu_torch.utils.weights import state_dict_from_jax

from test_mmdet_convert import _synthetic_mmdet_state

TINY = dict(num_classes=10, num_query=16, depth=18, num_encoder_layers=1,
            num_decoder_layers=1)
B, HW, G = 2, 64, 8


def tiny_variables(seed, cls_scale=1.0):
    """JAX ``{"params", "batch_stats"}`` of the tiny model. ``cls_scale``
    widens the class logits, so a teacher's scores are far apart and its
    top-k order is the same in both frameworks."""
    state = _synthetic_mmdet_state(num_classes=10, num_query=16, enc=1,
                                   dec=1, seed=seed)
    state["bbox_head.cls_branches.0.weight"] *= cls_scale
    params, stats = convert_mmdet_gfl_ddetr(state, depth=18)
    return {"params": params, "batch_stats": stats}


def port_model(variables, dropout=0.1):
    model = GFLDeformableDETR("cpu", dropout=dropout, **TINY)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def tiny_batch(seed=0):
    """numpy (images, img_hw, gt_bboxes, gt_labels, gt_valid)."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(B, HW, HW, 3) * 0.5).astype(np.float32)
    img_hw = np.array([[64, 64], [56, 60]], np.int32)
    xy = rng.rand(B, G, 2) * 36
    wh = rng.rand(B, G, 2) * 20 + 4
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    labels = rng.randint(0, 10, (B, G)).astype(np.int32)
    valid = np.arange(G)[None] < np.array([[5], [8]])
    return images, img_hw, gt, labels, valid


def torch_batch(arrays) -> Batch:
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in arrays))
