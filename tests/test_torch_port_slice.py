"""The port's serving slice against the JAX package's, at a tiny size.

ResNet-18, one encoder and two decoder layers, 12 queries, 7 classes, a
128x128 canvas and two images of different valid sizes. The JAX side is
``GFLDeformableDETR.apply`` + ``get_bboxes`` on variables converted from a
synthetic mmdet state; the port runs the same weights carried over by
``state_dict_from_jax``. On the CPU the JAX MSDA takes its XLA branch and
the port its plain twins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu.models.detector import GFLDeformableDETR as JaxDETR
from dskd_tpu.models.gfl_detr_head import get_bboxes as jax_get_bboxes
from dskd_tpu.utils.torch_weights import convert_mmdet_gfl_ddetr
from dskd_tpu_torch.core.postprocess import filter_scores_and_topk
from dskd_tpu_torch.models.detector import GFLDeformableDETR
from dskd_tpu_torch.models.gfl_detr_head import get_bboxes
from dskd_tpu_torch.utils.weights import state_dict_from_jax

from test_mmdet_convert import _synthetic_mmdet_state

torch.set_num_threads(1)

TINY = dict(num_classes=7, num_query=12, depth=18, num_encoder_layers=1,
            num_decoder_layers=2)


def _detections(det, i):
    """{(query, label): (score, box)} of image i's valid detections."""
    keep, lab, val = (np.asarray(det.keep_qid[i]), np.asarray(det.labels[i]),
                      np.asarray(det.valid[i]))
    sc, bx = np.asarray(det.scores[i]), np.asarray(det.bboxes[i])
    return {(int(q), int(c)): (float(s), b)
            for q, c, v, s, b in zip(keep, lab, val, sc, bx) if v}


def test_slice_matches_jax():
    rng = np.random.RandomState(7)
    images = (rng.randn(2, 128, 128, 3) * 0.4).astype(np.float32)
    img_hw = np.array([[128, 100], [96, 128]], np.int32)
    sf = np.array([[0.5, 0.5, 0.5, 0.5], [0.75, 0.75, 0.75, 0.75]],
                  np.float32)
    params, stats = convert_mmdet_gfl_ddetr(
        _synthetic_mmdet_state(seed=11), depth=18)
    variables = {"params": params, "batch_stats": stats}

    jmodel = JaxDETR(**TINY, remat=False)
    jout = jax.jit(lambda v, x, hw: jmodel.apply(v, x, hw,
                                                 deterministic=True))(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(images),
        jnp.asarray(img_hw))
    jdet = jax_get_bboxes(jout.head.cls_scores[-1], jout.head.bbox_preds[-1],
                          jnp.asarray(img_hw), jnp.asarray(sf), reg_max=16,
                          score_thr=0.0, max_per_img=100, rescale=True)

    model = GFLDeformableDETR("cpu", **TINY).eval()
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(images), torch.from_numpy(img_hw))
        det = get_bboxes(out.head.cls_scores[-1], out.head.bbox_preds[-1],
                         torch.from_numpy(img_hw), torch.from_numpy(sf),
                         reg_max=16, score_thr=0.0, max_per_img=100,
                         rescale=True)

    # f32 on CPU, summation orders differ between XLA and torch
    for name in ("cls_scores", "bbox_preds", "memory"):
        np.testing.assert_allclose(
            getattr(out.head, name).numpy(),
            np.asarray(getattr(jout.head, name)), rtol=1e-4, atol=1e-4,
            err_msg=name)
    for i in range(2):
        got, want = _detections(det, i), _detections(jdet, i)
        assert got.keys() == want.keys()
        for key, (s, b) in want.items():
            np.testing.assert_allclose(got[key][0], s, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[key][1], b, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", ["cut", "ties", "pad"])
def test_topk_order_matches_lax_top_k(case):
    """Same entries in the same order as lax.top_k, ties to the lower index,
    -1.0 sentinel and static size kept."""
    from dskd_tpu.core.postprocess import filter_scores_and_topk as jax_topk

    rng = np.random.RandomState(0)
    scores = rng.rand(30, 5).astype(np.float32)
    topk, thr = {"cut": (17, 0.2), "ties": (40, 0.0), "pad": (200, 0.5)}[
        case]
    if case == "ties":
        scores = np.round(scores * 4) / 4         # many exact ties
    want = jax_topk(jnp.asarray(scores), thr, topk)
    got = filter_scores_and_topk(torch.from_numpy(scores), thr, topk)
    for name in ("scores", "labels", "keep_idxs", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
