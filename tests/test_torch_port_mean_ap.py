"""The port's VOC mAP (``dskd_tpu_torch.eval.mean_ap``) against
dskd_tpu.eval.mean_ap: numpy on both sides, so every number agrees to 1e-7
on seeded random detections, with ignore regions, area ranges and both AP
modes, and the recall matrix and printed summary agree too."""
import numpy as np
import pytest

from dskd_tpu_torch.eval import mean_ap as TM


def _boxes(rng, n, scale=100.0):
    xy = rng.rand(n, 2) * scale
    wh = rng.rand(n, 2) * scale * 0.4 + 2.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _dataset(seed, n_img=6, n_cls=4, ignore=False):
    rng = np.random.RandomState(seed)
    dets, anns = [], []
    for _ in range(n_img):
        g = rng.randint(0, 7)
        gt = _boxes(rng, g)
        labels = rng.randint(0, n_cls, g).astype(np.int64)
        per_cls = []
        for c in range(n_cls):
            near = gt[labels == c] + rng.randn(int((labels == c).sum()), 4) \
                * 1.5
            rand = _boxes(rng, rng.randint(0, 4))
            boxes = np.concatenate([near, rand]).astype(np.float32)
            scores = rng.rand(len(boxes), 1).astype(np.float32)
            per_cls.append(np.concatenate([boxes, scores], -1))
        ann = dict(bboxes=gt, labels=labels)
        if ignore:
            k = rng.randint(0, 3)
            ann["bboxes_ignore"] = _boxes(rng, k)
            ann["labels_ignore"] = rng.randint(0, n_cls, k).astype(np.int64)
        dets.append(per_cls)
        anns.append(ann)
    return dets, anns


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k], np.float64),
                                       np.asarray(w[k], np.float64),
                                       rtol=1e-7, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["area", "11points"])
@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("scales", [None, ((0, 32), (32, 64), (64, 1e5))])
def test_eval_map_matches_jax(mode, ignore, scales):
    from dskd_tpu.eval import mean_ap as JM

    dets, anns = _dataset(1 + ignore + 2 * (scales is not None), ignore=ignore)
    for thr in (0.5, 0.75):
        want_map, want = JM.eval_map(dets, anns, scale_ranges=scales,
                                     iou_thr=thr, mode=mode)
        got_map, got = TM.eval_map(dets, anns, scale_ranges=scales,
                                   iou_thr=thr, mode=mode)
        np.testing.assert_allclose(got_map, want_map, rtol=1e-7, atol=1e-7)
        _assert_results_equal(got, want)
        assert 0.0 < np.mean(got_map) <= 1.0


def test_eval_recalls_and_summary_match_jax():
    from dskd_tpu.eval import mean_ap as JM

    rng = np.random.RandomState(4)
    gts = [_boxes(rng, rng.randint(0, 6)) for _ in range(5)]
    props = [np.concatenate([_boxes(rng, 30), rng.rand(30, 1)], -1)
             .astype(np.float32) for _ in range(4)] + [_boxes(rng, 20)]
    for nums, thrs in (((1, 5, 20), (0.3, 0.5, 0.7)), ((100,), (0.5,))):
        np.testing.assert_allclose(
            TM.eval_recalls(gts, props, nums, thrs),
            JM.eval_recalls(gts, props, nums, thrs), rtol=1e-7, atol=1e-7)
    assert not TM.eval_recalls([np.zeros((0, 4))], [_boxes(rng, 3)]).any()

    dets, anns = _dataset(7)
    mean, res = TM.eval_map(dets, anns)
    lines, want = [], []
    TM.print_map_summary(mean, res, ["a", "b", "c", "d"], log=lines.append)
    JM.print_map_summary(mean, res, ["a", "b", "c", "d"], log=want.append)
    assert lines == want and len(lines) == 4 + 4 + 1
    a = np.array([0.1, 0.4, 0.4, 0.8])
    p = np.array([1.0, 0.5, 0.6, 0.3])
    for mode in ("area", "11points"):
        np.testing.assert_allclose(TM.average_precision(a, p, mode),
                                   JM.average_precision(a, p, mode),
                                   rtol=1e-7)
    with pytest.raises(ValueError):
        TM.average_precision(a, p, "voc")
