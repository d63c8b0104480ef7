"""The port's class-aware NMS (``dskd_tpu_torch/core/postprocess.py
batched_nms``) against ``dskd_tpu.core.postprocess.batched_nms`` on the CPU.

Clustered boxes of a few classes, so that suppression chains run several
rounds deep, with tied scores and invalid rows: the keep mask, the output
order, the scores, labels and boxes, and ``src_idx`` equal JAX's, image by
image (JAX's ``vmap``), on the port's tiled fixpoint (one tile of n <= 512
rows, tiles of 512 and of 128, where the images of a batch iterate
together) and with its plain reference, the sequential scan, in place of
the tiles. JAX takes its scan for n <= 768 and its tiles above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.core import postprocess
from dskd_tpu_torch.core.postprocess import batched_nms

torch.set_num_threads(1)


def nms_inputs(seed, B, n, n_classes=3):
    """Boxes around 12 centres per image, so neighbours overlap in chains;
    scores on a coarse grid, so many tie; the last tenth invalid."""
    rng = np.random.RandomState(seed)
    centres = rng.rand(B, 12, 2) * 200
    pick = rng.randint(0, 12, (B, n))
    xy = (np.take_along_axis(centres, pick[..., None], 1)
          + rng.randn(B, n, 2) * 4)
    wh = rng.rand(B, n, 2) * 10 + 30
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1).astype(np.float32)
    scores = (rng.randint(0, 40, (B, n)) / 40).astype(np.float32)
    labels = rng.randint(0, n_classes, (B, n)).astype(np.int32)
    valid = np.ones((B, n), bool)
    valid[:, -(n // 10):] = False
    return boxes, scores, labels, valid


def jax_nms(arrays, iou_thr, max_out):
    from dskd_tpu.core.postprocess import batched_nms as jnms
    out = jax.jit(jax.vmap(lambda b, s, l, v: jnms(b, s, l, iou_thr, max_out,
                                                   valid=v)))(
        *(jnp.asarray(a) for a in arrays))
    return [np.asarray(t) for t in out]


def keep_by_scan(monkeypatch):
    """Have batched_nms run the plain scan in place of the tiled fixpoint."""
    monkeypatch.setattr(postprocess, "_nms_keep_tiled",
                        lambda shifted, svalid, iou_thr, tile:
                        postprocess._nms_keep_scan(shifted, svalid, iou_thr))


# tiled "1": the tiled fixpoint at ``tile`` rows per tile; "0": the scan
@pytest.mark.parametrize("n,tiled,tile", [
    (300, "1", "512"),       # one tile of 300 rows (JAX: its scan)
    (1000, "1", "512"),      # two tiles (JAX: its tiles)
    (1000, "1", "128"),      # eight tiles
    (1000, "0", "512"),      # the scan
])
def test_batched_nms_matches_jax(monkeypatch, n, tiled, tile):
    monkeypatch.setattr(postprocess, "NMS_TILE", int(tile))
    if tiled == "0":
        keep_by_scan(monkeypatch)
    arrays = nms_inputs(n + int(tile), 3, n)
    want = jax_nms(arrays, 0.5, n // 2)
    b, s, lb, v = (torch.from_numpy(a) for a in arrays)
    got = batched_nms(b, s, lb, 0.5, n // 2, valid=v)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    kept = got.keep.sum(1)
    # suppression acts, and ties among the kept scores occur
    assert (kept > 5).all() and (kept < n // 4).all(), kept
    s = got.scores[0][got.keep[0]]
    assert (s[1:] == s[:-1]).any()


def test_tiled_and_scan_agree_and_leading_axes(monkeypatch):
    """The tiles and the scan give one mask; leading axes are images."""
    arrays = nms_inputs(7, 4, 900)
    t = [torch.from_numpy(a) for a in arrays]

    def nms(b, s, lb, v):
        return batched_nms(b, s, lb, 0.6, 50, valid=v)

    tiled = nms(*t)
    with monkeypatch.context() as m:
        keep_by_scan(m)
        scan = nms(*t)
    for a, b in zip(tiled, scan):
        assert torch.equal(a, b)
    one = nms(*(x[1] for x in t))
    two = nms(*(x.reshape((2, 2) + x.shape[1:]) for x in t))
    for a, b, c in zip(one, tiled, two):
        assert torch.equal(a, b[1]) and torch.equal(c.reshape(b.shape), b)
