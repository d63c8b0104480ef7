"""FoveaBox on the port (``models/foveabox.py``) against
dskd_tpu.models.foveabox on the CPU, at the tiny configuration of
tests/torch_port_dense.py: every level's targets (exactly, f64), also with
two GTs of equal area whose foveas overlap, where the later one wins as
JAX's stable sort leaves it; the forward (1e-4); the losses and one
family step's named gradients in f64 (1e-8); the decode with and without
a binding per-level top-k; the registry's eval step; the seeded init."""
import jax
import numpy as np
import pytest
import torch

import torch_port_dense as D
import torch_port_dense_more as M
from dskd_tpu_torch.models import foveabox as PV

torch.set_num_threads(1)

ARCH = "foveabox"
SIZES = [(9, 11), (5, 6), (3, 3), (2, 2), (1, 1)]
GRAD_NAMES = ("bbox_head.cls_convs.3.conv.weight",
              "bbox_head.reg_convs.3.conv.weight",
              "bbox_head.cls_convs.0.conv.weight",
              "bbox_head.reg_convs.1.gn.weight",
              "bbox_head.conv_cls.weight", "bbox_head.conv_reg.weight",
              "neck.lateral_convs.0.conv.weight",
              "neck.fpn_convs.4.conv.weight")


def _fovea_targets(gt, labels, valid):
    from dskd_tpu.models import foveabox as J
    want = []
    with jax.enable_x64(True):
        for lvl, (h, w) in enumerate(SIZES):
            want.append([np.asarray(x) for x in jax.vmap(
                lambda b, lb, v: J._level_targets(
                    h, w, J.STRIDES[lvl], J.BASE_EDGES[lvl],
                    J.SCALE_RANGES[lvl][0], J.SCALE_RANGES[lvl][1], b, lb, v,
                    D.NC))(gt, labels, valid)])
    got = [PV._level_targets(h, w, lvl, *(torch.from_numpy(a) for a in (
        gt, labels, valid)), D.NC) for lvl, (h, w) in enumerate(SIZES)]
    return got, want


def test_fovea_level_targets_match_jax_exactly():
    gt, labels, valid = D.batch_arrays(1)[2:]
    got, want = _fovea_targets(gt.astype(np.float64), labels, valid)
    for lvl, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(lvl))
    assert sum(int(g[2].sum()) for g in got) > 0


def test_fovea_equal_area_gts_keep_jax_order():
    """Two GTs of equal area (sqrt 40, on P3 and P4) whose foveas overlap,
    and a larger one over both: the smaller area wins a cell, and of the
    equal two the later."""
    gt = np.array([[[10.0, 10.0, 50.0, 50.0], [18.0, 18.0, 58.0, 58.0],
                    [0.0, 0.0, 70.0, 70.0], [0.0, 0.0, 0.0, 0.0]]])
    labels = np.array([[1, 2, 3, 4]])
    valid = np.array([[True, True, True, False]])
    got, want = _fovea_targets(gt, labels, valid)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)
    lbl0 = got[0][0].reshape(9, 11)
    # on P3 the foveas span 22-38 and 30-46: the cell centred at (36, 36)
    # lies in both and goes to the later GT, (28, 28) in the first alone
    assert lbl0[4, 4] == 2 and lbl0[3, 3] == 1
    assert {int(x) for x in got[0][0][got[0][2]]} == {1, 2}


def test_forward_matches_jax():
    M.assert_forward_matches(ARCH, M.jax_variables(ARCH),
                             *M.batch_arrays(ARCH)[:2])


def test_losses_match_jax_in_f64():
    M.check_losses_f64(ARCH, rtol=M.F64_RTOL)


def test_family_step_matches_jax_grad_in_f64():
    M.check_family_step_f64(ARCH, GRAD_NAMES, rtol=M.F64_RTOL)


@pytest.mark.parametrize("nms_pre", [1000, 50])
def test_get_bboxes_matches_jax(nms_pre):
    M.check_get_bboxes(ARCH, nms_pre)


def test_eval_step_matches_jax():
    assert M.check_eval_step(ARCH).valid.any()


def test_init_weights_scales_and_seed():
    D.check_init_weights(ARCH, ("bbox_head.cls_convs.0.conv.weight",
                                "bbox_head.conv_reg.weight"),
                         "bbox_head.conv_cls", -np.log(99))
