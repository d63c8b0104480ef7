"""The HRNet backbone and HRFPN neck on the port (``models/hrnet.py``) with
FCOS against dskd_tpu.models on the CPU, cut the same way in both
packages (tests/torch_port_zoo.py: one module a stage, one block a
branch, width 8):

- the backbone's four branches in f64 (1e-8 relative, L2);
- one family step's losses and named gradients (HRFPN's reduction and
  output convs, the fuse layers) in f64 (1e-8);
- the registry's eval step (f32: labels and valid exactly, scores 1e-5,
  boxes 1e-4) and the seeded init.
"""
import pytest
import torch

import torch_port_zoo as Z

torch.set_num_threads(1)

FAMILIES = (("fcos", "hrnet_w8"),)

@pytest.fixture(autouse=True)
def _cut():
    with Z.cut():
        yield


@pytest.mark.parametrize("arch,spec,hw", [
    ("fcos", "hrnet_w8", (64, 96))])
def test_backbone_outputs_match_jax_in_f64(arch, spec, hw):
    images, img_hw = Z.canvas(*hw)
    outs = Z.check_backbone_f64(arch, spec, images, img_hw,
                                Z.jax_backbone(spec), Z.port_backbone(spec))
    assert tuple(outs[0].shape[2:]) == (hw[0] // 4, hw[1] // 4)
    assert len(outs) == 4


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_family_step_matches_jax_grad_in_f64(arch, spec):
    Z.check_family_step_f64(arch, spec, Z.GRAD_NAMES[spec])


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_eval_step_matches_jax(arch, spec):
    Z.check_eval_step(arch, spec)


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_init_weights_seeded(arch, spec):
    Z.check_init_weights(arch, spec)
