"""The PVT backbone on the port (``models/pvt.py``) with RetinaNet against
dskd_tpu.models on the CPU, cut the same way in both packages
(tests/torch_port_zoo.py):

- the backbone's outputs in f64 (1e-8 relative, L2) on 64x64 and 72x88,
  where the 56 x 56 positional embedding shrinks and the spatial
  reduction pads as flax's SAME (72x88), and on 256x320, where it grows;
- the spatial reduction's padding against ``lax.padtype_to_pads``;
- one family step's losses and named gradients in f64 (1e-8);
- the registry's eval step (f32: labels and valid exactly, scores 1e-5,
  boxes 1e-4) and the seeded init (truncated-normal embeddings).
"""
import jax
import pytest
import torch

import torch_port_zoo as Z

torch.set_num_threads(1)

FAMILIES = (("retinanet", "pvt_micro"),)

@pytest.fixture(autouse=True)
def _cut():
    with Z.cut():
        yield


@pytest.mark.parametrize("arch,spec,hw", [
    ("retinanet", "pvt_micro", (64, 64)),
    ("retinanet", "pvt_micro", (72, 88)),
    ("retinanet", "pvt_micro", (256, 320))])
def test_backbone_outputs_match_jax_in_f64(arch, spec, hw):
    images, img_hw = Z.canvas(*hw)
    outs = Z.check_backbone_f64(arch, spec, images, img_hw,
                                Z.jax_backbone(spec), Z.port_backbone(spec))
    # stage 0 is (h / 4, w / 4): the embedding of 56 x 56 shrinks on the
    # small canvases and grows on 256x320
    assert tuple(outs[0].shape[2:]) == (hw[0] // 4, hw[1] // 4)
    assert len(outs) == 4


def test_pvt_spatial_reduction_pads_as_flax_same():
    from dskd_tpu_torch.models.pvt import same_pad
    for n, k in ((18, 8), (22, 8), (16, 8), (9, 4), (5, 2), (1, 2)):
        (lo, hi), = jax.lax.padtype_to_pads((n,), (k,), (k,), "SAME")
        x = torch.rand(1, 2, n, n, dtype=torch.float64) + 1
        y = same_pad(x, k, k)
        assert tuple(y.shape[2:]) == (n + lo + hi,) * 2, (n, k)
        assert torch.equal(y[..., lo:lo + n, lo:lo + n], x)
        y[..., lo:lo + n, lo:lo + n] = 0
        assert not y.any()


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_family_step_matches_jax_grad_in_f64(arch, spec):
    Z.check_family_step_f64(arch, spec, Z.GRAD_NAMES[spec])


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_eval_step_matches_jax(arch, spec):
    Z.check_eval_step(arch, spec)


@pytest.mark.parametrize("arch,spec", FAMILIES)
def test_init_weights_seeded(arch, spec):
    sd = Z.check_init_weights(arch, spec)
    if spec.startswith("pvt"):
        pe = sd["backbone.pos_embed0"]
        assert float(pe.abs().max()) <= 0.04 + 1e-7
        assert abs(float(pe.std()) - 0.0176) < 2e-3
