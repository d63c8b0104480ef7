#!/usr/bin/env python3
"""Where the dense families' f32 gradients part from the CPU's.

    python3 tools/torch_dense_grad_check.py [ARCH ...]

For each arch (default: gfl, atss; phase 15's archs too), the step that
``chip_smoke.py``'s phase 14 or 15 holds against the CPU
(``check_family_card_vs_cpu``: the config's seeded student, B=2 on
``chip_smoke.DENSE_CMP_HW``, the family's named gradients; for phase 15's
archs their kind's whole set, ``chip_smoke.VARIANT_GRAD_PARAMS``), run on
one CUDA card and on the CPU twice: in f64, where every named gradient
(the FPN lateral's, FPG's and NAS-FPN's tower convs' included) is held to
``F64_GRAD_REL_TOL``; then in f32 with cuDNN off (PyTorch's native
convolutions), so that a gap can be read without cuDNN's algorithm
choice. TF32 stays off. Prints the card's name and power limit and each
gradient's relative L2 error; a gradient past its tolerance raises.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from dskd_tpu_torch.utils.config import apply_overrides, \
    load_config  # noqa: E402


def main(archs):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"card: {card}")
    for arch in archs:
        fam = cs.FAMILIES[arch]
        if arch in cs.DENSE_CONFIGS:
            cfg = apply_overrides(load_config(cs.DENSE_CONFIGS[arch]),
                                  list(cs.DENSE_SETS))
        else:
            cfg = apply_overrides(load_config(cs.VARIANT_CONFIGS[arch]),
                                  list(cs.VARIANT_SETS))
            # the family kind's whole set, the gradients phase 15 leaves
            # out included
            fam = dict(fam, grad_params=cs.VARIANT_GRAD_PARAMS[
                cs.dense_kind(arch)])
        cs.check_family_card_vs_cpu(fam, cfg, card, torch.float64,
                                    hw=cs.DENSE_CMP_HW, tag=f"{arch} f64")
        torch.backends.cudnn.enabled = False
        try:
            cs.check_family_card_vs_cpu(fam, cfg, card, torch.float32,
                                        hw=cs.DENSE_CMP_HW,
                                        tag=f"{arch} f32 cuDNN off")
        finally:
            torch.backends.cudnn.enabled = True


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise RuntimeError("this check needs a CUDA card")
    main(sys.argv[1:] or ["gfl", "atss"])
