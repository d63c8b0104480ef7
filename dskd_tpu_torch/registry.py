"""Family registry of the port: arch -> {build, init_weights, from_jax,
losses | train_step, eval_step} (port of dskd_tpu/registry.py
``register_family`` and ``get_family``).

A family's module registers one spec when it is imported, and the
dispatchers are thin lookups in it: ``train.incremental.build_model`` and
``init_variables``, ``train.family.make_family_train_step``,
``eval.evaluator.make_eval_step`` and ``apis.inference.init_detector``.
``_LAZY`` lists only the archs the port builds; any other arch raises a
ValueError that names it.

Spec keys:
  build(model_cfg, device) -> nn.Module on ``device``
  init_weights(model, seed) -> None: seeded random weights at the JAX
      package's initializer scales, in place
  from_jax(variables) -> state_dict: the JAX package's ``{"params",
      "batch_stats"}`` tree, for ``load_state_dict(strict=True)``
  losses(model, cfg, *, num_prev, has_teacher, use_dropout)
      -> losses_fn(model, batch, teacher, generator) -> losses dict; the
      generic step (``train.step.make_generic_step``) trains it
  train_step(model, cfg, *, num_prev, has_teacher, use_dropout,
      compute_dtype) -> step: a family that builds its own full step (the
      flagship) registers this instead of ``losses``
  eval_step(model, *, score_thr, max_per_img, reg_max)
      -> step(images, img_hw, scale_factors) -> detections with
      ``bboxes``, ``scores``, ``labels`` and ``valid``
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Tuple

_REGISTRY: Dict[str, Dict[str, Any]] = {}

# arch -> module that registers it on import
_LAZY = {
    "gfl_deformable_detr": "dskd_tpu_torch.models.detector",
    "deformable_detr_il": "dskd_tpu_torch.models.detector",
    "deformable_detr": "dskd_tpu_torch.models.deformable_detr",
    "detr": "dskd_tpu_torch.models.detr",
    "yolof": "dskd_tpu_torch.models.yolof",
    "yoloy": "dskd_tpu_torch.models.yoloy",
    "retinanet": "dskd_tpu_torch.models.retinanet",
    "atss": "dskd_tpu_torch.models.atss",
    "gfl": "dskd_tpu_torch.models.gfl",
    "fcos": "dskd_tpu_torch.models.fcos",
    "nasfcos": "dskd_tpu_torch.models.fcos",
    "vfnet": "dskd_tpu_torch.models.vfnet",
    "reppoints": "dskd_tpu_torch.models.reppoints",
    "ld": "dskd_tpu_torch.models.ld",
    "paa": "dskd_tpu_torch.models.paa",
    "lad": "dskd_tpu_torch.models.paa",
    "pisa_retinanet": "dskd_tpu_torch.models.retinanet",
    "retinanet_ghm": "dskd_tpu_torch.models.retinanet",
    "retinanet_fpg": "dskd_tpu_torch.models.retinanet",
    "retinanet_nasfpn": "dskd_tpu_torch.models.retinanet",
    "tood": "dskd_tpu_torch.models.tood",
    "fsaf": "dskd_tpu_torch.models.fsaf",
    "foveabox": "dskd_tpu_torch.models.foveabox",
    "autoassign": "dskd_tpu_torch.models.autoassign",
    "free_anchor": "dskd_tpu_torch.models.free_anchor",
    "sabl_retina": "dskd_tpu_torch.models.sabl_retina",
    "yolox": "dskd_tpu_torch.models.yolox",
    "yolov3": "dskd_tpu_torch.models.yolov3",
    "centernet": "dskd_tpu_torch.models.centernet",
}


def register_family(name: str, *, build, init_weights, from_jax,
                    losses=None, train_step=None, eval_step) -> None:
    if (losses is None) == (train_step is None):
        raise ValueError(f"family {name!r}: give exactly one of losses and "
                         "train_step")
    _REGISTRY[name] = dict(build=build, init_weights=init_weights,
                           from_jax=from_jax, losses=losses,
                           train_step=train_step, eval_step=eval_step)


def archs() -> Tuple[str, ...]:
    """The archs the port builds."""
    return tuple(sorted(_LAZY))


def get_family(name: str) -> Dict[str, Any]:
    """The spec of arch ``name``; an arch the port does not build raises."""
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])
    if name not in _REGISTRY:
        raise ValueError(f"the port has no arch {name!r}; it builds "
                         f"{', '.join(archs())}")
    return _REGISTRY[name]
