"""JAX variables -> the port's ``state_dict`` (the inverses of
dskd_tpu/utils/torch_weights.py ``convert_mmdet_gfl_ddetr`` and
``convert_mmdet_detr``).

The port names its parameters after the mmdet checkpoint keys that those
converters read, so ``state_dict_from_jax`` (the flagship) and
``detr_state_dict_from_jax`` (DETR) are those converters run backwards:
Dense kernels (in, out) -> (out, in), conv HWIO -> OIHW,
MultiHeadDotProductAttention q/k/v kernels (C, H, Dh) -> packed
``in_proj_weight`` (3C, C), LayerNorm/GroupNorm/BN ``scale`` -> ``weight``,
BN ``batch_stats`` mean/var -> ``running_mean``/``running_var``.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


class _Writer:
    """Writes JAX leaves into a state_dict under mmdet keys."""

    def __init__(self):
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, key, arr):
        self.out[key] = torch.from_numpy(np.array(arr, np.float32))

    def linear(self, dst, p):
        self.put(dst + ".weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.put(dst + ".bias", p["bias"])

    def conv(self, dst, p):
        self.put(dst + ".weight",
                 np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.put(dst + ".bias", p["bias"])

    def norm(self, dst, p):
        self.put(dst + ".weight", p["scale"])
        self.put(dst + ".bias", p["bias"])

    def bn(self, dst, p, s):
        self.norm(dst, p)
        self.put(dst + ".running_mean", s["mean"])
        self.put(dst + ".running_var", s["var"])

    def mha(self, dst, attn):
        """flax ``MultiHeadDotProductAttention`` -> torch's packed
        ``in_proj_weight`` / ``in_proj_bias`` and ``out_proj``."""
        C = np.asarray(attn["query"]["kernel"]).shape[0]
        self.put(f"{dst}.in_proj_weight", np.concatenate(
            [np.asarray(attn[n]["kernel"]).reshape(C, C).T
             for n in ("query", "key", "value")], 0))
        self.put(f"{dst}.in_proj_bias", np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(C)
             for n in ("query", "key", "value")], 0))
        self.put(f"{dst}.out_proj.weight",
                 np.asarray(attn["out"]["kernel"]).reshape(C, C).T)
        self.put(f"{dst}.out_proj.bias", attn["out"]["bias"])

    def ffn(self, dst, p):
        self.linear(f"{dst}.layers.0.0", p["fc1"])
        self.linear(f"{dst}.layers.1", p["fc2"])

    def backbone(self, bp, bs):
        self.conv("backbone.conv1", bp["stem_conv"])
        self.bn("backbone.bn1", bp["stem_bn"], bs["stem_bn"])
        for name in sorted(k for k in bp if k.startswith("layer")):
            stage, block = re.fullmatch(r"layer(\d+)_block(\d+)",
                                        name).groups()
            dst = f"backbone.layer{stage}.{block}"
            for sub in sorted(bp[name]):
                if sub.startswith("conv"):
                    self.conv(f"{dst}.{sub}", bp[name][sub])
                elif sub.startswith("bn"):
                    self.bn(f"{dst}.{sub}", bp[name][sub], bs[name][sub])
            if "downsample_conv" in bp[name]:
                self.conv(f"{dst}.downsample.0", bp[name]["downsample_conv"])
                self.bn(f"{dst}.downsample.1", bp[name]["downsample_bn"],
                        bs[name]["downsample_bn"])


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of arrays -> mmdet-keyed CPU
    tensors for ``GFLDeformableDETR.load_state_dict``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    w = _Writer()
    w.backbone(params["backbone"], stats["backbone"])

    # neck
    neck = params["neck"]
    for name in neck:
        m = re.fullmatch(r"(extra_)?conv(\d+)", name)
        if m:
            dst = f"neck.{m.group(1) or ''}convs.{m.group(2)}"
            w.conv(f"{dst}.conv", neck[name])
            w.norm(f"{dst}.gn", neck[f"{m.group(1) or ''}gn{m.group(2)}"])

    # head
    hp = params["bbox_head"]
    w.put("bbox_head.query_embedding.weight", hp["query_embedding"])
    if "prototype" in hp:
        w.put("bbox_head.prototype.weight", hp["prototype"])
    w.linear("bbox_head.cls_branches.0", hp["cls_branch"])
    w.linear("bbox_head.reg_branches.0.0", hp["reg_fc0"])
    w.linear("bbox_head.reg_branches.0.2", hp["reg_fc1"])
    w.linear("bbox_head.reg_branches.0.4", hp["reg_out"])

    tp = hp["transformer"]
    tdst = "bbox_head.transformer"
    w.put(f"{tdst}.level_embeds", tp["level_embeds"])
    w.linear(f"{tdst}.reference_points", tp["reference_points"])

    def msda(dst, p):
        for lin in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            w.linear(f"{dst}.{lin}", p[lin])

    for name in tp:
        m = re.fullmatch(r"(encoder|decoder)_layer(\d+)", name)
        if not m:
            continue
        p = tp[name]
        dst = f"{tdst}.{m.group(1)}.layers.{m.group(2)}"
        if m.group(1) == "encoder":
            msda(f"{dst}.attentions.0", p["self_attn"])
            n_norms = 2
        else:
            w.mha(f"{dst}.attentions.0.attn", p["self_attn"]["attn"])
            msda(f"{dst}.attentions.1", p["cross_attn"])
            n_norms = 3
        w.ffn(f"{dst}.ffns.0", p["ffn"])
        for k in range(n_norms):
            w.norm(f"{dst}.norms.{k}", p[f"norm{k + 1}"])
    return w.out


def detr_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/detr.DETR`` variables -> mmdet-keyed CPU tensors
    for the port's ``models.detr.DETR`` (the inverse of
    ``convert_mmdet_detr``)."""
    params = variables["params"]
    w = _Writer()
    w.backbone(params["backbone"], variables.get("batch_stats",
                                                 {})["backbone"])
    w.conv("bbox_head.input_proj", params["input_proj"])
    w.put("bbox_head.query_embedding.weight", params["query_embedding"])
    tdst = "bbox_head.transformer"
    for name in params:
        m = re.fullmatch(r"(encoder|decoder)_layer(\d+)", name)
        if not m:
            continue
        p = params[name]
        dst = f"{tdst}.{m.group(1)}.layers.{m.group(2)}"
        w.mha(f"{dst}.attentions.0.attn", p["self_attn"]["attn"])
        n_norms = 2
        if m.group(1) == "decoder":
            w.mha(f"{dst}.attentions.1.attn", p["cross_attn"]["attn"])
            n_norms = 3
        w.ffn(f"{dst}.ffns.0", p["ffn"])
        for k in range(n_norms):
            w.norm(f"{dst}.norms.{k}", p[f"norm{k + 1}"])
    w.norm(f"{tdst}.decoder.post_norm", params["post_norm"])
    w.linear("bbox_head.fc_cls", params["fc_cls"])
    w.linear("bbox_head.reg_ffn.layers.0.0", params["reg_ffn0"])
    w.linear("bbox_head.reg_ffn.layers.1", params["reg_ffn1"])
    w.linear("bbox_head.fc_reg", params["fc_reg"])
    return w.out
