"""JAX variables -> the port's ``state_dict`` (the inverse of
dskd_tpu/utils/torch_weights.py ``convert_mmdet_gfl_ddetr``).

The port names its parameters after the mmdet checkpoint keys that
``convert_mmdet_gfl_ddetr`` reads, so ``state_dict_from_jax`` is exactly
that converter run backwards: Dense kernels (in, out) -> (out, in), conv
HWIO -> OIHW, MultiHeadDotProductAttention q/k/v kernels (C, H, Dh) ->
packed ``in_proj_weight`` (3C, C), LayerNorm/GroupNorm/BN ``scale`` ->
``weight``, BN ``batch_stats`` mean/var -> ``running_mean``/``running_var``.
"""
from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of arrays -> mmdet-keyed CPU
    tensors for ``GFLDeformableDETR.load_state_dict``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        out[key] = torch.from_numpy(np.array(arr, np.float32))

    def linear(dst, p):
        put(dst + ".weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            put(dst + ".bias", p["bias"])

    def conv(dst, p):
        put(dst + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(dst + ".bias", p["bias"])

    def norm(dst, p):
        put(dst + ".weight", p["scale"])
        put(dst + ".bias", p["bias"])

    def bn(dst, p, s):
        norm(dst, p)
        put(dst + ".running_mean", s["mean"])
        put(dst + ".running_var", s["var"])

    # backbone
    bp, bs = params["backbone"], stats["backbone"]
    conv("backbone.conv1", bp["stem_conv"])
    bn("backbone.bn1", bp["stem_bn"], bs["stem_bn"])
    for name in sorted(k for k in bp if k.startswith("layer")):
        stage, block = re.fullmatch(r"layer(\d+)_block(\d+)", name).groups()
        dst = f"backbone.layer{stage}.{block}"
        for sub in sorted(bp[name]):
            if sub.startswith("conv"):
                conv(f"{dst}.{sub}", bp[name][sub])
            elif sub.startswith("bn"):
                bn(f"{dst}.{sub}", bp[name][sub], bs[name][sub])
        if "downsample_conv" in bp[name]:
            conv(f"{dst}.downsample.0", bp[name]["downsample_conv"])
            bn(f"{dst}.downsample.1", bp[name]["downsample_bn"],
               bs[name]["downsample_bn"])

    # neck
    neck = params["neck"]
    for name in neck:
        m = re.fullmatch(r"(extra_)?conv(\d+)", name)
        if m:
            dst = f"neck.{m.group(1) or ''}convs.{m.group(2)}"
            conv(f"{dst}.conv", neck[name])
            norm(f"{dst}.gn", neck[f"{m.group(1) or ''}gn{m.group(2)}"])

    # head
    hp = params["bbox_head"]
    put("bbox_head.query_embedding.weight", hp["query_embedding"])
    if "prototype" in hp:
        put("bbox_head.prototype.weight", hp["prototype"])
    linear("bbox_head.cls_branches.0", hp["cls_branch"])
    linear("bbox_head.reg_branches.0.0", hp["reg_fc0"])
    linear("bbox_head.reg_branches.0.2", hp["reg_fc1"])
    linear("bbox_head.reg_branches.0.4", hp["reg_out"])

    tp = hp["transformer"]
    tdst = "bbox_head.transformer"
    put(f"{tdst}.level_embeds", tp["level_embeds"])
    linear(f"{tdst}.reference_points", tp["reference_points"])

    def msda(dst, p):
        for lin in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            linear(f"{dst}.{lin}", p[lin])

    def ffn_norms(dst, p, n_norms):
        linear(f"{dst}.ffns.0.layers.0.0", p["ffn"]["fc1"])
        linear(f"{dst}.ffns.0.layers.1", p["ffn"]["fc2"])
        for k in range(n_norms):
            norm(f"{dst}.norms.{k}", p[f"norm{k + 1}"])

    for name in tp:
        m = re.fullmatch(r"(encoder|decoder)_layer(\d+)", name)
        if not m:
            continue
        p = tp[name]
        dst = f"{tdst}.{m.group(1)}.layers.{m.group(2)}"
        if m.group(1) == "encoder":
            msda(f"{dst}.attentions.0", p["self_attn"])
            ffn_norms(dst, p, 2)
            continue
        attn = p["self_attn"]["attn"]
        C = np.asarray(attn["query"]["kernel"]).shape[0]
        put(f"{dst}.attentions.0.attn.in_proj_weight", np.concatenate(
            [np.asarray(attn[n]["kernel"]).reshape(C, C).T
             for n in ("query", "key", "value")], 0))
        put(f"{dst}.attentions.0.attn.in_proj_bias", np.concatenate(
            [np.asarray(attn[n]["bias"]).reshape(C)
             for n in ("query", "key", "value")], 0))
        put(f"{dst}.attentions.0.attn.out_proj.weight",
            np.asarray(attn["out"]["kernel"]).reshape(C, C).T)
        put(f"{dst}.attentions.0.attn.out_proj.bias", attn["out"]["bias"])
        msda(f"{dst}.attentions.1", p["cross_attn"])
        ffn_norms(dst, p, 3)
    return out
