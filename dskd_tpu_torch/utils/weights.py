"""JAX variables -> the port's ``state_dict`` (the inverses of
dskd_tpu/utils/torch_weights.py ``convert_mmdet_gfl_ddetr``,
``convert_mmdet_detr``, ``convert_mmdet_yolof``,
``convert_mmdet_retinanet`` and ``convert_mmdet_gfl``, and
``deformable_detr_state_dict_from_jax``, ``atss_state_dict_from_jax``,
``fcos_state_dict_from_jax``, ``paa_state_dict_from_jax``,
``vfnet_state_dict_from_jax``, ``reppoints_state_dict_from_jax``,
``fsaf_state_dict_from_jax``, ``foveabox_state_dict_from_jax``,
``sabl_state_dict_from_jax``, ``autoassign_state_dict_from_jax`` and
``tood_state_dict_from_jax`` under mmdet's names; ``yolox_``, ``yolov3_``
and ``centernet_state_dict_from_jax`` and the RegNetX, EfficientNet, PVT,
HRNet and MobileNetV2 backbones under JAX's own names, which
``_Writer.tree`` writes).

The port names its parameters after the mmdet checkpoint keys that those
converters read, so ``state_dict_from_jax`` (the flagship),
``detr_state_dict_from_jax`` (DETR) and ``yolof_state_dict_from_jax``
(YOLOF) are those converters run backwards, and
``yoloy_state_dict_from_jax`` (YOLOY, which JAX cannot load from mmdet)
writes mmdet's YOLOX neck and head names:
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
        """f32, or f64 where ``arr`` is (a gradient held in f64)."""
        arr = np.asarray(arr)
        self.out[key] = torch.from_numpy(np.array(
            arr, np.float64 if arr.dtype == np.float64 else np.float32))

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

    def conv_bn(self, dst, p, s):
        """A conv + ``TrainableBatchNorm`` pair -> ``{dst}.conv`` and
        ``{dst}.bn`` (mmdet's ConvModule)."""
        self.conv(f"{dst}.conv", p["conv"])
        self.bn(f"{dst}.bn", p["bn"]["bn"], s["bn"]["bn"])

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

    def channel_mapper(self, neck):
        """The ChannelMapper's convs and GroupNorms -> ``neck.convs.i`` and
        ``neck.extra_convs.i`` (``.conv``, ``.gn``)."""
        for name in neck:
            m = re.fullmatch(r"(extra_)?conv(\d+)", name)
            if m:
                dst = f"neck.{m.group(1) or ''}convs.{m.group(2)}"
                self.conv(f"{dst}.conv", neck[name])
                self.norm(f"{dst}.gn",
                          neck[f"{m.group(1) or ''}gn{m.group(2)}"])

    def msda(self, dst, p):
        for lin in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            self.linear(f"{dst}.{lin}", p[lin])

    def deformable_layers(self, tdst, tp):
        """``encoder_layer{i}`` / ``decoder_layer{i}`` of ``tp`` ->
        ``{tdst}.encoder.layers.i`` / ``{tdst}.decoder.layers.i``."""
        for name in tp:
            m = re.fullmatch(r"(encoder|decoder)_layer(\d+)", name)
            if not m:
                continue
            p = tp[name]
            dst = f"{tdst}.{m.group(1)}.layers.{m.group(2)}"
            if m.group(1) == "encoder":
                self.msda(f"{dst}.attentions.0", p["self_attn"])
                n_norms = 2
            else:
                self.mha(f"{dst}.attentions.0.attn", p["self_attn"]["attn"])
                self.msda(f"{dst}.attentions.1", p["cross_attn"])
                n_norms = 3
            self.ffn(f"{dst}.ffns.0", p["ffn"])
            for k in range(n_norms):
                self.norm(f"{dst}.norms.{k}", p[f"norm{k + 1}"])

    def tree(self, prefix, params, stats=None, renames=()):
        """Every leaf of a JAX module's ``params`` and ``stats`` subtrees
        under the port's name for it: the module path joined by ``.``
        after ``prefix``, a TrainableBatchNorm's inner ``bn`` folded into
        its parent (``x_bn/bn/scale`` -> ``x_bn.weight``), kernels ->
        ``weight`` (conv HWIO -> OIHW, dense (in, out) -> (out, in)),
        ``scale`` -> ``weight``, ``mean`` / ``var`` -> ``running_mean`` /
        ``running_var``, any other leaf (a positional embedding) as it is;
        then each ``(pattern, replacement)`` of ``renames`` in turn."""
        leaves = {"kernel": "weight", "scale": "weight",
                  "mean": "running_mean", "var": "running_var"}

        def walk(path, node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(path + (k,), v)
                    continue
                mods = list(path)
                if (len(mods) >= 2 and mods[-1] == "bn"
                        and re.search(r"bn\d*$", mods[-2])):
                    mods.pop()
                arr = np.asarray(v)
                if k == "kernel":
                    arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 \
                        else arr.T
                key = ".".join(([prefix] if prefix else []) + mods
                               + [leaves.get(k, k)])
                for pattern, repl in renames:
                    key = re.sub(pattern, repl, key)
                self.put(key, arr)

        walk((), params)
        walk((), stats or {})

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

    w.channel_mapper(params["neck"])

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

    w.deformable_layers(tdst, tp)
    return w.out


def deformable_detr_state_dict_from_jax(variables: Dict[str, Any]
                                        ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/deformable_detr.DeformableDETR`` variables ->
    mmdet-keyed CPU tensors for the port's ``models.deformable_detr.
    DeformableDETR`` (mmdet's ``deformable_detr_head.py`` names; JAX has
    no converter for this family). Without refinement JAX holds one
    ``cls_branch0`` / ``reg0_*`` set, written to every layer's index, as
    mmdet's shared branches are."""
    params = variables["params"]
    w = _Writer()
    w.backbone(params["backbone"], variables.get("batch_stats",
                                                 {})["backbone"])
    w.channel_mapper(params["neck"])
    hp = params["bbox_head"]
    tdst = "bbox_head.transformer"
    w.put(f"{tdst}.level_embeds", hp["level_embeds"])
    w.deformable_layers(tdst, hp)
    if "enc_output" in hp:
        w.linear(f"{tdst}.enc_output", hp["enc_output"])
        w.norm(f"{tdst}.enc_output_norm", hp["enc_output_norm"])
        w.linear(f"{tdst}.pos_trans", hp["pos_trans_fc"])
        w.norm(f"{tdst}.pos_trans_norm", hp["pos_trans_norm"])
    else:
        w.put("bbox_head.query_embedding.weight", hp["query_embedding"])
        w.linear(f"{tdst}.reference_points", hp["reference_points"])
    n_dec = sum(bool(re.fullmatch(r"decoder_layer\d+", k)) for k in hp)
    num_pred = n_dec + int("enc_output" in hp)
    shared = "cls_branch1" not in hp
    for i in range(num_pred):
        j = 0 if shared else i
        w.linear(f"bbox_head.cls_branches.{i}", hp[f"cls_branch{j}"])
        for k, name in ((0, "fc0"), (2, "fc1"), (4, "out")):
            w.linear(f"bbox_head.reg_branches.{i}.{k}", hp[f"reg{j}_{name}"])
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


def yolof_state_dict_from_jax(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/yolof.YOLOF`` variables -> mmdet-keyed CPU tensors
    for the port's ``models.yolof.YOLOF`` (the inverse of
    ``convert_mmdet_yolof``), the running statistics of every trainable
    BatchNorm included."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    w.backbone(params["backbone"], stats["backbone"])
    neck, nstats = params["neck"], stats["neck"]
    for name in ("lateral", "fpn"):
        w.conv(f"neck.{name}_conv", neck[f"{name}_conv"])
        w.bn(f"neck.{name}_norm", neck[f"{name}_norm"]["bn"],
             nstats[f"{name}_norm"]["bn"])
    for name in neck:
        m = re.fullmatch(r"dilated_block(\d+)", name)
        if not m:
            continue
        for c in (1, 2, 3):
            dst = f"neck.dilated_encoder_blocks.{m.group(1)}.conv{c}"
            w.conv(f"{dst}.conv", neck[name][f"conv{c}"])
            w.bn(f"{dst}.bn", neck[name][f"bn{c}"]["bn"],
                 nstats[name][f"bn{c}"]["bn"])
    head, hstats = params["bbox_head"], stats["bbox_head"]
    for name in head:
        m = re.fullmatch(r"(cls|reg)_conv(\d+)", name)
        if not m:
            continue
        kind, i = m.groups()
        dst = f"bbox_head.{'cls' if kind == 'cls' else 'bbox'}_subnet.{i}"
        w.conv(f"{dst}.conv", head[name])
        w.bn(f"{dst}.bn", head[f"{kind}_bn{i}"]["bn"],
             hstats[f"{kind}_bn{i}"]["bn"])
    for name in ("cls_score", "bbox_pred", "object_pred"):
        w.conv(f"bbox_head.{name}", head[name])
    return w.out


def yoloy_state_dict_from_jax(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/yoloy.YOLOY`` variables -> CPU tensors for the
    port's ``models.yoloy.YOLOY``: JAX's ``reduce{i}`` / ``top_down{i}``
    (i from the top level down) become ``reduce_layers`` /
    ``top_down_blocks`` in mmdet's order, ``down{i}``, ``bottom_up{i}``
    and ``out_conv{i}`` become ``downsamples``, ``bottom_up_blocks`` and
    ``out_convs``, a CSP layer's ``block{j}`` its ``blocks.{j}``, and the
    head's ``{cls,reg}_conv{l}_{i}`` and ``conv_{cls,reg,obj}{l}`` its
    ``multi_level_*`` lists."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    w.backbone(params["backbone"], stats["backbone"])
    _yoloy_neck_head(w, params, stats)
    return w.out


def _yoloy_neck_head(w: _Writer, params, stats) -> None:
    """YOLOY's (and YOLOX's) PAFPN and decoupled head, as
    ``yoloy_state_dict_from_jax`` names them."""
    neck, nstats = params["neck"], stats["neck"]
    top = max(int(n[len("reduce"):]) for n in neck if n.startswith("reduce"))

    def csp(dst, p, s):
        for sub in ("main_conv", "short_conv", "final_conv"):
            w.conv_bn(f"{dst}.{sub}", p[sub], s[sub])
        for name in p:
            m = re.fullmatch(r"block(\d+)", name)
            if m:
                for c in ("conv1", "conv2"):
                    w.conv_bn(f"{dst}.blocks.{m.group(1)}.{c}", p[name][c],
                              s[name][c])

    for name in neck:
        m = re.fullmatch(r"(reduce|top_down|down|bottom_up|out_conv)(\d+)",
                         name)
        kind, i = m.group(1), int(m.group(2))
        if kind == "reduce":
            w.conv_bn(f"neck.reduce_layers.{top - i}", neck[name],
                      nstats[name])
        elif kind == "top_down":
            csp(f"neck.top_down_blocks.{top - i}", neck[name], nstats[name])
        elif kind == "down":
            w.conv_bn(f"neck.downsamples.{i}", neck[name], nstats[name])
        elif kind == "bottom_up":
            csp(f"neck.bottom_up_blocks.{i}", neck[name], nstats[name])
        else:
            w.conv_bn(f"neck.out_convs.{i}", neck[name], nstats[name])
    head, hstats = params["bbox_head"], stats["bbox_head"]
    for name in head:
        m = re.fullmatch(r"(cls|reg)_conv(\d+)_(\d+)", name)
        if m:
            kind, lvl, i = m.groups()
            w.conv_bn(f"bbox_head.multi_level_{kind}_convs.{lvl}.{i}",
                      head[name], hstats[name])
            continue
        m = re.fullmatch(r"conv_(cls|reg|obj)(\d+)", name)
        w.conv(f"bbox_head.multi_level_conv_{m.group(1)}.{m.group(2)}",
               head[name])


def yolox_state_dict_from_jax(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/yolox.YOLOX`` variables -> CPU tensors for the
    port's ``models.yolox.YOLOX``: CSPDarknet under JAX's names (a CSP
    layer's ``block{j}`` as ``blocks.{j}``), the PAFPN and head as
    YOLOY's."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    w.tree("backbone", params["backbone"], stats["backbone"],
           ((r"\.block(\d+)\.", r".blocks.\1."),))
    _yoloy_neck_head(w, params, stats)
    return w.out


def yolov3_state_dict_from_jax(variables: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/yolov3.YOLOV3`` variables (Darknet-53 or
    MobileNetV2) -> CPU tensors for the port's ``models.yolov3.YOLOV3``,
    which keeps JAX's names throughout."""
    w = _Writer()
    w.tree("", variables["params"], variables["batch_stats"])
    return w.out


def centernet_state_dict_from_jax(variables: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/centernet.CenterNet`` variables -> CPU tensors for
    the port's ``models.centernet.CenterNet``: the ResNet under
    torchvision's names, the neck and head under JAX's. flax's
    ``ConvTranspose`` does not flip its (kh, kw, in, out) kernel, which
    ``nn.ConvTranspose2d`` does: its weight (in, out, kh, kw) is the
    kernel flipped in both spatial axes."""
    params, stats = variables["params"], variables["batch_stats"]
    w = _Writer()
    w.backbone(params["backbone"], stats["backbone"])
    w.tree("neck", params["neck"], stats["neck"])
    w.tree("bbox_head", params["bbox_head"])
    for name, p in params["neck"].items():
        if name.startswith("deconv") and "kernel" in p:
            k = np.asarray(p["kernel"])
            w.put(f"neck.{name}.weight", k[::-1, ::-1].transpose(2, 3, 0, 1))
    return w.out


# HRNet's bottlenecks are the port's ResNet blocks
_HRNET_RENAMES = ((r"\.downsample_conv\.", ".downsample.0."),
                  (r"\.downsample_bn\.", ".downsample.1."))


def write_backbone(w: _Writer, bp, bs) -> None:
    """A JAX backbone's variables -> ``backbone.*``: ResNet's (a 7x7 stem)
    under torchvision's names (``_Writer.backbone``), the others under
    JAX's own (``_Writer.tree``), HRNet's bottleneck projections as
    ``downsample.0/1``."""
    stem = bp.get("stem_conv", {}).get("kernel")
    if stem is not None and np.asarray(stem).shape[0] == 7:
        w.backbone(bp, bs)
    else:
        w.tree("backbone", bp, bs,
               _HRNET_RENAMES if "stem_conv1" in bp else ())


def _fpn(w: _Writer, neck, stats=None) -> None:
    """JAX's FPN ``lateral{i}``, ``fpn_conv{i}`` and ``extra_conv{j}`` ->
    ``neck.lateral_convs.i.conv`` and ``neck.fpn_convs.k.conv``, the extra
    convs after the outputs' (mmdet's ``fpn_convs.{3,4}`` at P3-P7); the
    BatchNorms of ``norm="bn"`` (``lateral_gn{i}``, ``fpn_gn{i}``,
    ``extra_gn{j}``) -> the same ConvModules' ``.bn``."""
    n = sum(bool(re.fullmatch(r"lateral\d+", k)) for k in neck)
    for name, p in neck.items():
        m = re.fullmatch(r"(lateral|fpn|extra)(_conv|_gn|)(\d+)", name)
        kind, part, i = m.group(1), m.group(2), int(m.group(3))
        dst = (f"neck.lateral_convs.{i}" if kind == "lateral" else
               f"neck.fpn_convs.{i + n * (kind == 'extra')}")
        if part == "_gn":
            w.bn(f"{dst}.bn", p, stats[name])
        else:
            w.conv(f"{dst}.conv", p)


def _hrfpn(w: _Writer, neck, stats=None) -> None:
    """JAX's HRFPN (``reduction_conv``, ``fpn_conv{i}``) under its own
    names."""
    w.tree("neck", neck)


_FPG_TRANSITIONS = {"same_up": "same_up", "lateral": "across_lateral",
                    "across_down": "across_down", "skip": "across_skip"}


def _fpg(w: _Writer, neck, stats=None) -> None:
    """JAX's FPG ``lateral{i}``, ``extra_down{e}``, ``s{i}_l{l}_<kind>`` and
    ``out{l}`` (each transition a ``conv`` and a ``gn``) ->
    ``neck.lateral_convs.i``, ``neck.extra_downsamples.e``,
    ``neck.fpn_transitions.i.l.<mmdet kind>`` and
    ``neck.output_transition.l``."""
    for name, p in neck.items():
        m = re.fullmatch(r"(lateral|extra_down)(\d+)", name)
        if m:
            dst = {"lateral": "lateral_convs",
                   "extra_down": "extra_downsamples"}[m.group(1)]
            w.conv(f"neck.{dst}.{m.group(2)}", p)
            continue
        m = re.fullmatch(r"s(\d+)_l(\d+)_(same_up|lateral|across_down|skip)",
                         name)
        if m:
            dst = (f"neck.fpn_transitions.{m.group(1)}.{m.group(2)}."
                   f"{_FPG_TRANSITIONS[m.group(3)]}")
        else:
            lvl = re.fullmatch(r"out(\d+)", name).group(1)
            dst = f"neck.output_transition.{lvl}"
        w.conv(f"{dst}.conv", p["conv"])
        w.norm(f"{dst}.gn", p["gn"])


def _nasfpn(w: _Writer, neck, stats) -> None:
    """JAX's NAS-FPN ``lateral{i}`` / ``lateral_bn{i}``, ``extra{j}`` /
    ``extra_bn{j}`` and ``s{s}_<cell>`` (``out_conv``, ``out_bn``) ->
    ``neck.lateral_convs.i``, ``neck.extra_downsamples.j`` and
    ``neck.fpn_stages.s.<cell>.out_conv`` (``.conv``, ``.bn``), the
    BatchNorms' running statistics included."""
    for name, p in neck.items():
        m = re.fullmatch(r"(lateral|extra)(_bn)?(\d+)", name)
        if m:
            dst = {"lateral": "lateral_convs",
                   "extra": "extra_downsamples"}[m.group(1)]
            dst = f"neck.{dst}.{m.group(3)}"
            if m.group(2):
                w.bn(f"{dst}.bn", p, stats[name])
            else:
                w.conv(f"{dst}.conv", p)
            continue
        stage, cell = re.fullmatch(r"s(\d+)_(\w+)", name).groups()
        dst = f"neck.fpn_stages.{stage}.{cell}.out_conv"
        w.conv(f"{dst}.conv", p["out_conv"])
        w.bn(f"{dst}.bn", p["out_bn"], stats[name]["out_bn"])


def _dense(variables, outputs, gn: bool, neck=_fpn, extra=None
           ) -> Dict[str, torch.Tensor]:
    """A ResNet + neck (``neck`` writes it: FPN's by default) + dense head
    of JAX's: the towers ``{cls,reg}_conv{i}`` (and ``_gn{i}``) ->
    ``bbox_head.{cls,reg}_convs.i.conv`` (``.gn``), RetinaSepBNHead's
    ``{cls,reg}_bn{i}_lvl{l}`` -> ``bbox_head.{cls,reg}_norms.l.i``, the
    ``outputs`` convs under their own names, ``scale{l}`` ->
    ``bbox_head.scales.l.scale``; GHM's EMAs in ``batch_stats`` ->
    ``ghm_acc_c`` / ``ghm_acc_r``. ``extra(w, name, p)`` writes a head
    parameter of the family's own and says whether it did."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    w = _Writer()
    write_backbone(w, params["backbone"], stats.get("backbone", {}))
    neck(w, params["neck"], stats.get("neck", {}))
    head, hstats = params["bbox_head"], stats.get("bbox_head", {})
    for name, p in head.items():
        if extra is not None and extra(w, name, p):
            continue
        m = re.fullmatch(r"(cls|reg)_(conv|gn)(\d+)", name)
        if m:
            kind, part, i = m.groups()
            dst = f"bbox_head.{kind}_convs.{i}.{part}"
            if part == "conv":
                w.conv(dst, p)
            else:
                w.norm(dst, p)
            continue
        m = re.fullmatch(r"(cls|reg)_bn(\d+)_lvl(\d+)", name)
        if m:
            kind, i, lvl = m.groups()
            w.bn(f"bbox_head.{kind}_norms.{lvl}.{i}", p, hstats[name])
            continue
        m = re.fullmatch(r"scale(\d+)", name)
        if m:
            w.put(f"bbox_head.scales.{m.group(1)}.scale", p["scale"])
        elif name in outputs:
            w.conv(f"bbox_head.{name}", p)
        else:
            raise KeyError(f"unexpected head parameter {name!r}")
    if gn != any("_gn" in k for k in head):
        raise KeyError("the head's GroupNorms do not match the family")
    for name in ("ghm_acc_c", "ghm_acc_r"):
        if name in stats:
            w.put(name, stats[name])
    return w.out


def retinanet_state_dict_from_jax(variables: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/retinanet.RetinaNet`` variables -> CPU tensors for
    the port's ``models.retinanet.RetinaNet``, every variant: mmdet's names
    with the FPN (the inverse of ``convert_mmdet_retinanet``), FPG's or
    NAS-FPN's neck by its parameter names, the SepBN head's per-level
    BatchNorms and GHM's EMAs."""
    neck = variables["params"]["neck"]
    writer = (_fpg if "extra_down0" in neck else
              _nasfpn if "lateral_bn0" in neck else
              _hrfpn if "reduction_conv" in neck else _fpn)
    return _dense(variables, ("retina_cls", "retina_reg"), gn=False,
                  neck=writer)


def _dyhead(w: _Writer, dyhead) -> None:
    """JAX's DyHead ``block{i}`` -> ``dyhead.dyhead_blocks.i``: the three
    ``spatial_conv_*`` kernels and GroupNorms (``.conv``, ``.norm``), the
    offset conv, ``scale_attn_conv`` -> ``scale_attn_module.1`` and
    ``task_attn`` -> ``task_attn_module.conv{1,2}.conv``."""
    for name, blk in dyhead.items():
        dst = "dyhead.dyhead_blocks." + re.fullmatch(r"block(\d+)", name)[1]
        for part in ("high", "mid", "low"):
            p = blk[f"spatial_conv_{part}"]
            w.conv(f"{dst}.spatial_conv_{part}.conv", p)
            w.norm(f"{dst}.spatial_conv_{part}.norm", p["gn"])
        w.conv(f"{dst}.spatial_conv_offset", blk["spatial_conv_offset"])
        w.conv(f"{dst}.scale_attn_module.1", blk["scale_attn_conv"])
        for c in ("conv1", "conv2"):
            w.conv(f"{dst}.task_attn_module.{c}.conv", blk["task_attn"][c])


def atss_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/atss.ATSS`` variables -> mmdet-keyed CPU tensors
    for the port's ``models.atss.ATSS`` (mmdet's ``atss_head.py`` names;
    ATSS-DyHead's blocks under ``dyhead.``, and its head without towers
    has no GroupNorm)."""
    dyhead = variables["params"].get("dyhead")
    out = _dense(variables, ("atss_cls", "atss_reg", "atss_centerness"),
                 gn=dyhead is None)
    if dyhead is not None:
        w = _Writer()
        _dyhead(w, dyhead)
        out.update(w.out)
    return out


def gfl_state_dict_from_jax(variables: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/gfl.GFL`` variables -> mmdet-keyed CPU tensors for
    the port's ``models.gfl.GFL`` (the inverse of ``convert_mmdet_gfl``)."""
    return _dense(variables, ("gfl_cls", "gfl_reg"), gn=True)


def _nasfcos(w: _Writer, neck, stats) -> None:
    """JAX's NAS-FCOS neck ``adapt{i}`` / ``adapt_bn{i}``, the cells
    ``<cell>`` (``in{1,2}_conv``, ``in{1,2}_gn``, ``out_bn``, ``out_conv``)
    and ``extra_down{j}`` -> ``neck.adapt_convs.i`` (``.conv``, ``.bn``),
    ``neck.fpn.<cell>.input{1,2}_conv`` (``.conv``, ``.gn``),
    ``neck.fpn.<cell>.out_conv`` (``.bn``, ``.conv``) and
    ``neck.extra_downsamples.j.conv``, the BatchNorms' running statistics
    included. The grouped 1x1 ``out_conv`` kernel (1, 1, 2, C) becomes
    (C, 2, 1, 1): output c reads the concat's channels 2c and 2c + 1."""
    for name, p in neck.items():
        m = re.fullmatch(r"(adapt|adapt_bn|extra_down)(\d+)", name)
        if m:
            kind, i = m.groups()
            if kind == "adapt":
                w.conv(f"neck.adapt_convs.{i}.conv", p)
            elif kind == "adapt_bn":
                w.bn(f"neck.adapt_convs.{i}.bn", p, stats[name])
            else:
                w.conv(f"neck.extra_downsamples.{i}.conv", p)
            continue
        dst = f"neck.fpn.{name}"
        for k in ("1", "2"):
            w.conv(f"{dst}.input{k}_conv.conv", p[f"in{k}_conv"])
            w.norm(f"{dst}.input{k}_conv.gn", p[f"in{k}_gn"])
        w.bn(f"{dst}.out_conv.bn", p["out_bn"], stats[name]["out_bn"])
        w.conv(f"{dst}.out_conv.conv", p["out_conv"])


def fcos_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/fcos.FCOS`` variables (``fcos`` and ``nasfcos``)
    -> mmdet-keyed CPU tensors for the port's ``models.fcos.FCOS``
    (mmdet's ``fcos_head.py`` / ``anchor_free_head.py`` names; the
    NAS-FCOS neck by its parameter names)."""
    neck = variables["params"]["neck"]
    neck = (_nasfcos if "adapt0" in neck else
            _hrfpn if "reduction_conv" in neck else _fpn)
    return _dense(variables, ("conv_cls", "conv_reg", "conv_centerness"),
                  gn=True, neck=neck)


def vfnet_state_dict_from_jax(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/vfnet.VFNet`` variables -> CPU tensors for the
    port's ``models.vfnet.VFNet`` (mmdet's ``vfnet_head.py`` names:
    ``vfnet_reg_conv`` (``.conv``, ``.gn``), the deformable kernels
    ``vfnet_reg_refine_dconv`` and ``vfnet_cls_dconv``, ``scales_refine``)."""
    def extra(w, name, p):
        if name == "vfnet_reg_conv":
            w.conv("bbox_head.vfnet_reg_conv.conv", p)
        elif name == "vfnet_reg_conv_gn":
            w.norm("bbox_head.vfnet_reg_conv.gn", p)
        elif name in ("reg_refine_dconv_kernel", "cls_dconv_kernel"):
            dst = {"reg_refine_dconv_kernel": "vfnet_reg_refine_dconv",
                   "cls_dconv_kernel": "vfnet_cls_dconv"}[name]
            w.conv(f"bbox_head.{dst}", {"kernel": p})
        elif re.fullmatch(r"scale_refine\d+", name):
            w.put(f"bbox_head.scales_refine.{name[12:]}.scale", p["scale"])
        else:
            return False
        return True

    return _dense(variables, ("vfnet_reg", "vfnet_reg_refine", "vfnet_cls"),
                  gn=True, extra=extra)


def reppoints_state_dict_from_jax(variables: Dict[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/reppoints.RepPoints`` variables -> CPU tensors for
    the port's ``models.reppoints.RepPoints`` (mmdet's
    ``reppoints_head.py`` names: the towers ``cls_convs`` and
    ``reg_convs`` (JAX's ``pts_conv{i}``), the deformable kernels
    ``reppoints_cls_conv`` and ``reppoints_pts_refine_conv``; JAX's
    top-level ``moment_transfer``)."""
    def extra(w, name, p):
        m = re.fullmatch(r"pts_conv(\d+)", name)
        if m:
            w.conv(f"bbox_head.reg_convs.{m[1]}.conv", p)
        elif name.endswith("_conv_kernel"):
            w.conv(f"bbox_head.{name[:-7]}", {"kernel": p})
        else:
            return False
        return True

    out = _dense(variables, ("reppoints_pts_init_conv",
                             "reppoints_pts_init_out", "reppoints_cls_out",
                             "reppoints_pts_refine_out"),
                 gn=False, extra=extra)
    w = _Writer()
    w.put("moment_transfer", variables["params"]["moment_transfer"])
    return {**out, **w.out}


def paa_state_dict_from_jax(variables: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/paa.PAA`` variables (PAA and LAD, any depth) ->
    CPU tensors for the port's ``models.paa.PAA`` (JAX's head names
    ``paa_cls``, ``paa_reg``, ``paa_iou``; mmdet's elsewhere)."""
    return _dense(variables, ("paa_cls", "paa_reg", "paa_iou"), gn=True)


def fsaf_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/fsaf.FSAF`` variables -> CPU tensors for the port's
    ``models.fsaf.FSAF`` (mmdet's ``fsaf_head.py`` names: towers with
    biases and no norm, ``conv_cls``, ``conv_reg``)."""
    return _dense(variables, ("conv_cls", "conv_reg"), gn=False)


def foveabox_state_dict_from_jax(variables: Dict[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/foveabox.FoveaBox`` variables -> CPU tensors for
    the port's ``models.foveabox.FoveaBox`` (mmdet's ``fovea_head.py``
    names: GroupNorm towers, ``conv_cls``, ``conv_reg``)."""
    return _dense(variables, ("conv_cls", "conv_reg"), gn=True)


def sabl_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/sabl_retina.SABLRetinaNet`` variables -> CPU
    tensors for the port's ``models.sabl_retina.SABLRetinaNet`` (mmdet's
    ``sabl_retina_head.py`` names: ``retina_cls``, ``retina_bbox_cls``,
    ``retina_bbox_reg``)."""
    return _dense(variables, ("retina_cls", "retina_bbox_cls",
                              "retina_bbox_reg"), gn=False)


def autoassign_state_dict_from_jax(variables: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/autoassign.AutoAssign`` variables -> CPU tensors
    for the port's ``models.autoassign.AutoAssign``: the FCOS-style head
    (``conv_cls``, ``conv_reg``, ``conv_objectness``, ``scales``) and the
    detector's own ``center_prior_mean`` and ``center_prior_sigma``."""
    out = _dense(variables, ("conv_cls", "conv_reg", "conv_objectness"),
                 gn=True)
    w = _Writer()
    for name in ("center_prior_mean", "center_prior_sigma"):
        w.put(name, variables["params"][name])
    return {**out, **w.out}


_TOOD_SEQ = {"la_conv1": "layer_attention.0", "la_conv2": "layer_attention.2",
             "cls_prob_conv1": "cls_prob_module.0",
             "cls_prob_conv2": "cls_prob_module.2",
             "reg_offset_conv1": "reg_offset_module.0",
             "reg_offset_conv2": "reg_offset_module.2"}


def tood_state_dict_from_jax(variables: Dict[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """The JAX ``models/tood.TOOD`` variables -> CPU tensors for the port's
    ``models.tood.TOOD`` (mmdet's ``tood_head.py`` names: ``inter_conv{i}``
    / ``inter_gn{i}`` -> ``inter_convs.i.conv`` / ``.gn``, each
    TaskDecomposition's ``la_conv{1,2}`` -> ``layer_attention.{0,2}`` and
    ``reduction`` / ``reduction_gn`` -> ``reduction_conv.conv`` / ``.gn``,
    ``cls_prob_conv{1,2}`` and ``reg_offset_conv{1,2}`` -> the two convs of
    ``cls_prob_module`` and ``reg_offset_module``)."""
    def extra(w, name, p):
        m = re.fullmatch(r"inter_(conv|gn)(\d+)", name)
        if m:
            dst = f"bbox_head.inter_convs.{m[2]}.{m[1]}"
            (w.conv if m[1] == "conv" else w.norm)(dst, p)
        elif name in ("cls_decomp", "reg_decomp"):
            dst = f"bbox_head.{name}"
            for k in ("la_conv1", "la_conv2"):
                w.conv(f"{dst}.{_TOOD_SEQ[k]}", p[k])
            w.conv(f"{dst}.reduction_conv.conv", p["reduction"])
            w.norm(f"{dst}.reduction_conv.gn", p["reduction_gn"])
        elif name in _TOOD_SEQ:
            w.conv(f"bbox_head.{_TOOD_SEQ[name]}", p)
        else:
            return False
        return True

    return _dense(variables, ("tood_cls", "tood_reg"), gn=True, extra=extra)
