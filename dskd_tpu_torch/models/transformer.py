"""Deformable-DETR transformer (port of
dskd_tpu/models/transformer.py ``inverse_sigmoid``, ``MSDeformAttention``,
``MultiheadAttention``, ``FFN``, ``EncoderLayer``, ``DecoderLayer``,
``encoder_reference_points``, ``level_masks_and_ratios`` and
``DeformableDetrTransformer``).

Tensors are batch-first (B, S, C). Parameter names follow mmdet/mmcv
(``encoder.layers.i.attentions.0.sampling_offsets``, ``ffns.0.layers.0.0``,
``norms.k``, ``attentions.0.attn.in_proj_weight``, ...). Not ported: the
premap decoder branch, box refinement, two-stage and remat.

Dropout sits where the JAX layers put it: after MSDA's output projection, on
the attention weights of ``MultiheadAttention`` and after its output, and
twice in the FFN. Its masks come from the ``torch.Generator`` passed into the
forward, the port's counterpart of the train step's ``dropout_rng``, never
from the global RNG. It is active in training mode at p > 0, where a
forward without a generator raises; eval mode and p = 0 turn it off.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.msda import ms_deform_attn_core
from .positional import sine_positional_encoding


def dropout(x: torch.Tensor, p: float, training: bool,
            generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1-p, scale kept values by
    1/(1-p). Off in eval and at p = 0; otherwise ``generator`` (on ``x``'s
    device) draws the mask and must be given."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode at p > 0 needs a "
                         "torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def msda_offset_bias(num_heads, num_levels, num_points) -> torch.Tensor:
    """The mmcv rotational-grid init of ``sampling_offsets.bias`` (CPU)."""
    thetas = torch.arange(num_heads, dtype=torch.float32) * (
        2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)          # (H, 2)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    grid = grid * torch.arange(1, num_points + 1,
                               dtype=torch.float32)[None, None, :, None]
    return grid.reshape(-1)


class MSDeformAttention(nn.Module):
    """Multi-scale deformable attention over flattened level tokens."""

    def __init__(self, device, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, dropout=0.1):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = (
            num_heads, num_levels, num_points)
        self.dropout = dropout
        hlp = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, hlp * 2, device=device)
        self.attention_weights = nn.Linear(embed_dims, hlp, device=device)
        self.value_proj = nn.Linear(embed_dims, embed_dims, device=device)
        self.output_proj = nn.Linear(embed_dims, embed_dims, device=device)

    def forward(self, query, value, query_pos, reference_points,
                spatial_shapes, key_padding_mask=None, generator=None):
        """query (B, Q, C); value (B, S, C); reference_points (B, Q, L, 2)
        normalized; key_padding_mask (B, S), True at padding."""
        B, Q, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        v = v.reshape(B, -1, H, C // H)
        offsets = self.sampling_offsets(query).reshape(B, Q, H, L, P, 2)
        weights = self.attention_weights(query).reshape(B, Q, H, L * P)
        weights = weights.softmax(-1).reshape(B, Q, H, L, P)
        norm = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                            dtype=query.dtype, device=query.device)
        locs = (reference_points[:, :, None, :, None, :]
                + offsets / norm[None, None, None, :, None, :])
        out = ms_deform_attn_core(v, spatial_shapes, locs, weights)
        return identity + dropout(self.output_proj(out), self.dropout,
                                  self.training, generator)


class _InOutProj(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters: packed q/k/v
    ``in_proj_weight`` (3C, C) / ``in_proj_bias`` and ``out_proj``."""

    def __init__(self, embed_dims, device):
        super().__init__()
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * embed_dims, embed_dims, device=device))
        self.in_proj_bias = nn.Parameter(
            torch.zeros(3 * embed_dims, device=device))
        self.out_proj = nn.Linear(embed_dims, embed_dims, device=device)


class MultiheadAttention(nn.Module):
    """Dot-product MHA with DETR-style positions (q = k = x + pos, v = x),
    written out as projections, matmul and softmax."""

    def __init__(self, device, embed_dims=256, num_heads=8, dropout=0.1):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.attn = _InOutProj(embed_dims, device)

    def forward(self, query, query_pos=None, generator=None):
        B, Q, C = query.shape
        H = self.num_heads
        Dh = C // H
        qk_in = query + query_pos if query_pos is not None else query
        wq, wk, wv = self.attn.in_proj_weight.chunk(3)
        bq, bk, bv = self.attn.in_proj_bias.chunk(3)
        q = F.linear(qk_in, wq, bq).reshape(B, Q, H, Dh) / math.sqrt(Dh)
        k = F.linear(qk_in, wk, bk).reshape(B, Q, H, Dh)
        v = F.linear(query, wv, bv).reshape(B, Q, H, Dh)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k).softmax(-1)
        attn = dropout(attn, self.dropout, self.training, generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, Q, C)
        return query + dropout(self.attn.out_proj(out), self.dropout,
                               self.training, generator)


class FFN(nn.Module):
    def __init__(self, device, embed_dims=256, feedforward_channels=1024,
                 dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels,
                                    device=device), nn.ReLU()),
            nn.Linear(feedforward_channels, embed_dims, device=device))

    def forward(self, x, generator=None):
        y = dropout(self.layers[0](x), self.dropout, self.training,
                    generator)
        y = dropout(self.layers[1](y), self.dropout, self.training,
                    generator)
        return x + y


def _norms(n, embed_dims, device):
    return nn.ModuleList(nn.LayerNorm(embed_dims, eps=1e-5, device=device)
                         for _ in range(n))


class EncoderLayer(nn.Module):
    """('self_attn', 'norm', 'ffn', 'norm') with MSDeformAttention."""

    def __init__(self, device, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=1024, dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([MSDeformAttention(
            device, embed_dims, num_heads, num_levels, num_points, dropout)])
        self.ffns = nn.ModuleList([FFN(device, embed_dims,
                                       feedforward_channels, dropout)])
        self.norms = _norms(2, embed_dims, device)

    def forward(self, x, pos, reference_points, spatial_shapes,
                key_padding_mask, generator=None):
        x = self.attentions[0](x, x, pos, reference_points, spatial_shapes,
                               key_padding_mask, generator)
        x = self.norms[0](x)
        return self.norms[1](self.ffns[0](x, generator))


class DecoderLayer(nn.Module):
    """('self_attn', 'norm', 'cross_attn', 'norm', 'ffn', 'norm')."""

    def __init__(self, device, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, feedforward_channels=1024, dropout=0.1):
        super().__init__()
        self.attentions = nn.ModuleList([
            MultiheadAttention(device, embed_dims, num_heads, dropout),
            MSDeformAttention(device, embed_dims, num_heads, num_levels,
                              num_points, dropout)])
        self.ffns = nn.ModuleList([FFN(device, embed_dims,
                                       feedforward_channels, dropout)])
        self.norms = _norms(3, embed_dims, device)

    def forward(self, query, query_pos, memory, reference_points,
                spatial_shapes, key_padding_mask, generator=None):
        query = self.norms[0](self.attentions[0](query, query_pos,
                                                 generator))
        query = self.attentions[1](query, memory, query_pos,
                                   reference_points, spatial_shapes,
                                   key_padding_mask, generator)
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query, generator))


def encoder_reference_points(spatial_shapes, valid_ratios):
    """(B, S, L, 2) normalized grid reference points."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
        rx = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
        ry = ry[:, None].expand(h, w).reshape(-1)
        rx = rx[None, :].expand(h, w).reshape(-1)
        ry = ry[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], -1))       # (B, h*w, 2)
    ref = torch.cat(refs, 1)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def level_masks_and_ratios(img_hw, batch_input_shape, spatial_shapes):
    """Per-level padding masks (True = pad) and (B, L, 2) valid (w, h)
    ratios; pixel i of an h-row level samples input row i * H // h, as the
    reference's nearest interpolation of the full-size mask does."""
    H, W = batch_input_shape
    dev = img_hw.device
    masks, ratios = [], []
    for (h, w) in spatial_shapes:
        ys = (torch.arange(h, device=dev) * H // h)[None, :, None]
        xs = (torch.arange(w, device=dev) * W // w)[None, None, :]
        pad = (ys >= img_hw[:, 0, None, None]) | (xs >= img_hw[:, 1, None,
                                                              None])
        masks.append(pad)
        valid_h = (~pad[:, :, 0]).sum(1).float()
        valid_w = (~pad[:, 0, :]).sum(1).float()
        ratios.append(torch.stack([valid_w / w, valid_h / h], -1))
    return masks, torch.stack(ratios, 1)


class _Layers(nn.Module):
    """Holds ``layers`` so parameter names read ``encoder.layers.i``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableDetrTransformer(nn.Module):
    """Encoder + decoder over flattened multi-level features."""

    def __init__(self, device, embed_dims=256, num_heads=8, num_levels=4,
                 num_points=4, num_encoder_layers=6, num_decoder_layers=6,
                 feedforward_channels=1024, dropout=0.1):
        super().__init__()
        args = (device, embed_dims, num_heads, num_levels, num_points,
                feedforward_channels, dropout)
        self.level_embeds = nn.Parameter(
            torch.zeros(num_levels, embed_dims, device=device))
        self.encoder = _Layers(EncoderLayer(*args)
                               for _ in range(num_encoder_layers))
        self.decoder = _Layers(DecoderLayer(*args)
                               for _ in range(num_decoder_layers))
        self.reference_points = nn.Linear(embed_dims, 2, device=device)

    def forward(self, mlvl_feats: Sequence[torch.Tensor], img_hw,
                batch_input_shape: Tuple[int, int], query_embed,
                generator=None):
        """mlvl_feats: NCHW (B, C, h, w) per level; img_hw (B, 2) valid
        (h, w); query_embed (num_query, 2C); generator draws the dropout
        masks in training mode.

        Returns (hs (nl, B, Q, C), init_reference (B, Q, 2),
        inter_references (nl, B, Q, 2), memory (B, S, C), mask_flat (B, S)).
        """
        B, C = mlvl_feats[0].shape[:2]
        spatial_shapes = tuple((f.shape[2], f.shape[3]) for f in mlvl_feats)
        masks, valid_ratios = level_masks_and_ratios(
            img_hw, batch_input_shape, spatial_shapes)
        feat_flat, mask_flat, pos_flat = [], [], []
        for lvl, (feat, mask) in enumerate(zip(mlvl_feats, masks)):
            pos = sine_positional_encoding(mask, num_feats=C // 2)
            feat_flat.append(feat.flatten(2).transpose(1, 2))  # raster order
            mask_flat.append(mask.flatten(1))
            pos_flat.append(pos.flatten(1, 2).to(feat.dtype)
                            + self.level_embeds[lvl])
        feat_flat = torch.cat(feat_flat, 1)
        mask_flat = torch.cat(mask_flat, 1)
        pos_flat = torch.cat(pos_flat, 1)

        enc_refs = encoder_reference_points(spatial_shapes, valid_ratios)
        x = feat_flat
        for layer in self.encoder.layers:
            x = layer(x, pos_flat, enc_refs, spatial_shapes, mask_flat,
                      generator)
        memory = x

        query_pos, query = query_embed.split(C, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        query = query[None].expand(B, -1, -1)
        reference_points = self.reference_points(query_pos).sigmoid()
        ref_input = reference_points[:, :, None, :] * valid_ratios[:, None]
        states = []
        for layer in self.decoder.layers:
            query = layer(query, query_pos, memory, ref_input,
                          spatial_shapes, mask_flat, generator)
            states.append(query)
        hs = torch.stack(states, 0)
        # no box refinement: every layer keeps the initial references
        inter_refs = reference_points[None].expand(len(states), -1, -1, -1)
        return hs, reference_points, inter_refs, memory, mask_flat
