"""Pyramid Vision Transformer v1 backbone (port of dskd_tpu/models/pvt.py
``SRAttention``, ``PVTBlock`` and ``PVT``).

Four stages of patch embedding (a VALID conv of patch 4, then 2) ->
LayerNorm -> a learned positional embedding -> transformer blocks with
spatial-reduction attention (K and V from an ``sr``-strided conv of the
token map, padded as flax's ``SAME``, and a LayerNorm). LayerNorms use
eps 1e-6; the MLP's GELU is flax's tanh approximation; no norm after a
stage (v1). The positional embeddings are learned at the 224-input grid
(56, 28, 14, 7) and resized bilinearly to the stage's map as
``jax.image.resize`` does: half-pixel centres, antialiased where it
shrinks. Stochastic depth: block ``i`` of ``n`` drops its two residual
branches per sample at rate ``drop_path_rate * i / (n - 1)`` in training
(``backbones.drop_path``). Outputs are NCHW; parameter names are JAX's
(``patch_embed{s}``, ``pos_embed{s}``, ``stage{s}_block{b}.attn.q`` ...).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .backbones import drop_path
from .nasfcos_fpn import _resize_bilinear

ARCHS = {
    "tiny": dict(dims=(64, 128, 320, 512), depths=(2, 2, 2, 2),
                 heads=(1, 2, 5, 8), sr=(8, 4, 2, 1), mlp=(8, 8, 4, 4)),
    "small": dict(dims=(64, 128, 320, 512), depths=(3, 4, 6, 3),
                  heads=(1, 2, 5, 8), sr=(8, 4, 2, 1), mlp=(8, 8, 4, 4)),
}
LN_EPS = 1e-6


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """NCHW ``x`` padded (zeros) as flax's ``padding="SAME"`` pads a conv of
    kernel ``k`` and stride ``s``: ``max((ceil(n / s) - 1) * s + k - n,
    0)`` per axis, the smaller half before."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class SRAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int, device):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.q = nn.Linear(dim, dim, device=device)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio,
                                device=device)
            self.sr_norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.kv = nn.Linear(dim, 2 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x, h: int, w: int):
        """x (B, N, C): the tokens of an (h, w) map."""
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        q = self.q(x).reshape(B, N, H, hd)
        kv_in = x
        if self.sr_ratio > 1:
            m = x.reshape(B, h, w, C).permute(0, 3, 1, 2)
            m = self.sr(same_pad(m, self.sr_ratio, self.sr_ratio))
            kv_in = self.sr_norm(m.flatten(2).transpose(1, 2))
        k, v = self.kv(kv_in).chunk(2, dim=-1)
        M = k.shape[1]
        k = k.reshape(B, M, H, hd)
        v = v.reshape(B, M, H, hd)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * (hd ** -0.5)
        attn = attn.softmax(dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, C)
        return self.proj(out)


class PVTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int, device, drop_path: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = SRAttention(dim, num_heads, sr_ratio, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio, device=device)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim, device=device)
        self.drop_path = drop_path

    def forward(self, x, h, w, generator=None):
        y = self.attn(self.norm1(x), h, w)
        x = x + drop_path(y, self.drop_path, generator, self.training)
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + drop_path(y, self.drop_path, generator, self.training)


class PVT(nn.Module):
    def __init__(self, device, arch: str = "tiny",
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 drop_path_rate: float = 0.1):
        super().__init__()
        cfg = ARCHS[arch]
        self.cfg = cfg
        self.out_indices = tuple(out_indices)
        total = sum(cfg["depths"])
        bi, cin = 0, 3
        for si in range(4):
            dim = cfg["dims"][si]
            patch = 4 if si == 0 else 2
            self.add_module(f"patch_embed{si}", nn.Conv2d(
                cin, dim, patch, stride=patch, device=device))
            self.add_module(f"embed_norm{si}",
                            nn.LayerNorm(dim, eps=LN_EPS, device=device))
            base = 224 // (4 * 2 ** si)
            self.register_parameter(f"pos_embed{si}", nn.Parameter(
                torch.zeros(base * base, dim, device=device)))
            for b in range(cfg["depths"][si]):
                self.add_module(f"stage{si}_block{b}", PVTBlock(
                    dim, cfg["heads"][si], cfg["sr"][si], cfg["mlp"][si],
                    device, drop_path=drop_path_rate * bi / max(total - 1,
                                                                1)))
                bi += 1
            cin = dim
        self.out_channels = [cfg["dims"][i] for i in self.out_indices]

    def forward(self, x, generator=None) -> Tuple:
        B = x.shape[0]
        outs = []
        for si in range(4):
            dim = self.cfg["dims"][si]
            x = getattr(self, f"patch_embed{si}")(x)
            h, w = x.shape[2:]
            tokens = getattr(self, f"embed_norm{si}")(
                x.flatten(2).transpose(1, 2))
            base = 224 // (4 * 2 ** si)
            pe = getattr(self, f"pos_embed{si}").reshape(base, base, dim)
            pe = _resize_bilinear(pe.permute(2, 0, 1)[None], (h, w))
            tokens = tokens + pe[0].flatten(1).transpose(0, 1)[None]
            for b in range(self.cfg["depths"][si]):
                tokens = getattr(self, f"stage{si}_block{b}")(
                    tokens, h, w, generator)
            x = tokens.transpose(1, 2).reshape(B, dim, h, w)
            if si in self.out_indices:
                outs.append(x)
        return tuple(outs)
