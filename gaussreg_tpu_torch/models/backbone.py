"""KPConv-FPN backbone: 5-stage encoder + 3-level decoder
(port of gaussreg_tpu/models/backbone.py).

Returns (feats_f, feats_c): level-1 decoder features (dim `output_dim`) and
level-4 encoder features (dim init_dim * 32).
"""

from __future__ import annotations

import torch
from torch import nn

from gaussreg_tpu_torch.data.pipeline import Pyramid
from gaussreg_tpu_torch.engine.debug import annotate
from gaussreg_tpu_torch.models import initializers as init
from gaussreg_tpu_torch.models.kpconv import (
    ConvBlock,
    ResidualBlock,
    UnaryBlock,
    kernel_points,
    kpconv_geometry,
    nearest_upsample,
)


class KPConvFPN(nn.Module):
    def __init__(self, input_dim, output_dim, init_dim, kernel_size, init_radius,
                 init_sigma, group_norm, shared_geometry=True):
        super().__init__()
        d, k, r, s, g = init_dim, kernel_size, init_radius, init_sigma, group_norm
        self.kernel_size = k
        self.init_radius = r
        self.init_sigma = s
        self.shared_geometry = shared_geometry
        self.encoder1_1 = ConvBlock(input_dim, d, k, r, s, g)
        self.encoder1_2 = ResidualBlock(d, d * 2, k, r, s, g)
        self.encoder2_1 = ResidualBlock(d * 2, d * 2, k, r, s, g, strided=True)
        self.encoder2_2 = ResidualBlock(d * 2, d * 4, k, r * 2, s * 2, g)
        self.encoder2_3 = ResidualBlock(d * 4, d * 4, k, r * 2, s * 2, g)
        self.encoder3_1 = ResidualBlock(d * 4, d * 4, k, r * 2, s * 2, g, strided=True)
        self.encoder3_2 = ResidualBlock(d * 4, d * 8, k, r * 4, s * 4, g)
        self.encoder3_3 = ResidualBlock(d * 8, d * 8, k, r * 4, s * 4, g)
        self.encoder4_1 = ResidualBlock(d * 8, d * 8, k, r * 4, s * 4, g, strided=True)
        self.encoder4_2 = ResidualBlock(d * 8, d * 16, k, r * 8, s * 8, g)
        self.encoder4_3 = ResidualBlock(d * 16, d * 16, k, r * 8, s * 8, g)
        self.encoder5_1 = ResidualBlock(d * 16, d * 16, k, r * 8, s * 8, g, strided=True)
        self.encoder5_2 = ResidualBlock(d * 16, d * 32, k, r * 16, s * 16, g)
        self.encoder5_3 = ResidualBlock(d * 32, d * 32, k, r * 16, s * 16, g)
        self.decoder4 = UnaryBlock(d * 48, d * 16, g)
        self.decoder3 = UnaryBlock(d * 24, d * 8, g)
        self.decoder2 = nn.Linear(d * 12, output_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's init for every block (models/initializers.py)."""
        for name, module in self.named_children():
            if name == "decoder2":
                init.dense_(module, generator)
            else:
                module.reset_parameters(generator)

    def forward(self, feats: torch.Tensor, pyramid: Pyramid):
        """Spans: `backbone.geometry`, `backbone.encoder1`-`5`, `backbone.decoder`."""
        pts, msk = pyramid.points, pyramid.masks
        nbr, sub, up = pyramid.neighbors, pyramid.subsampling, pyramid.upsampling

        with annotate("backbone.geometry"):
            if self.shared_geometry:
                # one (influence, count) per neighbor list, shared by every conv
                # on it (all convs share the deterministic kernel disposition)
                kp0 = torch.from_numpy(kernel_points(self.kernel_size)).to(feats.device)
                r, s = self.init_radius, self.init_sigma
                geo_n = [
                    kpconv_geometry(pts[l], pts[l], nbr[l], kp0 * (r * 2**l), s * 2**l)
                    for l in range(5)
                ]
                geo_s = [
                    kpconv_geometry(pts[l + 1], pts[l], sub[l], kp0 * (r * 2**l), s * 2**l)
                    for l in range(4)
                ]
            else:
                geo_n, geo_s = [None] * 5, [None] * 4

        with annotate("backbone.encoder1"):
            x1 = self.encoder1_1(feats, pts[0], pts[0], nbr[0], msk[0], geo_n[0])
            x1 = self.encoder1_2(x1, pts[0], pts[0], nbr[0], msk[0], msk[0], geo_n[0])

        with annotate("backbone.encoder2"):
            x2 = self.encoder2_1(x1, pts[1], pts[0], sub[0], msk[1], msk[0], geo_s[0])
            x2 = self.encoder2_2(x2, pts[1], pts[1], nbr[1], msk[1], msk[1], geo_n[1])
            x2 = self.encoder2_3(x2, pts[1], pts[1], nbr[1], msk[1], msk[1], geo_n[1])

        with annotate("backbone.encoder3"):
            x3 = self.encoder3_1(x2, pts[2], pts[1], sub[1], msk[2], msk[1], geo_s[1])
            x3 = self.encoder3_2(x3, pts[2], pts[2], nbr[2], msk[2], msk[2], geo_n[2])
            x3 = self.encoder3_3(x3, pts[2], pts[2], nbr[2], msk[2], msk[2], geo_n[2])

        with annotate("backbone.encoder4"):
            x4 = self.encoder4_1(x3, pts[3], pts[2], sub[2], msk[3], msk[2], geo_s[2])
            x4 = self.encoder4_2(x4, pts[3], pts[3], nbr[3], msk[3], msk[3], geo_n[3])
            x4 = self.encoder4_3(x4, pts[3], pts[3], nbr[3], msk[3], msk[3], geo_n[3])

        with annotate("backbone.encoder5"):
            x5 = self.encoder5_1(x4, pts[4], pts[3], sub[3], msk[4], msk[3], geo_s[3])
            x5 = self.encoder5_2(x5, pts[4], pts[4], nbr[4], msk[4], msk[4], geo_n[4])
            x5 = self.encoder5_3(x5, pts[4], pts[4], nbr[4], msk[4], msk[4], geo_n[4])

        with annotate("backbone.decoder"):
            l4 = torch.cat([nearest_upsample(x5, up[3]), x4], dim=-1)
            l4 = self.decoder4(l4, msk[3])
            l3 = torch.cat([nearest_upsample(l4, up[2]), x3], dim=-1)
            l3 = self.decoder3(l3, msk[2])
            l2 = torch.cat([nearest_upsample(l3, up[1]), x2], dim=-1)
            feats_f = self.decoder2(l2)
        return feats_f, x5
