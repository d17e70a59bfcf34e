"""GLT-Net in PyTorch (port of :mod:`vit_cnn_tpu.models.
glt_net`, ref: model/compare_method/GLT_Net/GLT_Net.py:310-422, with the
JAX package's single-patch adaptation).

* The scale pyramid (P, 2P, 3P) comes from the (P, P) patch by bilinear
  resizing (half-pixel centers, edges clamped: ``jax.image.resize``'s
  "bilinear" for upsampling).
* CNN encoder: a 3x3 conv + BN + ReLU stem per modality shared by the
  three scales, a conv + BN + ReLU + 2x2 pool tower per scale and
  modality, learned scalar mixing (xishu1, xishu2); per scale a Dense
  embeds the flattened positions to P^2 tokens.
* SA-GDR: mean and max of the three scales per channel through one shared
  7x7 conv and a sigmoid: the 64 gate maps are the tokens.
* Encoder transformer (dim 64) and decoder transformer (dim 32), both 4
  heads of 16 (kernel K8), then six sigmoid reconstruction heads (scales
  1x / 2x / 3x, nearest upsampling, per modality) whose mean squared
  errors against the pyramid make ``con_loss``.
* Classifier: the raw Dense logits of the CLS token (LayerNorm eps 1e-6)
  times coefficient1 plus the softmax CNN head times coefficient2.

Dropout (``emb_dropout`` after the positions, ``dropout`` in both
backbones) acts in train mode. Returns ``(logits, con_loss)``; serving
takes the first, training adds the second to the loss (``glt``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import BatchNorm, Conv, Dense, LayerNorm, max_pool_2x2
from ..nn.noise import Dropout
from ..nn.transformer import ViTBackbone


def resize(x, size: int, mode: str):
    """Resize (B, H, W, C) to (B, size, size, C): ``mode`` "bilinear"
    (align_corners False) or "nearest-exact", the counterparts of
    ``jax.image.resize``'s "bilinear" (upsampling) and "nearest"."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode=mode,
                      **({"align_corners": False} if mode == "bilinear"
                         else {}))
    return y.permute(0, 2, 3, 1)


class _ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int, pool: bool = False):
        super().__init__()
        self.pool = pool
        self.Conv_0 = Conv(in_features, features, 3, padding=1)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        return max_pool_2x2(x) if self.pool else x


class _SAGDR(nn.Module):
    """Spatial-attention grouped dimension reduction (ref: :176-206)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = Conv(2, 1, kernel_size, padding=kernel_size // 2,
                         use_bias=False)

    def forward(self, x1, x2, x3):
        # xi: (B, p*p, dim) token maps
        b, l, d = x1.shape
        p = int(round(l ** 0.5))
        stacked = torch.stack([x.transpose(1, 2).reshape(b, d, p, p)
                               for x in (x1, x2, x3)], dim=2)
        feats = torch.stack([stacked.mean(dim=2), stacked.amax(dim=2)],
                            dim=-1).reshape(b * d, p, p, 2)
        return torch.sigmoid(self.conv(feats)).reshape(b, d, p * p)


class GLTNet(nn.Module):
    def __init__(self, n_bands1: int, n_bands2: int, patch_size: int,
                 n_classes: int, encoder_embed_dim: int = 64,
                 decoder_embed_dim: int = 32,
                 en_depth: int = 5, en_heads: int = 4, de_depth: int = 5,
                 de_heads: int = 4, dim_head: int = 16, mlp_dim: int = 8,
                 dropout: float = 0.1, emb_dropout: float = 0.1):
        super().__init__()
        p, dim, ddim = patch_size, encoder_embed_dim, decoder_embed_dim
        self.stem_hsi = _ConvBlock(n_bands1, 32)
        self.stem_lidar = _ConvBlock(n_bands2, 32)
        self.xishu1 = nn.Parameter(torch.empty(1))
        self.xishu2 = nn.Parameter(torch.empty(1))
        for i in range(3):
            setattr(self, "tower_hsi{}".format(i), _ConvBlock(32, 64, True))
            setattr(self, "tower_lidar{}".format(i), _ConvBlock(32, 64, True))
            side = (i + 1) * p // 2
            setattr(self, "encoder_embedding{}".format(i + 1),
                    Dense(side * side, p * p))
        self.sa_gdr = _SAGDR()
        self.encoder_pos_embed = nn.Parameter(torch.empty(1, p * p + 1, dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.emb_drop = Dropout(emb_dropout)
        self.en_transformer = ViTBackbone(dim, en_depth, en_heads, dim_head,
                                          mlp_dim, dropout)
        self.decoder_embedding = Dense(dim, ddim)
        self.decoder_pos_embed = nn.Parameter(torch.empty(1, p * p + 1, ddim))
        self.de_transformer = ViTBackbone(ddim, de_depth, de_heads, dim_head,
                                          mlp_dim, dropout)
        self.decoder_pred1 = Dense(ddim, 64)
        for i, ch in enumerate((n_bands1, n_bands2) * 3):
            setattr(self, "dconv{}".format(i + 1), Conv(64, ch, 3, padding=1))
        self.head_norm = LayerNorm(dim)
        self.head = Dense(dim, n_classes)
        self.cls_conv1 = Conv(dim, 32, 1)
        self.cls_bn1 = BatchNorm(32)
        self.cls_conv2 = Dense(32, n_classes)
        self.coefficient1 = nn.Parameter(torch.empty(1))
        self.coefficient2 = nn.Parameter(torch.empty(1))

    def reset_parameters(self, g: torch.Generator):
        for p in (self.xishu1, self.xishu2, self.coefficient1,
                  self.coefficient2):
            nn.init.constant_(p, 0.5)
        for p in (self.encoder_pos_embed, self.cls_token,
                  self.decoder_pos_embed):
            nn.init.normal_(p, 0.0, 1.0, generator=g)

    def forward(self, hsi, lidar):
        b, p, _, _ = hsi.shape
        dim = self.cls_token.shape[-1]
        scales1 = [hsi] + [resize(hsi, s * p, "bilinear") for s in (2, 3)]
        scales2 = [lidar] + [resize(lidar, s * p, "bilinear") for s in (2, 3)]

        tokens = []
        for i in range(3):
            a = getattr(self, "tower_hsi{}".format(i))(
                self.stem_hsi(scales1[i]))
            c = getattr(self, "tower_lidar{}".format(i))(
                self.stem_lidar(scales2[i]))
            fused = a * self.xishu1 + c * self.xishu2
            flat = fused.reshape(b, -1, 64).transpose(1, 2)
            emb = getattr(self, "encoder_embedding{}".format(i + 1))
            tokens.append(emb(flat).transpose(1, 2))
        x_cnn = self.sa_gdr(*tokens)                        # (B, dim, P^2)

        pos = self.encoder_pos_embed
        x = x_cnn.transpose(1, 2) + pos[:, 1:]
        x = torch.cat([self.cls_token.expand(b, 1, dim), x], dim=1)
        x_vit = self.en_transformer(self.emb_drop(x + pos[:, :1]))

        d = self.decoder_embedding(x_vit) + self.decoder_pos_embed
        d = self.decoder_pred1(self.de_transformer(d))[:, 1:]
        dimg = d.transpose(1, 2).reshape(b, 64, p, p).permute(0, 2, 3, 1)
        mse = lambda a, t: torch.mean((a - t) ** 2)
        con_loss = 0.0
        for s in range(3):
            up = dimg if s == 0 else resize(dimg, (s + 1) * p,
                                            "nearest-exact")
            r1 = torch.sigmoid(getattr(self, "dconv{}".format(2 * s + 1))(up))
            r2 = torch.sigmoid(getattr(self, "dconv{}".format(2 * s + 2))(up))
            con_loss = con_loss + (0.5 * mse(r1, scales1[s])
                                   + 0.5 * mse(r2, scales2[s]))
        con_loss = con_loss / 3.0

        x_cls1 = self.head(self.head_norm(x_vit[:, 0]))
        cimg = x_cnn.reshape(b, dim, p, p).permute(0, 2, 3, 1)
        y = F.relu(self.cls_bn1(self.cls_conv1(cimg))).mean(dim=(1, 2))
        x_cls2 = torch.softmax(self.cls_conv2(y), dim=-1)
        return x_cls1 * self.coefficient1 + x_cls2 * self.coefficient2, \
            con_loss
