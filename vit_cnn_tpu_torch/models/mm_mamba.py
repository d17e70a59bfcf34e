"""Multimodality_Mamba, the flagship, in PyTorch.

Port of :mod:`vit_cnn_tpu.models.mm_mamba` (ref:
model/Multimodality_Mamba/Mutimodality_Mamba7.py:1141-1181), NHWC,
module and parameter names as in the flax tree. Dataflow at Houston2013
width (patch 9, HSI plan [144, 256, 144], LiDAR [1, 16, 32], fusion 128):

  hsi1 = GlobalLocalBlock(9, 144->256)     # 9x9 -> 7x7, Mamba over 81 tokens
  hsi2 = GlobalLocalBlock(7, 256->144)     # 7x7 -> 5x5, Mamba over 49 tokens
  lidar1/2 = BN -> valid 3x3 conv -> ReLU
  fusion_k = FusionBlock(hsi_k, lidar_k)
  logits = Dense(128, K)(mean(f1) + mean(f2))

Each GlobalLocalBlock runs one multi-directional Mamba layer (kernels
K1-K3) and one NonLocal cross-attention (kernel K4: 49 x 9 keys at 128
channels, then 25 x 4 at 72).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import (BatchNorm, ChannelLastBatchNorm, Conv, Dense,
                         LayerNorm, max_pool_2x2)
from ..nn.mamba import DirectionalMambaBackbone
from ..ops.attention import fused_attention_auto


class TokenLearner(nn.Module):
    """S spatial-attention maps -> S tokens (ref: :26-64), as one 1x1 conv
    with S outputs over the (max, mean) channel summary."""

    def __init__(self, num_tokens: int):
        super().__init__()
        self.conv = Conv(2, num_tokens, 1)
        self.bn = BatchNorm(num_tokens)

    def forward(self, x):
        combined = torch.cat([x.amax(dim=-1, keepdim=True),
                              x.mean(dim=-1, keepdim=True)], dim=-1)
        weight = torch.sigmoid(self.bn(self.conv(combined), relu=True))
        return torch.einsum("bhwc,bhws->bsc", x, weight) / (
            x.shape[1] * x.shape[2])


class NonLocalBlock2D(nn.Module):
    """theta/phi/g 1x1 convs, 2x2 max-pool subsampling of phi and g, an
    unscaled softmax attention and a zero-initialised BN on the output
    projection (ref: :66-159)."""

    def __init__(self, in_channels: int):
        super().__init__()
        inter = max(in_channels // 2, 1)
        self.inter = inter
        self.theta = Conv(in_channels, inter, 1)
        self.phi = Conv(in_channels, inter, 1)
        self.g = Conv(in_channels, inter, 1)
        self.W_conv = Conv(inter, in_channels, 1)
        self.W_bn = ChannelLastBatchNorm(in_channels, zero_scale=True)

    def forward(self, x, y, z):
        b, h, w, _ = x.shape
        theta = self.theta(x)
        phi, g = max_pool_2x2(self.phi(y)), max_pool_2x2(self.g(z))
        tq = theta.reshape(b, h * w, self.inter)
        tk = phi.reshape(b, -1, self.inter)
        tv = g.reshape(b, -1, self.inter)
        # the reference applies a raw (unscaled) softmax here
        o = fused_attention_auto(tq, tk, tv, 1.0).reshape(b, h, w, self.inter)
        return self.W_bn(self.W_conv(o)) + z


def channel_exchange(x1, x2):
    """Swap every other channel (the even ones) between two maps
    (Changer paper)."""
    mask = torch.arange(x1.shape[-1], device=x1.device) % 2 == 0
    return torch.where(mask, x2, x1), torch.where(mask, x1, x2)


class MsConvBNReLU(nn.Module):
    """BN -> valid 3x3 conv -> ReLU (ref: :1035-1048; BN comes first)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = Conv(in_features, features, 3)

    def forward(self, x):
        return F.relu(self.Conv_0(self.BatchNorm_0(x)))


class FusionBlock(nn.Module):
    """ChannelExchange (when channel counts match) -> concat -> 1x1 conv,
    BN, ReLU (ref: :1119-1139)."""

    def __init__(self, in1: int, in2: int, out_channels: int):
        super().__init__()
        self.Conv_0 = Conv(in1 + in2, out_channels, 1)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, x1, x2):
        if x1.shape[-1] == x2.shape[-1]:
            x1, x2 = channel_exchange(x1, x2)
        x = self.Conv_0(torch.cat([x1, x2], dim=-1))
        return self.BatchNorm_0(x, relu=True)


class GLFusionBlock(nn.Module):
    """NonLocal cross-attention merge of channel and local features
    (ref: :1093-1117)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.cross_attention = NonLocalBlock2D(channels)
        self.Conv_0 = Conv(2 * channels, out_channels, 1)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, x1, x2):
        # x1: channel feature, x2: local feature
        globalf = x2 + x1
        localf = self.cross_attention(x2, x1, x1) + x2
        x = self.Conv_0(torch.cat([localf, globalf], dim=-1))
        return self.BatchNorm_0(x, relu=True)


class GlobalLocalBlock(nn.Module):
    """Global (Mamba) + local (conv) + channel (TokenLearner) paths; the
    spatial side shrinks by 2 (ref: :1050-1091)."""

    def __init__(self, img_size: int, in_channels: int, out_channels: int):
        super().__init__()
        s = img_size
        inner = (s - 2) * (s - 2)
        self.side = s - 2
        self.global_view = DirectionalMambaBackbone(
            embed_dims=in_channels, num_layers=1,
            feedforward_channels=in_channels // 2, img_size=s,
            in_channels=in_channels, path_type="{}_2+8".format(s * s))
        self.change_dim = Conv(in_channels, out_channels, 1)
        self.global_tokens = TokenLearner(inner)
        self.ln3 = LayerNorm(out_channels)
        self.local_feature = MsConvBNReLU(in_channels, out_channels)
        self.channel_feature = Conv(in_channels, out_channels, 1)
        self.channel_tokens = TokenLearner(inner)
        self.ln4 = LayerNorm(out_channels)
        self.gl_fusion = GLFusionBlock(out_channels, out_channels)
        self.fusion = FusionBlock(out_channels, out_channels, out_channels)

    def forward(self, hsi):
        b, s = hsi.shape[0], self.side
        gf = self.change_dim(self.global_view(hsi))
        gf = self.ln3(self.global_tokens(gf)).reshape(b, s, s, -1)
        local = self.local_feature(hsi)
        cf = self.channel_tokens(self.channel_feature(hsi))
        cf = self.ln4(cf).reshape(b, s, s, -1)
        return self.fusion(gf, self.gl_fusion(cf, local))


class MultimodalityMamba(nn.Module):
    def __init__(self, img_size: int, in_channels1: int, in_channels2: int,
                 dim_embedding: int, n_classes: int):
        super().__init__()
        plane_hsi = (in_channels1, 256, in_channels1)
        plane_lidar = (in_channels2, 16, 32)
        fusion_ch = 128
        self.hsi1 = GlobalLocalBlock(img_size, plane_hsi[0], plane_hsi[1])
        self.hsi2 = GlobalLocalBlock(img_size - 2, plane_hsi[1], plane_hsi[2])
        self.lidar1 = MsConvBNReLU(plane_lidar[0], plane_lidar[1])
        self.lidar2 = MsConvBNReLU(plane_lidar[1], plane_lidar[2])
        self.fusion1 = FusionBlock(plane_hsi[1], plane_lidar[1], fusion_ch)
        self.fusion2 = FusionBlock(plane_hsi[2], plane_lidar[2], fusion_ch)
        self.classifier = Dense(fusion_ch, n_classes)

    def forward(self, hsi, lidar):
        hsi1 = self.hsi1(hsi)
        hsi2 = self.hsi2(hsi1)
        lidar1 = self.lidar1(lidar)
        lidar2 = self.lidar2(lidar1)
        f1 = self.fusion1(hsi1, lidar1)
        f2 = self.fusion2(hsi2, lidar2)
        return self.classifier(f1.mean(dim=(1, 2)) + f2.mean(dim=(1, 2)))
