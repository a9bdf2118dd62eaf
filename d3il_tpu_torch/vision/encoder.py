"""Vision obs encoder: ResNet18 (GroupNorm) + SpatialSoftmax.

Counterpart of ``d3il_tpu/vision/encoder.py``: per camera a ResNet18 trunk
with GroupNorm, SpatialSoftmax keypoints and a dense layer; the two
cameras' features concatenated with the low-dim robot state. The modules
take images [B, H, W, 3] (the renderer's layout) and run NCHW inside.

What the Flax modules do, kept here: ``padding="SAME"`` is asymmetric under
stride 2 (the extra row and column go after: the 7x7/2 stem on 96 pads
(2, 3), a 3x3/2 conv on 24 pads (0, 1)), and so is the SAME max pool, which
pads with -inf; GroupNorm's epsilon is 1e-6, the stem has 16 groups and a
block min(16, filters); the ResNet convs have no bias, the SpatialSoftmax
1x1 conv and the dense layer do. The initial weights follow Flax's laws:
LeCun-normal kernels (truncated at 2 std, as ``nets.mlp.dense``), zero
biases, GroupNorm scale 1 and bias 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from d3il_tpu_torch.agents.nets.mlp import dense

GN_EPS = 1e-6
# robomimic's VisualCore at 96 x 96: ResNet18 width 32 (torchvision's is
# 64), 32 keypoints, 64 features per camera
WIDTH, NUM_KP, CAM_FEAT = 32, 32, 64


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of a size-n axis: out = ceil(n / s), the total
    split with the larger half after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal(shape, fan_in: int, generator: torch.Generator):
    """Flax's default kernel initialiser: a normal of std sqrt(1 / fan_in)
    truncated at 2 std (0.8796 restores the variance the truncation
    removes), drawn from ``generator`` on its device."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    u = torch.rand(shape, generator=generator, device=generator.device)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))      # Phi(-2)
    w = torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1) * (math.sqrt(2) * std)
    return w.clamp(-2 * std, 2 * std)


class SameConv(nn.Module):
    """nn.Conv of Flax with padding "SAME": weight [out, in, k, k]."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 bias: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(_lecun_normal((c_out, c_in, k, k),
                                                 c_in * k * k, generator))
        self.bias = nn.Parameter(torch.zeros(
            c_out, device=generator.device)) if bias else None

    def forward(self, x):
        ph = _same_pad(x.shape[2], self.k, self.stride)
        pw = _same_pad(x.shape[3], self.k, self.stride)
        if any(ph + pw):
            x = F.pad(x, pw + ph)
        return F.conv2d(x, self.weight, self.bias, self.stride)


def max_pool_same(x, k: int = 3, s: int = 2):
    """nn.max_pool(x, (k, k), (s, s), padding="SAME"): -inf padding."""
    ph = _same_pad(x.shape[2], k, s)
    pw = _same_pad(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, pw + ph, value=-math.inf), k, s)


def group_norm(groups: int, ch: int, device) -> nn.GroupNorm:
    return nn.GroupNorm(groups, ch, eps=GN_EPS, device=device)


class ResNetBlock(nn.Module):
    def __init__(self, c_in: int, filters: int, stride: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        g, dev = generator, generator.device
        groups = min(16, filters)
        self.conv1 = SameConv(c_in, filters, 3, stride, generator=g)
        self.gn1 = group_norm(groups, filters, dev)
        self.conv2 = SameConv(filters, filters, 3, generator=g)
        self.gn2 = group_norm(groups, filters, dev)
        self.short = self.short_gn = None
        if c_in != filters or stride != 1:
            self.short = SameConv(c_in, filters, 1, stride, generator=g)
            self.short_gn = group_norm(groups, filters, dev)

    def forward(self, x):
        y = F.relu(self.gn1(self.conv1(x)))
        y = self.gn2(self.conv2(y))
        if self.short is not None:
            x = self.short_gn(self.short(x))
        return F.relu(y + x)


class ResNet18(nn.Module):
    """ResNet18 trunk: [B, 3, H, W] -> [B, 8w, H/32, W/32]."""

    def __init__(self, width: int, *, generator: torch.Generator):
        super().__init__()
        w = width
        self.stem = SameConv(3, w, 7, 2, generator=generator)
        self.stem_gn = group_norm(16, w, generator.device)
        blocks, c_in = [], w
        for filters, stride in ((w, 1), (w, 1), (2 * w, 2), (2 * w, 1),
                                (4 * w, 2), (4 * w, 1), (8 * w, 2),
                                (8 * w, 1)):
            blocks.append(ResNetBlock(c_in, filters, stride,
                                      generator=generator))
            c_in = filters
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = c_in

    def forward(self, x):
        x = max_pool_same(F.relu(self.stem_gn(self.stem(x))))
        for block in self.blocks:
            x = block(x)
        return x


class SpatialSoftmax(nn.Module):
    """Keypoint expectation over feature maps: [B, C, H, W] -> [B, 2K],
    the softmax over the H * W positions row by row, [kx, ky]."""

    def __init__(self, c_in: int, num_kp: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = SameConv(c_in, num_kp, 1, bias=True, generator=generator)

    def forward(self, x):
        B, _, H, W = x.shape
        attn = torch.softmax(self.conv(x).flatten(2), dim=-1)   # [B, K, H*W]
        ys = torch.linspace(-1, 1, H, device=x.device)
        xs = torch.linspace(-1, 1, W, device=x.device)
        ky = (attn.reshape(B, -1, H, W) * ys[:, None]).sum(dim=(2, 3))
        kx = (attn.reshape(B, -1, H, W) * xs).sum(dim=(2, 3))
        return torch.cat([kx, ky], dim=-1)


class CameraEncoder(nn.Module):
    """img [B, H, W, 3] in [0, 1] -> [B, CAM_FEAT]."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        self.trunk = ResNet18(WIDTH, generator=generator)
        self.kp = SpatialSoftmax(self.trunk.out_channels, NUM_KP,
                                 generator=generator)
        self.out = dense(2 * NUM_KP, CAM_FEAT, generator)

    def forward(self, img):
        x = self.trunk(img.permute(0, 3, 1, 2))
        return self.out(self.kp(x))


class MultiImageObsEncoder(nn.Module):
    """(bp_img, inhand_img, low_dim) -> [f_bp, f_inhand, low_dim]: one
    CameraEncoder per camera."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        self.bp = CameraEncoder(generator=generator)
        self.ih = CameraEncoder(generator=generator)

    @staticmethod
    def feature_dim(low_dim: int) -> int:
        return 2 * CAM_FEAT + low_dim

    def forward(self, bp_img, inhand_img, low_dim):
        return torch.cat([self.bp(bp_img), self.ih(inhand_img), low_dim],
                         dim=-1)
