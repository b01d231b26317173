"""U-Net (counterpart of ``singa_tpu/models/unet.py``): double-conv
encoder blocks with 2×2 max-pool downsampling, and a decoder of 2×2
stride transposed convs (``layer.ConvTranspose2d``) that concatenate the
skip, closed by a 1×1 conv to per-pixel class logits; per-pixel softmax
cross-entropy on (B, H, W) integer labels."""

from __future__ import annotations

from torch import nn

from .. import autograd, layer
from .common import Classifier, apply_dist_option

__all__ = ["DoubleConv", "Down", "Up", "UNet", "unet"]


class DoubleConv(layer.Layer):
    def __init__(self, out_channels):
        super().__init__()
        self.conv1 = layer.Conv2d(out_channels, 3, padding=1, bias=False)
        self.bn1 = layer.BatchNorm2d()
        self.conv2 = layer.Conv2d(out_channels, 3, padding=1, bias=False)
        self.bn2 = layer.BatchNorm2d()
        self.relu = layer.ReLU()

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(x)))


class Down(layer.Layer):
    def __init__(self, out_channels):
        super().__init__()
        self.pool = layer.MaxPool2d(2, 2)
        self.conv = DoubleConv(out_channels)

    def forward(self, x):
        return self.conv(self.pool(x))


class Up(layer.Layer):
    """2×2-stride transposed-conv upsample, concat the skip, double
    conv."""

    def __init__(self, out_channels):
        super().__init__()
        self.up = layer.ConvTranspose2d(out_channels, 2, stride=2)
        self.conv = DoubleConv(out_channels)

    def forward(self, x, skip):
        x = self.up(x)
        return self.conv(autograd.cat([skip, x], axis=1))


class UNet(Classifier):
    """``num_classes`` per-pixel logits; ``base_channels`` sets the width
    and ``depth`` the number of down/up stages."""

    def __init__(self, num_classes=2, base_channels=16, depth=3):
        super().__init__()
        assert depth >= 1
        self.inc = DoubleConv(base_channels)
        self.downs = nn.ModuleList(Down(base_channels * 2 ** (i + 1))
                                   for i in range(depth))
        self.ups = nn.ModuleList(Up(base_channels * 2 ** (depth - 1 - i))
                                 for i in range(depth))
        self.outc = layer.Conv2d(num_classes, 1)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        f = 2 ** len(self.downs)
        if h % f or w % f:
            raise ValueError(
                f"UNet(depth={len(self.downs)}) needs H and W divisible "
                f"by {f}, got {h}x{w}: pooling floors odd sizes, so the "
                f"decoder's skip concat would mismatch")
        feats = [self.inc(x)]
        for d in self.downs:
            feats.append(d(feats[-1]))
        y = feats[-1]
        for u, skip in zip(self.ups, reversed(feats[:-1])):
            y = u(y, skip)
        return self.outc(y)

    def train_one_batch(self, x, y, dist_option="plain", spars=None):
        """``y``: (B, H, W) integer labels; per-pixel cross-entropy."""
        out = self.forward(x)
        b, c, h, w = out.shape
        flat = autograd.reshape(
            autograd.transpose(out, (0, 2, 3, 1)), (b * h * w, c))
        loss = self.softmax_cross_entropy(
            flat, autograd.reshape(y, (b * h * w,)))
        apply_dist_option(self.optimizer, loss, dist_option, spars)
        return out, loss


def unet(num_classes=2, base_channels=16, depth=3):
    return UNet(num_classes, base_channels, depth)
