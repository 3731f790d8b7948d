"""ResNet image classifiers in PyTorch — counterpart of
``pytorch_distributed_training_example_tpu/models/resnet.py``.

The classic architecture: a stem (7x7/2 conv, BatchNorm, ReLU, 3x3/2
max-pool; for small images a 3x3/1 conv and no pool), four stages of
residual blocks (``BasicBlock`` for ResNet-18/34, ``Bottleneck`` for
ResNet-50/101/152, a 1x1 projection where a block changes the shape), a
global mean over H and W and a linear head. Submodule names follow the flax
parameter tree (``conv_init``, ``bn_init``, ``BasicBlock_<i>`` or
``Bottleneck_<i>`` numbered across the stages, inside them ``Conv_<j>``,
``BatchNorm_<j>``, ``downsample_conv``, ``downsample_norm``; ``head``), so
``bridge.py`` maps a JAX checkpoint leaf by leaf. Conv kernels are stored
OIHW (flax: HWIO).

Images come in NHWC, as the loader gives them; the model permutes them to
NCHW without a copy, which is PyTorch's channels_last layout, and the
convolutions, BatchNorm and pooling run through cuDNN and PyTorch's own
kernels in that layout (XLA ops in the JAX package: no Pallas kernel).

What the flax modules do, and this one with them:

- ``padding="SAME"`` pads ``total = max((out - 1) * stride + k - in, 0)``
  with ``total // 2`` before and the rest after, so a stride-2 3x3 conv on
  an even size pads (0, 1), the 7x7/2 stem at 224 (2, 3), and the SAME
  max-pool pads (0, 1) with -inf: explicit pads, since PyTorch's
  ``padding=`` is symmetric.
- BatchNorm: statistics over N, H, W in fp32 (or fp64 for fp64 inputs)
  whatever the compute dtype, normalisation in that type and the result in
  the compute dtype, eps 1e-5;
  running averages ``0.9 * running + 0.1 * batch`` with the *biased* batch
  variance (``nn.BatchNorm2d`` keeps the unbiased one, so it is not used).
  Training normalises by the batch's statistics and updates the running
  ones once per forward; eval (``model.eval()``) normalises by the running
  ones and updates nothing.
- Init: convs ``he_normal`` (truncated normal, fan-in), the last BatchNorm
  scale of every block zero, the head's kernel lecun normal and its bias
  zero.
- The global mean and the head run in the compute dtype; logits are fp32.

No dropout (the JAX factories have none either).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_training_example_tpu_torch.models.gpt2 import _dense

BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5
# Truncated normal at +-2 std has std 0.8796 of the untruncated one; flax's
# variance_scaling divides it out.
_TRUNC_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial axis under ``padding="SAME"``
    (``lax.padtype_to_pads``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` [B, C, H, W] padded for a SAME window; ``(x, padding)`` where a
    symmetric pad is left to the op (``padding``) and an asymmetric one is
    applied here."""
    ph = same_pads(x.shape[2], kernel, stride)
    pw = same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias, SAME padding, at the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(torch.empty(
            cout, cin, kernel, kernel, dtype=param_dtype, device=device))

    def forward(self, x):
        x, padding = _pad_same(x.to(self.dtype), self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channels
    of a [B, C, H, W] tensor (see the module docstring)."""

    def __init__(self, channels: int, dtype=torch.float32,
                 param_dtype=torch.float32, zero_scale: bool = False,
                 device=None):
        super().__init__()
        self.dtype, self.zero_scale = dtype, zero_scale
        self.weight = nn.Parameter(torch.empty(channels, dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(channels, dtype=param_dtype,
                                             device=device))
        self.register_buffer("running_mean", torch.empty(
            channels, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.empty(
            channels, dtype=torch.float32, device=device))

    def forward(self, x):
        # Statistics and normalisation in fp32, or wider for a wider x.
        dt = torch.promote_types(x.dtype, torch.float32)
        w, b = self.weight.to(dt), self.bias.to(dt)
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(dt),
                                self.running_var.to(dt), w, b, training=False,
                                eps=BN_EPSILON).to(self.dtype)
        # The batch statistics with the normalisation; the inverse std gives
        # the biased variance back for the running average.
        y, mean, invstd = torch.ops.aten._native_batch_norm_legit.no_stats(
            x, w, b, True, 0.0, BN_EPSILON)
        with torch.no_grad():
            var = (invstd.double().pow(-2) - BN_EPSILON).float()
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)
        return y.to(self.dtype)


class _Block(nn.Module):
    """What both blocks share: the 1x1 projection of the residual where
    the block changes the shape (stride 2 or more channels)."""

    def _downsample(self, cin: int, cout: int, stride: int, kw: dict):
        self.has_downsample = cin != cout or stride != 1
        if self.has_downsample:
            self.downsample_conv = Conv(cin, cout, 1, stride, **kw)
            self.downsample_norm = BatchNorm(cout, **kw)

    def residual(self, x):
        if self.has_downsample:
            return self.downsample_norm(self.downsample_conv(x))
        return x


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, **kw):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, **kw)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True, **kw)
        self._downsample(cin, filters, stride, kw)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        return F.relu(self.residual(x) + y)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, **kw):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, filters * 4, 1, **kw)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True, **kw)
        self._downsample(cin, filters * 4, stride, kw)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        return F.relu(self.residual(x) + y)


class ResNet(nn.Module):
    """ResNet with the JAX module's fields (``stage_sizes``, ``block_cls``,
    ``num_classes``, ``num_filters``, ``dtype``, ``param_dtype``,
    ``small_images``). ``max_blocks`` cuts depth for smoke runs: each stage
    keeps at most that many blocks (its first, which changes the shape,
    always), at the stage's width."""

    def __init__(self, stage_sizes, block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.float32,
                 param_dtype=torch.float32, small_images: bool = False,
                 max_blocks: int | None = None, device=None):
        super().__init__()
        self.stage_sizes = [min(n, max_blocks or n) for n in stage_sizes]
        self.num_classes = num_classes
        self.dtype = dtype
        self.small_images = small_images
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        if small_images:
            self.conv_init = Conv(3, num_filters, 3, **kw)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, **kw)
        self.bn_init = BatchNorm(num_filters, **kw)
        cin, n = num_filters, 0
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                block = block_cls(cin, num_filters * 2 ** i,
                                  2 if i > 0 and j == 0 else 1, **kw)
                self.add_module(f"{block_cls.__name__}_{n}", block)
                cin, n = num_filters * 2 ** i * block_cls.expansion, n + 1
        self.num_blocks = n
        self.block_name = block_cls.__name__
        self.head = nn.Linear(cin, num_classes, dtype=param_dtype,
                              device=device)

    def blocks(self):
        return [getattr(self, f"{self.block_name}_{i}")
                for i in range(self.num_blocks)]

    def decayed_parameter_names(self) -> set[str]:
        """Names of the parameters whose flax leaf has ``ndim >= 2`` (the
        JAX ``_wd_mask``): the conv kernels and the head's kernel; not the
        BatchNorm scales and biases nor the head's bias."""
        return {n for n, p in self.named_parameters() if p.ndim >= 2}

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """The port's seeded init, drawn where the parameters live, with
        the flax initialisers' laws: convs he normal (truncated at two
        std, std sqrt(2 / fan_in)), the head lecun normal (sqrt(1 /
        fan_in)), BatchNorm scales one (zero for each block's last) and
        biases zero, running means zero and variances one. JAX draws other
        bits from the same seed; tests that compare the two packages carry
        weights across with ``bridge.py`` instead."""
        gen = torch.Generator(device=self.head.weight.device)
        gen.manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (Conv, nn.Linear)):
                w = module.weight
                gain = 2.0 if isinstance(module, Conv) else 1.0
                std = math.sqrt(gain / w[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.weight.fill_(0.0 if module.zero_scale else 1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)

    def forward(self, images: torch.Tensor, generator=None) -> torch.Tensor:
        """[B, H, W, 3] images (NHWC, as the JAX package's) -> [B,
        num_classes] fp32 logits. ``generator`` is the train loop's dropout
        generator, unused: ResNet has no dropout."""
        x = self.bn_init(self.conv_init(
            images.to(self.dtype).permute(0, 3, 1, 2)))
        x = F.relu(x)
        if not self.small_images:
            x, padding = _pad_same(x, 3, 2, value=float("-inf"))
            x = F.max_pool2d(x, 3, 2, padding=padding)
        for block in self.blocks():
            x = block(x)
        x = x.mean(dim=(2, 3))
        return _dense(self.head, x, self.dtype).float()


def resnet_micro(num_classes: int = 10, **kw) -> ResNet:
    """Two-block ResNet (BasicBlock, stages [1, 1], 32 filters, the small
    image stem): the test-suite model."""
    kw.setdefault("small_images", True)
    return ResNet([1, 1], BasicBlock, num_classes=num_classes,
                  num_filters=32, **kw)


def resnet18(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes=num_classes, **kw)


def resnet34(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes=num_classes, **kw)


def resnet50(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 6, 3], Bottleneck, num_classes=num_classes, **kw)


def resnet101(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 4, 23, 3], Bottleneck, num_classes=num_classes, **kw)


def resnet152(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet([3, 8, 36, 3], Bottleneck, num_classes=num_classes, **kw)


def flops_per_image(name: str, image_size: int = 224) -> float:
    """Approximate forward FLOPs of one image (for MFU): the JAX package's
    table of published figures at 224 (ResNet-50 4.09e9), scaled with the
    image's area. Kept as JAX has it so the two packages' MFU compare. The
    figures are multiply-adds (verified by tests/test_torch_resnet_flops.py:
    a two-flop count of the port's ResNet-50 forward reads 8.178e9), so an
    MFU on them is half the two-flop one."""
    base = {"resnet18": 1.81e9, "resnet34": 3.66e9, "resnet50": 4.09e9,
            "resnet101": 7.80e9, "resnet152": 11.51e9,
            "resnet_micro": 1.2e7}[name]
    return base * (image_size / 224.0) ** 2
