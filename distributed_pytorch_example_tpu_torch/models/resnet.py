"""ResNet-18 / ResNet-50 (the JAX package's models/resnet.py; BASELINE.json
configs 1-2: ResNet-18 on CIFAR-10, ResNet-50 on ImageNet).

The constructor takes JAX's arguments (``stage_sizes``, ``block_cls``,
``num_classes``, ``num_filters``, ``small_inputs``,
``space_to_depth_stem``, ``dtype``), so narrow variants of both packages
build from the same ones.

- The input is NHWC, as the data pipeline ships it; inside, the model
  computes NCHW in ``torch.channels_last`` memory (a permuted view of the
  NHWC input, no copy), the layout cuDNN's tensor-core convolutions take.
- Parameters are float32; convolutions run in ``dtype`` (inputs and
  kernels cast, as flax's ``dtype=``); BatchNorm takes float32 statistics
  and returns ``dtype`` (``models/batchnorm.py``); the head is a float32
  Dense in both packages.
- Flax's ``padding="SAME"`` pads (total // 2, total - total // 2), with
  total = max((out - 1) * stride + k - size, 0): the 7x7/2 stem on 224
  pads (2, 3), a 3x3/2 conv or the 3x3/2 max pool on an even size (0, 1).
  Torch's symmetric ``padding=`` would shift every such window by a
  pixel, so :func:`same_pad` pads explicitly (-inf for the pool) and the
  conv runs unpadded; symmetric cases go through the conv's own padding.
- ``space_to_depth_stem``: the same 7x7 kernel (the bare parameter
  ``stem_conv_kernel``, kept in flax's HWIO layout) applied as a 4x4/1
  conv to a space-to-depth(2) input, equal to the plain stem.
- Initialisers are flax's: lecun-normal kernels, zero biases, unit
  BatchNorm scales but a zero scale on each block's last norm.

Module names reproduce flax's auto-names inside blocks (``Conv_0``,
``BatchNorm_1``, ..., ``shortcut_conv``, ``shortcut_norm``) and
``stage{s}_block{b}``, so :mod:`interop` maps the trees by name and the
leaves sort in ``jax.tree_util`` order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Type, Union

import torch
import torch.nn.functional as F
from torch import nn

from distributed_pytorch_example_tpu_torch.models.batchnorm import BatchNorm
from distributed_pytorch_example_tpu_torch.models.transformer import (
    lecun_normal_,
)
from distributed_pytorch_example_tpu_torch.runtime.device import resolve_device

CHANNELS = 3  # RGB: every dataset the port loads ships three channels


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA SAME padding (lo, hi) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, k: int, stride: int,
             value: float = 0.0) -> Tuple[torch.Tensor, Union[int, Tuple]]:
    """(input, conv padding) that give flax's SAME output for a k x k
    window at ``stride`` on NCHW ``x``: symmetric padding is left to the
    conv, anything else is padded here with ``value``."""
    (t, b), (l, r) = (_same(x.shape[2], k, stride),
                      _same(x.shape[3], k, stride))
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), 0


class Conv(nn.Conv2d):
    """flax ``nn.Conv(padding="SAME", use_bias=False, dtype=...)``: a k x k
    conv at ``stride``, kernel and input cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, bias=False)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if generator is not None:  # nn.Conv2d.__init__ calls it bare
            lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = same_pad(x, self.kernel_size[0], self.stride[0])
        w = self.weight.to(self.compute_dtype).contiguous(
            memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=padding)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ResNet-18/34); expansion 1."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 3, stride, dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        if stride != 1 or cin != filters:
            self.shortcut_conv = Conv(cin, filters, 1, stride, dtype)
            self.shortcut_norm = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if hasattr(self, "shortcut_conv"):
            x = self.shortcut_norm(self.shortcut_conv(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (the stride) -> 1x1 expand (ResNet-50/101/152);
    expansion 4."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(cin, filters, 1, 1, dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, 1, dtype)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        if stride != 1 or cin != out:
            self.shortcut_conv = Conv(cin, out, 1, stride, dtype)
            self.shortcut_norm = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if hasattr(self, "shortcut_conv"):
            x = self.shortcut_norm(self.shortcut_conv(x))
        return F.relu(x + y)


class ResNet(nn.Module):
    """NHWC ResNet: ``(B, H, W, C)`` images -> ``(B, num_classes)``
    float32 logits. ``small_inputs`` takes the CIFAR 3x3 stem (no pool);
    otherwise the ImageNet 7x7/2 stem and a 3x3/2 max pool, or the
    space-to-depth form of that stem."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: Type[nn.Module],
        num_classes: int = 1000,
        num_filters: int = 64,
        small_inputs: bool = False,
        space_to_depth_stem: bool = False,
        dtype: torch.dtype = torch.float32,
        *,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes, self.num_filters = num_classes, num_filters
        self.small_inputs = small_inputs
        self.space_to_depth_stem = space_to_depth_stem and not small_inputs
        self.dtype = dtype
        with torch.device("meta"):
            if self.space_to_depth_stem:
                self.stem_conv_kernel = nn.Parameter(
                    torch.empty(7, 7, CHANNELS, num_filters))
            else:
                k, s = (3, 1) if small_inputs else (7, 2)
                self.stem_conv = Conv(CHANNELS, num_filters, k, s, dtype)
            self.stem_norm = BatchNorm(num_filters)
            cin = num_filters
            for stage, blocks in enumerate(self.stage_sizes):
                filters = num_filters * 2 ** stage
                for block in range(blocks):
                    stride = 2 if stage > 0 and block == 0 else 1
                    self.add_module(f"stage{stage}_block{block}",
                                    block_cls(cin, filters, stride, dtype))
                    cin = filters * block_cls.expansion
            self.head = nn.Linear(cin, num_classes)
        self.to_empty(device=dev)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers, drawn in module order from ``generator``."""
        for module in self.modules():
            if isinstance(module, Conv):
                module.reset_parameters(generator)
            elif isinstance(module, BatchNorm):
                module.reset_parameters()
        if self.space_to_depth_stem:
            kh, kw, cin, _ = self.stem_conv_kernel.shape
            lecun_normal_(self.stem_conv_kernel, generator,
                          fan_in=kh * kw * cin)
        lecun_normal_(self.head.weight, generator)
        nn.init.zeros_(self.head.bias)

    def _stem_s2d(self, x: torch.Tensor) -> torch.Tensor:
        """The 7x7/2 SAME stem as a 4x4/1 conv on a space-to-depth(2)
        input (JAX ``ResNet._stem_s2d``): the kernel shifted into an 8x8
        with a zero first row and column and block-reshaped; the input
        padded (3, 5); the extra last output row and column dropped."""
        w = self.stem_conv_kernel.to(self.dtype)  # (7, 7, C, F), HWIO
        c, f = w.shape[2], w.shape[3]
        w4 = (F.pad(w, (0, 0, 0, 0, 1, 0, 1, 0))
              .reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1)
              .contiguous(memory_format=torch.channels_last))
        x = F.pad(x, (3, 5, 3, 5))  # NCHW: W then H
        b, _, h, wd = x.shape
        x = (x.reshape(b, c, h // 2, 2, wd // 2, 2)
             .permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, wd // 2)
             .contiguous(memory_format=torch.channels_last))
        return F.conv2d(x, w4)[:, :, :-1, :-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)  # NHWC -> NCHW view
        if self.space_to_depth_stem:
            x = self._stem_s2d(x)
        else:
            x = self.stem_conv(x)
        x = F.relu(self.stem_norm(x))
        if not self.small_inputs:
            x, padding = same_pad(x, 3, 2, value=-math.inf)
            x = F.max_pool2d(x, 3, 2, padding=padding)
        for stage, blocks in enumerate(self.stage_sizes):
            for block in range(blocks):
                x = getattr(self, f"stage{stage}_block{block}")(x)
        x = x.mean(dim=(2, 3))  # global average pool, in dtype
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ResNet18(num_classes: int = 10, small_inputs: bool = True,
             **kw) -> ResNet:
    """BASELINE.json config 1's default: CIFAR-10 (10 classes, 3x3 stem)."""
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes=num_classes,
                  small_inputs=small_inputs, **kw)


def ResNet50(num_classes: int = 1000, small_inputs: bool = False,
             **kw) -> ResNet:
    """BASELINE.json config 2's default: ImageNet (1000 classes, 7x7/2 stem
    and max pool)."""
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes=num_classes,
                  small_inputs=small_inputs, **kw)
