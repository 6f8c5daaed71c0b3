"""ResNet-50-class conv net with GroupNorm — the port of
edl_tpu.models.resnet.

Activations stay NHWC, as in the JAX package, so every GroupNorm site is a
contiguous ``[b, hw, c]`` view for :mod:`edl_tpu_torch.ops.group_norm` (the
hand-written kernels on the card).  Convolutions run on the channels-last
NCHW view of the same memory through ``F.conv2d``; the weights keep the
JAX tree's HWIO layout and names (``stem``, ``stem_norm.scale``,
``stages.{i}.{j}.conv1``, …, ``head``, ``head_bias``) and live in fp32, so
they carry across unchanged (:mod:`edl_tpu_torch.interop`); compute runs in
``cfg.dtype``.  Padding is JAX's ``"SAME"``, which pads less before than
after where the total is odd (every stride-2 window on an even input), so
it is written out with ``F.pad`` where it is not symmetric.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from edl_tpu_torch.device import resolve
from edl_tpu_torch.ops.group_norm import group_norm


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    groups: int = 32  # GroupNorm groups
    dtype: torch.dtype = torch.bfloat16
    #: "conv7" = 7x7-stride-2 stem + 3x3 max-pool; "s2d" = 4x4
    #: space-to-depth + 2x2 conv straight to H/4
    stem: str = "conv7"


RESNET50 = ResNetConfig()
RESNET50_TPU = ResNetConfig(stem="s2d")
TINY = ResNetConfig(stage_sizes=(1, 1), width=8, num_classes=10, groups=4,
                    dtype=torch.float32)


# -- parameters --------------------------------------------------------------


class Norm(nn.Module):
    """One GroupNorm's parameters (``scale``, ``bias``)."""

    def __init__(self, c: int, device: torch.device) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int, device, conv) -> None:
        super().__init__()
        self.conv1 = conv(1, 1, cin, cmid)
        self.norm1 = Norm(cmid, device)
        self.conv2 = conv(3, 3, cmid, cmid)
        self.norm2 = Norm(cmid, device)
        self.conv3 = conv(1, 1, cmid, cout)
        self.norm3 = Norm(cout, device)
        if cin != cout:
            self.proj = conv(1, 1, cin, cout)
            self.proj_norm = Norm(cout, device)


class ResNet(nn.Module):
    """The net's parameters (fp32, HWIO convs), initialized from ``seed``
    with a ``torch.Generator`` on ``device`` as the JAX package's ``init``
    draws them; ``forward`` is :func:`apply`."""

    def __init__(self, cfg: ResNetConfig, device="cuda", seed: int = 0
                 ) -> None:
        super().__init__()
        dev = resolve(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg

        def conv(kh, kw, cin, cout):
            w = torch.randn(kh, kw, cin, cout, generator=gen, device=dev)
            return nn.Parameter(w * (2.0 / (kh * kw * cin)) ** 0.5)

        self.stem = (conv(2, 2, 48, cfg.width) if cfg.stem == "s2d"
                     else conv(7, 7, 3, cfg.width))
        self.stem_norm = Norm(cfg.width, dev)
        self.stages = nn.ModuleList()
        cin = cfg.width
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            cmid = cfg.width * 2 ** stage
            blocks = nn.ModuleList()
            for _ in range(n_blocks):
                blocks.append(Bottleneck(cin, cmid, cmid * 4, dev, conv))
                cin = cmid * 4
            self.stages.append(blocks)
        self.head = nn.Parameter(
            torch.randn(cin, cfg.num_classes, generator=gen, device=dev)
            * (1.0 / cin) ** 0.5)
        self.head_bias = nn.Parameter(torch.zeros(cfg.num_classes,
                                                  device=dev))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return apply(self, images)


# -- building blocks ---------------------------------------------------------


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial dim under JAX's "SAME": the
    output is ceil(size / stride) and the odd pixel goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC ``x`` · HWIO ``w`` with JAX "SAME" padding → NHWC, in x's
    dtype.  The conv runs on channels-last views, so its output is NHWC in
    memory."""
    kh, kw = w.shape[:2]
    (top, bottom), (left, right) = (same_pads(x.shape[1], kh, stride),
                                    same_pads(x.shape[2], kw, stride))
    wt = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if top == bottom and left == right:
        return _nhwc(F.conv2d(_nchw(x), wt, stride=stride,
                              padding=(top, left)))
    x = F.pad(x, (0, 0, left, right, top, bottom))
    return _nhwc(F.conv2d(_nchw(x), wt, stride=stride))


def _max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2
                   ) -> torch.Tensor:
    """``reduce_window(max, -inf, SAME)`` on NHWC."""
    (top, bottom), (left, right) = (same_pads(x.shape[1], k, stride),
                                    same_pads(x.shape[2], k, stride))
    x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), k, stride))


def _group_norm(x: torch.Tensor, p: Norm, groups: int, eps: float = 1e-5
                ) -> torch.Tensor:
    return group_norm(x, p.scale, p.bias, groups, eps)


def _bottleneck(x: torch.Tensor, blk: Bottleneck, groups: int, stride: int
                ) -> torch.Tensor:
    y = F.relu(_group_norm(_conv(x, blk.conv1), blk.norm1, groups))
    y = F.relu(_group_norm(_conv(y, blk.conv2, stride), blk.norm2, groups))
    y = _group_norm(_conv(y, blk.conv3), blk.norm3, groups)
    if hasattr(blk, "proj"):
        x = _group_norm(_conv(x, blk.proj, stride), blk.proj_norm, groups)
    return F.relu(x + y)


def apply(model: ResNet, images: torch.Tensor,
          cfg: ResNetConfig | None = None) -> torch.Tensor:
    """images [b, h, w, 3] → logits [b, num_classes] (fp32); ``cfg``
    (default: the model's own) as the JAX package passes it."""
    cfg = cfg or model.cfg
    x = images.to(cfg.dtype)
    if cfg.stem == "s2d":
        b, h, w, c = x.shape
        x = x.reshape(b, h // 4, 4, w // 4, 4, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 4, w // 4, 16 * c)
        x = _conv(x, model.stem)
        x = F.relu(_group_norm(x, model.stem_norm, cfg.groups))
    else:
        x = _conv(x, model.stem, stride=2)
        x = F.relu(_group_norm(x, model.stem_norm, cfg.groups))
        x = _max_pool_same(x)
    for stage, blocks in enumerate(model.stages):
        for i, blk in enumerate(blocks):
            x = _bottleneck(x, blk, cfg.groups,
                            2 if (stage > 0 and i == 0) else 1)
    x = x.mean(dim=(1, 2))  # global average pool
    return (x @ model.head.to(x.dtype) + model.head_bias).float()


def loss_fn(model: ResNet, batch, cfg: ResNetConfig | None = None
            ) -> torch.Tensor:
    """Mean cross entropy; batch = (images [b, h, w, 3], labels [b])."""
    images, labels = batch
    logp = F.log_softmax(apply(model, images, cfg), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def make_loss_fn(cfg: ResNetConfig):
    return functools.partial(loss_fn, cfg=cfg)


def group_norm_sites(cfg: ResNetConfig, hw: int) -> Counter:
    """How many GroupNorm sites of each ``(h·w, c)`` one forward at
    ``hw`` x ``hw`` images runs (53 sites at ResNet-50)."""
    sites: Counter = Counter()
    size = -(-hw // 4) if cfg.stem == "s2d" else -(-hw // 2)
    sites[(size * size, cfg.width)] += 1
    if cfg.stem != "s2d":
        size = -(-size // 2)
    cin = cfg.width
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        cmid = cfg.width * 2 ** stage
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            sites[(size * size, cmid)] += 1  # norm1, before the stride
            size = -(-size // stride)
            sites[(size * size, cmid)] += 1  # norm2
            sites[(size * size, cmid * 4)] += 1 + (cin != cmid * 4)
            cin = cmid * 4
    return sites
