"""ResNet-101 v1 image backbone of the raw-image model: bottleneck blocks
with the stride on the 3x3 conv (the tf-slim / torchvision v1.5 convention,
so public checkpoints convert layer for layer), compute in the configured
dtype with float32 parameters and BatchNorm statistics, inference-mode
BatchNorm unless batch statistics are asked for. 448x448 inputs -> output
stride 32 -> a 14x14x2048 grid.

Activations are NCHW tensors in the ``channels_last`` memory format, so the
last stage's [B, 2048, 14, 14] is physically [B, 14, 14, 2048] and
``grid`` is a view of it. Convolutions are cuDNN's (the JAX package leaves
them to XLA: there is no TPU kernel here); BatchNorm and ReLU are plain
PyTorch, BatchNorm computed as flax computes it (:class:`BatchNorm`).

:func:`convert_torch_state_dict` maps a torchvision-format ``resnet101``
state dict onto this module's ``state_dict``, rewriting the 7x7 stem for
the space-to-depth stems.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vqa_transfer_externaldata_torch.ops.layers import lecun_normal_

RESNET101_STAGES = (3, 4, 23, 3)
# tf-slim v1 preprocessing: RGB mean subtraction, no scaling.
RGB_MEAN = (123.68, 116.779, 103.939)
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's BatchNorm default
STEMS = ("conv", "space_to_depth", "space_to_depth_4")
# The stem of the raw-image model and of the extractor: the exact
# space-to-depth rewrite of the 7x7 conv, which checkpoints convert to.
BACKBONE_STEM = "space_to_depth"


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 as flax computes it: ``(x - mean) * (scale *
    rsqrt(var + eps)) + bias`` in float32 from the input, then cast to
    ``dtype``. ``scale``/``bias`` are parameters, ``mean``/``var`` buffers
    (the JAX package's ``batch_stats``).

    ``train`` is an argument, not ``nn.Module.training``: the default
    (inference) normalizes with the buffers and never changes them, which
    is all that the raw-image model and the extractor run. ``train=True``
    normalizes with the batch's statistics (float32, the variance as
    ``max(0, E[x^2] - E[x]^2)``) and moves the buffers toward them by
    ``BN_MOMENTUM``, as flax's ``BatchNorm(use_running_average=False)``.
    ``repeat`` tiles the per-feature vectors over a channel axis that
    packs ``repeat`` groups of ``features`` (the ``space_to_depth_4``
    stem), whose batch statistics then pool the groups."""

    def __init__(self, features: int, *, dtype: torch.dtype,
                 repeat: int = 1) -> None:
        super().__init__()
        self.dtype = dtype
        self.repeat = repeat
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        r = self.repeat
        xf = x.float()
        if train:
            # [B, r*F, ...] -> [B, r, F, ...]: the statistics over all but F.
            g = xf.unflatten(1, (r, -1))
            dims = (0, 1) + tuple(range(3, g.dim()))
            mean = g.mean(dims)
            var = torch.clamp((g * g).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = BN_MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        vecs = (mean, torch.rsqrt(var + BN_EPS) * self.scale, self.bias)
        if r > 1:
            vecs = tuple(t.repeat(r) for t in vecs)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean, mul, bias = (t.view(shape) for t in vecs)
        return ((xf - mean) * mul + bias).to(self.dtype)


class Conv(nn.Module):
    """A bias-free conv with a float32 OIHW ``weight`` cast to ``dtype`` at
    use, symmetric ``padding`` and flax's lecun-normal init."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        with torch.no_grad():
            lecun_normal_(self.weight, cin * k * k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # One copy: cast, and on the card the channels_last layout of the
        # activations, which cuDNN then keeps.
        w = self.weight.to(self.dtype, memory_format=(
            torch.channels_last if x.is_cuda else torch.preserve_format))
        return F.conv2d(x.to(self.dtype), w, stride=self.stride,
                        padding=self.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here, padding k//2) -> 1x1 (4x ``features``),
    each conv followed by BatchNorm, ReLU after the first two and after the
    residual sum; the residual is a strided 1x1 projection when the channels
    or the stride change."""

    def __init__(self, cin: int, features: int, *, stride: int = 1,
                 dtype: torch.dtype,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        g, out = generator, 4 * features
        self.conv1 = Conv(cin, features, 1, dtype=dtype, generator=g)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = Conv(features, features, 3, stride=stride, padding=1,
                          dtype=dtype, generator=g)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3 = Conv(features, out, 1, dtype=dtype, generator=g)
        self.bn3 = BatchNorm(out, dtype=dtype)
        self.project = cin != out or stride != 1
        if self.project:
            self.conv_proj = Conv(cin, out, 1, stride=stride, dtype=dtype,
                                  generator=g)
            self.bn_proj = BatchNorm(out, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        residual = (self.bn_proj(self.conv_proj(x), train) if self.project
                    else x)
        return torch.relu(out + residual)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/b, W/b, b*b*C], channel index (dy, dx, c)."""
    B, H, W, C = x.shape
    b = block
    x = x.reshape(B, H // b, b, W // b, b, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // b, W // b, b * b * C)


def conv1_to_space_to_depth(w7: np.ndarray) -> np.ndarray:
    """[7,7,C,O] (HWIO) stem weights -> the equivalent [4,4,4C,O] kernel
    applied (stride 1, padding (2,1)) to a space-to-depth(2) input: tap
    (kY,kX,dy,dx) reads original tap (2kY+dy-1, 2kX+dx-1), out-of-range
    taps zero."""
    C, O = w7.shape[2], w7.shape[3]
    out = np.zeros((4, 4, 4 * C, O), w7.dtype)
    for kY in range(4):
        for kX in range(4):
            for dy in range(2):
                for dx in range(2):
                    ky, kx = 2 * kY + dy - 1, 2 * kX + dx - 1
                    if 0 <= ky < 7 and 0 <= kx < 7:
                        d = (dy * 2 + dx) * C
                        out[kY, kX, d:d + C] = w7[ky, kx]
    return out


def conv1_to_space_to_depth4(w7: np.ndarray) -> np.ndarray:
    """[7,7,C,O] (HWIO) stem weights -> the equivalent [3,3,16C,4O] kernel
    of the ``space_to_depth_4`` stem: input space-to-depth(4) (channel
    index (dy, dx, c)), output the four conv1 stride phases packed as
    channel index (ry, rx, o); tap k = 4*kY + dy - 2r - 1, zero outside
    0..6."""
    C, O = w7.shape[2], w7.shape[3]
    out = np.zeros((3, 3, 16 * C, 4 * O), w7.dtype)
    for kY in range(3):
        for kX in range(3):
            for dy in range(4):
                for dx in range(4):
                    for ry in range(2):
                        for rx in range(2):
                            ky = 4 * kY + dy - 2 * ry - 1
                            kx = 4 * kX + dx - 2 * rx - 1
                            if 0 <= ky < 7 and 0 <= kx < 7:
                                ci = (dy * 4 + dx) * C
                                oi = (ry * 2 + rx) * O
                                out[kY, kX, ci:ci + C, oi:oi + O] = \
                                    w7[ky, kx]
    return out


def _phase_max(x: torch.Tensor) -> torch.Tensor:
    """The 3x3/s2/p1 max pool of the 224-grid from its four stride phases:
    x [B, Hq, Wq, 2 (ry), 2 (rx), F] -> [B, Hq, Wq, F]. Pool output m covers
    positions {2m-1, 2m, 2m+1} = phases {(m-1, r=1), (m, 0), (m, 1)} on
    each axis; the missing m-1 at the edge is -inf."""
    prev_y = F.pad(x[:, :-1, :, 1], (0, 0, 0, 0, 0, 0, 1, 0),
                   value=-float("inf"))
    x = torch.maximum(torch.maximum(prev_y, x[:, :, :, 0]), x[:, :, :, 1])
    prev_x = F.pad(x[:, :, :-1, 1], (0, 0, 1, 0), value=-float("inf"))
    return torch.maximum(torch.maximum(prev_x, x[:, :, :, 0]), x[:, :, :, 1])


class ResNetV1(nn.Module):
    """[B, S, S, 3] float images (preprocessed) -> {"grid": [B, S/32, S/32,
    4*8*width] in ``dtype`` (a view of the channels_last activations),
    "pool5": its float32 mean over the grid}.

    Stems: ``"conv"`` the 7x7/s2/p3 conv; ``"space_to_depth"`` the same
    conv rewritten exactly as a 4x4/s1 conv over a space-to-depth(2) input
    padded (2, 1) on each axis (:func:`conv1_to_space_to_depth`);
    ``"space_to_depth_4"`` the whole stem (conv, BatchNorm, ReLU, max pool)
    over a space-to-depth(4) input, the four conv stride phases packed in
    the output channels and pooled by a 9-way shifted max. Parameter names
    follow the JAX package's tree (``conv1``, ``bn1``, ``layer{s}_{b}``)."""

    def __init__(self, stage_sizes: Sequence[int] = RESNET101_STAGES,
                 width: int = 64, *, dtype: torch.dtype = torch.bfloat16,
                 stem: str = "conv",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"stem={stem!r}: expected one of {STEMS}")
        g = generator
        self.dtype, self.stem, self.width = dtype, stem, width
        self.stage_sizes = tuple(stage_sizes)
        if stem == "space_to_depth_4":
            self.conv1 = Conv(48, 4 * width, 3, padding=1, dtype=dtype,
                              generator=g)
            self.bn1 = BatchNorm(width, dtype=dtype, repeat=4)
        elif stem == "space_to_depth":
            self.conv1 = Conv(12, width, 4, dtype=dtype, generator=g)
            self.bn1 = BatchNorm(width, dtype=dtype)
        else:
            self.conv1 = Conv(3, width, 7, stride=2, padding=3, dtype=dtype,
                              generator=g)
            self.bn1 = BatchNorm(width, dtype=dtype)
        cin = width
        self.blocks = []
        for stage, n_blocks in enumerate(self.stage_sizes):
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"layer{stage + 1}_{block}"
                features = width * 2 ** stage
                self.add_module(name, Bottleneck(
                    cin, features, stride=stride, dtype=dtype, generator=g))
                self.blocks.append(name)
                cin = 4 * features
        self.out_channels = cin

    def stem_forward(self, x: torch.Tensor,
                     train: bool = False) -> torch.Tensor:
        """[B, S, S, 3] -> the stem's pooled NCHW (channels_last) output."""
        x = x.to(self.dtype)
        if self.stem == "space_to_depth_4":
            x = space_to_depth(x, 4).permute(0, 3, 1, 2)
            x = torch.relu(self.bn1(self.conv1(x), train))  # [B, 4F, Hq, Wq]
            B, _, Hq, Wq = x.shape
            x = x.permute(0, 2, 3, 1).reshape(B, Hq, Wq, 2, 2, self.width)
            return _phase_max(x).permute(0, 3, 1, 2)
        if self.stem == "space_to_depth":
            x = space_to_depth(x, 2).permute(0, 3, 1, 2)
            x = self.conv1(F.pad(x, (2, 1, 2, 1)))
        else:
            x = self.conv1(x.permute(0, 3, 1, 2))
        x = torch.relu(self.bn1(x, train))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        """``train``: batch statistics in every BatchNorm, which then move
        its buffers (:class:`BatchNorm`); no entry point of the port asks
        for it, as none of the JAX package's does."""
        x = self.stem_forward(x, train).contiguous(
            memory_format=torch.channels_last)
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        grid = x.permute(0, 2, 3, 1)  # [B, h, w, C], channels_last: a view
        return {"grid": grid, "pool5": grid.float().mean(dim=(1, 2))}


def preprocess_images(images: torch.Tensor, size: int = 448) -> torch.Tensor:
    """[B, H, W, 3] uint8 RGB -> [B, size, size, 3] float32, mean-subtracted
    (tf-slim v1); resized only when the size differs, bilinear with
    antialiasing (``jax.image.resize(..., "bilinear", antialias=True)``)."""
    x = images.float()
    if x.shape[1] != size or x.shape[2] != size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", antialias=True,
                          align_corners=False).permute(0, 2, 3, 1)
    # Filled on the device: a host list copied up would be a pageable copy,
    # which waits for the queue and cannot be captured in a CUDA graph.
    return x - torch.stack([torch.full((), m, dtype=torch.float32,
                                       device=x.device) for m in RGB_MEAN])


def conv_macs(model: ResNetV1, image_size: int) -> int:
    """Multiply-accumulates of every conv of ``model`` on one square image
    of ``image_size`` pixels a side, from its convs' weight shapes, strides
    and paddings."""

    def side(s: int, conv: Conv, pad: int) -> int:
        return (s + pad - conv.weight.shape[-1]) // conv.stride + 1

    def macs(conv: Conv, s: int) -> int:
        return s * s * int(np.prod(conv.weight.shape))

    block = {"conv": 1, "space_to_depth": 2, "space_to_depth_4": 4}
    s_in = image_size // block[model.stem]
    extra = 3 if model.stem == "space_to_depth" else 0  # padding (2, 1)
    s = side(s_in, model.conv1, 2 * model.conv1.padding + extra)
    total = macs(model.conv1, s)
    if model.stem != "space_to_depth_4":
        s = (s + 2 - 3) // 2 + 1  # the 3x3/s2/p1 max pool
    for name in model.blocks:
        b = getattr(model, name)
        s_out = s
        for conv in (b.conv1, b.conv2, b.conv3):
            s_out = side(s_out, conv, 2 * conv.padding)
            total += macs(conv, s_out)
        if b.project:
            total += macs(b.conv_proj, side(s, b.conv_proj, 0))
        s = s_out
    return total


# ---------------------------------------------------------------------------
# torchvision-format weight conversion
# ---------------------------------------------------------------------------


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _oihw(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (3, 2, 0, 1)), dtype=np.float32))


def convert_torch_state_dict(sd: Mapping[str, object],
                             stage_sizes: Sequence[int] = RESNET101_STAGES,
                             stem: str = "conv") -> Dict[str, torch.Tensor]:
    """torchvision ``resnet101().state_dict()`` (tensors or arrays) ->
    :class:`ResNetV1`'s ``state_dict`` (float32): conv weights, BatchNorm
    ``scale``/``bias`` and its ``mean``/``var`` statistics. The 7x7 stem is
    rewritten into the space-to-depth form of ``stem``. A missing key
    raises ``KeyError``."""
    if stem not in STEMS:
        raise ValueError(f"stem={stem!r}: expected one of {STEMS}")
    src = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v)
                         else v, np.float32) for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}

    def put_bn(dst: str, name: str) -> None:
        for leaf, key in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            out[f"{dst}.{leaf}"] = torch.from_numpy(
                src[f"{name}.{key}"].copy())

    conv1 = _hwio(src["conv1.weight"])
    if stem == "space_to_depth":
        conv1 = conv1_to_space_to_depth(conv1)
    elif stem == "space_to_depth_4":
        conv1 = conv1_to_space_to_depth4(conv1)
    out["conv1.weight"] = _oihw(conv1)
    put_bn("bn1", "bn1")
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            dst, name = f"layer{stage + 1}_{block}", f"layer{stage + 1}.{block}"
            for i in (1, 2, 3):
                out[f"{dst}.conv{i}.weight"] = torch.from_numpy(
                    src[f"{name}.conv{i}.weight"].copy())
                put_bn(f"{dst}.bn{i}", f"{name}.bn{i}")
            if f"{name}.downsample.0.weight" in src:
                out[f"{dst}.conv_proj.weight"] = torch.from_numpy(
                    src[f"{name}.downsample.0.weight"].copy())
                put_bn(f"{dst}.bn_proj", f"{name}.downsample.1")
    return out


def torchvision_state_dict(model: ResNetV1) -> Dict[str, torch.Tensor]:
    """A ``conv``-stem :class:`ResNetV1`'s weights and statistics under
    torchvision's resnet names (``num_batches_tracked`` 0): the inverse of
    :func:`convert_torch_state_dict`, for writing a checkpoint the
    converters read."""
    if model.stem != "conv":
        raise ValueError("torchvision_state_dict needs the 7x7 'conv' stem")
    out: Dict[str, torch.Tensor] = {}

    def put_bn(dst: str, bn: BatchNorm) -> None:
        for leaf, key in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            out[f"{dst}.{key}"] = getattr(bn, leaf).detach().clone()
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    out["conv1.weight"] = model.conv1.weight.detach().clone()
    put_bn("bn1", model.bn1)
    for name in model.blocks:
        block = getattr(model, name)
        stage, index = name[len("layer"):].split("_")
        dst = f"layer{stage}.{index}"
        for i in (1, 2, 3):
            out[f"{dst}.conv{i}.weight"] = \
                getattr(block, f"conv{i}").weight.detach().clone()
            put_bn(f"{dst}.bn{i}", getattr(block, f"bn{i}"))
        if block.project:
            out[f"{dst}.downsample.0.weight"] = \
                block.conv_proj.weight.detach().clone()
            put_bn(f"{dst}.downsample.1", block.bn_proj)
    return out
