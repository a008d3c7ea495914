"""The CIFAR train and eval stacks in PyTorch, with a hand-written CUDA kernel.

The counterpart of ``fast_autoaugment_tpu/ops/preprocess.py``.  The order
is the reference's (``data.py:88-112``): the augmentation policy first, on
raw pixels (:func:`~fast_autoaugment_tpu_torch.ops.augment.
apply_subpolicy_draws`), then a random crop with zero padding, a random
horizontal flip, normalization, and a cutout box zeroed on the
*normalized* image.

Randomness enters only as tensors: per image, ``draws [N, 5]`` int32 =
(crop offset y in [0, 2*pad], crop offset x in [0, 2*pad], flip bit,
cutout centre y in [0, H), cutout centre x in [0, W)), the draws the JAX
package takes from ``_cifar_train_one``'s key (``:91-106``).
:func:`~fast_autoaugment_tpu_torch.ops.augment.sample_crop` makes them
from counter-based keys.

Normalization is ``(img * (1/255) - mean) * (1/std)`` with both
reciprocals rounded to float32 and each product and difference rounded on
its own.  That is what XLA compiles the reference's
``(img / 255.0 - mean) / std`` into on the CPU without fused multiply-add,
so the two agree bit for bit; the true divisions differ from it in the
last place for 431 of the 768 (level, channel) pairs.

The stack after the policy is one CUDA kernel (``csrc/preprocess.cu``): on
a CUDA tensor :func:`cifar_stack` launches it or raises; only a CPU tensor
goes to the plain version.  Its output is ``[N, 3, H, W]`` in
``channels_last`` strides (NHWC in memory): the layout of the JAX package
and the one the port's convolutions read without a copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops.augment import apply_subpolicy_draws

__all__ = [
    "CIFAR_MEAN", "CIFAR_STD", "IMAGENET_MEAN", "IMAGENET_STD", "CROP_PAD",
    "norm_constants", "normalize", "random_crop_with_pad",
    "random_hflip", "cutout_default", "cifar_stack", "cifar_stack_plain",
    "cifar_train_batch", "cifar_eval_batch", "eval_draws",
]

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)  # reference data.py:34
CIFAR_STD = (0.2023, 0.1994, 0.2010)
IMAGENET_MEAN = (0.485, 0.456, 0.406)  # reference data.py:71
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP_PAD = 4

#: 1/255 as float32, the factor XLA multiplies by for ``img / 255.0``
_SCALE = float(np.float32(1.0) / np.float32(255.0))


def norm_constants(mean: Sequence[float], std: Sequence[float]):
    """(mean, 1/std) as float32 numpy arrays of three values: the constants
    of the reciprocal form."""
    mean32 = np.asarray(mean, np.float32)
    return mean32, np.float32(1.0) / np.asarray(std, np.float32)


def normalize(img: torch.Tensor, mean: Sequence[float] = CIFAR_MEAN,
              std: Sequence[float] = CIFAR_STD) -> torch.Tensor:
    """uint8-valued [0..255] float NHWC -> normalized float (ToTensor +
    Normalize), in the reciprocal form described above."""
    mean32, rstd32 = norm_constants(mean, std)
    scale = torch.tensor(_SCALE, dtype=torch.float32, device=img.device)
    m = torch.as_tensor(mean32, device=img.device)
    r = torch.as_tensor(rstd32, device=img.device)
    return (img * scale - m) * r


def random_crop_with_pad(img: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                         pad: int = CROP_PAD) -> torch.Tensor:
    """torchvision RandomCrop(size, padding=pad) with zero fill on a batch
    ``[N, H, W, C]``: pad all sides, then take the window at ``(oy, ox)``
    (``[N]`` integers in ``[0, 2*pad]``) at the original size."""
    n, h, w, _ = img.shape
    padded = torch.nn.functional.pad(img, (0, 0, pad, pad, pad, pad))
    ys = oy.to(torch.int64).reshape(n, 1, 1) + torch.arange(h, device=img.device).reshape(1, h, 1)
    xs = ox.to(torch.int64).reshape(n, 1, 1) + torch.arange(w, device=img.device).reshape(1, 1, w)
    rows = torch.arange(n, device=img.device).reshape(n, 1, 1)
    return padded[rows, ys, xs]


def random_hflip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Mirror the images of ``img [N, H, W, C]`` whose ``flip [N]`` is set."""
    return torch.where(flip.reshape(-1, 1, 1, 1) != 0, img.flip(2), img)


def cutout_default(img: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
                   length: int) -> torch.Tensor:
    """DARTS-style cutout on the normalized batch (reference
    ``CutoutDefault``, ``data.py:228-250``): zero the ``length x length``
    box ``[c - length//2, c + length//2)`` around ``(cy, cx)`` (``[N]``),
    clipped at the borders."""
    n, h, w, _ = img.shape
    half = int(length) // 2
    ys = torch.arange(h, device=img.device).reshape(1, h, 1)
    xs = torch.arange(w, device=img.device).reshape(1, 1, w)
    cy = cy.to(torch.int64).reshape(n, 1, 1)
    cx = cx.to(torch.int64).reshape(n, 1, 1)
    inside = (ys >= cy - half) & (ys < cy + half) & (xs >= cx - half) & (xs < cx + half)
    return torch.where(inside[..., None], torch.zeros((), device=img.device), img)


def _check_stack(images: torch.Tensor, draws: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N, H, W, 3], got {tuple(images.shape)}")
    if images.dtype != torch.float32 or draws.dtype != torch.int32:
        raise TypeError("images must be float32 and draws int32")
    if tuple(draws.shape) != (images.shape[0], 5):
        raise ValueError(f"draws must be [{images.shape[0]}, 5], got {tuple(draws.shape)}")
    if draws.device != images.device:
        raise ValueError(f"images on {images.device}, draws on {draws.device}")


def cifar_stack_plain(images: torch.Tensor, draws: torch.Tensor, *,
                      cutout_length: int = 16, mean: Sequence[float] = CIFAR_MEAN,
                      std: Sequence[float] = CIFAR_STD,
                      pad: int = CROP_PAD) -> torch.Tensor:
    """The plain PyTorch version of the stack after the policy, on any
    device: crop, flip, normalize, cutout.  ``images [N, H, W, 3]`` float32
    integral in [0, 255], ``draws [N, 5]`` int32; returns ``[N, 3, H, W]``
    in ``channels_last`` strides."""
    _check_stack(images, draws)
    x = random_crop_with_pad(images, draws[:, 0], draws[:, 1], pad)
    x = random_hflip(x, draws[:, 2])
    x = normalize(x, mean, std)
    if cutout_length > 0:
        x = cutout_default(x, draws[:, 3], draws[:, 4], cutout_length)
    return x.contiguous().permute(0, 3, 1, 2)


def cifar_stack(images: torch.Tensor, draws: torch.Tensor, *,
                cutout_length: int = 16, mean: Sequence[float] = CIFAR_MEAN,
                std: Sequence[float] = CIFAR_STD,
                pad: int = CROP_PAD) -> torch.Tensor:
    """Crop, flip, normalize and cut out a batch: on a CUDA tensor one
    launch of the hand-written kernel, on a CPU tensor the plain version.
    Same contract as :func:`cifar_stack_plain`."""
    if images.device.type == "cpu":
        return cifar_stack_plain(images, draws, cutout_length=cutout_length,
                                 mean=mean, std=std, pad=pad)
    if images.device.type != "cuda":
        raise ValueError(f"no CIFAR stack for device {images.device}")
    _check_stack(images, draws)
    mean32, rstd32 = norm_constants(mean, std)
    return _kernels.cifar_stack(images.contiguous(), draws.contiguous(), pad=pad,
                                cutout_length=cutout_length, scale=_SCALE,
                                mean=mean32.tolist(), rstd=rstd32.tolist())


def cifar_train_batch(images: torch.Tensor, draws: torch.Tensor, *,
                      policy: torch.Tensor | None = None,
                      sub_idx: torch.Tensor | None = None,
                      policy_draws: torch.Tensor | None = None,
                      cutout_length: int = 16, mean: Sequence[float] = CIFAR_MEAN,
                      std: Sequence[float] = CIFAR_STD) -> torch.Tensor:
    """The full CIFAR/SVHN train-time stack on a ``[N, H, W, 3]``
    uint8-valued batch, given its draws.

    With a ``policy [num_sub, num_op, 3]``, image i first goes through
    sub-policy ``sub_idx[i]`` with ``policy_draws[i]`` (the augmentation
    kernel on the card); then the stack of :func:`cifar_stack` with
    ``draws [N, 5]``.  Returns ``[N, 3, H, W]`` in ``channels_last``
    strides."""
    images = images.to(torch.float32)
    if policy is not None:
        if sub_idx is None or policy_draws is None:
            raise ValueError("a policy needs sub_idx and policy_draws")
        images = apply_subpolicy_draws(images.contiguous(), policy, sub_idx, policy_draws)
    return cifar_stack(images, draws, cutout_length=cutout_length, mean=mean, std=std)


def eval_draws(n: int, device, pad: int = CROP_PAD) -> torch.Tensor:
    """``[n, 5]`` draws that make the stack the identity before
    normalization: the crop window at the centre, no flip (and cutout off
    by length 0)."""
    draws = torch.zeros((n, 5), dtype=torch.int32, device=device)
    draws[:, :2] = pad
    return draws


def cifar_eval_batch(images: torch.Tensor, mean: Sequence[float] = CIFAR_MEAN,
                     std: Sequence[float] = CIFAR_STD) -> torch.Tensor:
    """Eval stack: normalize only (reference ``data.py:45-47``), through the
    same kernel with crop, flip and cutout turned off.  Returns
    ``[N, 3, H, W]`` in ``channels_last`` strides."""
    images = images.to(torch.float32)
    return cifar_stack(images, eval_draws(images.shape[0], images.device),
                       cutout_length=0, mean=mean, std=std)
