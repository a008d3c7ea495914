"""The ImageNet train and eval stacks on the device, in PyTorch, with a
hand-written CUDA kernel (``fast_autoaugment_tpu/ops/preprocess_imagenet.py``,
the device side).

After the policy, ``_train_one`` (``:168-188``) takes each host-cropped
image ``[S, S, 3]`` through:

1. a horizontal flip (``img[:, ::-1]`` when the flip bit is set);
2. ColorJitter(0.4, 0.4, 0.4) (``_color_jitter``, ``:136``): brightness,
   contrast and saturation with factors ``U(0.6, 1.4)``, in one of six
   orders; each is the PIL-exact blend of ``ops/augment.py``
   (``deg + (img - deg) * f``, trunc, clip), contrast blending toward the
   rounded mean grey of the image as it stands just before contrast;
3. ``/ 255``;
4. AlexNet PCA lighting (``_lighting``, ``:161``): ``+ rgb`` with
   ``rgb = (eigvec * alpha * eigval).sum(1)`` per image;
5. ``- mean``, ``/ std``;
6. cutout (``cutout_default``) on the normalized image when ``cutout > 0``.

Randomness enters only as tensors (:class:`ImageNetDraws`): the policy's
draws, the flip bit, the jitter order, the three factors, the lighting
noise ``alpha`` and the cutout centre.  The lighting offset ``rgb`` is
computed once per image in PyTorch (:func:`lighting_rgb`) and both the
plain version and the kernel add the same three floats.

Rounding is what XLA compiles the reference into (``tests/
test_torch_imagenet.py`` holds it): each blend rounds its difference,
product and sum on its own; ``/ 255`` and ``/ std`` are multiplications by
the float32 reciprocals (the CIFAR stack's form, ``ops/preprocess.py``);
the contrast mean is ``trunc(sum / (H*W) + 0.5)`` on the exact integer grey
sum, as in the augmentation kernel.

On a CUDA tensor :func:`imagenet_stack` launches the kernel
(``csrc/imagenet.cu``) or raises; only a CPU tensor goes to the plain
version.  The eval stack is normalization alone, the CIFAR stack's kernel
with the ImageNet constants.  The host side (crop boxes, bicubic resize)
waits for the lazy ImageNet loader (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops.augment import (
    apply_subpolicy_draws,
    brightness,
    color,
    contrast,
)
from fast_autoaugment_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _SCALE,
    cifar_eval_batch,
    cutout_default,
    norm_constants,
    random_hflip,
)

__all__ = ["PCA_EIGVAL", "PCA_EIGVEC", "JITTER_ORDERS", "ImageNetDraws", "lighting_rgb",
           "color_jitter", "lighting", "imagenet_stack", "imagenet_stack_plain",
           "imagenet_train_batch", "imagenet_eval_batch"]

# reference data.py:21-33
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array(
    [[-0.5675, 0.7192, 0.4009],
     [-0.5808, -0.0045, -0.8140],
     [-0.5836, -0.6948, 0.4203]],
    np.float32,
)
#: the six orders of (0 brightness, 1 contrast, 2 saturation), the branch
#: table of ``_color_jitter`` (``:152``)
JITTER_ORDERS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


@dataclass
class ImageNetDraws:
    """Every draw of the ImageNet train stack for N images.

    ``sub_idx [N]`` int32 and ``policy [N, num_op, 4]`` float32 are the
    policy's draws (None without a policy); ``flip [N]`` int32;
    ``order [N]`` int32 in [0, 6) indexes :data:`JITTER_ORDERS`;
    ``factors [N, 3]`` float32 the brightness, contrast and saturation
    factors; ``alpha [N, 3]`` float32 the lighting noise (``N(0, 0.1)``);
    ``centre [N, 2]`` int32 the cutout centre (y, x)."""

    sub_idx: torch.Tensor | None
    policy: torch.Tensor | None
    flip: torch.Tensor
    order: torch.Tensor
    factors: torch.Tensor
    alpha: torch.Tensor
    centre: torch.Tensor


def lighting_rgb(alpha: torch.Tensor) -> torch.Tensor:
    """Per-image PCA offset ``[N, 3]``: ``(eigvec * alpha * eigval).sum(1)``
    in float32 (``_lighting``, ``:161-165``), the products and the
    three-term sum rounded in the reference's order."""
    vec = torch.as_tensor(PCA_EIGVEC, device=alpha.device)
    val = torch.as_tensor(PCA_EIGVAL, device=alpha.device)
    t = vec[None] * alpha.to(torch.float32)[:, None, :] * val[None, None, :]  # [N, 3, 3]
    return t[..., 0] + t[..., 1] + t[..., 2]


def color_jitter(img: torch.Tensor, order: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(0.4, 0.4, 0.4) on ``[N, H, W, 3]`` with the
    drawn ``order [N]`` and ``factors [N, 3]`` (plain version): each image
    goes through brightness, contrast and saturation in its order."""
    table = torch.tensor(JITTER_ORDERS, dtype=torch.int64, device=img.device)
    ops = table[order.to(torch.int64)]  # [N, 3]
    x = img
    for k in range(3):
        b = brightness(x, factors[:, 0])
        c = contrast(x, factors[:, 1])
        s = color(x, factors[:, 2])
        op = ops[:, k].reshape(-1, 1, 1, 1)
        x = torch.where(op == 0, b, torch.where(op == 1, c, s))
    return x


def lighting(img01: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Add each image's PCA offset ``rgb [N, 3]`` to ``img01 [N, H, W, 3]``."""
    return img01 + rgb[:, None, None, :]


def _check(images: torch.Tensor, draws: ImageNetDraws) -> None:
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [N, H, W, 3], got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError("images must be uint8 or float32")
    n = images.shape[0]
    for name, t, shape, dtype in (("flip", draws.flip, (n,), torch.int32),
                                  ("order", draws.order, (n,), torch.int32),
                                  ("factors", draws.factors, (n, 3), torch.float32),
                                  ("alpha", draws.alpha, (n, 3), torch.float32),
                                  ("centre", draws.centre, (n, 2), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"draws.{name} must be {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != images.device:
            raise ValueError(f"images on {images.device}, draws.{name} on {t.device}")


def imagenet_stack_plain(images: torch.Tensor, draws: ImageNetDraws, *, cutout_length: int = 0,
                         mean: Sequence[float] = IMAGENET_MEAN,
                         std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """The plain PyTorch version of the stack after the policy, on any
    device: flip, ColorJitter, ``/255``, lighting, normalize, cutout.
    ``images [N, H, W, 3]`` uint8, or float32 integral in [0, 255]; returns
    ``[N, 3, H, W]`` float32 in ``channels_last`` strides."""
    _check(images, draws)
    mean32, rstd32 = norm_constants(mean, std)
    x = random_hflip(images.to(torch.float32), draws.flip)
    x = color_jitter(x, draws.order, draws.factors)
    x = x * torch.tensor(_SCALE, dtype=torch.float32, device=x.device)
    x = lighting(x, lighting_rgb(draws.alpha))
    x = (x - torch.as_tensor(mean32, device=x.device)) * torch.as_tensor(rstd32, device=x.device)
    if cutout_length > 0:
        x = cutout_default(x, draws.centre[:, 0], draws.centre[:, 1], cutout_length)
    return x.contiguous().permute(0, 3, 1, 2)


def imagenet_stack(images: torch.Tensor, draws: ImageNetDraws, *, cutout_length: int = 0,
                   mean: Sequence[float] = IMAGENET_MEAN,
                   std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    """Flip, jitter, light, normalize and cut out a batch: on a CUDA tensor
    the hand-written kernel (one launch, or two for images too large for a
    thread-block cluster; ``ops/_kernels.py imagenet_plan``), on a CPU
    tensor the plain version.  Same contract as :func:`imagenet_stack_plain`."""
    if images.device.type == "cpu":
        return imagenet_stack_plain(images, draws, cutout_length=cutout_length, mean=mean,
                                    std=std)
    if images.device.type != "cuda":
        raise ValueError(f"no ImageNet stack for device {images.device}")
    _check(images, draws)
    if cutout_length < 0:
        raise ValueError("cutout_length must be >= 0")
    mean32, rstd32 = norm_constants(mean, std)
    ints = torch.stack([draws.flip, draws.order, draws.centre[:, 0], draws.centre[:, 1]],
                       dim=-1).contiguous()
    floats = torch.cat([draws.factors, lighting_rgb(draws.alpha)], dim=-1).contiguous()
    return _kernels.imagenet_stack(images.contiguous(), ints, floats,
                                   cutout_length=cutout_length, scale=_SCALE,
                                   mean=mean32.tolist(), rstd=rstd32.tolist())


def imagenet_train_batch(images: torch.Tensor, draws: ImageNetDraws, *,
                         policy: torch.Tensor | None = None,
                         cutout_length: int = 0) -> torch.Tensor:
    """The ImageNet train stack on host-cropped ``[N, S, S, 3]`` batches,
    given its draws.  With a ``policy [num_sub, num_op, 3]`` each image
    first goes through sub-policy ``draws.sub_idx[i]`` with
    ``draws.policy[i]`` (the augmentation kernel on the card, which works in
    float32); then :func:`imagenet_stack`.  Returns ``[N, 3, S, S]`` in
    ``channels_last`` strides."""
    if policy is not None:
        if draws.sub_idx is None or draws.policy is None:
            raise ValueError("a policy needs draws.sub_idx and draws.policy")
        images = apply_subpolicy_draws(images.to(torch.float32).contiguous(), policy,
                                       draws.sub_idx, draws.policy)
    return imagenet_stack(images, draws, cutout_length=cutout_length)


def imagenet_eval_batch(images: torch.Tensor) -> torch.Tensor:
    """The eval stack: normalization alone with the ImageNet constants
    (``:225``), in the compiled reference's reciprocal form, through the
    CIFAR stack's kernel on the card."""
    return cifar_eval_batch(images, IMAGENET_MEAN, IMAGENET_STD)
