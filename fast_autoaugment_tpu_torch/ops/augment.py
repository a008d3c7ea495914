"""Batched policy augmentation in PyTorch, with a hand-written CUDA kernel.

The counterpart of ``fast_autoaugment_tpu/ops/augment.py``.  Images are
NHWC float32 with integral values in [0, 255], as in the JAX package.
Every one of the 19 ops is a plain PyTorch function on a batch
``[N, H, W, C]`` with one value per image; the semantics are PIL's, as
pinned by the JAX package's golden tests (``tests/test_augment_golden.py``).

Randomness enters only as tensors.  A policy application takes, per image,
a sub-policy index ``sub_idx [B]`` and ``draws [B, num_op, 4]`` holding
(gate uniform, mirror uniform, cutout x centre in [0, W), cutout y centre
in [0, H)) -- the same draws the JAX key tree consumes
(``apply_policy`` -> ``apply_subpolicy`` -> ``apply_op`` -> ``_cutout_abs``).
Given its draws, :func:`apply_subpolicy_draws` is deterministic.  The two
samplers below make those draws from counter-based keys
(:mod:`fast_autoaugment_tpu_torch.ops.rng`).

The per-slot scalars (value after the range table and the mirror sign,
the gate, the 2x3 affine matrix, the cutout box) are computed once per
(image, slot) by :func:`slot_records`, in PyTorch on the images' device,
and both the plain version and the CUDA kernel consume those same
records.  So Rotate's ``cos``/``sin`` are evaluated once, the same way for
both, and the kernel's per-pixel arithmetic is all that remains to match.

Rounding is the reference's documented float32 semantics: every product
and every sum is rounded on its own, in the reference's order (PIL's
``Image.blend`` and the JAX ops evaluated op by op).  XLA on an FMA-capable
CPU contracts some multiply-adds of the JAX package's compiled programs,
differently from one program to the next; the tests therefore compile the
JAX references with ``--xla_cpu_max_isa=AVX``, which has no fused
multiply-add, where every JAX program agrees with the port bit for bit.

On a CUDA tensor :func:`apply_subpolicy_draws` launches the kernel
(``csrc/augment.cu``: all op slots in one launch, the image held on chip,
except for images too large for a thread-block cluster, which take one
launch per slot) or raises; only a CPU tensor goes to the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops.rng import (cos_sin_turn, log_unit, philox4x32, sqrt_f64,
                                                uniform24)

__all__ = [
    "OP_NAMES", "SEARCH_OP_NAMES", "NUM_OPS", "CUTOUT_COLOR", "REC_WIDTH",
    "op_index", "augment_list", "run_op", "slot_records",
    "apply_subpolicy_draws", "apply_subpolicy_draws_plain",
    "sample_exact", "sample_grouped", "sample_draws", "sample_crop", "sample_imagenet",
    "check_policy",
    "shear_x", "shear_y", "translate_x", "translate_y", "rotate",
    "auto_contrast", "invert", "equalize", "solarize", "posterize",
    "contrast", "color", "brightness", "sharpness", "cutout", "cutout_abs",
    "posterize2", "translate_x_abs", "translate_y_abs",
]

# (name, low, high, mirrored): value = level * (high - low) + low, then the
# sign is flipped when `mirrored` and the mirror draw is > 0.5.
_OP_TABLE = (
    ("ShearX", -0.3, 0.3, True),
    ("ShearY", -0.3, 0.3, True),
    ("TranslateX", -0.45, 0.45, True),
    ("TranslateY", -0.45, 0.45, True),
    ("Rotate", -30.0, 30.0, True),
    ("AutoContrast", 0.0, 1.0, False),
    ("Invert", 0.0, 1.0, False),
    ("Equalize", 0.0, 1.0, False),
    ("Solarize", 0.0, 256.0, False),
    ("Posterize", 4.0, 8.0, False),
    ("Contrast", 0.1, 1.9, False),
    ("Color", 0.1, 1.9, False),
    ("Brightness", 0.1, 1.9, False),
    ("Sharpness", 0.1, 1.9, False),
    ("Cutout", 0.0, 0.2, False),
    ("CutoutAbs", 0.0, 20.0, False),  # no sign flip
    ("Posterize2", 0.0, 4.0, False),
    ("TranslateXAbs", 0.0, 10.0, True),
    ("TranslateYAbs", 0.0, 10.0, True),
)

OP_NAMES: tuple[str, ...] = tuple(t[0] for t in _OP_TABLE)
NUM_OPS = len(OP_NAMES)
SEARCH_OP_NAMES: tuple[str, ...] = OP_NAMES[:15]
_OP_LOW = np.array([t[1] for t in _OP_TABLE], np.float32)
_OP_HIGH = np.array([t[2] for t in _OP_TABLE], np.float32)
_OP_MIRROR = np.array([t[3] for t in _OP_TABLE], np.bool_)

CUTOUT_COLOR = (125.0, 123.0, 114.0)

(SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE, AUTO_CONTRAST, INVERT,
 EQUALIZE, SOLARIZE, POSTERIZE, CONTRAST, COLOR, BRIGHTNESS, SHARPNESS,
 CUTOUT, CUTOUT_ABS, POSTERIZE2, TRANSLATE_X_ABS, TRANSLATE_Y_ABS) = range(NUM_OPS)

#: floats per (image, slot) record, the layout ``csrc/augment.cu`` reads:
#: [op, gate, value, m00, m01, m02, m10, m11, m12, x0, y0, x1, y1,
#:  cutout_active, 0, 0]
REC_WIDTH = 16


def op_index(name: str) -> int:
    return OP_NAMES.index(name)


def augment_list(for_autoaug: bool = True) -> list[tuple[str, float, float]]:
    """Name/range table, same contract as the reference ``augment_list``."""
    rows = _OP_TABLE if for_autoaug else _OP_TABLE[:15]
    return [(name, low, high) for name, low, high, _ in rows]


# ---------------------------------------------------------------------------
# per-slot scalars shared by the plain version and the kernel
# ---------------------------------------------------------------------------


def _affine_rows(op: torch.Tensor, v: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The PIL-convention inverse map ``[N, 6]`` = (a, b, c, d, e, f) of each
    geometric op (identity rows for the others), evaluated exactly as
    ``fast_autoaugment_tpu/ops/augment.py:189-227`` does."""
    cx, cy = w / 2.0, h / 2.0
    rad = v * (np.pi / 180.0)
    ca, sa = torch.cos(rad), torch.sin(rad)
    one, zero = torch.ones_like(v), torch.zeros_like(v)
    rot = op == ROTATE
    m00 = torch.where(rot, ca, one)
    m01 = torch.where(op == SHEAR_X, v, torch.where(rot, -sa, zero))
    m02 = torch.where(op == TRANSLATE_X, v * w,
                      torch.where(op == TRANSLATE_X_ABS, v,
                                  torch.where(rot, cx - ca * cx + sa * cy, zero)))
    m10 = torch.where(op == SHEAR_Y, v, torch.where(rot, sa, zero))
    m11 = m00
    m12 = torch.where(op == TRANSLATE_Y, v * h,
                      torch.where(op == TRANSLATE_Y_ABS, v,
                                  torch.where(rot, cy - sa * cx - ca * cy, zero)))
    return torch.stack([m00, m01, m02, m10, m11, m12], dim=-1)


def _cutout_box(op: torch.Tensor, v: torch.Tensor, centre: torch.Tensor,
                h: int, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive box ``[N, 4]`` (x0, y0, x1, y1) and an active flag ``[N]``
    for Cutout (fraction of the width) and CutoutAbs (pixels)
    (``fast_autoaugment_tpu/ops/augment.py:333-365``)."""
    frac = op == CUTOUT
    size = torch.where(frac, v * w, v)
    x0 = torch.trunc(torch.clamp(centre[:, 0] - size / 2.0, min=0.0))
    y0 = torch.trunc(torch.clamp(centre[:, 1] - size / 2.0, min=0.0))
    x1 = torch.clamp(x0 + size, max=float(w))
    y1 = torch.clamp(y0 + size, max=float(h))
    # CutoutAbs is the identity for a negative size; Cutout also for v <= 0
    active = ~(size < 0.0) & ~(frac & (v <= 0.0))
    return torch.stack([x0, y0, x1, y1], dim=-1), active


def _records(op: torch.Tensor, gate: torch.Tensor, v: torch.Tensor,
             centre: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pack flat ``[N]`` slot scalars into ``[N, REC_WIDTH]`` records."""
    box, active = _cutout_box(op, v, centre, h, w)
    pad = torch.zeros_like(v)
    return torch.cat([
        torch.stack([op.to(torch.float32), gate.to(torch.float32), v], -1),
        _affine_rows(op, v, h, w), box,
        torch.stack([active.to(torch.float32), pad, pad], -1)], dim=-1)


_TABLES: dict = {}


def _op_tables(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ops' level ranges and mirror flags on `dev`, uploaded once per
    device: a later call copies nothing from the host, so it can run inside
    a CUDA graph capture."""
    if dev not in _TABLES:
        _TABLES[dev] = tuple(torch.as_tensor(t, device=dev)
                             for t in (_OP_LOW, _OP_HIGH, _OP_MIRROR))
    return _TABLES[dev]


def slot_records(policy: torch.Tensor, sub_idx: torch.Tensor,
                 draws: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Per-(image, slot) records ``[B, num_op, REC_WIDTH]`` float32.

    Maps level -> value with the range table, applies the mirror sign and
    the probability gate (``fast_autoaugment_tpu/ops/augment.py:416-449``),
    and evaluates the affine matrix and cutout box of each slot."""
    rows = policy[sub_idx.to(torch.int64)]  # [B, num_op, 3]
    b, num_op = rows.shape[0], rows.shape[1]
    op = rows[..., 0].to(torch.int64)
    low, high, mirror = (t[op] for t in _op_tables(policy.device))
    value = rows[..., 2] * (high - low) + low
    sign = torch.where(mirror & (draws[..., 1] > 0.5), -1.0, 1.0)
    value = value * sign
    gate = draws[..., 0] < rows[..., 1]
    rec = _records(op.reshape(-1), gate.reshape(-1), value.reshape(-1),
                   draws[..., 2:4].reshape(-1, 2), height, width)
    return rec.reshape(b, num_op, REC_WIDTH).contiguous()


# ---------------------------------------------------------------------------
# primitives (plain version)
# ---------------------------------------------------------------------------


def _clip(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img, 0.0, 255.0)


def _to_int(img: torch.Tensor) -> torch.Tensor:
    return _clip(img).to(torch.int32)


def _grayscale_u8(img: torch.Tensor) -> torch.Tensor:
    """PIL 'L' conversion on integral-valued float input -> int32 [N, H, W]."""
    ii = _to_int(img)
    return (ii[..., 0] * 19595 + ii[..., 1] * 38470 + ii[..., 2] * 7471
            + 0x8000) >> 16


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1, 1, 1)


def _blend(degenerate: torch.Tensor, img: torch.Tensor,
           factor: torch.Tensor) -> torch.Tensor:
    """PIL Image.blend + uint8 store: float32 lerp, trunc, clip."""
    out = degenerate + (img - degenerate) * _per_image(factor)
    return _clip(torch.trunc(out))


def _apply_lut(img: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Per-(image, channel) 256-entry LUT gather; lut [N, C, 256]."""
    n, _, _, c = img.shape
    base = (torch.arange(n * c, device=img.device) * 256).reshape(n, 1, 1, c)
    return lut.reshape(-1)[_to_int(img).to(torch.int64) + base].to(torch.float32)


def _histogram256(img: torch.Tensor) -> torch.Tensor:
    """Per-(image, channel) 256-bin histogram of ``_to_int(img)`` -> [N, C, 256]."""
    n, _, _, c = img.shape
    base = (torch.arange(n * c, device=img.device) * 256).reshape(n, 1, 1, c)
    idx = (_to_int(img).to(torch.int64) + base).reshape(-1)
    return torch.bincount(idx, minlength=n * c * 256).reshape(n, c, 256)


def _warp_affine_nearest(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """PIL-exact nearest affine warp with zero fill:
    ``src = floor(A @ (x+0.5, y+0.5) + t)`` with ``mat [N, 6]``."""
    n, h, w, c = img.shape
    ys = (torch.arange(h, device=img.device, dtype=torch.float32) + 0.5).reshape(1, h, 1)
    xs = (torch.arange(w, device=img.device, dtype=torch.float32) + 0.5).reshape(1, 1, w)
    m = mat.reshape(n, 6, 1, 1)
    sx = torch.floor(m[:, 0] * xs + m[:, 1] * ys + m[:, 2]).to(torch.int64)
    sy = torch.floor(m[:, 3] * xs + m[:, 4] * ys + m[:, 5]).to(torch.int64)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    base = (torch.arange(n, device=img.device) * (h * w)).reshape(n, 1, 1)
    flat = base + sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)
    gathered = img.reshape(n * h * w, c)[flat]
    return torch.where(valid[..., None], gathered, torch.zeros((), device=img.device))


def _smooth_degenerate(img: torch.Tensor) -> torch.Tensor:
    """PIL ImageFilter.SMOOTH: 3x3 [[1,1,1],[1,5,1],[1,1,1]]/13, border copied."""
    n, h, w, c = img.shape
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                          device=img.device) / 13.0
    padded = torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            acc = acc + kernel[dy, dx] * padded[:, dy:dy + h, dx:dx + w, :]
    sm = _clip(torch.trunc(acc + 0.5))
    border = torch.zeros((1, h, w, 1), dtype=torch.bool, device=img.device)
    border[:, 0] = border[:, -1] = True
    border[:, :, 0] = border[:, :, -1] = True
    return torch.where(border, _clip(img), sm)


# ---------------------------------------------------------------------------
# the 19 ops on records: (images [N,H,W,C], records [N, REC_WIDTH]) -> images
# ---------------------------------------------------------------------------


def _rec_warp(img, rec):
    return _warp_affine_nearest(img, rec[:, 3:9])


def _rec_auto_contrast(img, rec):
    """PIL ImageOps.autocontrast(cutoff=0) as the exact rational
    ``(i - lo) * 255 // (hi - lo)``; PIL's double-precision form may land 1
    lower (the JAX package's documented deviation)."""
    ii = _to_int(img)
    lo = ii.amin(dim=(1, 2))[..., None]  # [N, C, 1]
    hi = ii.amax(dim=(1, 2))[..., None]
    ix = torch.arange(256, device=img.device, dtype=torch.int32)
    span = torch.clamp(hi - lo, min=1)
    lut = torch.clamp(torch.div((ix - lo) * 255, span, rounding_mode="floor"), 0, 255)
    return _apply_lut(img, torch.where(hi <= lo, ix, lut))


def _rec_invert(img, rec):
    return 255.0 - _clip(img)


def _rec_equalize(img, rec):
    """PIL ImageOps.equalize: per-channel integer histogram remap."""
    h = _histogram256(img)  # [N, C, 256] int64
    total = h.sum(-1, keepdim=True)
    nonzero = h > 0
    num_nonzero = nonzero.sum(-1, keepdim=True)
    last_idx = 255 - torch.argmax(nonzero.flip(-1).to(torch.int32), dim=-1, keepdim=True)
    h_last = torch.gather(h, -1, last_idx)
    step = torch.div(total - h_last, 255, rounding_mode="floor")
    csum = torch.cumsum(h, -1) - h
    n = torch.div(step, 2, rounding_mode="floor") + csum
    lut = torch.clamp(torch.div(n, torch.clamp(step, min=1), rounding_mode="floor"), 0, 255)
    ix = torch.arange(256, device=img.device, dtype=torch.int64)
    return _apply_lut(img, torch.where((num_nonzero <= 1) | (step == 0), ix, lut))


def _rec_solarize(img, rec):
    ii = _clip(img)
    return torch.where(ii < _per_image(rec[:, 2]), ii, 255.0 - ii)


def _rec_posterize(img, rec):
    bits = torch.trunc(rec[:, 2]).to(torch.int64)
    shift = 8 - bits
    ok = (shift >= 0) & (shift < 32)
    mask = torch.where(ok, (0xFF << shift.clamp(0, 31)) & 0xFF, 0)
    return (_to_int(img).to(torch.int64) & _per_image(mask)).to(torch.float32)


def _rec_contrast(img, rec):
    n, h, w, _ = img.shape
    # the grey sum is an integer; exact in float32 up to 2**24, i.e. for
    # images up to 65,793 pixels, where it equals the reference's float sum
    gray_sum = _grayscale_u8(img).to(torch.int64).sum(dim=(1, 2)).to(torch.float32)
    mean = torch.trunc(gray_sum / float(h * w) + 0.5)
    return _blend(_per_image(mean).expand_as(img), _clip(img), rec[:, 2])


def _rec_color(img, rec):
    deg = _grayscale_u8(img)[..., None].to(torch.float32).expand_as(img)
    return _blend(deg, _clip(img), rec[:, 2])


def _rec_brightness(img, rec):
    return _blend(torch.zeros_like(img), _clip(img), rec[:, 2])


def _rec_sharpness(img, rec):
    return _blend(_smooth_degenerate(img), _clip(img), rec[:, 2])


def _rec_cutout(img, rec):
    """Fill the inclusive box with the reference grey where active."""
    _, h, w, _ = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32).reshape(1, h, 1)
    xs = torch.arange(w, device=img.device, dtype=torch.float32).reshape(1, 1, w)
    box = rec[:, 9:13].reshape(-1, 4, 1, 1)
    inside = ((xs >= box[:, 0]) & (xs <= box[:, 2]) & (ys >= box[:, 1])
              & (ys <= box[:, 3]) & (rec[:, 13] > 0).reshape(-1, 1, 1))
    fill = torch.tensor(CUTOUT_COLOR, dtype=img.dtype, device=img.device)
    return torch.where(inside[..., None], fill, img)


_REC_FNS = (
    _rec_warp, _rec_warp, _rec_warp, _rec_warp, _rec_warp,
    _rec_auto_contrast, _rec_invert, _rec_equalize, _rec_solarize, _rec_posterize,
    _rec_contrast, _rec_color, _rec_brightness, _rec_sharpness, _rec_cutout,
    _rec_cutout, _rec_posterize, _rec_warp, _rec_warp,
)
assert len(_REC_FNS) == NUM_OPS


def run_op(images: torch.Tensor, op: int, value, centre=None) -> torch.Tensor:
    """Apply op `op` at the already-mirrored `value` (one per image, or a
    scalar) to ``images [N, H, W, C]``.  `centre` ``[N, 2]`` (x, y) places
    Cutout/CutoutAbs boxes and is ignored by the other ops."""
    n, h, w, _ = images.shape
    dev = images.device
    v = torch.as_tensor(value, dtype=torch.float32, device=dev).expand(n).contiguous()
    if centre is None:
        centre = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    centre = torch.as_tensor(centre, dtype=torch.float32, device=dev).reshape(n, 2)
    opt = torch.full((n,), int(op), dtype=torch.int64, device=dev)
    rec = _records(opt, torch.ones_like(opt, dtype=torch.bool), v, centre, h, w)
    return _REC_FNS[op](images, rec)


def _named(op: int):
    def fn(images, value, centre=None):
        return run_op(images, op, value, centre)

    fn.__name__ = fn.__qualname__ = _camel_to_snake(OP_NAMES[op])
    fn.__doc__ = f"{OP_NAMES[op]} on a batch: ``run_op(images, {op}, value, centre)``."
    return fn


def _camel_to_snake(name: str) -> str:
    return "".join("_" + ch.lower() if ch.isupper() else ch for ch in name).lstrip("_")


(shear_x, shear_y, translate_x, translate_y, rotate, auto_contrast, invert,
 equalize, solarize, posterize, contrast, color, brightness, sharpness,
 cutout, cutout_abs, posterize2, translate_x_abs, translate_y_abs) = (
    _named(i) for i in range(NUM_OPS))


# ---------------------------------------------------------------------------
# policy application given draws
# ---------------------------------------------------------------------------


def check_policy(policy) -> np.ndarray:
    """Validate a ``[num_sub, num_op, 3]`` policy on the host; returns it
    as float32 numpy.  Op ids must be integral and in ``[0, NUM_OPS)``."""
    arr = np.asarray(policy, np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 3 or arr.shape[0] < 1 or arr.shape[1] < 1:
        raise ValueError(f"policy must be [num_sub, num_op, 3], got {arr.shape}")
    ops = arr[..., 0]
    if not np.all((ops >= 0) & (ops < NUM_OPS) & (ops == np.trunc(ops))):
        raise ValueError(f"policy op ids must be integers in [0, {NUM_OPS})")
    return arr


def _check_draws(images, policy, sub_idx, draws):
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"images must be [B, H, W, 3], got {tuple(images.shape)}")
    if images.dtype != torch.float32 or policy.dtype != torch.float32 \
            or draws.dtype != torch.float32:
        raise TypeError("images, policy and draws must be float32")
    if policy.dim() != 3 or policy.shape[-1] != 3 or min(policy.shape) < 1:
        raise ValueError(f"policy must be [num_sub, num_op, 3], got {tuple(policy.shape)}")
    b, num_op = images.shape[0], policy.shape[1]
    if tuple(sub_idx.shape) != (b,) or tuple(draws.shape) != (b, num_op, 4):
        raise ValueError(
            f"sub_idx must be [{b}] and draws [{b}, {num_op}, 4], got "
            f"{tuple(sub_idx.shape)} and {tuple(draws.shape)}")
    devices = {t.device for t in (images, policy, sub_idx, draws)}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    if b:
        lo, hi = torch.aminmax(sub_idx.to(torch.int64))
        msg = f"sub_idx out of range [0, {policy.shape[0]})"
        if sub_idx.device.type == "cpu":
            if int(lo) < 0 or int(hi) >= policy.shape[0]:
                raise ValueError(msg)
        else:  # on the device: no host read, so the call can be captured in a CUDA graph
            torch._assert_async((lo >= 0) & (hi < policy.shape[0]), msg)


def apply_subpolicy_draws_plain(images: torch.Tensor, policy: torch.Tensor,
                                sub_idx: torch.Tensor,
                                draws: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the policy application, on any device:
    per op slot, each gated-on image goes through its op; the others pass
    through unchanged."""
    _check_draws(images, policy, sub_idx, draws)
    _, h, w, _ = images.shape
    rec = slot_records(policy, sub_idx, draws, h, w)
    x = images
    for s in range(rec.shape[1]):
        r = rec[:, s]
        op = r[:, 0].to(torch.int64)
        on = r[:, 1] > 0
        out = x.clone()
        for k in torch.unique(op[on]).tolist():
            sel = torch.nonzero(on & (op == k)).squeeze(1)
            out[sel] = _REC_FNS[k](x[sel], r[sel])
        x = out
    return x


def apply_subpolicy_draws(images: torch.Tensor, policy: torch.Tensor,
                          sub_idx: torch.Tensor,
                          draws: torch.Tensor) -> torch.Tensor:
    """Apply sub-policy ``policy[sub_idx[i]]`` to image i with its draws.

    ``images [B, H, W, 3]`` float32 integral in [0, 255], ``policy
    [num_sub, num_op, 3]`` float32, ``sub_idx [B]`` integer, ``draws
    [B, num_op, 4]`` float32, all on one device.  A CUDA batch goes through
    the hand-written kernel (one launch for all op slots, as
    ``_kernels.augment_plan`` says); a CPU batch through the plain version.
    Returns a new tensor."""
    if images.device.type == "cpu":
        return apply_subpolicy_draws_plain(images, policy, sub_idx, draws)
    if images.device.type != "cuda":
        raise ValueError(f"no augmentation path for device {images.device}")
    _check_draws(images, policy, sub_idx, draws)
    _, h, w, _ = images.shape
    return _kernels.augment(images, slot_records(policy, sub_idx, draws, h, w))


# ---------------------------------------------------------------------------
# samplers: keys -> (sub_idx, draws)
# ---------------------------------------------------------------------------

# Philox counter layout (c0, c1, c2, c3): c1 names the stream.
(_STREAM_SLOT, _STREAM_SUB, _STREAM_PERM, _STREAM_GROUP, _STREAM_CROP,
 _STREAM_IMAGENET) = 0, 1, 2, 3, 4, 5


def _pick(word: torch.Tensor, n: int) -> torch.Tensor:
    """A 32-bit word -> integer in [0, n) from its top 24 bits (exact)."""
    return (((word >> 8) * n) >> 24).to(torch.int32)


def _slot_draws(k0, k1, lane, num_op: int, height: int, width: int) -> torch.Tensor:
    """``[L, num_op, 4]`` draws: for each lane and slot one Philox block
    gives (gate, mirror, cutout x in [0, W), cutout y in [0, H))."""
    slot = torch.arange(num_op, dtype=torch.int64, device=k0.device).reshape(1, -1)
    zero = torch.zeros_like(slot)
    w = philox4x32((k0.reshape(-1, 1), k1.reshape(-1, 1)),
                   (slot, zero + _STREAM_SLOT, lane.reshape(-1, 1), zero))
    return torch.stack([uniform24(w[0]), uniform24(w[1]),
                        uniform24(w[2]) * width, uniform24(w[3]) * height], dim=-1)


def sample_exact(keys: torch.Tensor, num_sub: int, num_op: int, height: int,
                 width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact sampler: an i.i.d. sub-policy and draws per lane, each a
    function of that lane's key alone.

    ``keys [B, 2]`` int64 holding 32-bit words (hi, lo) -- the JAX key
    layout, so ``PRNGKey(s)`` for ``s < 2**31`` is ``(0, s)``.  Returns
    ``sub_idx [B]`` int32 and ``draws [B, num_op, 4]`` float32 on the keys'
    device, bit-identical on every device."""
    keys = keys.to(torch.int64).reshape(-1, 2)
    k1, k0 = keys[:, 0], keys[:, 1]
    zero = torch.zeros_like(k0)
    sub = philox4x32((k0, k1), (zero, zero + _STREAM_SUB, zero, zero))[0]
    return _pick(sub, num_sub), _slot_draws(k0, k1, zero, num_op, height, width)


def sample_grouped(key: torch.Tensor, batch: int, groups: int, num_sub: int,
                   num_op: int, height: int,
                   width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The grouped sampler, one key ``[2]`` per dispatch: a random
    permutation of the batch is cut into ``min(groups, batch)`` chunks of
    ``ceil(batch / groups)`` positions and each chunk draws one sub-policy
    (stratified selection, the JAX ``apply_policy_batch_grouped``
    contract); gates, mirrors and cutout centres stay per image."""
    g = max(1, min(int(groups), batch))
    chunk = -(-batch // g)
    key = key.to(torch.int64).reshape(2)
    k1, k0 = key[0], key[1]
    dev = key.device
    lane = torch.arange(batch, dtype=torch.int64, device=dev)
    zero = torch.zeros_like(lane)
    perm_words = philox4x32((k0, k1), (lane, zero + _STREAM_PERM, zero, zero))[0]
    perm = torch.sort(perm_words, stable=True).indices  # position -> image
    pos = torch.empty_like(perm)
    pos[perm] = lane  # image -> position
    gi = torch.arange(g, dtype=torch.int64, device=dev)
    gz = torch.zeros_like(gi)
    group_sub = _pick(philox4x32((k0, k1), (gi, gz + _STREAM_GROUP, gz, gz))[0], num_sub)
    sub_idx = group_sub[torch.div(pos, chunk, rounding_mode="floor")]
    draws = _slot_draws(k0.expand(batch), k1.expand(batch), lane + 1, num_op,
                        height, width)
    return sub_idx, draws


def sample_crop(keys: torch.Tensor, height: int, width: int,
                pad: int = 4) -> torch.Tensor:
    """The draws of the CIFAR stack after the policy
    (``fast_autoaugment_tpu/ops/preprocess.py:91-106``), one row per lane:
    ``[L, 5]`` int32 = (crop offset y in [0, 2*pad], crop offset x in
    [0, 2*pad], flip bit, cutout centre y in [0, H), cutout centre x in
    [0, W)), each a function of that lane's key ``keys [L, 2]`` alone (two
    Philox blocks of its own stream), bit-identical on every device."""
    keys = keys.to(torch.int64).reshape(-1, 2)
    k1, k0 = keys[:, 0:1], keys[:, 1:2]
    block = torch.arange(2, dtype=torch.int64, device=keys.device)
    zero = torch.zeros_like(block)
    w = philox4x32((k0, k1), (block, zero + _STREAM_CROP, zero, zero))  # 4 x [L, 2]
    span = 2 * int(pad) + 1
    return torch.stack([_pick(w[0][:, 0], span), _pick(w[1][:, 0], span),
                        _pick(w[2][:, 0], 2), _pick(w[3][:, 0], height),
                        _pick(w[0][:, 1], width)], dim=-1)


def sample_imagenet(keys: torch.Tensor, height: int, width: int, strength: float = 0.4,
                    alphastd: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """The draws of the ImageNet stack after the policy
    (``fast_autoaugment_tpu/ops/preprocess_imagenet.py:136-188``), one row
    per lane, from three Philox blocks of that lane's key ``keys [L, 2]``
    (stream 5):

    - ``ints [L, 4]`` int32 = (flip bit, ColorJitter order in [0, 6),
      cutout centre y in [0, H), cutout centre x in [0, W));
    - ``floats [L, 6]`` float32 = (brightness, contrast, saturation factors
      ``U(1 - strength, 1 + strength)``, the PCA lighting noise
      ``N(0, alphastd)`` x 3).

    The normals are Box-Muller on ``u = 1 - j 2^-24`` in (0, 1] and the turn
    ``j' 2^-24``, evaluated in float64 by :func:`log_unit`, :func:`sqrt_f64`
    and :func:`cos_sin_turn` from correctly rounded operations only and rounded
    once to float32, so the CPU and the card give the same bits; the rest is
    integer arithmetic and exact."""
    keys = keys.to(torch.int64).reshape(-1, 2)
    k1, k0 = keys[:, 0:1], keys[:, 1:2]
    block = torch.arange(3, dtype=torch.int64, device=keys.device)
    zero = torch.zeros_like(block)
    w = philox4x32((k0, k1), (block, zero + _STREAM_IMAGENET, zero, zero))  # 4 x [L, 3]
    ints = torch.stack([_pick(w[0][:, 0], 2), _pick(w[1][:, 0], 6),
                        _pick(w[2][:, 0], height), _pick(w[3][:, 0], width)], dim=-1)
    lo = np.float32(1.0 - strength)
    span = np.float32(1.0 + strength) - lo
    factors = torch.stack([uniform24(w[i][:, 1]) for i in range(3)], dim=-1) * float(span) \
        + float(lo)
    # the third block's four words give the radii and the angles
    r0 = sqrt_f64(log_unit((1 << 24) - (w[0][:, 2] >> 8)) * -2.0)
    r1 = sqrt_f64(log_unit((1 << 24) - (w[2][:, 2] >> 8)) * -2.0)
    c0, s0 = cos_sin_turn(w[1][:, 2] >> 8)
    c1, _ = cos_sin_turn(w[3][:, 2] >> 8)
    normals = torch.stack([r0 * c0, r0 * s0, r1 * c1], dim=-1)
    alpha = (normals * float(alphastd)).to(torch.float32)
    return ints, torch.cat([factors, alpha], dim=-1)


def sample_draws(dispatch: str, keys, batch: int, *, num_sub: int, num_op: int,
                 height: int, width: int, groups: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """The port's draw source for :class:`~fast_autoaugment_tpu_torch.serve.
    policy_server.PolicyApplier`: ``exact`` takes ``[batch, 2]`` uint32
    keys, ``grouped`` one ``[2]`` key.  Draws are made on `device`."""
    k = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64), device=device)
    if dispatch == "exact":
        return sample_exact(k.reshape(batch, 2), num_sub, num_op, height, width)
    return sample_grouped(k, batch, groups, num_sub, num_op, height, width)
