"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one:
a CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on a
GPU machine that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Bound: bitwise (``torch.equal``).  The augmentation kernel and its plain
version consume the same per-slot records and round every product and sum
the same way; the CIFAR stack kernel and its plain version compute the same
gather and the same reciprocal-form normalization, each product and
difference rounded on its own; the ImageNet stack kernel and its plain
version compute the same blends, the same integer grey sum and the same
scale, lighting offset and normalization, each operation rounded on its own.
"""

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops import augment as T
from fast_autoaugment_tpu_torch.ops import preprocess as P
from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as PI
from fast_autoaugment_tpu_torch.ops import rng
from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws
from fast_autoaugment_tpu_torch.policies.archive import ARCHIVES, load_policy, policy_to_tensor

SHAPES = [(8, 32, 32), (4, 17, 23), (2, 224, 224)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _images(g, b, h, w, dev):
    return torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_every_op_bitwise_vs_plain(cuda_device, b, h, w):
    g = np.random.default_rng(h)
    imgs = _images(g, b, h, w, cuda_device)
    for op in range(T.NUM_OPS):
        pol = torch.tensor([[[op, 1.0, lv]] for lv in np.linspace(0, 1, 5)],
                           dtype=torch.float32, device=cuda_device)
        sub = torch.arange(b, dtype=torch.int32, device=cuda_device) % 5
        draws = torch.from_numpy(np.stack([
            np.zeros(b), np.where(np.arange(b) % 2 == 0, 0.25, 0.75),
            g.uniform(0, w, b), g.uniform(0, h, b)], -1).astype(np.float32)[:, None]).to(cuda_device)
        got = T.apply_subpolicy_draws(imgs, pol, sub, draws)
        assert torch.equal(got, T.apply_subpolicy_draws_plain(imgs, pol, sub, draws)), T.OP_NAMES[op]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARCHIVES)
def test_archive_draws_bitwise_vs_plain(cuda_device, name):
    g = np.random.default_rng(len(name))
    pol = torch.from_numpy(policy_to_tensor(load_policy(name))).to(cuda_device)
    imgs = _images(g, 16, 32, 32, cuda_device)
    keys = torch.from_numpy(g.integers(0, 2**32, (16, 2), dtype=np.int64)).to(cuda_device)
    sub, draws = T.sample_exact(keys, pol.shape[0], pol.shape[1], 32, 32)
    before = _kernels.launch_counts()["augment_slot"]
    got = T.apply_subpolicy_draws(imgs, pol, sub, draws)
    assert _kernels.launch_counts()["augment_slot"] == before + pol.shape[1]
    assert torch.equal(got, T.apply_subpolicy_draws_plain(imgs, pol, sub, draws))


@pytest.mark.cuda
def test_samplers_bitwise_cuda_vs_cpu(cuda_device):
    keys = torch.from_numpy(np.random.default_rng(0).integers(0, 2**32, (64, 2), dtype=np.int64))
    for a, c in zip(T.sample_exact(keys.to(cuda_device), 493, 2, 224, 224),
                    T.sample_exact(keys, 493, 2, 224, 224)):
        assert torch.equal(a.cpu(), c)
    for a, c in zip(T.sample_grouped(keys[0].to(cuda_device), 128, 8, 493, 2, 32, 32),
                    T.sample_grouped(keys[0], 128, 8, 493, 2, 32, 32)):
        assert torch.equal(a.cpu(), c)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    imgs = torch.zeros((2, 8, 8, 3), device=cuda_device)
    rec = torch.zeros((2, 2, 16), device=cuda_device)
    with pytest.raises(TypeError):
        _kernels.augment(imgs.double(), rec)
    with pytest.raises(ValueError):
        _kernels.augment(imgs[:, :, :, :2], rec)
    with pytest.raises(ValueError):
        _kernels.augment(imgs.permute(0, 2, 1, 3), rec)
    with pytest.raises(ValueError):
        _kernels.augment(imgs, rec.cpu())


def _stack_draws(b, h, w, g):
    """Every crop offset and flip bit, cutout centres at the corners, the
    edges and random places."""
    centres = [(0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (h // 2, 0), (0, w // 2)]
    rows = []
    for i in range(b):
        j = i % 162
        cy, cx = centres[i % 6] if i % 12 < 6 else (g.integers(0, h), g.integers(0, w))
        rows.append((j // 18, (j // 2) % 9, j % 2, cy, cx))
    return np.int32(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(640, 32, 32), (4, 17, 23)])
@pytest.mark.parametrize("length", [0, 16])
def test_cifar_stack_bitwise_vs_plain(cuda_device, b, h, w, length):
    g = np.random.default_rng(b + length)
    imgs = _images(g, b, h, w, cuda_device)
    draws = torch.from_numpy(_stack_draws(b, h, w, g)).to(cuda_device)
    before = _kernels.launch_counts()["cifar_stack"]
    got = P.cifar_stack(imgs, draws, cutout_length=length)
    assert _kernels.launch_counts()["cifar_stack"] == before + 1
    want = P.cifar_stack_plain(imgs, draws, cutout_length=length)
    assert got.shape == (b, 3, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cifar_eval_batch_and_crop_draws_on_the_card(cuda_device):
    imgs = torch.arange(256, dtype=torch.float32).reshape(1, 16, 16, 1).repeat(2, 1, 1, 3)
    got = P.cifar_eval_batch(imgs.to(cuda_device))
    assert torch.equal(got.cpu(), P.cifar_eval_batch(imgs))
    keys = rng.split(torch.tensor([4, 2]), 4096)
    assert torch.equal(T.sample_crop(keys.to(cuda_device), 32, 32).cpu(),
                       T.sample_crop(keys, 32, 32))


@pytest.mark.cuda
def test_cifar_stack_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    imgs = torch.zeros((2, 8, 8, 3), device=cuda_device)
    draws = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    kw = dict(pad=4, cutout_length=16, scale=1 / 255, mean=(0, 0, 0), rstd=(1, 1, 1))
    with pytest.raises(TypeError):
        _kernels.cifar_stack(imgs.double(), draws, **kw)
    with pytest.raises(ValueError):
        _kernels.cifar_stack(imgs.permute(0, 2, 1, 3), draws, **kw)
    with pytest.raises(ValueError):
        _kernels.cifar_stack(imgs, draws.cpu(), **kw)
    with pytest.raises(ValueError):
        _kernels.cifar_stack(imgs, draws[:1], **kw)


def _imagenet_draws(n, h, w, dev, seed=0):
    """Philox draws with every (jitter order, flip) pair in turn and cutout
    centres at the corners and inside."""
    d = PhiloxDraws().imagenet_draws(torch.tensor([3, seed]), batch=n, policy_shape=None,
                                     height=h, width=w, dispatch="exact", groups=8, device=dev)
    i = torch.arange(n, device=dev, dtype=torch.int32)
    d.order, d.flip = (i % 6).contiguous(), ((i // 6) % 2).contiguous()
    corners = torch.tensor([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1]], dtype=torch.int32,
                           device=dev)
    d.centre[: min(4, n)] = corners[: min(4, n)]
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(128, 224, 224), (4, 17, 23), (24, 32, 32)])
@pytest.mark.parametrize("length", [0, 16])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_imagenet_stack_bitwise_vs_plain(cuda_device, b, h, w, length, dtype):
    g = np.random.default_rng(b + length)
    imgs = torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).to(cuda_device)
    imgs = imgs.to(dtype)
    d = _imagenet_draws(b, h, w, cuda_device, seed=length)
    before = _kernels.launch_counts()["imagenet_stack"]
    got = PI.imagenet_stack(imgs, d, cutout_length=length)
    assert _kernels.launch_counts()["imagenet_stack"] == before + 2
    want = PI.imagenet_stack_plain(imgs, d, cutout_length=length)
    assert got.shape == (b, 3, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_imagenet_train_batch_and_draws_on_the_card(cuda_device):
    """With the ImageNet archive through the augmentation kernel first, and
    the stack's draws bit-identical on the card and the CPU."""
    pol = torch.from_numpy(policy_to_tensor(load_policy("fa_resnet50_rimagenet"))).to(cuda_device)
    src = PhiloxDraws()
    for dispatch in ("exact", "grouped"):
        draws = {dev: src.imagenet_draws(torch.tensor([5, 1]), batch=16, policy_shape=(498, 2),
                                         height=64, width=64, dispatch=dispatch, groups=4,
                                         device=dev) for dev in (cuda_device, "cpu")}
        for f in ("sub_idx", "policy", "flip", "order", "factors", "alpha", "centre"):
            assert torch.equal(getattr(draws[cuda_device], f).cpu(), getattr(draws["cpu"], f)), f
    imgs = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (16, 64, 64, 3))
                            .astype(np.uint8)).to(cuda_device)
    d = draws[cuda_device]
    got = PI.imagenet_train_batch(imgs, d, policy=pol, cutout_length=16)
    x = T.apply_subpolicy_draws_plain(imgs.float(), pol, d.sub_idx, d.policy)
    assert torch.equal(got, PI.imagenet_stack_plain(x, d, cutout_length=16))
    assert torch.equal(PI.imagenet_eval_batch(imgs).cpu(), PI.imagenet_eval_batch(imgs.cpu()))


@pytest.mark.cuda
def test_imagenet_stack_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    imgs = torch.zeros((2, 8, 8, 3), device=cuda_device)
    ints = torch.zeros((2, 4), dtype=torch.int32, device=cuda_device)
    floats = torch.zeros((2, 6), device=cuda_device)
    kw = dict(cutout_length=0, scale=1 / 255, mean=(0, 0, 0), rstd=(1, 1, 1))
    with pytest.raises(TypeError):
        _kernels.imagenet_stack(imgs.double(), ints, floats, **kw)
    with pytest.raises(ValueError):
        _kernels.imagenet_stack(imgs.permute(0, 2, 1, 3), ints, floats, **kw)
    with pytest.raises(ValueError):
        _kernels.imagenet_stack(imgs, ints.cpu(), floats, **kw)
    with pytest.raises(ValueError):
        _kernels.imagenet_stack(imgs, ints[:1], floats, **kw)
