"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one:
a CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on a
GPU machine that has only the port's dependencies:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Bound: bitwise (``torch.equal``).  The augmentation kernel builds the
per-slot records on chip as its plain version's ``slot_records`` does and
both round every product and sum the same way; the CIFAR stack kernel and its plain version compute the same
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

#: 32x32 (one block per image), odd sizes, 224x224 (a cluster of blocks per
#: image), 225x223 (bands of unequal height that cross odd rows), 496x300 (the
#: tallest that fits clusters of 16, at one block per SM) and 520x300 (too
#: large for a cluster: one launch per slot)
SHAPES = [(8, 32, 32), (4, 17, 23), (2, 224, 224), (3, 225, 223), (2, 496, 300),
          (2, 520, 300)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _images(g, b, h, w, dev):
    return torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.float32)).to(dev)


def _forced(g, b, h, w, op, dev):
    """A 5-sub-policy policy of op `op` at five levels, forced on, with
    both mirror signs and random cutout centres."""
    pol = torch.tensor([[[op, 1.0, lv]] for lv in np.linspace(0, 1, 5)],
                       dtype=torch.float32, device=dev)
    sub = torch.arange(b, dtype=torch.int32, device=dev) % 5
    draws = torch.from_numpy(np.stack([
        np.zeros(b), np.where(np.arange(b) % 2 == 0, 0.25, 0.75),
        g.uniform(0, w, b), g.uniform(0, h, b)], -1).astype(np.float32)[:, None]).to(dev)
    return pol, sub, draws


def _augment_counted(imgs, pol, sub, draws):
    """The kernel's result and its launches for one call."""
    before = _kernels.launch_counts()["augment"]
    got = T.apply_subpolicy_draws(imgs, pol, sub, draws)
    return got, _kernels.launch_counts()["augment"] - before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_every_op_bitwise_vs_plain(cuda_device, b, h, w):
    g = np.random.default_rng(h)
    imgs = _images(g, b, h, w, cuda_device)
    imgs[0] = torch.floor(imgs[0] / 4 + 64)  # a low-range image for the histogram ops
    plan = _kernels.augment_plan(h, w, 1)
    for op in range(T.NUM_OPS):
        pol, sub, draws = _forced(g, b, h, w, op, cuda_device)
        got, launches = _augment_counted(imgs, pol, sub, draws)
        assert launches == plan.launches == 1
        want = T.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
        assert torch.equal(got, want), T.OP_NAMES[op]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,clusters", [(6, 32, 32, (1, 2, 4, 8, 16)),
                                            (3, 17, 23, (2, 16)),
                                            (2, 224, 224, (8, 16))])
def test_every_op_at_every_cluster_size(cuda_device, b, h, w, clusters):
    """Bands of 2 rows cross at every other row at 16 blocks per 32x32
    image; at 17 rows, 7 of 16 blocks hold no row at all."""
    g = np.random.default_rng(w)
    imgs = _images(g, b, h, w, cuda_device)
    for op in range(T.NUM_OPS):
        pol, sub, draws = _forced(g, b, h, w, op, cuda_device)
        want = T.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
        for c in clusters:
            got = _kernels.augment(imgs, pol, sub, draws, cluster=c)
            assert torch.equal(got, want), (T.OP_NAMES[op], c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(16, 32, 32), (2, 224, 224), (4, 225, 223), (2, 520, 300)])
@pytest.mark.parametrize("name", ARCHIVES)
def test_archive_draws_bitwise_vs_plain(cuda_device, name, b, h, w):
    g = np.random.default_rng(len(name) + h)
    pol = torch.from_numpy(policy_to_tensor(load_policy(name))).to(cuda_device)
    imgs = _images(g, b, h, w, cuda_device)
    keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(cuda_device)
    sub, draws = T.sample_exact(keys, pol.shape[0], pol.shape[1], h, w)
    got, launches = _augment_counted(imgs, pol, sub, draws)
    assert launches == _kernels.augment_plan(h, w, pol.shape[1]).launches
    assert launches == (1 if h * w < 520 * 300 else pol.shape[1])
    assert torch.equal(got, T.apply_subpolicy_draws_plain(imgs, pol, sub, draws))


@pytest.mark.cuda
@pytest.mark.parametrize("num_op", [1, 2, 3])
@pytest.mark.parametrize("b,h,w", [(64, 32, 32), (4, 224, 224), (2, 520, 300)])
def test_random_policies_of_1_2_3_slots(cuda_device, num_op, b, h, w):
    """Random ops, probabilities and levels over all 19 ops: gated-off
    slots, chains of reductions and warps within one launch."""
    g = np.random.default_rng(num_op * 100 + h)
    pol = np.zeros((8, num_op, 3), np.float32)
    pol[..., 0] = g.integers(0, T.NUM_OPS, (8, num_op))
    pol[..., 1:] = g.uniform(0, 1, (8, num_op, 2))
    pol = torch.from_numpy(pol).to(cuda_device)
    imgs = _images(g, b, h, w, cuda_device)
    keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(cuda_device)
    sub, draws = T.sample_exact(keys, 8, num_op, h, w)
    got, launches = _augment_counted(imgs, pol, sub, draws)
    assert launches == (1 if h < 520 else num_op)
    assert torch.equal(got, T.apply_subpolicy_draws_plain(imgs, pol, sub, draws))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", _kernels.AUGMENT_CLUSTERS)
def test_largest_band_of_every_cluster_size_is_resident(cuda_device, cluster):
    """The planner takes a cluster size only where the smaller ones do not
    fit, so the most shared memory a cluster size is planned with is that of
    the tallest image whose band still fits; such a cluster must be resident,
    or every launch of that shape would be refused."""
    h = max(h for h in range(1, 2048)
            if _kernels.augment_smem_bytes(h, 300, cluster) <= _kernels.MAX_SMEM_BYTES)
    assert _kernels.augment_max_active_clusters(h, 300, cluster=cluster) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(4, 32, 32), (2, 224, 224), (2, 520, 300)])
def test_histogram_ops_on_constant_and_two_valued_images(cuda_device, b, h, w):
    """Equalize's identity LUT (one used bin; two bins, where step may be
    0) and AutoContrast's hi <= lo case, on every path."""
    imgs = torch.full((b, h, w, 3), 77.0, device=cuda_device)
    imgs[1, : h // 3] = 200.0  # two values, a third of the image one of them
    imgs[-1, :, :, 1] = 3.0
    imgs[-1, h - 1, w - 1, 1] = 250.0  # a single outlier
    for op in (T.EQUALIZE, T.AUTO_CONTRAST, T.CONTRAST):
        pol = torch.tensor([[[op, 1.0, 0.6]]], dtype=torch.float32, device=cuda_device)
        sub = torch.zeros(b, dtype=torch.int32, device=cuda_device)
        draws = torch.zeros((b, 1, 4), dtype=torch.float32, device=cuda_device)
        got = T.apply_subpolicy_draws(imgs, pol, sub, draws)
        assert torch.equal(got, T.apply_subpolicy_draws_plain(imgs, pol, sub, draws)), op


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
    pol = torch.zeros((3, 2, 3), device=cuda_device)
    sub = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    draws = torch.zeros((2, 2, 4), device=cuda_device)
    with pytest.raises(TypeError):
        _kernels.augment(imgs.double(), pol, sub, draws)
    with pytest.raises(TypeError):
        _kernels.augment(imgs, pol, sub.long(), draws)
    with pytest.raises(ValueError):
        _kernels.augment(imgs[:, :, :, :2], pol, sub, draws)
    with pytest.raises(ValueError):
        _kernels.augment(imgs.permute(0, 2, 1, 3), pol, sub, draws)
    with pytest.raises(ValueError):
        _kernels.augment(imgs, pol, sub, draws.transpose(0, 1))
    with pytest.raises(ValueError):
        _kernels.augment(imgs, pol, sub, draws[:, :1].contiguous())
    with pytest.raises(ValueError):
        _kernels.augment(imgs, pol.cpu(), sub, draws)
    with pytest.raises(ValueError):
        _kernels.augment(imgs, pol, sub, draws, records=torch.zeros((2, 2, 15), device=cuda_device))


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
#: staged in shared memory at 32x32, 17x23 and 40x24; read from global
#: memory at 100x90 (108 KB, over the 48 KB a block gets without opting in)
@pytest.mark.parametrize("b,h,w", [(640, 32, 32), (4, 17, 23), (6, 40, 24), (2, 100, 90)])
@pytest.mark.parametrize("length", [0, 16])
def test_cifar_stack_bitwise_vs_plain(cuda_device, b, h, w, length):
    assert _kernels.cifar_plan(h, w).staged == (h * w < 100 * 90)
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
@pytest.mark.parametrize("b,h,w", [(128, 224, 224), (4, 17, 23), (24, 32, 32), (3, 225, 223)])
@pytest.mark.parametrize("length", [0, 16])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_imagenet_stack_bitwise_vs_plain(cuda_device, b, h, w, length, dtype):
    g = np.random.default_rng(b + length)
    imgs = torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).to(cuda_device)
    imgs = imgs.to(dtype)
    d = _imagenet_draws(b, h, w, cuda_device, seed=length)
    got, launches = _imagenet_counted(imgs, d, length)
    assert launches == _kernels.imagenet_plan(h, w, dtype).launches
    want = PI.imagenet_stack_plain(imgs, d, cutout_length=length)
    assert got.shape == (b, 3, h, w) and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


def _imagenet_counted(imgs, d, length, cluster=None):
    """The stack's result through the wrapper of ``_kernels`` (with a forced
    cluster size) or through ``imagenet_stack``, and its launches."""
    before = _kernels.launch_counts()["imagenet_stack"]
    if cluster is None:
        got = PI.imagenet_stack(imgs, d, cutout_length=length)
    else:
        ints = torch.stack([d.flip, d.order, d.centre[:, 0], d.centre[:, 1]], -1).contiguous()
        floats = torch.cat([d.factors, PI.lighting_rgb(d.alpha)], -1).contiguous()
        mean, rstd = (v.tolist() for v in P.norm_constants(P.IMAGENET_MEAN, P.IMAGENET_STD))
        got = _kernels.imagenet_stack(imgs, ints, floats, cutout_length=length, scale=P._SCALE,
                                      mean=mean, rstd=rstd, cluster=cluster)
    return got, _kernels.launch_counts()["imagenet_stack"] - before


def _imagenet_cases():
    """(b, h, w, dtype, cluster): every cluster size that fits at 224x224 and
    at 225x223 (bands of unequal height), for both dtypes."""
    return [(b, h, w, dtype, c) for b, h, w in ((16, 224, 224), (3, 225, 223))
            for dtype in (torch.uint8, torch.float32) for c in _kernels.IMAGENET_CLUSTERS
            if _imagenet_fits(h, w, dtype, c)]


def _imagenet_fits(h, w, dtype, cluster):
    try:
        _kernels.imagenet_plan(h, w, dtype, cluster)
    except ValueError:
        return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,dtype,cluster", _imagenet_cases())
def test_imagenet_stack_at_every_cluster_size(cuda_device, b, h, w, dtype, cluster):
    g = np.random.default_rng(cluster)
    imgs = torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).to(cuda_device)
    imgs = imgs.to(dtype)
    for length in (0, 16):
        d = _imagenet_draws(b, h, w, cuda_device, seed=cluster + length)
        got, launches = _imagenet_counted(imgs, d, length, cluster)
        assert launches == 1
        assert torch.equal(got, PI.imagenet_stack_plain(imgs, d, cutout_length=length))


#: the two-pass path: images whose band does not fit clusters of 16 blocks
TWO_PASS = [(2, 1100, 300, torch.float32), (2, 4200, 300, torch.uint8)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,dtype", TWO_PASS)
def test_imagenet_stack_two_pass_path(cuda_device, b, h, w, dtype):
    assert _kernels.imagenet_plan(h, w, dtype).path == "two_pass"
    g = np.random.default_rng(h)
    imgs = torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.uint8)).to(cuda_device)
    imgs = imgs.to(dtype)
    d = _imagenet_draws(b, h, w, cuda_device, seed=h)
    got, launches = _imagenet_counted(imgs, d, 16)
    assert launches == 2
    assert torch.equal(got, PI.imagenet_stack_plain(imgs, d, cutout_length=16))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(12, 224, 224), (12, 17, 23), (2, 1100, 300)])
def test_imagenet_stack_on_float_input_off_the_integers(cuda_device, b, h, w):
    """float32 input that is not integral and lies partly outside [0, 255]:
    every blend clips and truncates what it is given, as PIL's uint8 store
    does, on the cluster and the two-pass path."""
    g = np.random.default_rng(b * h)
    imgs = torch.from_numpy(g.uniform(-40.0, 300.0, (b, h, w, 3)).astype(np.float32))
    imgs = imgs.to(cuda_device)
    for length in (0, 16):
        d = _imagenet_draws(b, h, w, cuda_device, seed=7 + length)
        got, _ = _imagenet_counted(imgs, d, length)
        assert torch.equal(got, PI.imagenet_stack_plain(imgs, d, cutout_length=length))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(12, 224, 224), (12, 17, 23)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_imagenet_stack_on_constant_and_two_valued_images(cuda_device, b, h, w, dtype):
    """The contrast mean of a constant image is that value; of a two-valued
    one, a rounded mean between them."""
    imgs = torch.full((b, h, w, 3), 77, dtype=dtype, device=cuda_device)
    imgs[b // 2:, : h // 3] = 200  # two values, a third of the image one of them
    imgs[-1] = 0
    imgs[-2] = 255
    d = _imagenet_draws(b, h, w, cuda_device, seed=3)
    got, _ = _imagenet_counted(imgs, d, 16)
    assert torch.equal(got, PI.imagenet_stack_plain(imgs, d, cutout_length=16))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", _kernels.IMAGENET_CLUSTERS)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_imagenet_largest_band_of_every_cluster_size_is_resident(cuda_device, cluster, dtype):
    """The most shared memory a cluster size is planned with is that of the
    tallest image whose band still fits; such a cluster must be resident."""
    h = max(h for h in range(1, 4096) if _imagenet_fits(h, 300, dtype, cluster))
    assert _kernels.imagenet_max_active_clusters(h, 300, dtype, cluster=cluster) >= 1


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


@pytest.mark.cuda
def test_lighting_draws_bitwise_on_the_card(cuda_device):
    """The ImageNet draws (the lighting normals among them) of 2^20 keys are
    the same bits on the card and the CPU."""
    n = 1 << 20
    keys = torch.stack([torch.full((n,), 3, dtype=torch.int64),
                        torch.arange(n, dtype=torch.int64)], dim=1)
    ints, floats = T.sample_imagenet(keys, 224, 224)
    ints_g, floats_g = T.sample_imagenet(keys.to(cuda_device), 224, 224)
    assert torch.equal(ints_g.cpu(), ints)
    assert torch.equal(floats_g.cpu().view(torch.int32), floats.view(torch.int32))


# ------------------------------------------- K7, the sampler; K8, the noise


def _counted(name, fn):
    """`fn()`'s result and the launches of kernel `name` it made."""
    before = _kernels.launch_counts()[name]
    out = fn()
    return out, _kernels.launch_counts()[name] - before


def _same(a, b):
    """Bitwise equality of two tensors (or tuples of them) on any devices."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in (torch.float32, torch.float64):
        bits = torch.int32 if a.dtype == torch.float32 else torch.int64
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _rand_keys(seed, n):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 2**32, (n, 2), dtype=np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 37, 128])
@pytest.mark.parametrize("num_op", [1, 2, 3])
@pytest.mark.parametrize("hw", [32, 224])
def test_sampler_exact_bitwise_vs_plain(cuda_device, b, num_op, hw):
    keys = _rand_keys(b * 10 + num_op, b)
    got, n = _counted("sampler", lambda: T.sample_exact(keys.to(cuda_device), 25, num_op, hw, hw))
    assert n == 1
    assert _same(got, T.sample_exact_plain(keys.to(cuda_device), 25, num_op, hw, hw))
    assert _same(got, T.sample_exact(keys, 25, num_op, hw, hw))


@pytest.mark.cuda
@pytest.mark.parametrize("b,groups,num_sub", [(1, 8, 25), (13, 4, 25), (128, 8, 25), (5, 8, 7),
                                              (200, 3, 2), (37, 1, 493), (5000, 8, 25)])
@pytest.mark.parametrize("num_op", [1, 3])
def test_sampler_grouped_bitwise_vs_plain(cuda_device, b, groups, num_sub, num_op):
    """Groups beyond the batch, a batch not a multiple of 32, one larger than
    the kernel's shared tile of words (4096)."""
    key = _rand_keys(b + groups, 1)[0]
    got, n = _counted("sampler", lambda: T.sample_grouped(key.to(cuda_device), b, groups,
                                                          num_sub, num_op, 32, 32))
    assert n == 1
    assert _same(got, T.sample_grouped_plain(key.to(cuda_device), b, groups, num_sub, num_op,
                                             32, 32))
    assert _same(got, T.sample_grouped(key, b, groups, num_sub, num_op, 32, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(32, 32), (17, 23), (224, 224)])
def test_sampler_crop_and_imagenet_bitwise_vs_plain(cuda_device, h, w):
    keys = _rand_keys(h, 301)
    got, n = _counted("sampler", lambda: T.sample_crop(keys.to(cuda_device), h, w))
    assert n == 1 and _same(got, T.sample_crop_plain(keys.to(cuda_device), h, w))
    assert _same(got, T.sample_crop(keys, h, w))
    for kw in ({}, {"strength": 0.25, "alphastd": 0.3}):
        got, n = _counted("sampler", lambda: T.sample_imagenet(keys.to(cuda_device), h, w, **kw))
        assert n == 1 and _same(got, T.sample_imagenet_plain(keys.to(cuda_device), h, w, **kw))
        assert _same(got, T.sample_imagenet(keys, h, w, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["exact", "grouped"])
@pytest.mark.parametrize("num_sub,num_op", [(1, 2), (5, 1), (5, 2), (25, 3)])
def test_philox_draws_records_in_one_launch(cuda_device, dispatch, num_sub, num_op):
    """The TTA step's records of 5 draw keys x 128 lanes (CIFAR, and the
    ImageNet stack at 224x224) in one launch each, equal to the CPU's."""
    src = PhiloxDraws()
    keys = _rand_keys(num_sub + num_op, 5)
    kw = dict(batch=128, num_sub=num_sub, num_op=num_op, dispatch=dispatch, groups=8)
    got, n = _counted("sampler", lambda: src.draws(keys.to(cuda_device), height=32, width=32,
                                                   device=cuda_device, **kw))
    want = src.draws(keys, height=32, width=32, device="cpu", **kw)
    assert n == 1 and _same((got.sub_idx, got.policy, got.crop),
                            (want.sub_idx, want.policy, want.crop))
    fields = ("sub_idx", "policy", "flip", "order", "factors", "alpha", "centre")
    got, n = _counted("sampler", lambda: src.imagenet_lane_draws(
        keys.to(cuda_device), height=224, width=224, device=cuda_device, **kw))
    want = src.imagenet_lane_draws(keys, height=224, width=224, device="cpu", **kw)
    assert n == 1 and all(_same(getattr(got, f), getattr(want, f)) for f in fields)
    assert all(getattr(got, f).is_contiguous() for f in fields)
    shape = None if num_op == 1 else (num_sub, num_op)
    got, n = _counted("sampler", lambda: src.imagenet_draws(
        keys[0].to(cuda_device), batch=128, policy_shape=shape, height=224, width=224,
        dispatch=dispatch, groups=8, device=cuda_device))
    want = src.imagenet_draws(keys[0], batch=128, policy_shape=shape, height=224, width=224,
                              dispatch=dispatch, groups=8, device="cpu")
    assert n == 1 and all(_same(getattr(got, f), getattr(want, f)) for f in fields)


@pytest.mark.cuda
def test_key_entry_bitwise_vs_plain(cuda_device):
    keys = _rand_keys(7, 33)
    k = keys.to(cuda_device)
    cases = [lambda t: rng.fold_in(t[0], 12345), lambda t: rng.fold_in(t[:5], 77),
             lambda t: rng.fold_in(t[1], torch.tensor(2**40 + 3, device=t.device)),
             lambda t: rng.fold_in(t[2], torch.tensor(-5, device=t.device)),
             lambda t: rng.split(t, 6), lambda t: rng.split(t[3], 2),
             lambda t: rng.split(t[:4].reshape(2, 2, 2), 3),
             lambda t: rng.fold_in_range(t[4], 90), lambda t: rng.blocks(t[:3], 300, 9),
             lambda t: rng.blocks(t[5], 1000, 10)]
    plain = [lambda t: rng.fold_in_plain(t[0], 12345), lambda t: rng.fold_in_plain(t[:5], 77),
             lambda t: rng.fold_in_plain(t[1], torch.tensor(2**40 + 3, device=t.device)),
             lambda t: rng.fold_in_plain(t[2], torch.tensor(-5, device=t.device)),
             lambda t: rng.split_plain(t, 6), lambda t: rng.split_plain(t[3], 2),
             lambda t: rng.split_plain(t[:4].reshape(2, 2, 2), 3),
             lambda t: rng.fold_in_range_plain(t[4], 90),
             lambda t: rng.blocks_plain(t[:3], 300, 9), lambda t: rng.blocks_plain(t[5], 1000, 10)]
    for fn, fp in zip(cases, plain):
        got, n = _counted("sampler", lambda: fn(k))
        assert n == 1 and _same(got, fp(k)) and _same(got, fn(keys))


def _zoo_sites():
    from fast_autoaugment_tpu_torch.ops.shake import NoiseSite

    kinds = [("shake_shake", 0.0, 0), ("shake_drop", 0.3, 0), ("dropout", 0.2, 1280),
             ("drop_connect", 0.2, 0), ("shake_drop", 0.5, 0)] * 18
    sites = [NoiseSite(*k) for k in kinds]
    for i, s in enumerate(sites):
        s.site = i
    return sites


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 37, 128])
@pytest.mark.parametrize("alpha", [0.0, 0.2, 1.0])
def test_train_noise_bitwise_vs_plain(cuda_device, batch, alpha):
    """90 sites of every kind and a dropout of 1280 features, and mixup's
    draws, in one launch, equal to the plain version's on the card and the
    CPU's."""
    from fast_autoaugment_tpu_torch.ops.shake import ModelNoise

    src = PhiloxDraws()
    sites = _zoo_sites()
    ks, kd, km = _rand_keys(batch, 3)
    (noise, lam, perm), n = _counted("train_noise", lambda: src.train_draws(
        sites, batch, ks.to(cuda_device), kd.to(cuda_device), km.to(cuda_device), alpha,
        cuda_device))
    assert n == 1
    noise_cpu, lam_cpu, perm_cpu = src.train_draws(sites, batch, ks, kd, km, alpha, "cpu")
    assert all(_same(a, b) for a, b in zip(noise.tensors, noise_cpu.tensors))
    plain = ModelNoise.draw_plain(sites, batch, ks.to(cuda_device), kd.to(cuda_device))
    assert all(_same(a, b) for a, b in zip(noise.tensors, plain.tensors))
    assert _same(lam, lam_cpu) and _same(perm, perm_cpu)
    if alpha:
        (lam_m, perm_m), n = _counted("train_noise", lambda: src.mixup_draws(
            km.to(cuda_device), batch, alpha, cuda_device))
        assert n == 1 and _same(lam_m, lam_cpu) and _same(perm_m, perm_cpu)
    got, n = _counted("train_noise", lambda: src.model_noise(sites, batch, ks.to(cuda_device),
                                                            kd.to(cuda_device), cuda_device))
    assert n == 1 and all(_same(a, b) for a, b in zip(got.tensors, noise_cpu.tensors))


def _mixup_plain(keys, alpha, num):
    """The plain mixup draws of each key ``[N, 2]``: float32 Betas from
    ``split(key, 2)[0]``, the permutation of `num` from the first key's
    ``split(key, 2)[1]``."""
    pair = rng.split_plain(keys, 2)
    return (rng.beta_symmetric(pair[:, 0], alpha).to(torch.float32),
            rng.permutation(pair[0, 1], num) if num else None)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.2, 1.0, 2.0])
def test_beta_bitwise_vs_plain(cuda_device, alpha):
    """4096 mixup keys' Betas in one K8 launch, equal to the plain version's
    on the card and the CPU's."""
    keys = _rand_keys(int(alpha * 10), 4096)
    gamma = rng.gamma_constants(alpha)
    out, n = _counted("train_noise", lambda: _kernels.train_noise(
        mix_keys=keys.to(cuda_device), gamma=gamma))
    assert n == 1 and set(out) == {"lam"}
    assert _same(out["lam"], _mixup_plain(keys.to(cuda_device), alpha, 0)[0])
    assert _same(out["lam"], _mixup_plain(keys, alpha, 0)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("num", [1, 64, 128, 4096, 5000])
def test_permutation_bitwise_vs_plain(cuda_device, num):
    """A mixup key's permutation of `num` (the rank code, tile by tile past
    4096) in one K8 launch, equal to the plain version's."""
    key = _rand_keys(num, 1)
    gamma = rng.gamma_constants(0.2)
    out, n = _counted("train_noise", lambda: _kernels.train_noise(
        mix_keys=key.to(cuda_device), perm_n=num, gamma=gamma))
    assert n == 1
    for want in (_mixup_plain(key.to(cuda_device), 0.2, num), _mixup_plain(key, 0.2, num)):
        assert _same(out["lam"], want[0]) and _same(out["perm"], want[1])


@pytest.mark.cuda
def test_gamma_without_acceptance_traps(cuda_device):
    """A Gamma that accepts none of its candidates stops the kernel with a
    device fault and a message, never a quiet value (here forced by NaN
    constants, in a process of its own: the fault ends its CUDA context)."""
    import subprocess
    import sys

    code = ("import torch\n"
            "from fast_autoaugment_tpu_torch.ops import _kernels\n"
            "k = torch.zeros((4, 2), dtype=torch.int64, device='cuda')\n"
            "out = _kernels.train_noise(mix_keys=k, gamma=(float('nan'), 0.0, 1.0, False))\n"
            "torch.cuda.synchronize()\n"
            "print('QUIET', out['lam'].cpu())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "QUIET" not in proc.stdout
    assert "accepted none of its 16 candidates" in proc.stdout + proc.stderr


@pytest.mark.cuda
def test_graph_replay_reads_the_step_counter(cuda_device):
    """A captured train step's draws (the step's key entry, the records, the
    noise and mixup) read the step counter at each replay."""
    src = PhiloxDraws()
    sites = _zoo_sites()[:10]
    key = torch.tensor([3, 99], dtype=torch.int64, device=cuda_device)
    step = torch.zeros((), dtype=torch.int64, device=cuda_device)

    def draw(key, step, dev):
        key_aug, key_model = src.split(src.fold_in(key, step, dev), 2, dev)
        ks, kd, km = src.split(key_model, 3, dev)
        d = src.draws(key_aug, batch=64, num_sub=5, num_op=2, height=32, width=32,
                      dispatch="grouped", groups=8, device=dev)
        noise, lam, perm = src.train_draws(sites, 64, ks, kd, km, 0.2, dev)
        return [d.sub_idx, d.policy, d.crop, lam, perm, *[t for ts in noise.tensors for t in ts]]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draw(key, step, cuda_device)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _kernels.counting_capture() as tally, torch.cuda.graph(graph):
        outs = draw(key, step, cuda_device)
    assert tally["sampler"] == 4 and tally["train_noise"] == 1
    for s in (7, 0, 123456):
        step.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        want = draw(key.cpu(), torch.tensor(s), "cpu")
        assert all(_same(a, b) for a, b in zip(outs, want)), s


@pytest.mark.cuda
def test_sampler_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    keys = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        _kernels.sampler_keys(keys.cpu(), 2, _kernels.SPLIT)
    with pytest.raises(TypeError):
        _kernels.sampler_keys(keys.to(torch.int32), 2, _kernels.SPLIT)
    with pytest.raises(ValueError):
        _kernels.sampler_lanes(keys.t(), batch=0, height=8, width=8, crop=True)
    with pytest.raises(ValueError):
        _kernels.sampler_grouped(keys, batch=4, groups=2, num_sub=0, num_op=1, height=8,
                                 width=8)
    with pytest.raises(ValueError):
        _kernels.train_noise(mix_keys=keys, gamma=(1.0, 1.0, 1.0, False),
                             key_shake=keys[0].cpu())
    with pytest.raises(ValueError):
        _kernels.train_noise(mix_keys=keys[0], gamma=(1.0, 1.0, 1.0, False))
    with pytest.raises(ValueError):
        T.sample_exact(keys.to("meta"), 2, 1, 8, 8)
