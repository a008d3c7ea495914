"""The launch planners of the port's CUDA kernels, on the CPU.

``ops/_kernels.py augment_plan`` chooses, from an image's shape alone,
between the augmentation kernel's cluster path (every op slot in one
launch, the image held in shared memory by a thread-block cluster) and its
per-slot path (one launch per slot, for images too large for a cluster);
``cifar_plan`` whether the CIFAR stack kernel stages its image in shared
memory; ``imagenet_plan``, from the shape and dtype, between the ImageNet
stack's cluster path (one launch) and its two-pass path.  The kernels check the plan they are handed against their own
layout and refuse a mismatch; these tests hold the planners to the
documented rule and to the constants in the CUDA sources.  Exact integer
checks: no tolerance.
"""

import re

import pytest
import torch

from fast_autoaugment_tpu_torch.ops import _kernels as K

#: (h, w): CIFAR, serving and odd sizes, ImageNet's 224, band-crossing odd
#: sizes, and the edges of the largest cluster's reach
SHAPES = [(32, 32), (17, 23), (1, 1), (1, 5000), (64, 64), (100, 100), (224, 224),
          (225, 223), (320, 300), (496, 300), (497, 300), (520, 300), (4096, 4095)]


def _source_constant(name: str, file: str) -> int:
    text = K.SOURCES[file].read_text()
    m = re.search(rf"constexpr int {name} = ([0-9* ]+);", text)
    assert m, f"{name} not found in {file}"
    return eval(m.group(1))  # noqa: S307 -- an integer literal product from our source


def test_constants_match_the_cuda_sources():
    assert K._AUGMENT_SCRATCH_BYTES == _source_constant("kScratchBytes", "augment")
    assert K.MAX_SMEM_BYTES == _source_constant("kMaxSmemBytes", "augment") == 232_448
    assert K._CIFAR_HEADER_BYTES == _source_constant("kHeaderBytes", "preprocess")
    assert K._CIFAR_SMEM_LIMIT == _source_constant("kMaxSmemBytes", "preprocess")
    assert K._IMAGENET_HEADER_BYTES == _source_constant("kHeaderBytes", "imagenet")
    assert K._IMAGENET_SCRATCH_PER_THREAD == _source_constant("kScratchPerThread", "imagenet")
    assert K.MAX_SMEM_BYTES == _source_constant("kMaxSmemBytes", "imagenet")


def test_32x32_is_one_block_per_image_in_one_launch():
    plan = K.augment_plan(32, 32, 2)
    assert (plan.path, plan.cluster, plan.launches, plan.kernel) == \
        ("cluster", 1, 1, "augment_kernel")
    # two float32 buffers of the 12 KB image (+16 bytes of slack each) and the scratch
    assert plan.smem_bytes == K._AUGMENT_SCRATCH_BYTES + 2 * (32 * 32 * 3 * 4 + 16)
    assert plan.threads == 256


def test_224x224_is_a_cluster_within_the_shared_memory_limit():
    plan = K.augment_plan(224, 224, 2)
    assert plan.path == "cluster" and plan.launches == 1
    assert plan.cluster == 8
    assert plan.smem_bytes <= K.MAX_SMEM_BYTES
    assert -(-224 // plan.cluster) * plan.cluster >= 224
    for c in (1, 2, 4):  # a band of 56 rows or more does not fit
        assert K.augment_smem_bytes(224, 224, c) > K.MAX_SMEM_BYTES


@pytest.mark.parametrize("num_op", [1, 2, 3])
def test_large_image_takes_the_per_slot_path(num_op):
    plan = K.augment_plan(520, 300, num_op)
    assert (plan.path, plan.launches, plan.kernel) == \
        ("per_slot", num_op, "augment_slot_kernel")
    assert K.augment_smem_bytes(520, 300, 16) > K.MAX_SMEM_BYTES


@pytest.mark.parametrize("h,w", SHAPES)
def test_plan_is_the_documented_rule(h, w):
    """The smallest cluster size whose block fits; per-slot when none does;
    one launch on the cluster path, num_op on the per-slot path."""
    plan = K.augment_plan(h, w, 3)
    fits = [c for c in K.AUGMENT_CLUSTERS if K.augment_smem_bytes(h, w, c) <= K.MAX_SMEM_BYTES]
    if not fits:
        assert plan == K.AugmentPlan("per_slot", 1, 0, 256, 3)
        return
    assert plan.cluster == fits[0]
    assert plan.path == "cluster" and plan.launches == 1
    assert plan.smem_bytes == K.augment_smem_bytes(h, w, plan.cluster) <= K.MAX_SMEM_BYTES
    assert plan.threads == (512 if 2 * plan.smem_bytes > K.MAX_SMEM_BYTES else 256)
    assert plan == K.augment_plan(h, w, 3)  # the shape alone decides


def test_shared_memory_grows_with_the_band():
    for w in (1, 23, 224, 300):
        sizes = [K.augment_smem_bytes(h, w, 4) for h in range(1, 200)]
        assert sizes == sorted(sizes)
        assert all(s % 16 == 0 for s in sizes)  # buffers stay 16-byte aligned


def test_forced_cluster_sizes():
    scratch = K._AUGMENT_SCRATCH_BYTES
    assert K.augment_plan(32, 32, 2, cluster=16).cluster == 16
    assert K.augment_plan(224, 224, 2, cluster=8).smem_bytes == scratch + 8 * (28 * 224 * 3 + 4)
    assert K.augment_plan(224, 224, 2, cluster=16).smem_bytes == scratch + 8 * (14 * 224 * 3 + 4)
    with pytest.raises(ValueError, match="does not fit"):
        K.augment_plan(224, 224, 2, cluster=4)
    with pytest.raises(ValueError, match="cluster must be one of"):
        K.augment_plan(32, 32, 2, cluster=3)
    with pytest.raises(ValueError):
        K.augment_plan(0, 32, 2)
    with pytest.raises(ValueError):
        K.augment_plan(32, 32, 0)


@pytest.mark.parametrize("h,w,staged", [(32, 32, True), (17, 23, True), (40, 24, True),
                                        (100, 90, False), (224, 224, False)])
def test_cifar_plan(h, w, staged):
    plan = K.cifar_plan(h, w)
    assert plan.staged == staged
    if staged:
        assert plan.smem_bytes == 64 + 4 * (-(-h * w * 3 // 4) * 4 + 4) <= 48 * 1024
    else:
        assert plan.smem_bytes == 64


def test_wrappers_refuse_cpu_tensors_before_building():
    """On the CPU the plain versions run; the wrappers take CUDA tensors only."""
    with pytest.raises(ValueError, match="CUDA"):
        K.augment(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 1, 3)),
                  torch.zeros(1, dtype=torch.int32), torch.zeros((1, 1, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        K.cifar_stack(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 5), dtype=torch.int32),
                      pad=4, cutout_length=0, scale=1 / 255, mean=(0, 0, 0), rstd=(1, 1, 1))


# ------------------------------------------------------------- ImageNet stack

DTYPES = [(torch.uint8, 1), (torch.float32, 4)]


def _shared(h, w, itemsize, c):
    """Two blocks of 512 threads share an SM's shared memory."""
    return 2 * K.imagenet_smem_bytes(h, w, itemsize, c, 512) <= K.MAX_SMEM_BYTES


def _alone(h, w, itemsize, c):
    """One block of 1024 threads fits."""
    return K.imagenet_smem_bytes(h, w, itemsize, c, 1024) <= K.MAX_SMEM_BYTES


def test_imagenet_plan_at_224x224():
    """The main path's shapes: float32 after the policy (clusters of 8, two
    blocks of 512 threads an SM), uint8 without one (the whole image in one
    block of 1024 threads)."""
    f32 = K.imagenet_plan(224, 224, torch.float32)
    u8 = K.imagenet_plan(224, 224, torch.uint8)
    assert f32 == K.ImageNetPlan("cluster", 8, K.imagenet_smem_bytes(224, 224, 4, 8, 512), 512, 1)
    assert u8 == K.ImageNetPlan("cluster", 1, K.imagenet_smem_bytes(224, 224, 1, 1, 1024), 1024, 1)
    assert f32.kernel == u8.kernel == ("imagenet_cluster_kernel",)
    # the header, one band in the input's dtype, 16 bytes of slack, and a
    # warp's scratch of 128 pixels (48 bytes a thread)
    assert f32.smem_bytes == 256 + 28 * 224 * 3 * 4 + 16 + 48 * 512
    assert u8.smem_bytes == 256 + 224 * 224 * 3 + 16 + 48 * 1024
    assert 2 * f32.smem_bytes <= K.MAX_SMEM_BYTES and u8.smem_bytes <= K.MAX_SMEM_BYTES
    # a float32 224x224 image is 602,112 bytes: no band of 56 rows or more
    # lets two blocks share an SM
    assert not any(_shared(224, 224, 4, c) for c in (1, 2, 4))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dtype,itemsize", DTYPES)
def test_imagenet_plan_is_the_documented_rule(h, w, dtype, itemsize):
    """One block of 1024 threads when the image fits one alone; else the
    smallest cluster at which two blocks of 512 threads share an SM; else the
    smallest whose block of 1024 threads fits; else two passes."""
    plan = K.imagenet_plan(h, w, dtype)
    shared = [c for c in K.IMAGENET_CLUSTERS if _shared(h, w, itemsize, c)]
    alone = [c for c in K.IMAGENET_CLUSTERS if _alone(h, w, itemsize, c)]
    if _alone(h, w, itemsize, 1) and not _shared(h, w, itemsize, 1):
        want = (1, 1024)
    elif shared:
        want = (shared[0], 512)
    elif alone:
        want = (alone[0], 1024)
    else:
        assert plan == K.ImageNetPlan("two_pass", 0, 0, 0, 2)
        assert plan.kernel == ("grey_sum_kernel", "imagenet_stack_kernel")
        return
    assert (plan.path, plan.cluster, plan.threads, plan.launches) == ("cluster", *want, 1)
    assert plan.smem_bytes == K.imagenet_smem_bytes(h, w, itemsize, *want) <= K.MAX_SMEM_BYTES
    assert plan == K.imagenet_plan(h, w, dtype)  # the shape and dtype alone decide


def test_imagenet_shared_memory_grows_with_the_band():
    for itemsize in (1, 4):
        for w in (1, 23, 224, 300):
            sizes = [K.imagenet_smem_bytes(h, w, itemsize, 4, 512) for h in range(1, 200)]
            assert sizes == sorted(sizes)
            assert all(s % 16 == 0 for s in sizes)  # the scratch stays 16-byte aligned


@pytest.mark.parametrize("dtype,itemsize", DTYPES)
def test_imagenet_forced_cluster_sizes(dtype, itemsize):
    for c in K.IMAGENET_CLUSTERS:
        if _shared(224, 224, itemsize, c) or _alone(224, 224, itemsize, c):
            plan = K.imagenet_plan(224, 224, dtype, cluster=c)
            threads = 512 if _shared(224, 224, itemsize, c) else 1024
            assert plan == K.ImageNetPlan(
                "cluster", c, K.imagenet_smem_bytes(224, 224, itemsize, c, threads), threads, 1)
        else:
            with pytest.raises(ValueError, match="does not fit"):
                K.imagenet_plan(224, 224, dtype, cluster=c)
    with pytest.raises(ValueError, match="cluster must be one of"):
        K.imagenet_plan(224, 224, dtype, cluster=3)
    with pytest.raises(ValueError):
        K.imagenet_plan(0, 224, dtype)
    with pytest.raises(TypeError):
        K.imagenet_plan(224, 224, torch.float64)


@pytest.mark.parametrize("h,w,dtype", [(1100, 300, torch.float32), (4200, 300, torch.uint8)])
def test_imagenet_image_too_large_for_16_blocks_takes_two_passes(h, w, dtype):
    plan = K.imagenet_plan(h, w, dtype)
    assert (plan.path, plan.launches) == ("two_pass", 2)
    with pytest.raises(ValueError, match="does not fit"):
        K.imagenet_plan(h, w, dtype, cluster=16)
    # the tallest image whose band of 16 blocks still fits takes the cluster path
    itemsize = 1 if dtype == torch.uint8 else 4
    tallest = max(hh for hh in range(1, h) if _alone(hh, w, itemsize, 16))
    assert K.imagenet_plan(tallest, w, dtype).path == "cluster"
    assert K.imagenet_plan(tallest + 1, w, dtype).path == "two_pass"


def test_imagenet_wrapper_refuses_cpu_tensors_before_building():
    ints = torch.zeros((1, 4), dtype=torch.int32)
    floats = torch.zeros((1, 6))
    before = K.launch_counts()["imagenet_stack"]
    with pytest.raises(ValueError, match="CUDA"):
        K.imagenet_stack(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), ints, floats,
                         cutout_length=0, scale=1 / 255, mean=(0, 0, 0), rstd=(1, 1, 1))
    assert K.launch_counts()["imagenet_stack"] == before
