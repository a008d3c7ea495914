"""The launch planners of the port's CUDA kernels, on the CPU.

``ops/_kernels.py augment_plan`` chooses, from an image's shape alone,
between the augmentation kernel's cluster path (every op slot in one
launch, the image held in shared memory by a thread-block cluster) and its
per-slot path (one launch per slot, for images too large for a cluster);
``cifar_plan`` whether the CIFAR stack kernel stages its image in shared
memory.  The kernels check the plan they are handed against their own
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
        K.augment(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 1, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        K.cifar_stack(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 5), dtype=torch.int32),
                      pad=4, cutout_length=0, scale=1 / 255, mean=(0, 0, 0), rstd=(1, 1, 1))
