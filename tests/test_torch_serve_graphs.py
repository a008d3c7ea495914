"""The serving applier's CUDA graphs against its eager dispatch, on the card
(``fast_autoaugment_tpu_torch/serve/policy_server.py``).

Every test here needs an NVIDIA GPU and skips without one: a CUDA graph
has no CPU mode.  This file imports no JAX, so it runs on a GPU machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_serve_graphs.py -m cuda --noconftest -q

Bound: bitwise (equal floats).  The graph of a padded shape runs the
port's sampler and the policy kernel (``csrc/augment.cu``) over static
buffers; the eager arm (``PolicyApplier.apply_eager``) pads, draws and
applies launch by launch, the path ``tests/test_torch_serve.py`` holds
against the JAX package on the CPU.
"""

import threading

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor
from fast_autoaugment_tpu_torch.serve.policy_server import PolicyApplier, PolicyServer

pytestmark = pytest.mark.cuda

SHAPES = (1, 8, 32, 128)


@pytest.fixture(scope="module")
def appliers():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: a CUDA graph has no CPU mode")
    cifar = policy_to_tensor(load_policy("fa_reduced_cifar10"))
    single = policy_to_tensor([load_policy("fa_resnet50_rimagenet")[0]])
    return {"grouped": PolicyApplier(cifar, image=32, shapes=SHAPES, device="cuda"),
            "donated": PolicyApplier(cifar, image=32, shapes=SHAPES, device="cuda",
                                     donate=True),
            "exact": PolicyApplier(single, image=64, shapes=(1, 8), device="cuda"),
            "cifar": cifar}


def _images(n, size, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3)).astype(np.uint8)


@pytest.mark.parametrize("s", SHAPES)
@pytest.mark.parametrize("which", ["grouped", "donated"])
def test_grouped_graph_replay_bitwise_every_shape(appliers, which, s):
    ap = appliers[which]
    assert ap.graphed and ap.compile_log[s]["sec"] > 0
    for n in sorted({s, max(1, s - 3)}):
        imgs = _images(n, 32, seed=s + n)
        for d in (0, 7, 2**31 + 5):
            key = np.uint32([0, d & 0xFFFFFFFF])
            assert np.array_equal(ap.apply(imgs, key), ap.apply_eager(imgs, key))


@pytest.mark.parametrize("n", [1, 5, 8, 11])
def test_exact_graph_replay_bitwise(appliers, n):
    ap = appliers["exact"]
    imgs = _images(n, 64, seed=n)
    keys = np.stack([np.uint32([0, 1000 + i]) for i in range(n)])
    assert np.array_equal(ap.apply(imgs, keys), ap.apply_eager(imgs, keys))


def test_replays_count_the_captured_launches(appliers):
    ap = appliers["grouped"]
    per_call = _kernels.augment_plan(32, 32, ap.num_op).launches
    before = _kernels.launch_counts()["augment"]
    for i in range(5):
        ap.apply(_images(20, 32, seed=i), np.uint32([0, i]))
    assert _kernels.launch_counts()["augment"] - before == 5 * per_call


def test_replays_bitwise_beside_a_concurrent_tenant_capture(appliers):
    """A tenant's applier is built (its graphs captured) in another thread
    while this thread replays: every replay still equals the eager path,
    and so does the new tenant's."""
    ap = appliers["grouped"]
    built = {}

    def build():
        built["tenant"] = PolicyApplier(appliers["cifar"][::-1].copy(), image=32,
                                        shapes=SHAPES, device="cuda")

    t = threading.Thread(target=build)
    t.start()
    outs = []
    i = 0
    while t.is_alive() or i < 8:
        imgs, key = _images(32, 32, seed=100 + i), np.uint32([0, 100 + i])
        outs.append((imgs, key, ap.apply(imgs, key)))
        i += 1
    t.join()
    for imgs, key, out in outs:
        assert np.array_equal(out, ap.apply_eager(imgs, key))
    tenant = built["tenant"]
    imgs = _images(128, 32, seed=9)
    assert np.array_equal(tenant.apply(imgs, np.uint32([0, 3])),
                          tenant.apply_eager(imgs, np.uint32([0, 3])))


def test_double_buffered_server_on_graphs_bitwise(appliers):
    """The server's key for dispatch d is (0, d): a double-buffered server
    on the donated applier answers each sequential request with the eager
    path's bytes under that key."""
    ap = appliers["donated"]
    srv = PolicyServer(ap, max_wait_ms=1, double_buffer=True).start()
    try:
        for d, n in enumerate((3, 128, 1, 40, 8)):
            imgs = _images(n, 32, seed=50 + d)
            assert np.array_equal(srv.augment(imgs), ap.apply_eager(imgs, np.uint32([0, d])))
    finally:
        srv.stop()
