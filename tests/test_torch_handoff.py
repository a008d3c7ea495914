"""The hand-off from the draws to the policy application: K1 builds each
slot's record on chip from the policy, ``sub_idx`` and the draws.

This file imports no JAX: the JAX package's range table is read from its
source.  The CPU part checks what surrounds the kernel:

- the CPU path never reaches ``ops/_kernels.py``;
- ``_SIGNATURES["augment"]`` matches the ``extern "C"`` launchers of
  ``csrc/augment.cu``, and the kernel's op ids match ``OP_NAMES``;
- the range tables handed to K1 are ``_op_tables``' tensors of the port's
  ``_OP_LOW``/``_OP_HIGH``/``_OP_MIRROR``, equal to the JAX package's;
- a ``sub_idx`` that is not int32 reaches the kernel converted once, out of
  range where it was out of range.

The ``cuda`` part runs on the card:

    python -m pytest tests/test_torch_handoff.py -m cuda --noconftest -q

Bound: bitwise.  K1 from draws against ``apply_subpolicy_draws_plain``
(images) and against ``slot_records`` on the card (the records the kernel
built, each float32 word compared as an integer), 0 differing, for every op
at levels 0, 1 and a seeded sweep, Rotate at 65,536 levels under both mirror
signs, gates on and off, 1-3 slots, exact and grouped draws from K7, 32² at
B = 1, 8, 128, 640, 224² at B = 8 and 128, and the per-slot path; libdevice's
``cosf``/``sinf`` under the port's flags against ``torch.cos``/``torch.sin``
on every float32 of magnitude up to 0.53 (Rotate's radians reach 0.5236); an
out-of-range ``sub_idx`` or op id traps, in a process of its own.
"""

import ast
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.ops import _kernels
from fast_autoaugment_tpu_torch.ops import augment as T

REPO = Path(__file__).resolve().parent.parent


def _policy(g, num_sub, num_op, ops=T.NUM_OPS):
    """Random ops, probabilities and levels."""
    pol = np.zeros((num_sub, num_op, 3), np.float32)
    pol[..., 0] = g.integers(0, ops, (num_sub, num_op))
    pol[..., 1:] = g.uniform(0, 1, (num_sub, num_op, 2))
    return torch.from_numpy(pol)


# ------------------------------------------------------------------ the CPU


def test_cpu_path_never_reaches_the_kernels(monkeypatch):
    """The policy application on CPU tensors, alone and inside the CIFAR and
    ImageNet stacks: no wrapper of ``_kernels`` is called, nothing is built,
    no launch is counted."""
    from fast_autoaugment_tpu_torch.ops import preprocess as P
    from fast_autoaugment_tpu_torch.ops import preprocess_imagenet as PI
    from fast_autoaugment_tpu_torch.search.tta import PhiloxDraws

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernels")

    _kernels.reset_launch_counts()
    for name in ("load_libraries", "augment", "cifar_stack", "imagenet_stack"):
        monkeypatch.setattr(_kernels, name, refuse)
    g = np.random.default_rng(0)
    pol = _policy(g, 5, 2)
    imgs = torch.from_numpy(g.integers(0, 256, (6, 12, 10, 3)).astype(np.float32))
    sub, draws = T.sample_exact(torch.arange(12).reshape(6, 2), 5, 2, 12, 10)
    want = T.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
    assert torch.equal(T.apply_subpolicy_draws(imgs, pol, sub, draws), want)
    assert torch.equal(T.apply_subpolicy_draws(imgs, pol, sub.long(), draws), want)
    crop = T.sample_crop(torch.arange(12).reshape(6, 2), 12, 10)
    P.cifar_train_batch(imgs, crop, policy=pol, sub_idx=sub, policy_draws=draws)
    d = PhiloxDraws().imagenet_draws(torch.tensor([0, 5]), batch=6, policy_shape=(5, 2),
                                     height=12, width=12, dispatch="exact", groups=2,
                                     device="cpu")
    PI.imagenet_train_batch(torch.from_numpy(g.integers(0, 256, (6, 12, 12, 3))
                                             .astype(np.uint8)), d, policy=pol)
    assert all(v == 0 for v in _kernels.launch_counts().values())


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "void": None}


def _declarations(src: str) -> dict:
    decls = {}
    for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for arg in args.split(","):
            arg = " ".join(arg.replace("const ", "").split())
            kinds.append(("*", arg.split("*")[0].strip()) if "*" in arg
                         else _CTYPES[arg.rsplit(" ", 1)[0]])
        decls[name] = kinds
    return decls


def test_augment_signatures_match_the_source():
    """``_SIGNATURES["augment"]`` against the ``extern "C"`` declarations of
    ``csrc/augment.cu``: the same functions, and for K1's two launchers every
    argument's ctypes type (a pointer is ``c_void_p``); the occupancy query
    returns its count through an ``int*``."""
    decls = _declarations(_kernels.SOURCES["augment"].read_text())
    sigs = _kernels._SIGNATURES["augment"]
    assert set(decls) == set(sigs)
    for name in ("faa_augment", "faa_augment_slot"):
        got = [ctypes.c_void_p if isinstance(k, tuple) else k for k in decls[name]]
        assert got == sigs[name], name
    occupancy = decls["faa_augment_max_active_clusters"]
    assert occupancy[-1] == ("*", "int") and sigs["faa_augment_max_active_clusters"][-1] \
        == ctypes.POINTER(ctypes.c_int)
    assert occupancy[:-1] == sigs["faa_augment_max_active_clusters"][:-1]
    # the seven inputs of K1 besides the images, then the optional records out
    assert [k[1] for k in decls["faa_augment"][2:9]] == ["float", "int", "float", "float",
                                                         "float", "unsigned char", "float"]


def test_kernel_op_ids_match_the_table():
    """The kernel's op enum and op count are ``OP_NAMES``' order and length."""
    src = _kernels.SOURCES["augment"].read_text()
    enum = re.search(r"enum Op \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    snake = [re.sub(r"(?<!^)(?=[A-Z])", "_", n).upper() for n in T.OP_NAMES]
    assert names == snake
    assert int(re.search(r"constexpr int kNumOps = (\d+);", src).group(1)) == T.NUM_OPS


def _jax_op_table():
    """``_OP_TABLE`` of ``fast_autoaugment_tpu/ops/augment.py``, read from its
    source (no JAX import)."""
    tree = ast.parse((REPO / "fast_autoaugment_tpu" / "ops" / "augment.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "_OP_TABLE"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("no _OP_TABLE in the JAX package's ops/augment.py")


def test_range_tables_handed_to_k1_are_the_ports_and_the_jax_packages():
    """``augment_operands`` hands K1 the policy, ``sub_idx``, the draws and
    ``_op_tables``' own tensors on the policy's device (float32, float32,
    bool), whose values are ``_OP_LOW``/``_OP_HIGH``/``_OP_MIRROR`` and the
    JAX package's table rounded to float32."""
    pol = torch.zeros((2, 1, 3))
    sub = torch.zeros(3, dtype=torch.int32)
    draws = torch.zeros((3, 1, 4))
    operands = _kernels.augment_operands(pol, sub, draws)
    assert operands[0] is pol and operands[1] is sub and operands[2] is draws
    low, high, mirror = operands[3:]
    assert all(a is b for a, b in zip(operands[3:], T._op_tables(torch.device("cpu"))))
    assert (low.dtype, high.dtype, mirror.dtype) == (torch.float32, torch.float32, torch.bool)
    assert np.array_equal(low.numpy(), T._OP_LOW) and np.array_equal(high.numpy(), T._OP_HIGH)
    assert np.array_equal(mirror.numpy(), T._OP_MIRROR)
    table = _jax_op_table()
    assert [t[0] for t in table] == list(T.OP_NAMES)
    assert np.array_equal(low.numpy(), np.float32([t[1] for t in table]))
    assert np.array_equal(high.numpy(), np.float32([t[2] for t in table]))
    assert np.array_equal(mirror.numpy(), np.bool_([t[3] for t in table]))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16, torch.float32])
def test_sub_idx_reaches_the_kernel_in_32_bits_out_of_range_where_it_was(dtype):
    """int32 goes as it is (no device op); another type is read as the
    plain version reads it (``.to(torch.int64)``) and stays out of range
    where it was, however far out."""
    sub = torch.tensor([0, 4, 2], dtype=torch.int32)
    assert T._kernel_sub_idx(sub, 5) is sub
    vals = [0, 4, 5, -1, 2**31 - 1, 2**32, -(2**40)]
    if dtype == torch.int16:
        vals = [0, 4, 5, -1, 32767, -32768]
    elif dtype == torch.float32:
        vals = [0.0, 4.9, 5.0, -1.0, 2.0**32, -0.5]
    got = T._kernel_sub_idx(torch.tensor(vals, dtype=dtype), 5)
    assert got.dtype == torch.int32
    as_plain = torch.tensor(vals, dtype=dtype).to(torch.int64)
    inside = (as_plain >= 0) & (as_plain < 5)
    assert torch.equal(got[inside].long(), as_plain[inside])
    assert bool(((got[~inside] < 0) | (got[~inside] >= 5)).all())


# ------------------------------------------------------------------ the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _records(imgs, pol, sub, draws, cluster=None):
    """K1's output and the records it built, for one call."""
    rec = torch.full((imgs.shape[0], pol.shape[1], 16), float("nan"), device=imgs.device)
    out = _kernels.augment(imgs, pol, sub, draws, cluster=cluster, records=rec)
    return out, rec


def _hold(imgs, pol, sub, draws, cluster=None):
    """K1 from draws against ``slot_records`` (bits) and the plain version
    (images); the public call launches only K1, as its plan says."""
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    out, rec = _records(imgs, pol, sub, draws, cluster)
    want = T.slot_records(pol, sub, draws, h, w)
    n_rec = int((rec.view(torch.int32) != want.view(torch.int32)).sum())
    assert n_rec == 0, f"{n_rec} record words differ at {tuple(imgs.shape)}"
    plain = T.apply_subpolicy_draws_plain(imgs, pol, sub, draws)
    assert torch.equal(out, plain)
    before = _kernels.launch_counts()
    got = T.apply_subpolicy_draws(imgs, pol, sub, draws)
    after = _kernels.launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert launches == {"augment": _kernels.augment_plan(h, w, int(pol.shape[1])).launches}
    assert torch.equal(got, plain)


def _images(g, b, h, w, dev):
    x = torch.from_numpy(g.integers(0, 256, (b, h, w, 3)).astype(np.float32)).to(dev)
    x[: max(1, b // 4)] = torch.floor(x[: max(1, b // 4)] / 4 + 64)  # low range
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(8, 32, 32), (8, 224, 224), (2, 520, 300)])
def test_every_op_at_levels_0_1_and_a_sweep(cuda_device, b, h, w):
    """Each op forced on at levels 0 and 1 and 14 seeded levels, both
    mirror signs, cutout centres across the image; every fourth lane gated
    off by a draw at its probability."""
    g = np.random.default_rng(h * 7 + b)
    levels = np.concatenate([[0.0, 1.0], g.uniform(0, 1, 14)]).astype(np.float32)
    imgs = _images(g, b, h, w, cuda_device)
    for op in range(T.NUM_OPS):
        pol = torch.tensor([[[op, 0.5, lv]] for lv in levels], device=cuda_device)
        n = len(levels) * 2
        sub = torch.arange(n, dtype=torch.int32, device=cuda_device) % len(levels)
        gate = np.where(np.arange(n) % 4 == 3, 0.5, 0.25)  # 0.5 < 0.5 is off
        mirror = np.where(np.arange(n) < len(levels), 0.25, 0.75)
        draws = torch.from_numpy(np.stack([gate, mirror, g.uniform(0, w, n), g.uniform(0, h, n)],
                                          -1).astype(np.float32)[:, None]).to(cuda_device)
        for lo in range(0, n, b):
            _hold(imgs, pol, sub[lo:lo + b].contiguous(), draws[lo:lo + b].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,chunk", [(32, 32, 8192), (224, 224, 512)])
def test_rotate_at_65536_levels_under_both_signs(cuda_device, h, w, chunk):
    """Rotate's cos/sin and its rows: 65,536 levels in [0, 1] under both
    mirror signs, the records bitwise against ``slot_records`` on the card
    and the images against the plain version."""
    levels = np.linspace(0, 1, 65536, dtype=np.float32)
    pol = torch.from_numpy(np.stack([np.full_like(levels, T.ROTATE), np.ones_like(levels),
                                     levels], -1)[:, None]).to(cuda_device)
    n = 2 * len(levels)
    sub = (torch.arange(n, dtype=torch.int32, device=cuda_device) % len(levels))
    mirror = (torch.arange(n, device=cuda_device) >= len(levels)).to(torch.float32)
    draws = torch.stack([torch.zeros(n, device=cuda_device), mirror,
                         torch.full((n,), w / 3, device=cuda_device),
                         torch.full((n,), h / 3, device=cuda_device)], -1)[:, None].contiguous()
    g = np.random.default_rng(h)
    imgs = _images(g, chunk, h, w, cuda_device)
    for lo in range(0, n, chunk):
        s, d = sub[lo:lo + chunk].contiguous(), draws[lo:lo + chunk].contiguous()
        out, rec = _records(imgs, pol, s, d)
        want = T.slot_records(pol, s, d, h, w)
        assert int((rec.view(torch.int32) != want.view(torch.int32)).sum()) == 0, lo
        if lo % (8 * chunk) == 0:  # the images of every eighth chunk
            assert torch.equal(out, T.apply_subpolicy_draws_plain(imgs, pol, s, d)), lo


@pytest.mark.cuda
@pytest.mark.parametrize("num_op", [1, 2, 3])
@pytest.mark.parametrize("dispatch", ["exact", "grouped"])
@pytest.mark.parametrize("b,h,w", [(1, 32, 32), (8, 32, 32), (128, 32, 32), (640, 32, 32),
                                   (8, 224, 224), (128, 224, 224), (2, 520, 300)])
def test_random_policies_from_k7_draws(cuda_device, num_op, dispatch, b, h, w):
    """Random policies over all 19 ops (gates on and off by their
    probabilities) on K7's exact and grouped draws."""
    g = np.random.default_rng(num_op * 1000 + b + h)
    pol = _policy(g, 25, num_op).to(cuda_device)
    imgs = _images(g, b, h, w, cuda_device)
    keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(cuda_device)
    if dispatch == "exact":
        sub, draws = T.sample_exact(keys, 25, num_op, h, w)
    else:
        sub, draws = T.sample_grouped(keys[0], b, 8, 25, num_op, h, w)
    assert sub.dtype == torch.int32
    _hold(imgs, pol, sub, draws)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,clusters", [(6, 32, 32, (1, 2, 4, 8, 16)),
                                            (3, 17, 23, (2, 16)), (2, 224, 224, (8, 16))])
def test_records_at_every_cluster_size(cuda_device, b, h, w, clusters):
    """Rank 0 of each cluster writes the records the block built; every
    cluster size builds the same records and the same images."""
    g = np.random.default_rng(b * w)
    pol = _policy(g, 9, 3).to(cuda_device)
    imgs = _images(g, b, h, w, cuda_device)
    keys = torch.from_numpy(g.integers(0, 2**32, (b, 2), dtype=np.int64)).to(cuda_device)
    sub, draws = T.sample_exact(keys, 9, 3, h, w)
    for c in clusters:
        _hold(imgs, pol, sub, draws, cluster=c)


_TRIG_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void trig(uint32_t base, uint32_t sign, long long n, const float* rc, const float* rs,
                     unsigned long long* bad) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __uint_as_float((base + (uint32_t)i) | sign);
  if (__float_as_uint(cosf(x)) != __float_as_uint(rc[i])) atomicAdd(bad, 1ull);
  if (__float_as_uint(sinf(x)) != __float_as_uint(rs[i])) atomicAdd(bad + 1, 1ull);
}
extern "C" int probe(uint32_t base, uint32_t sign, long long n, const float* rc,
                     const float* rs, unsigned long long* bad, void* stream) {
  trig<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(base, sign, n, rc, rs,
                                                                      bad);
  return (int)cudaGetLastError();
}
"""


@pytest.mark.cuda
def test_cosf_sinf_under_the_ports_flags_equal_torch_on_every_rotate_radian(cuda_device,
                                                                             tmp_path):
    """K1 evaluates Rotate's cos/sin with libdevice's ``cosf``/``sinf``,
    built with ``_kernels.NVCC_FLAGS`` (``--fmad=false``); ``slot_records``
    with ``torch.cos``/``torch.sin`` on the card.  Every float32 of magnitude
    up to 0.53, both signs (about 2.1e9 values), gives the same bits."""
    src = tmp_path / "probe.cu"
    src.write_text(_TRIG_PROBE)
    lib_path = tmp_path / "probe.so"
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4
    top = int(np.float32(0.53).view(np.uint32))
    chunk = 1 << 26
    bad = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    for sign in (0, 1 << 31):
        for base in range(0, top + 1, chunk):
            n = min(chunk, top + 1 - base)
            bits = torch.arange(base, base + n, dtype=torch.int64, device=cuda_device) | sign
            x = (bits - (bits >= 1 << 31).long() * (1 << 32)).to(torch.int32).view(torch.float32)
            rc, rs = torch.cos(x), torch.sin(x)
            assert lib.probe(base, sign, n, rc.data_ptr(), rs.data_ptr(), bad.data_ptr(),
                             stream) == 0
    torch.cuda.synchronize()
    assert bad.tolist() == [0, 0]


_TRAP = """
import sys
import torch
from fast_autoaugment_tpu_torch.ops import augment as T
kind, h, w = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
pol = torch.tensor([[[T.ROTATE, 1.0, 0.5]], [[T.INVERT, 1.0, 0.5]]], device="cuda")
sub = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
if kind == "sub":
    sub[1] = 2
else:
    pol[1, 0, 0] = 19.0 if kind == "op_high" else -1.0
draws = torch.zeros((2, 1, 4), device="cuda")
out = T.apply_subpolicy_draws(torch.zeros((2, h, w, 3), device="cuda"), pol, sub, draws)
torch.cuda.synchronize()
print("QUIET", float(out.sum()))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("kind,message", [("sub", "sub_idx[1] = 2 is outside [0, 2)"),
                                          ("op_high", "op id 19 of sub-policy 1"),
                                          ("op_low", "op id -1 of sub-policy 1")])
@pytest.mark.parametrize("h,w", [(32, 32), (520, 300)])
def test_out_of_range_inputs_trap(cuda_device, kind, message, h, w):
    """A sub-policy index or an op id out of range stops K1 with a device
    fault and a message, on the cluster path and the per-slot path (in a
    process of its own: the fault ends its CUDA context)."""
    proc = subprocess.run([sys.executable, "-c", _TRAP, kind, str(h), str(w)],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0 and "QUIET" not in proc.stdout
    assert message in proc.stdout + proc.stderr
