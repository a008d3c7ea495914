"""A train step's draws in one launch (``search/tta.py PhiloxDraws.step_draws``,
``csrc/sampler.cu step_kernel``) against the chain of calls it replaces.

The CPU part needs no JAX and no card:

- ``PhiloxDraws.step_draws`` equals the chain of calls a train step made
  before it (the step counter's ``fold_in``, the split into ``(key_aug,
  key_model)``, the split of ``key_model`` into three, ``train_draws``, the
  record's ``draws`` or ``imagenet_draws``), written out here, for every
  record (CIFAR exact and grouped; ImageNet exact, grouped and without a
  policy; none), every kind of noise site and mixup at alpha 0, 0.2 and 1.5;
- a CPU train step through ``StepBody`` draws the golden file's bits
  (``tests/data/torch_sampler_golden.npz``, unchanged) when its key splits
  are the golden keys, and the plain versions' bits composed by hand
  otherwise;
- ``faa_step_draws``'s ctypes argument types match its ``extern "C"``
  declaration; ``chip_smoke._step_draw_launches`` predicts one K8 launch and
  no K7 launch a train step.

Bound: bitwise (``torch.equal`` with equal dtypes).

The card part (``-m cuda``, skipped without a GPU) holds the one launch
against the parent's chain of K7 and K8 launches and against the plain
versions on the card at WRN-40-2's, the zoo's and ResNet-50's shapes, a
captured launch at steps 0, 7 and 123456, the Beta where a Gamma's first
candidate is rejected and where its 16th is the first accepted, a Gamma
that accepts none (it traps), and the nodes of a captured step:

    python -m pytest tests/test_torch_step_draws.py -m cuda --noconftest -q
"""

import dataclasses
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch import nn

from fast_autoaugment_tpu_torch.ops import _kernels, rng
from fast_autoaugment_tpu_torch.ops.shake import ModelNoise, NoiseSite, noise_layout
from fast_autoaugment_tpu_torch.search import tta
from fast_autoaugment_tpu_torch.search.tta import DrawRecord, PhiloxDraws

#: every kind of noise site, numbered as a model numbers them
SITE_SETS = {
    "none": [],
    "shake_shake": [("shake_shake", 0.0, 0)] * 3,
    "shake_drop": [("shake_drop", 0.3, 0), ("shake_drop", 0.0, 0)],
    "drop_connect": [("drop_connect", 0.2, 0)] * 2,
    "dropout": [("drop_connect", 0.1, 0), ("dropout", 0.25, 7)],
}
#: (family, dispatch, policy): the records a train step draws
RECORDS = {"cifar_exact": ("cifar", "exact", True), "cifar_grouped": ("cifar", "grouped", True),
           "imagenet_exact": ("imagenet", "exact", True),
           "imagenet_grouped": ("imagenet", "grouped", True),
           "imagenet_nopolicy": ("imagenet", "grouped", False), "no_record": None}
BATCH, HEIGHT, WIDTH, NUM_SUB, NUM_OP, GROUPS = 6, 9, 7, 5, 2, 4


def _sites(name):
    sites = [NoiseSite(*k) for k in SITE_SETS[name]]
    for i, s in enumerate(sites):
        s.site = i
    return sites


def _record(name, batch=BATCH, hw=(HEIGHT, WIDTH), num_sub=NUM_SUB, groups=GROUPS):
    if RECORDS[name] is None:
        return None
    family, dispatch, policy = RECORDS[name]
    return DrawRecord(family == "imagenet", batch, *hw, (num_sub, NUM_OP) if policy else None,
                      dispatch, groups)


def _todays_chain(src, key, scalars, sites, batch, alpha, record):
    """A train step's draws as the step drew them by separate calls before
    ``step_draws`` (``train/steps.py`` and its augment functions)."""
    dev = scalars.device
    step = scalars[0].to(torch.int64)
    key_aug, key_model = src.split(src.fold_in(key, step, dev), 2, dev)
    noise = lam = perm = None
    if sites or alpha > 0.0:
        key_mix, key_shake, key_drop = src.split(key_model, 3, dev)
        noise, lam, perm = src.train_draws(sites, batch, key_shake, key_drop, key_mix, alpha, dev)
    draws = None
    if record is not None and record.imagenet:
        draws = src.imagenet_draws(key_aug, batch=batch, policy_shape=record.policy_shape,
                                   height=record.height, width=record.width,
                                   dispatch=record.dispatch, groups=record.groups, device=dev)
    elif record is not None:
        draws = src.draws(key_aug, batch=batch, num_sub=record.policy_shape[0],
                          num_op=record.policy_shape[1], height=record.height,
                          width=record.width, dispatch=record.dispatch, groups=record.groups,
                          device=dev)
    return tta.StepDraws(key_aug, draws, noise, lam, perm)


def _plain_step(key, scalars, sites, batch, alpha, record):
    """The same draws by the ``*_plain`` functions alone, on any device."""
    k = rng.fold_in_plain(key, scalars[0].to(torch.int64))
    key_aug, key_model = rng.split_plain(k, 2)
    noise = lam = perm = None
    if sites or alpha > 0.0:
        key_mix, key_shake, key_drop = rng.split_plain(key_model, 3)
        noise = ModelNoise.draw_plain(sites, batch, key_shake, key_drop) if sites else None
        if alpha > 0.0:
            lam, perm = tta.mixup_draws_plain(key_mix, batch, alpha)
    draws = None
    if record is not None:
        lanes, (h, w) = key_aug.reshape(1, 2), (record.height, record.width)
        if record.imagenet:
            draws = tta.imagenet_draws_plain(lanes, batch, record.policy_shape, h, w,
                                             record.grouped, record.groups)
        else:
            draws = tta.lane_draws_plain(lanes, batch, *record.policy_shape, h, w,
                                         record.grouped, record.groups)
    return tta.StepDraws(key_aug, draws, noise, lam, perm)


def _fields(d: tta.StepDraws) -> list:
    """Every tensor of a step's draws, in a fixed order (None kept)."""
    out = [d.key_aug, d.lam, d.perm]
    if d.draws is not None:
        out += [getattr(d.draws, f.name) for f in dataclasses.fields(d.draws)]
    if d.noise is not None:
        out += [t for ts in d.noise.tensors for t in ts]
    return out


def _same(a, b) -> bool:
    fa, fb = _fields(a), _fields(b)
    if len(fa) != len(fb):
        return False
    for x, y in zip(fa, fb):
        if (x is None) != (y is None):
            return False
        if x is None:
            continue
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            return False
    return True


def _scalars(step, device="cpu"):
    return torch.tensor([float(step), 0.1, 0.0, 1.0], dtype=torch.float64, device=device)


# ------------------------------------------------ the CPU


@pytest.mark.parametrize("alpha", [0.0, 0.2, 1.5])
@pytest.mark.parametrize("sites", list(SITE_SETS))
@pytest.mark.parametrize("record", list(RECORDS))
def test_step_draws_equal_todays_chain(record, sites, alpha):
    g = np.random.default_rng(len(record) * 31 + len(sites) * 7 + int(alpha * 10))
    key = torch.from_numpy(g.integers(0, 2**32, 2, dtype=np.int64))
    scalars = _scalars(int(g.integers(0, 2**40)))
    src, s, rec = PhiloxDraws(), _sites(sites), _record(record)
    got = src.step_draws(key, scalars, sites=s, batch=BATCH, alpha=alpha, record=rec,
                         layout=noise_layout(s, BATCH) if s else None)
    assert _same(got, _todays_chain(src, key, scalars, s, BATCH, alpha, rec))
    assert _same(got, _plain_step(key, scalars, s, BATCH, alpha, rec))
    assert (got.noise is None) == (not s) and (got.lam is None) == (alpha == 0.0)
    assert (got.draws is None) == (rec is None)


class _SiteModel(nn.Module):
    """A model that holds noise sites (numbered in registration order) and a
    linear head over the channel means; its forward takes the step's noise
    and leaves it unused."""

    def __init__(self, sites, classes=4):
        super().__init__()
        self.sites = nn.ModuleList(sites)
        for i, s in enumerate(sites):
            s.site = i
        self.head = nn.Linear(3, classes)

    def forward(self, x, noise=None):
        return self.head(x.mean(dim=(2, 3)))


class _Recording(PhiloxDraws):
    """PhiloxDraws that keeps each step's draws; `keys` replaces the step
    key's splits: ``(key_aug, (key_mix, key_shake, key_drop))``, either may
    be None."""

    def __init__(self, keys=(None, None)):
        self.keys, self.seen = keys, []

    def split(self, key, num, device):
        out = super().split(key, num, device)
        if num == 2 and self.keys[0] is not None:
            out = torch.stack([self.keys[0], out[1]])
        if num == 3 and self.keys[1] is not None:
            out = self.keys[1]
        return out

    def step_draws(self, *args, **kw):
        self.seen.append(super().step_draws(*args, **kw))
        return self.seen[-1]


def _run_body(src, sites, batch, hw, alpha, augment_fn, policy, step=3):
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.train import steps

    torch.manual_seed(0)
    model = _SiteModel(sites)
    opt = build_optimizer({"type": "sgd", "nesterov": True, "decay": 0.0}, lambda c: 0.05)
    state = steps.create_train_state(model, opt, use_ema=False)
    body = steps.make_train_step_body(model, opt, num_classes=4, mixup_alpha=alpha,
                                      augment_fn=augment_fn, draw_source=src)
    g = np.random.default_rng(step)
    images = torch.from_numpy(g.integers(0, 256, (batch, *hw, 3)).astype(np.uint8))
    labels = torch.from_numpy(g.integers(0, 4, batch))
    m = body(state, images, labels, policy, torch.tensor([7, 11]),
             torch.from_numpy(body.scalars(step, step)[0]))
    assert all(torch.isfinite(v).all() for v in m.values())
    return src.seen[-1]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor as the golden file holds it (``golden_records``' ``put``):
    float bits as integers, bool as uint8."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def test_train_step_body_keeps_the_golden_bits():
    """Three CPU train steps through ``StepBody`` whose key splits are the
    golden file's keys (``test_torch_sampler.golden_records``' generator,
    replayed): the noise of the golden sites at batch 5, mixup at batch 64
    and alpha 0.2, and the ImageNet record without a policy at batch 9 of
    224x224 are the file's records, bit for bit."""
    from test_torch_sampler import GOLDEN_SEED, _golden, _keys
    from test_torch_sampler import _sites as golden_sites

    from fast_autoaugment_tpu_torch.train import steps

    golden = _golden()
    g = np.random.default_rng(GOLDEN_SEED)
    _keys(g, 37)
    draw_keys, noise_keys, mix_key = _keys(g, 3), _keys(g, 2), _keys(g, 1)[0]
    cifar = steps.cifar_augment_fn(0, use_policy=False)
    policy = torch.zeros((1, 1, 3))
    model_keys = torch.stack([mix_key, noise_keys[0], noise_keys[1]])
    d = _run_body(_Recording((None, model_keys)), golden_sites(), 5, (8, 8), 0.0, cifar, policy)
    for i, ts in enumerate(d.noise.tensors):
        for j, t in enumerate(ts):
            assert np.array_equal(_bits(t).numpy(), golden[f"noise_{i}_{j}"]), (i, j)

    d = _run_body(_Recording((None, model_keys)), [], 64, (8, 8), 0.2, cifar, policy)
    assert d.lam.dtype == torch.float32
    assert np.array_equal(_bits(d.lam).numpy(), golden["mixup_0.2_64_lam"])
    assert np.array_equal(_bits(d.perm).numpy(), golden["mixup_0.2_64_perm"])

    inet = steps.imagenet_augment_fn(0, use_policy=False, aug_dispatch="grouped", aug_groups=8)
    d = _run_body(_Recording((draw_keys[0], None)), [], 9, (224, 224), 0.0, inet, policy)
    for f in ("flip", "order", "factors", "alpha", "centre"):
        assert np.array_equal(_bits(getattr(d.draws, f)).numpy(),
                              golden[f"imagenet_nopolicy_{f}"]), f


@pytest.mark.parametrize("family", ["cifar", "imagenet"])
@pytest.mark.parametrize("dispatch", ["exact", "grouped"])
def test_train_step_body_draws_the_plain_chain(family, dispatch):
    """A CPU train step through ``StepBody`` with noise sites and mixup draws
    what the plain versions give on the step's key chain, and its record
    feeds the augment function's application."""
    from fast_autoaugment_tpu_torch.train import steps

    make = steps.imagenet_augment_fn if family == "imagenet" else steps.cifar_augment_fn
    fn = make(0, True, dispatch, 2)
    policy = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (3, NUM_OP, 3))
                              .astype(np.float32))
    policy[..., 0] = torch.tensor([[1.0, 4.0], [0.0, 2.0], [3.0, 5.0]])
    sites = _sites("dropout") + _sites("shake_drop")
    src = _Recording()
    d = _run_body(src, sites, 6, (12, 10), 0.2, fn, policy, step=9)
    rec = DrawRecord(family == "imagenet", 6, 12, 10, (3, NUM_OP), dispatch, 2)
    assert d.draws is not None
    assert _same(d, _plain_step(torch.tensor([7, 11]), _scalars(9), sites, 6, 0.2, rec))


def test_custom_augment_fn_draws_from_key_aug():
    """An augment function without a record draws its own, from the key_aug
    the step's draws hand it, as the step did before."""
    from fast_autoaugment_tpu_torch.train import steps

    inner = steps.cifar_augment_fn(0, use_policy=False)
    keys = []

    def custom(images, policy, key, src):
        keys.append(key)
        return inner(images, policy, key, src)

    src = _Recording()
    d = _run_body(src, [], 4, (8, 8), 0.0, custom, torch.zeros((1, 1, 3)), step=2)
    assert d.draws is None and torch.equal(keys[-1], d.key_aug)
    assert torch.equal(d.key_aug, _plain_step(torch.tensor([7, 11]), _scalars(2), [], 4, 0.0,
                                              None).key_aug)


_CTYPES = {"int": "c_int", "unsigned": "c_uint", "float": "c_float", "double": "c_double",
           "long long": "c_longlong", "*": "c_void_p"}


def test_step_draws_signature_matches_the_source():
    """``faa_step_draws``' ctypes argument types against its ``extern "C"``
    declaration in ``csrc/sampler.cu`` (a pointer is ``c_void_p``)."""
    import ctypes

    src = _kernels.SOURCES["sampler"].read_text()
    (args,) = re.findall(r'extern "C" int faa_step_draws\(([^)]*)\)', src)
    kinds = []
    for arg in args.split(","):
        arg = " ".join(arg.replace("const ", "").split())
        kinds.append(getattr(ctypes, _CTYPES["*" if "*" in arg else arg.rsplit(" ", 1)[0]]))
    assert kinds == _kernels._SIGNATURES["sampler"]["faa_step_draws"]


@pytest.mark.parametrize("steps", [1, 3, 12])
def test_a_train_step_predicts_one_draw_launch(steps):
    """Every train step, with noise sites and mixup or without: one K8
    launch and no K7 launch."""
    import chip_smoke

    assert chip_smoke._step_draw_launches(steps) == {"sampler": 0, "train_noise": steps}


def test_step_draws_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        _kernels.step_draws(torch.tensor([1, 2]), _scalars(0), batch=4)


# ------------------------------------------------ the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _counted(fn):
    before = _kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = _kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _case(name):
    """``(sites, batch, alpha, record)`` of a main path's train step: the
    WRN-40-2 flagship, the zoo's presets and ResNet-50 (sites from the model
    built on the meta device)."""
    import chip_smoke
    from fast_autoaugment_tpu_torch.core.config import load_config
    from fast_autoaugment_tpu_torch.models import get_model, num_class
    from fast_autoaugment_tpu_torch.ops.shake import noise_sites
    from fast_autoaugment_tpu_torch.policies.archive import load_policy, policy_to_tensor

    cifar_sub = policy_to_tensor(load_policy("fa_reduced_cifar10")).shape[0]
    inet_sub = policy_to_tensor(load_policy("fa_resnet50_rimagenet")).shape[0]
    if name.startswith("wrn40_2"):
        return [], 128, 0.0, DrawRecord(False, 128, 32, 32, (cifar_sub, 2), name[8:], 8)
    if name.startswith("resnet50"):
        kind = name[9:]
        return [], 128, 0.0, DrawRecord(True, 128, 224, 224,
                                        None if kind == "nopolicy" else (inet_sub, 2),
                                        "exact" if kind == "exact" else "grouped", 8)
    path, overrides = {z[0]: z[1:] for z in chip_smoke.ZOO}[name]
    conf = load_config(f"{chip_smoke.REPO}/{path}", overrides=overrides)
    model = get_model(dict(conf["model"], dataset=conf["dataset"]), num_class(conf["dataset"]),
                      device="meta")
    b, imagenet = int(conf["batch"]), conf["dataset"].endswith("imagenet")
    hw = 224 if imagenet else 32
    return (noise_sites(model), b, float(conf.get("mixup", 0) or 0),
            DrawRecord(imagenet, b, hw, hw, (inet_sub if imagenet else cifar_sub, 2), "exact", 8))


CASES = ["wrn40_2-exact", "wrn40_2-grouped", "shakeshake26_2x96d", "pyramid272",
         "efficientnet_b0_condconv8", "resnet50-exact", "resnet50-grouped", "resnet50-nopolicy"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_one_launch_equals_the_chain_and_the_plain_versions(cuda_device, name):
    sites, b, alpha, record = _case(name)
    src, dev = PhiloxDraws(), cuda_device
    g = np.random.default_rng(len(name))
    key = torch.from_numpy(g.integers(0, 2**32, 2, dtype=np.int64))
    for step in (5, 2**33 + 7):
        scalars = _scalars(step)
        kw = dict(sites=sites, batch=b, alpha=alpha, record=record)
        one, n = _counted(lambda: src.step_draws(
            key.to(dev), scalars.to(dev), layout=noise_layout(sites, b) if sites else None, **kw))
        assert n == {"train_noise": 1}
        chain, n = _counted(lambda: tta.step_draws(src, key.to(dev), scalars.to(dev), **kw))
        noisy = bool(sites) or alpha > 0
        assert n == {"sampler": (3 if noisy else 2) + (record is not None),
                     **({"train_noise": 1} if noisy else {})}
        assert _same(one, chain)
        assert _same(one, _plain_step(key.to(dev), scalars.to(dev), sites, b, alpha, record))
        assert _same(one, src.step_draws(key, scalars, **kw))


@pytest.mark.cuda
def test_captured_launch_reads_each_steps_scalars(cuda_device):
    from fast_autoaugment_tpu_torch.ops.shake import NoiseSite

    sites = [NoiseSite(*k) for k in [("shake_shake", 0.0, 0), ("shake_drop", 0.3, 0),
                                     ("dropout", 0.2, 1280), ("drop_connect", 0.2, 0)] * 6]
    for i, s in enumerate(sites):
        s.site = i
    src = PhiloxDraws()
    record = DrawRecord(False, 64, 32, 32, (25, 2), "grouped", 8)
    kw = dict(sites=sites, batch=64, alpha=0.2, record=record)
    key = torch.tensor([3, 99], dtype=torch.int64)
    scalars = _scalars(0, cuda_device)
    kd = key.to(cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        src.step_draws(kd, scalars, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _kernels.counting_capture() as tally, torch.cuda.graph(graph):
        out = src.step_draws(kd, scalars, **kw)
    assert {k: v for k, v in tally.items() if v} == {"train_noise": 1}
    for step in (7, 0, 123456):
        scalars.copy_(_scalars(step))
        graph.replay()
        torch.cuda.synchronize()
        assert _same(out, src.step_draws(key, _scalars(step), **kw)), step


@pytest.mark.cuda
def test_captured_step_holds_one_draw_kernel_node(cuda_device):
    """The nodes of a captured call of the draws (one kernel, nothing
    else) and of a captured train step of a small WRN with mixup (one draw
    kernel among its kernels; the parent's chain held 4 draw kernels and
    the counter's cast)."""
    import chip_smoke
    from fast_autoaugment_tpu_torch.models import get_model
    from fast_autoaugment_tpu_torch.ops.optim import build_optimizer
    from fast_autoaugment_tpu_torch.train import steps

    src = PhiloxDraws()
    record = DrawRecord(False, 16, 32, 32, (25, 2), "exact", 8)
    key, scalars = torch.tensor([1, 2], device=cuda_device), _scalars(4, cuda_device)
    types, tally, names = chip_smoke.graph_census(
        lambda: src.step_draws(key, scalars, sites=[], batch=16, alpha=0.2, record=record),
        names=True)
    assert types == {"kernel": 1} and tally == {"train_noise": 1}
    assert list(names) == ["step_kernel"]

    model = get_model({"type": "wresnet10_1"}, 10, device=cuda_device)
    opt = build_optimizer({"type": "sgd", "nesterov": True, "decay": 0.0}, lambda c: 0.05)
    state = steps.create_train_state(model, opt, use_ema=False)
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.integers(0, 256, (16, 32, 32, 3)).astype(np.uint8)).to(cuda_device)
    y = torch.from_numpy(g.integers(0, 10, 16)).to(cuda_device)
    policy = torch.from_numpy(np.asarray([[[1.0, 0.5, 0.5], [3.0, 0.5, 0.5]]] * 25,
                                         np.float32)).to(cuda_device)

    def census(draw_source):
        body = steps.make_train_step_body(model, opt, num_classes=10, mixup_alpha=0.2,
                                          cutout_length=16, draw_source=draw_source)
        return chip_smoke.graph_census(lambda: body(state, x, y, policy, key, scalars),
                                       names=True)

    types, tally, names = census(src)
    draw_nodes = {k: v for k, v in names.items() if k in chip_smoke.DRAW_KERNELS}
    assert draw_nodes == {"step_kernel": 1} and tally["train_noise"] == 1
    assert "sampler" not in tally

    class Chain(PhiloxDraws):
        def step_draws(self, *a, **kw):
            return tta.step_draws(self, *a, **kw)

    chain_types, chain_tally, _ = census(Chain())
    assert chain_tally["sampler"] == 4 and chain_tally["train_noise"] == 1
    # the chain's 5 draw kernels and the counter's cast against the one launch
    assert chain_types["kernel"] - types["kernel"] == 5


def _first_accepts(gamma_keys: torch.Tensor, alpha: float) -> torch.Tensor:
    """The index of each key's first accepted Gamma candidate by the plain
    ``rng.gamma_log`` (99 where none of the 16 is), read by running it with
    1 to 16 candidates."""
    out = torch.full((gamma_keys.shape[0],), 99)
    saved = rng.BETA_CANDIDATES
    try:
        for k in range(rng.BETA_CANDIDATES, 0, -1):
            rng.BETA_CANDIDATES = k
            out[rng.gamma_log(gamma_keys, alpha)[1]] = k - 1
    finally:
        rng.BETA_CANDIDATES = saved
    return out


def _gamma_pairs(mix_keys):
    """The (X, Y) Gamma keys of each mixup key's Beta."""
    pair = rng.split_plain(rng.split_plain(mix_keys, 2)[:, 0], 2)
    return pair[:, 0], pair[:, 1]


def _step_mix_keys(key, steps: int):
    """``key_mix`` of steps 0 .. steps - 1 of a train step's key chain."""
    key_model = rng.split_plain(rng.fold_in_range_plain(key, steps), 2)[:, 1]
    return rng.split_plain(key_model, 3)[:, 0]


def _find(index_x, index_y, want_x):
    """The first position whose X Gamma's first accepted candidate is
    `want_x` (a predicate) and whose Y Gamma accepts one."""
    hits = torch.nonzero(want_x(index_x) & (index_y < 99)).flatten()
    assert hits.numel(), "no key found"
    return int(hits[0])


#: Gamma constants with c five times Marsaglia and Tsang's (alpha 1.5): a
#: candidate is accepted about 1 time in 5, so keys whose 16th candidate is
#: the first accepted (0.7%) and keys that accept none (3%) are found among
#: a few thousand
DISTORTED = (lambda d, c, inv, boost: (d, 5.0 * c, inv, boost))(*rng.gamma_constants(1.5))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["first_rejected_0.2", "first_rejected_1.5", "sixteenth"])
def test_beta_across_a_warp_keeps_lam(cuda_device, monkeypatch, case):
    """Mixup's lam from K8 alone (``train_noise``) and from the step's one
    launch equals the plain version where a Gamma's first candidate is
    rejected, and where its 16th is the first accepted (under the distorted
    constants, handed to both)."""
    alpha = 1.5 if case == "sixteenth" else float(case.rsplit("_", 1)[1])
    gamma = rng.gamma_constants(alpha)
    if case == "sixteenth":
        gamma = DISTORTED
        monkeypatch.setattr(rng, "gamma_constants", lambda shape: DISTORTED)
        want = lambda ix: ix == 15  # noqa: E731
    else:
        want = lambda ix: (ix > 0) & (ix < 99)  # noqa: E731
    g = np.random.default_rng(17)
    mix_keys = torch.from_numpy(g.integers(0, 2**32, (8192, 2), dtype=np.int64))
    x, y = _gamma_pairs(mix_keys)
    i = _find(_first_accepts(x, alpha), _first_accepts(y, alpha), want)
    k = mix_keys[i:i + 1]
    out = _kernels.train_noise(mix_keys=k.to(cuda_device), gamma=gamma)
    lam_plain = rng.beta_symmetric(rng.split_plain(k, 2)[:, 0], alpha).to(torch.float32)
    assert torch.equal(out["lam"].cpu(), lam_plain)

    key = torch.tensor([5, 6], dtype=torch.int64)
    x, y = _gamma_pairs(_step_mix_keys(key, 8192))
    step = _find(_first_accepts(x, alpha), _first_accepts(y, alpha), want)
    got = _kernels.step_draws(key.to(cuda_device), _scalars(step, cuda_device), batch=8,
                              gamma=gamma)
    plain = _plain_step(key, _scalars(step), [], 8, alpha, None)
    assert torch.equal(got["lam"].cpu().reshape(()), plain.lam)
    assert torch.equal(got["perm"].cpu(), plain.perm)


@pytest.mark.cuda
def test_gamma_accepting_none_traps_in_the_step_launch(cuda_device):
    """A step whose Gamma X accepts none of its 16 candidates (under the
    distorted constants) stops the launch with a device fault and the
    Gamma's key in the message, never a quiet value (in a process of its
    own: the fault ends its CUDA context)."""
    key = torch.tensor([5, 6], dtype=torch.int64)
    x, y = _gamma_pairs(_step_mix_keys(key, 8192))
    saved = rng.gamma_constants
    rng.gamma_constants = lambda shape: DISTORTED
    try:
        step = int(torch.nonzero(_first_accepts(x, 1.5) == 99).flatten()[0])
    finally:
        rng.gamma_constants = saved
    code = ("import torch\n"
            "from fast_autoaugment_tpu_torch.ops import _kernels\n"
            "k = torch.tensor([5, 6], dtype=torch.int64, device='cuda')\n"
            f"s = torch.tensor([{step}.0, 0.1, 0.0, 1.0], dtype=torch.float64, device='cuda')\n"
            f"out = _kernels.step_draws(k, s, batch=8, gamma={DISTORTED!r})\n"
            "torch.cuda.synchronize()\n"
            "print('QUIET', out['lam'].cpu())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and "QUIET" not in proc.stdout
    words = " ".join(str(int(w)) for w in x[step])
    assert f"accepted none of its 16 candidates (key {words})" in proc.stdout + proc.stderr
