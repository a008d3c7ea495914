"""The TTA and audit steps replayed as CUDA graphs against the same steps
run eagerly, on the card.

Every test here needs an NVIDIA GPU and skips without one: a CUDA graph
has no CPU mode.  This file imports no JAX, so it runs on a GPU machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_graphs.py -m cuda --noconftest -q

Bound: bitwise (equal floats), both arms under deterministic cuDNN.  The
graph captures the eager step's kernels with the batch, policy and key in
static buffers and the batch index as a device counter, and adds the sums
in the eager path's order and precision (``search/tta.py _GraphedSums``).
The eager arm is the same step with its fold sums run eagerly
(``search/tta.py _eager_sums``, the CPU path).
"""

import functools
import threading
import types

import numpy as np
import pytest
import torch

from fast_autoaugment_tpu_torch.data.datasets import ArrayDataset
from fast_autoaugment_tpu_torch.data.pipeline import device_batches, eval_batches
from fast_autoaugment_tpu_torch.models import get_model
from fast_autoaugment_tpu_torch.search import census, tta

pytestmark = pytest.mark.cuda


@pytest.fixture()
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: a CUDA graph has no CPU mode")
    dev = torch.device("cuda")
    g = np.random.default_rng(5)
    n = 200  # 4 batches of 64, the last padded
    fold = ArrayDataset(g.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
                        g.integers(0, 10, (n,), dtype=np.int32), 10)
    pol = np.zeros((3, 2, 3), np.float32)
    pol[..., 0] = g.integers(0, 15, (3, 2))
    pol[..., 1:] = g.uniform(0, 1, (3, 2, 2))
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield {"dev": dev, "model": get_model({"type": "wresnet10_1"}, 10, device=dev, seed=1),
           "batches": device_batches(eval_batches(fold, None, 64, pad_multiple=64), dev),
           "policy": pol, "key": torch.tensor([0, 9], device=dev),
           "keys": torch.tensor([[0, 9], [4, 11]], device=dev)}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def _eager(step):
    """`step` with its fold sums run eagerly."""
    return types.SimpleNamespace(sums=functools.partial(tta._eager_sums, step))


def _steps(model, **kw):
    return (tta.make_tta_step(model, num_policy=3, cutout_length=16, **kw),
            _eager(tta.make_tta_step(model, num_policy=3, cutout_length=16, **kw)))


@pytest.mark.parametrize("dispatch", ["exact", "grouped"])
def test_graphed_tta_equals_eager(setup, dispatch):
    graphed, eager = _steps(setup["model"], aug_dispatch=dispatch, aug_groups=4)
    for key in (setup["key"], torch.tensor([3, 1], device=setup["dev"])):
        assert tta.eval_tta(graphed, setup["batches"], setup["policy"], key) == \
            tta.eval_tta(eager, setup["batches"], setup["policy"], key)
    identity = np.zeros((1, 2, 3), np.float32)
    assert tta.eval_tta(graphed, setup["batches"], identity, setup["key"]) == \
        tta.eval_tta(eager, setup["batches"], identity, setup["key"])
    # one graph per policy shape, reused by every trial
    assert census.executable_census(graphed) == 2


def test_graphed_batched_tta_equals_eager(setup):
    graphed, eager = _steps(setup["model"], num_candidates=2)
    pols = np.stack([setup["policy"], setup["policy"][::-1].copy()])
    assert tta.eval_tta_batched(graphed, setup["batches"], pols, setup["keys"]) == \
        tta.eval_tta_batched(eager, setup["batches"], pols, setup["keys"])
    assert census.executable_census(graphed) == 1


def test_graphed_audit_equals_eager(setup):
    kw = dict(num_policy=3, cutout_length=16)
    graphed = tta.make_audit_step(setup["model"], **kw)
    eager = _eager(tta.make_audit_step(setup["model"], **kw))
    subs = setup["policy"][:, None, 0, :].repeat(2, axis=1)  # [3, 2, 3]
    got = tta.eval_audit(graphed, setup["batches"], subs, setup["key"])
    want = tta.eval_audit(eager, setup["batches"], subs, setup["key"])
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] == 200.0
    assert got[0].dtype == np.float64 and census.executable_census(graphed) == 1


def test_ragged_fold_takes_a_graph_per_batch_shape(setup):
    """A fold in batches of 64, 64, 64 and 8: the last batch's shape is
    captured in the middle of the fold; every field is the eager one."""
    g = np.random.default_rng(6)
    fold = ArrayDataset(g.integers(0, 256, (200, 32, 32, 3), dtype=np.uint8),
                        g.integers(0, 10, (200,), dtype=np.int32), 10)
    batches = device_batches(eval_batches(fold, None, 64, pad_multiple=1), setup["dev"])
    assert [int(b["x"].shape[0]) for b in batches] == [64, 64, 64, 8]
    graphed, eager = _steps(setup["model"])
    for key in (setup["key"], torch.tensor([3, 1], device=setup["dev"])):
        got = tta.eval_tta(graphed, batches, setup["policy"], key)
        assert got == tta.eval_tta(eager, batches, setup["policy"], key) and got["cnt"] == 200.0
    kw = dict(num_policy=3, cutout_length=16)
    audit = tta.make_audit_step(setup["model"], **kw)
    subs = setup["policy"][:, None, 0, :].repeat(2, axis=1)
    got = tta.eval_audit(audit, batches, subs, setup["key"])
    want = tta.eval_audit(_eager(tta.make_audit_step(setup["model"], **kw)), batches, subs,
                          setup["key"])
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] == 200.0
    assert census.executable_census(graphed) == 2 and census.executable_census(audit) == 2


def test_two_threads_share_the_step(setup):
    """Two threads scoring through one step at once: the step's lock
    covers a fold's staging, replays and readback, so both get the eager
    fields from one graph."""
    graphed, eager = _steps(setup["model"])
    want = tta.eval_tta(eager, setup["batches"], setup["policy"], setup["key"])
    out, start = [], threading.Barrier(2)

    def run():
        start.wait()
        out.append(tta.eval_tta(graphed, setup["batches"], setup["policy"], setup["key"]))

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == [want, want]
    assert census.executable_census(graphed) == 1
