"""Found-policy archives and the policy codec (the port's own copy of
``fast_autoaugment_tpu/policies/archive.py``).

The policies are data: JSON files under ``policies/data/``, copies of the
JAX package's.  The codec turns them into the ``[num_sub, num_op, 3]``
float32 tensor of (op_idx, prob, level) rows that the augmentation path
consumes, byte-equal to the JAX package's tensor.  :func:`policy_decoder`
turns a TPE proposal into sub-policies and :func:`remove_duplicates` drops
repeated op sequences, as the search driver needs them.
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from fast_autoaugment_tpu_torch.ops.augment import OP_NAMES, SEARCH_OP_NAMES, op_index

__all__ = ["ARCHIVES", "load_policy", "policy_to_tensor", "tensor_to_policy",
           "policy_decoder", "remove_duplicates"]

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

ARCHIVES = (
    "fa_reduced_cifar10",
    "fa_resnet50_rimagenet",
    "fa_reduced_svhn",
    "autoaug_policy",
    "autoaug_paper_cifar10",
    "arsaug_policy",
)

Policy = list[list[tuple[str, float, float]]]


@functools.lru_cache(maxsize=None)
def load_policy(name: str) -> Policy:
    """Load an archive by name; the result is cached (do not mutate it)."""
    if name not in ARCHIVES:
        raise KeyError(f"unknown policy archive {name!r}; have {ARCHIVES}")
    with open(os.path.join(_DATA_DIR, f"{name}.json")) as fh:
        raw = json.load(fh)
    return [[(str(op), float(p), float(lv)) for op, p, lv in sub] for sub in raw]


def policy_to_tensor(policies: Policy, num_op: int | None = None) -> np.ndarray:
    """Encode policies as a float32 [num_sub, num_op, 3] tensor.

    Rows are (op_idx, prob, level).  Ragged sub-policies are padded with
    no-op rows (prob 0), which the engine skips by construction.
    """
    if not policies:
        raise ValueError("empty policy list")
    if num_op is None:
        num_op = max(len(sub) for sub in policies)
    out = np.zeros((len(policies), num_op, 3), np.float32)
    for i, sub in enumerate(policies):
        if len(sub) > num_op:
            raise ValueError(f"sub-policy {i} has {len(sub)} ops > num_op={num_op}")
        for j, (name, prob, level) in enumerate(sub):
            out[i, j] = (op_index(name), prob, level)
    return out


def tensor_to_policy(tensor: np.ndarray) -> Policy:
    """Inverse of :func:`policy_to_tensor` (drops prob-0 padding rows)."""
    out: Policy = []
    for sub in np.asarray(tensor):
        ops = []
        for op_idx, prob, level in sub:
            if prob == 0.0 and level == 0.0 and op_idx == 0.0 and len(ops) > 0:
                continue  # padding
            ops.append((OP_NAMES[int(op_idx)], float(prob), float(level)))
        out.append(ops)
    return out


def policy_decoder(augment: dict, num_policy: int, num_op: int) -> Policy:
    """Decode a flat search sample into policies (reference ``archive.py:
    296-307``): keys ``policy_{i}_{j}`` (an index into the 15 searchable
    ops), ``prob_{i}_{j}`` and ``level_{i}_{j}``."""
    policies: Policy = []
    for i in range(num_policy):
        policies.append([(SEARCH_OP_NAMES[int(augment[f"policy_{i}_{j}"])],
                          float(augment[f"prob_{i}_{j}"]), float(augment[f"level_{i}_{j}"]))
                         for j in range(num_op)])
    return policies


def remove_duplicates(policies: Policy) -> Policy:
    """Drop sub-policies whose op-name sequence was already seen (reference
    ``remove_deplicates``, ``archive.py:264-278``)."""
    seen: set[str] = set()
    out: Policy = []
    for ops in policies:
        key = "_".join(op[0] for op in ops)
        if key not in seen:
            seen.add(key)
            out.append(ops)
    return out
