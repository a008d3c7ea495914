"""The port's configuration reader (``fast_autoaugment_tpu_torch.core.config``)
against the JAX package's (``fast_autoaugment_tpu/core/config.py``, which
reads YAML with PyYAML), on the CPU.

Oracles: ``yaml.safe_load`` of every preset in ``confs/`` (equal dicts, one
case per file); the JAX ``parse_overrides`` and ``load_config`` on the
same overrides (equal values of equal types, inside the subset); the JAX
``Config`` semantics (dotted ``get``, ``replace``, immutability, hashing).
"""

import glob
import os

import pytest
import yaml

from fast_autoaugment_tpu.core import config as JC
from fast_autoaugment_tpu_torch.core import config as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "confs", "*.yaml")))


@pytest.mark.parametrize("path", CONFS, ids=[os.path.basename(p) for p in CONFS])
def test_reader_equals_yaml_safe_load(path):
    with open(path) as fh:
        text = fh.read()
    want = yaml.safe_load(text)
    got = C.parse_yaml(text)
    assert got == want

    def types(tree):
        return {k: types(v) if isinstance(v, dict) else type(v) for k, v in tree.items()}

    assert types(got) == types(want)
    assert C.load_config(path).to_dict() == JC.load_config(path).to_dict()


SUBSET = """\
# a comment line
top: 1   # trailing comment
quoted: 'it''s # not a comment'
dq: "tab\\tand \\"quotes\\""
nested:
  deeper:
    leaf: -0.5e+3
    empty:
  other: yes
  hexa: 0x1F
  octal: 017
  binary: 0b101
  under: 1_000
  flt: 3.
  inf: -.inf
  tilde: ~
  off: Off
back: text with spaces
"""


def test_reader_subset_features_equal_yaml():
    assert C.parse_yaml(SUBSET) == yaml.safe_load(SUBSET)
    assert C.parse_yaml("") == {} and C.parse_yaml("# only\n\n") == {}


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n", "a: [1, 2]\n", "a: {b: 1}\n", "a: &x 1\nb: *x\n", "a: !!str 1\n",
    "a: |\n  text\n", "a: >\n  folded\n", "---\na: 1\n", "a: 1\n  b: 2\n", "a: 1\na: 2\n",
    "a: 'open\n", "just text\n", "a: 1:30\n", "a: 2020-01-01\n", "a: b: c\n",
    "a:\n\tb: 1\n",
], ids=["sequence", "flow_seq", "flow_map", "anchor", "tag", "literal", "folded", "document",
        "bad_indent", "duplicate", "unterminated", "not_a_map", "sexagesimal", "timestamp",
        "nested_colon", "tab"])
def test_reader_refuses_what_is_outside_the_subset_with_the_line(text):
    with pytest.raises(ValueError, match="line"):
        C.parse_yaml(text)


OVERRIDES = ["lr=0.4", "epoch=5", "model.type=resnet50", "optimizer.nesterov=False",
             "optimizer.ema=0", "aug=default", "lr_schedule.warmup.epoch=-1", "x=1e-3",
             "y=1.0e-3", "z=yes", "w=~", "v='quoted'", "u=0x10", "t=", "s=+.5", "r=NaN"]


@pytest.mark.parametrize("pair", OVERRIDES)
def test_overrides_equal_jax(pair):
    got = C.parse_overrides([pair])
    want = JC.parse_overrides([pair])
    assert list(got) == list(want)
    (k, g), (_, w) = next(iter(got.items())), next(iter(want.items()))
    assert type(g) is type(w) and (g == w or (g != g and w != w)), (pair, g, w)


def test_overrides_apply_and_config_semantics():
    path = os.path.join(REPO, "confs", "wresnet40x2_cifar.yaml")
    ov = ["dataset=synthetic_shapes", "epoch=2", "optimizer.decay=0.0005", "new.key=3"]
    got, want = C.load_config(path, overrides=ov), JC.load_config(path, overrides=ov)
    assert got.to_dict() == want.to_dict()
    assert got.get("optimizer.decay") == 0.0005 and got.get("missing.key", 7) == 7
    assert got.model.type == "wresnet40_2" and got["epoch"] == 2
    assert got.replace(aug="default")["aug"] == "default" and got["aug"] == "fa_reduced_cifar10"
    assert hash(got) == hash(C.Config(got.to_dict())) and got == C.Config(got.to_dict())
    with pytest.raises(TypeError):
        got.lr = 1.0
    with pytest.raises(ValueError):
        C.parse_overrides(["no_equals"])
