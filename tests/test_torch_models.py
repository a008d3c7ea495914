"""The port's WideResNet, its registry and the JAX -> port weight converter,
against the JAX package, on the CPU.

Oracles and bounds:

- logits of the JAX ``WideResNet`` (``wresnet10_1`` and a narrow
  ``wresnet16_2``) with random weights and BatchNorm statistics, run by the
  port through ``utils.interop.flax_to_state_dict``: |diff| <= 1e-5 +
  1e-5 * |logit| (float32 convolutions summed in another order by XLA and
  by PyTorch's CPU kernels; measured max |diff| 7.5e-8 on logits of
  magnitude 0.3);
- the round trip port ``state_dict`` -> the JAX package's
  ``import_state_dict(sd, "wideresnet")`` -> the same flax tree: exact;
- ``get_model("wresnet40_2")``'s parameter names and shapes against the
  JAX model's, from ``jax.eval_shape`` (no full-size forward on the CPU):
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.models import input_image_size as jax_input_image_size
from fast_autoaugment_tpu.models import num_class as jax_num_class
from fast_autoaugment_tpu.models.wideresnet import WideResNet as JaxWideResNet
from fast_autoaugment_tpu.utils.interop import import_state_dict
from fast_autoaugment_tpu_torch.models import get_model, input_image_size, num_class
from fast_autoaugment_tpu_torch.models.layers import BatchNorm, torch_default_init_
from fast_autoaugment_tpu_torch.models.wideresnet import WideResNet
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict

ATOL = RTOL = 1e-5


def _numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _random_variables(model, seed, size=32):
    """JAX init, then BatchNorm scales, biases and statistics made random
    (at init they are 1, 0, 0, 1, which would hide a mapping error)."""
    variables = _numpy_tree(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                                jnp.zeros((1, size, size, 3))))
    g = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "BatchNorm_0" not in name:
            return leaf
        if "'var'" in name:
            return g.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if "'scale'" in name:
            return g.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return g.normal(0, 0.2, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _port_model(depth, widen, variables, num_classes=10):
    model = WideResNet(depth, widen, num_classes)
    model.load_state_dict(flax_to_state_dict(variables))
    return model.eval().to(memory_format=torch.channels_last)


@pytest.mark.parametrize("depth,widen,size", [(10, 1, 32), (16, 2, 32), (10, 1, 17)])
def test_logits_match_jax_through_converter(depth, widen, size):
    jmodel = JaxWideResNet(depth=depth, widen_factor=widen, num_classes=10)
    variables = _random_variables(jmodel, depth + widen, size)
    x = np.random.default_rng(size).normal(0, 1, (4, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    port = _port_model(depth, widen, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_converter_round_trip_is_exact():
    jmodel = JaxWideResNet(depth=16, widen_factor=2, num_classes=10)
    variables = _random_variables(jmodel, 5)
    port = _port_model(16, 2, variables)
    back = import_state_dict(port.state_dict(), "wideresnet")
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(np.asarray(flat_got[path]), leaf), jax.tree_util.keystr(path)


def test_wresnet40_2_has_the_jax_parameter_shapes():
    jmodel = JaxWideResNet(depth=40, widen_factor=2, num_classes=10)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(zeros).items()}
    model = get_model({"type": "wresnet40_2"}, 10, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert 2_200_000 < n_params < 2_300_000  # WRN-40-2: 2.2M parameters


def test_get_model_layout_init_and_precision():
    a = get_model({"type": "wresnet10_1"}, 10, device="cpu", seed=3)
    b = get_model({"type": "wresnet10_1", "precision": "f32"}, 10, device="cpu", seed=3)
    c = get_model({"type": "wresnet10_1"}, 10, device="cpu", seed=4)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.conv1.weight, c.conv1.weight)
    assert a.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    # PyTorch's default init: U(+-1/sqrt(fan_in)) for weights and biases
    bound = 1 / np.sqrt(a.layer2[0].conv1.weight[0].numel())
    for p in (a.layer2[0].conv1.weight, a.layer2[0].conv1.bias):
        m = float(p.detach().abs().max())
        assert 0.9 * bound < m <= bound
    assert float(a.bn1.weight.min()) == 1.0 and float(a.bn1.running_var.min()) == 1.0


def test_get_model_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9b"):
        get_model({"type": "shakeshake26_2x32d", "precision": "bf16"}, 10, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model({"type": "wresnet40_2", "precision": "bf16"}, 10, device="cpu")
    with pytest.raises(ValueError, match="unknown model type"):
        get_model({"type": "densenet121"}, 10, device="cpu")
    with pytest.raises(ValueError):
        get_model({"type": "wresnet40_2", "precision": "f16"}, 10, device="cpu")
    with pytest.raises(ValueError):
        get_model({"type": "wresnet11_2"}, 10, device="cpu")  # depth must be 6n+4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model({"type": "wresnet10_1"}, 10)  # CUDA is the default


@pytest.mark.parametrize("dataset", ["cifar10", "reduced_cifar10", "cifar100", "svhn",
                                     "reduced_svhn", "imagenet", "reduced_imagenet",
                                     "synthetic", "synthetic100", "synthetic_shapes_n200"])
def test_num_class_and_image_size_match_jax(dataset):
    assert num_class(dataset) == jax_num_class(dataset)
    for model_type in ("wresnet40_2", "resnet50"):
        assert input_image_size(dataset, model_type) == jax_input_image_size(dataset, model_type)


def test_batchnorm_keeps_float32_statistics():
    bn = BatchNorm(4, momentum=0.9).eval()
    bn.running_mean.fill_(0.5)
    x = torch.randn(2, 4, 3, 3, dtype=torch.float64)
    out = bn(x)
    assert out.dtype == torch.float64 and bn.running_mean.dtype == torch.float32
    assert bn.momentum == 0.9 and bn.eps == 1e-5
    torch_default_init_(bn)
    assert float(bn.running_mean.abs().max()) == 0.0
