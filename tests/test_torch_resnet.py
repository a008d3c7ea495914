"""The port's ResNet, its registry entry, the ResNet weight converter and the
train-mode BatchNorm, against the JAX package, on the CPU.

Oracles and bounds:

- logits of the JAX ``ResNet`` with random weights and BatchNorm
  statistics, run by the port through ``utils.interop.flax_to_state_dict``
  (family ``resnet``): the ImageNet stem at 64x64 for depths 18 and 50 and
  the CIFAR bottleneck ResNet-11 at 32x32, batch 2, eval mode:
  |diff| <= 1e-4 + 1e-4 * |logit| (float32 convolutions summed in another
  order by XLA and by PyTorch's CPU kernels, through 18 to 50 layers);
- one train-mode forward of the JAX ResNet-18 and the port's from the same
  weights: logits and every updated running mean and variance within
  1e-4 + 1e-4 * |value| (the batch statistics are summed in another order;
  flax computes the variance as ``E[x^2] - E[x]^2``, torch with Welford);
- the round trip port ``state_dict`` -> the JAX package's
  ``import_state_dict(sd, "resnet")`` -> the same flax tree: exact;
- ``get_model("resnet50")``'s parameter names and shapes at 224 against the
  JAX model's, from ``jax.eval_shape``: exact;
- the BatchNorm repair: one train-mode forward of the JAX package's
  ``BatchNorm`` and the port's on 36 samples per channel, from running
  statistics (0, 1): both running buffers within 1e-6 + 1e-6 * |value| (a
  float32 sum of 36 values in another order).  The running variance is
  ``0.9 * 1 + 0.1 * var(ddof=0)``, flax's rule; ``nn.BatchNorm2d`` would
  store ``var(ddof=1)`` and miss the bound by 3%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_autoaugment_tpu.models import get_model as jax_get_model
from fast_autoaugment_tpu.models.layers import BatchNorm as JaxBatchNorm
from fast_autoaugment_tpu.models.resnet import ResNet as JaxResNet
from fast_autoaugment_tpu.utils.interop import import_state_dict
from fast_autoaugment_tpu_torch.models import get_model
from fast_autoaugment_tpu_torch.models.layers import BatchNorm
from fast_autoaugment_tpu_torch.models.resnet import ResNet
from fast_autoaugment_tpu_torch.utils.interop import flax_to_state_dict
from test_torch_models import _random_variables

TOL = 1e-4


def _port(dataset, depth, variables, num_classes=10, bottleneck=False):
    model = ResNet(dataset, depth, num_classes, bottleneck=bottleneck)
    model.load_state_dict(flax_to_state_dict(variables, "resnet"))
    return model.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("dataset,depth,size,bottleneck", [
    ("imagenet", 18, 64, False), ("imagenet", 50, 64, False), ("cifar", 11, 32, True)])
def test_logits_match_jax_through_converter(dataset, depth, size, bottleneck):
    jmodel = JaxResNet(dataset=dataset, depth=depth, num_classes=10, bottleneck=bottleneck)
    variables = _random_variables(jmodel, depth, size)
    x = np.random.default_rng(size + depth).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    port = _port(dataset, depth, variables, bottleneck=bottleneck).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_train_mode_forward_and_running_statistics_match_jax():
    jmodel = JaxResNet(dataset="imagenet", depth=18, num_classes=10)
    variables = _random_variables(jmodel, 3, 32)
    x = np.random.default_rng(9).normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    want, mutated = jax.jit(lambda v, a: jmodel.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    port = _port("imagenet", 18, variables).train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    stats = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])},
                               "resnet")
    sd = port.state_dict()
    compared = 0
    for k, v in stats.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=TOL, atol=TOL, err_msg=k)
            compared += 1
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k
    assert compared == 2 * 20  # 20 BatchNorms in ResNet-18


def test_converter_round_trip_is_exact():
    jmodel = JaxResNet(dataset="imagenet", depth=18, num_classes=10)
    variables = _random_variables(jmodel, 5)
    back = import_state_dict(_port("imagenet", 18, variables).state_dict(), "resnet")
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        assert np.array_equal(np.asarray(flat_got[path]), leaf), jax.tree_util.keystr(path)


def test_resnet50_has_the_jax_parameter_shapes_at_224():
    jmodel = jax_get_model({"type": "resnet50"}, 1000)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(zeros, "resnet").items()}
    model = get_model({"type": "resnet50"}, 1000, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert 25_500_000 < n_params < 25_600_000  # ResNet-50: 25.6M parameters
    # He-normal fan-out convolutions, unit BatchNorm
    w = model.layer3[0].conv2.weight.detach()
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 256))) < 0.05 * np.sqrt(2.0 / (9 * 256))
    assert float(model.layer3[0].bn2.weight.min()) == 1.0
    assert w.is_contiguous(memory_format=torch.channels_last)


def test_get_model_resnet_variants():
    cifar = get_model({"type": "resnet20", "dataset": "cifar10"}, 10, device="cpu")
    assert cifar.maxpool is None and len(cifar.layer3) == 3 and cifar.fc.in_features == 64
    bott = get_model({"type": "resnet29", "dataset": "cifar100", "bottleneck": True}, 100,
                     device="cpu")
    assert bott.fc.in_features == 256 and bott.fc.out_features == 100
    r18 = get_model({"type": "resnet18", "dataset": "imagenet"}, 1000, device="cpu", seed=1)
    assert r18.maxpool is not None and len(r18.layer4) == 2
    again = get_model({"type": "resnet18", "dataset": "imagenet"}, 1000, device="cpu", seed=1)
    assert all(torch.equal(a, b) for a, b in zip(r18.state_dict().values(),
                                                 again.state_dict().values()))
    # resnet50 is the ImageNet model on any dataset, as in the JAX package
    assert get_model({"type": "resnet50", "dataset": "cifar10"}, 10, device="cpu").maxpool \
        is not None
    with pytest.raises(ValueError):
        get_model({"type": "resnet21", "dataset": "cifar10"}, 10, device="cpu")
    with pytest.raises(ValueError):
        get_model({"type": "resnet19", "dataset": "imagenet"}, 10, device="cpu")


def test_batchnorm_running_statistics_are_flax_biased():
    """The repair: the port's train-mode BatchNorm updates running_var with
    the biased batch variance, as flax does (fails with nn.BatchNorm2d's
    unbiased update)."""
    x = np.random.default_rng(0).normal(0.3, 1.2, (4, 3, 3, 2)).astype(np.float32)  # NHWC
    jbn = JaxBatchNorm(momentum=0.1)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)  # scale 1, bias 0
    y_want, mutated = jbn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    stats = mutated["batch_stats"]["BatchNorm_0"]
    bn = BatchNorm(2, momentum=0.1).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-6, atol=1e-6)
    var = x.reshape(-1, 2).var(axis=0)  # ddof=0
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var, rtol=1e-6)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y_want),
                               rtol=1e-5, atol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def test_wideresnet_batchnorm_in_train_mode():
    """``get_model``'s WRN in train mode: torch momentum 0.9 (the weight of
    the new batch statistic, reference ``wideresnet.py:24``) and one count
    in ``num_batches_tracked`` per forward."""
    model = get_model({"type": "wresnet10_1"}, 10, device="cpu").train()
    x = torch.randn(4, 3, 8, 8)
    model(x)
    model(x)
    bn = model.layer1[0].bn1
    assert bn.momentum == 0.9 and int(bn.num_batches_tracked) == 2
    var, mean = torch.var_mean(model.conv1(x).detach(), dim=(0, 2, 3), unbiased=False)
    # after two identical batches: 0.1 * (0.1 * 0 + 0.9 m) + 0.9 m
    torch.testing.assert_close(bn.running_mean, 0.1 * 0.9 * mean + 0.9 * mean)
    torch.testing.assert_close(bn.running_var, 0.1 * (0.1 + 0.9 * var) + 0.9 * var)
