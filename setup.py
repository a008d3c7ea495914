from setuptools import find_packages, setup

setup(
    name="fast-autoaugment-tpu",
    version="0.1.0",
    description="TPU-native Fast AutoAugment: policy search by density matching in JAX/Flax",
    packages=find_packages(include=["fast_autoaugment_tpu*"]),
    package_data={"fast_autoaugment_tpu.policies": ["data/*.json"],
                  "fast_autoaugment_tpu_torch": ["csrc/*.cu"],
                  "fast_autoaugment_tpu_torch.policies": ["data/*.json"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "pyyaml", "msgpack"],
    entry_points={
        "console_scripts": [
            "faa-train=fast_autoaugment_tpu.launch.train_cli:main",
            "faa-search=fast_autoaugment_tpu.launch.search_cli:main",
            "faa-fleet=fast_autoaugment_tpu.launch.fleet:main",
        ]
    },
)
