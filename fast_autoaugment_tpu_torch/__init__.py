"""fast-autoaugment-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference ``fast_autoaugment_tpu``; it
imports ``torch`` and nothing of JAX or of the reference package.  Layers
of the slices ported so far (serving, TTA policy scoring, training):

- ``ops``      counter-based random draws, the 19 augmentation ops and the
               CIFAR and ImageNet train stacks in plain PyTorch with their
               hand-written CUDA kernels (``csrc/``), LR schedules and the
               optimizer chain
- ``models``   WideResNet and ResNet, true float32, ``channels_last``
- ``train``    the train and eval steps and ``train_and_eval``
- ``search``   the TTA policy-scoring step
- ``data``     in-memory datasets, splits and batching
- ``policies`` found-policy archives (data) + codec
- ``serve``    policy applier, batch-coalescing server, HTTP CLI
- ``core``, ``utils``  clocks, metrics, device selection, logging, weight
               conversion from the JAX package

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` / ``--device cpu`` (the CPU path exists for tests).
"""

__version__ = "0.1.0"
