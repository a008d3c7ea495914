"""fast-autoaugment-tpu, ported to PyTorch and CUDA for NVIDIA Hopper.

A second package beside the JAX reference ``fast_autoaugment_tpu``; it
imports ``torch`` and nothing of JAX or of the reference package.  Layers
of the slice ported so far (the policy-serving path):

- ``ops``      counter-based random draws, the 19 augmentation ops in
               plain PyTorch, and the hand-written CUDA kernel that
               applies a policy (``csrc/augment.cu``)
- ``policies`` found-policy archives (data) + codec
- ``serve``    policy applier, batch-coalescing server, HTTP CLI
- ``core``, ``utils``  clocks and logging

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` / ``--device cpu`` (the CPU path exists for tests).
"""

__version__ = "0.1.0"
