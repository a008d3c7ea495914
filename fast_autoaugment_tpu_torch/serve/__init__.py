"""Policy serving on the GPU: a policy applier over padded batch shapes,
a batch-coalescing overload-safe server, and the HTTP CLI
(``python -m fast_autoaugment_tpu_torch.serve.serve_cli``)."""

from fast_autoaugment_tpu_torch.serve.policy_server import (
    DeadlineExpiredError,
    PolicyApplier,
    PolicyServer,
    ServeError,
    ServerOverloadedError,
    ServerStoppedError,
)

__all__ = [
    "DeadlineExpiredError",
    "PolicyApplier",
    "PolicyServer",
    "ServeError",
    "ServerOverloadedError",
    "ServerStoppedError",
]
