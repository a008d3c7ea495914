"""Policy serving on the GPU: a policy applier that replays one CUDA graph
per padded batch shape, a batch-coalescing overload-safe server with
tenancy and hot reload, the HTTP CLI
(``python -m fast_autoaugment_tpu_torch.serve.serve_cli``), and in front of
its replicas the router (``serve.router_cli``) and the autoscaler
(``serve.autoscaler``)."""

from fast_autoaugment_tpu_torch.serve.policy_server import (
    DeadlineExpiredError,
    PolicyApplier,
    PolicyServer,
    ServeError,
    ServerOverloadedError,
    ServerStoppedError,
    TenantNotResidentError,
    TenantPool,
)

__all__ = [
    "DeadlineExpiredError",
    "PolicyApplier",
    "PolicyServer",
    "ServeError",
    "ServerOverloadedError",
    "ServerStoppedError",
    "TenantNotResidentError",
    "TenantPool",
]
