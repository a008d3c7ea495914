"""Policy serving on the GPU: a policy applier that replays one CUDA graph
per padded batch shape, a batch-coalescing overload-safe server with
tenancy and hot reload, the HTTP CLI
(``python -m fast_autoaugment_tpu_torch.serve.serve_cli``), and in front of
its replicas the router (``serve.router_cli``) and the autoscaler
(``serve.autoscaler``).

The names below are ``serve/policy_server.py``'s, imported at their first
use: the router, the autoscaler and the wire client never touch the
device, and start without importing torch."""

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


def __getattr__(name: str):
    if name in __all__:
        from fast_autoaugment_tpu_torch.serve import policy_server

        return getattr(policy_server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
