"""Continuous-batching MoR serving: scheduler, policy, slotted kv pool,
telemetry and the engine."""
from repro_torch.serving.engine import Engine, Request, RequestRejected  # noqa: F401
