"""Continuous-batching MoR serving: scheduler, admission and preemption
policies, the slotted and paged kv pools, self-speculative decoding,
open-loop load generation, telemetry and the engine."""
from repro_torch.serving.engine import Engine, Request, RequestRejected
from repro_torch.serving.policy import (FCFSPolicy, Policy, PriorityPolicy,
                                        ShortestPrefillPolicy, get_policy)
from repro_torch.serving.telemetry import ServingTelemetry, calibrate_capacity

__all__ = ["Engine", "Request", "RequestRejected", "Policy", "FCFSPolicy",
           "PriorityPolicy", "ShortestPrefillPolicy", "get_policy",
           "ServingTelemetry", "calibrate_capacity"]
