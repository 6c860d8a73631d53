"""The multi-rank pieces (``repro.distributed``): the sharding rules
and their realisation on a mesh of processes (``sharding_rules``), the
collectives of tensor parallelism, FSDP and the page-sharded serving
layout (``collectives``), the distributed flash decode over a
page-sharded pool (``decode_attention``), and the training loop's
straggler monitor and elastic re-mesh plan (``fault_tolerance``)."""

from repro_torch.distributed.sharding_rules import PAGE_AXIS  # noqa: F401
