"""The page-sharded serving layout's multi-rank pieces
(``repro.distributed``): the flash merge collective and the distributed
flash decode over a page-sharded pool; and the training loop's
straggler monitor (``fault_tolerance``).  The parameter and activation
sharding rules, the overlapped collectives of training and tensor
parallelism, gradient compression and the elastic re-mesh plan are
ROADMAP queue A 7 of the port."""

# The name of the axis the serving page pools shard over
# (``repro.distributed.sharding_rules.PAGE_AXIS``): physical kv and
# state pages partitioned over the ranks, block tables, parameters and
# activations replicated.
PAGE_AXIS = "pages"
