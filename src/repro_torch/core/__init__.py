"""The MoR core: predictor, calibration, clustering, tile policy,
execution plans, the ``masked_ffn`` entry points and the offline
deployment stage.  The names ``repro.core`` exports, where the port has
them (not its numpy ``pairwise_cosines``)."""
from repro_torch.core.predictor import (  # noqa: F401
    MoRLayer, binarize, binary_preact, hybrid_predict, make_identity_layer,
    predictor_eval_count, reset_predictor_eval_count,
)
from repro_torch.core.executor import MoRExecutionPlan, as_plan  # noqa: F401
from repro_torch.core.calibration import (  # noqa: F401
    CalibAccumulator, init_accumulator, update_accumulator,
    finalize_regression,
)
from repro_torch.core.clustering import (  # noqa: F401
    closest_neighbor_graph, greedy_proxy_clustering, cluster_layer,
)
from repro_torch.core.policy import (  # noqa: F401
    build_mor_layer, tile_mask_from_neuron_mask,
)
from repro_torch.core.masked_ffn import (  # noqa: F401
    mor_ffn_apply, mor_relu_matmul,
)
