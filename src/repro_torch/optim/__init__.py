"""AdamW and the LR schedules (``repro.optim``).  The int8 gradient
compression of the inter-pod all-reduce (``repro.optim.compression``)
is ROADMAP queue A 7 of the port."""
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_warmup)
