"""AdamW, the LR schedules and the int8 error-feedback gradient
compression (``repro.optim``; ``compression`` is imported on its
own)."""
from repro_torch.optim.adamw import (OptConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_warmup)
