from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.serialization import (  # noqa: F401
    load_pytree, save_pytree)
