from repro_torch.checkpoint.io import (CheckpointError, load_checkpoint,
                                       load_registry, save_checkpoint,
                                       save_registry)
from repro_torch.checkpoint.state import (CheckpointManager,
                                          latest_checkpoint,
                                          restore_server_state,
                                          save_server_state,
                                          verify_checkpoint)

__all__ = [
    "CheckpointError", "CheckpointManager", "latest_checkpoint",
    "load_checkpoint", "load_registry", "restore_server_state",
    "save_checkpoint", "save_registry", "save_server_state",
    "verify_checkpoint",
]
