from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.serialization import restore, save

__all__ = ["CheckpointManager", "save", "restore"]
