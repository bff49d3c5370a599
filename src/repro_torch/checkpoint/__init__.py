"""Checkpointing: atomic per-step directories, keep-K rotation, async save,
in the JAX package's on-disk layout."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            latest_step, load_checkpoint,
                                            save_checkpoint)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "save_checkpoint"]
