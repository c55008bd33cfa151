"""The training plane: the window trainer, the GNN maintenance trainer
and the checkpoint store (npz layout)."""

from sitewhere_tpu_torch.training.checkpoint import CheckpointStore
from sitewhere_tpu_torch.training.maintenance import (
    MaintenanceTrainer,
    MaintenanceTrainerConfig,
    build_maintenance_model,
)
from sitewhere_tpu_torch.training.trainer import Trainer, TrainerConfig, make_windows

__all__ = ["Trainer", "TrainerConfig", "make_windows",
           "MaintenanceTrainer", "MaintenanceTrainerConfig",
           "build_maintenance_model", "CheckpointStore"]
