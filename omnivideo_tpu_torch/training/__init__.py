from .checkpoint import CheckpointManager
from .dataset import (
    OmniVideoDataset,
    PadSpec,
    PrefetchLoader,
    collate,
    data_loader,
    make_dummy_dataset,
)
from .trainer import (
    AdamW,
    TrainConfig,
    TrainState,
    UnifiedParams,
    init_train_state,
    init_unified_params,
    make_optimizer,
    make_train_step,
    make_unified_loss,
    make_unified_train_step,
)

__all__ = [
    "AdamW",
    "TrainConfig",
    "TrainState",
    "UnifiedParams",
    "make_optimizer",
    "make_train_step",
    "make_unified_loss",
    "make_unified_train_step",
    "init_train_state",
    "init_unified_params",
    "CheckpointManager",
    "OmniVideoDataset",
    "PadSpec",
    "collate",
    "data_loader",
    "PrefetchLoader",
    "make_dummy_dataset",
]
