from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.metrics import average_precision, binary_metrics, roc_auc
from repro_torch.train.optim import OptState, adamw, clip_by_global_norm, cosine_schedule

__all__ = [
    "roc_auc",
    "average_precision",
    "binary_metrics",
    "adamw",
    "cosine_schedule",
    "clip_by_global_norm",
    "OptState",
    "save_checkpoint",
    "load_checkpoint",
]
