from repro_torch.baselines.gbdt import GBDTConfig, GBDTModel, train_gbdt
from repro_torch.baselines.mlp import MLPConfig, mlp_forward, mlp_init, train_mlp

__all__ = [
    "GBDTConfig",
    "GBDTModel",
    "train_gbdt",
    "MLPConfig",
    "mlp_init",
    "mlp_forward",
    "train_mlp",
]
