"""The paper's own model: LNN on DDS graphs (fraud detection).

Not part of the transformer zoo; exposes the LNNConfig used by the paper
reproduction benchmarks and examples, plus the canonical ``ServiceConfig``
serving artifacts built on it (``repro_torch.service``).  Copied value for
value from the reference's ``configs/lnn_fraud.py``.
"""
from repro_torch.core.lnn import LNNConfig
from repro_torch.service import ModelSection, ServiceConfig

CONFIG = LNNConfig(
    gnn_type="gcn",
    num_gnn_layers=3,
    hidden_dim=64,
    mlp_dims=(64, 32),
    feat_dim=48,          # 12 raw + 36 GBDT-encoded (paper §4.2 encoding)
    pos_weight=3.0,
)

# the one serving artifact benches/examples derive from (`.replace(...)`
# for local overrides): same model, streaming Lambda loop, exact refresh
SERVICE = ServiceConfig(
    mode="streaming",
    model=ModelSection.from_lnn_config(CONFIG),
)

# offline batch/speed split over a static store
SERVICE_BATCH = SERVICE.replace(mode="batch")
