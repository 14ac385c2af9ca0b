"""yi-34b — llama-architecture dense GQA [arXiv:2403.04652].

60L, d_model=7168, 56 q heads (head_dim 128), 8 kv heads, d_ff=20480,
vocab=64000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    arch_type="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    source="[arXiv:2403.04652]",
)
