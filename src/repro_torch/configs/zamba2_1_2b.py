"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242].

38 Mamba2 blocks (d_model=2048, ssm_state=64) with ONE shared
attention+MLP block (32 q heads / 32 kv heads, head_dim 64, d_ff=8192)
applied every 6 mamba blocks; its parameters are shared across all
applications (the Zamba trick).  vocab=32000.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    source="[arXiv:2411.15242]",
)
