"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

56L, d_model=6144, 48 q heads (head_dim 128), 8 kv heads, expert d_ff=16384,
8 experts top-2, vocab=32768, window=4096 (per assignment).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    window=4096,
    source="[arXiv:2401.04088]",
)
