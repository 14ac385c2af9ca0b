"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32 q heads (head_dim 128), 8 kv heads, expert d_ff=6400,
16 experts top-2, vocab=32064.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    source="[hf:microsoft/Phi-3.5-MoE-instruct]",
)
