"""qwen1.5-32b — dense decoder with QKV bias [hf:Qwen/Qwen1.5-0.5B family].

64L, d_model=5120, 40 heads (head_dim 128), kv=40 (MHA), d_ff=27392,
vocab=152064, attention QKV projections carry biases.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    source="[hf:Qwen/Qwen1.5-0.5B]",
)
