"""olmo-1b — dense decoder with non-parametric LayerNorm [arXiv:2402.00838].

16L, d_model=2048, 16 heads (head_dim 128), kv=16 (MHA), d_ff=8192,
vocab=50304.  OLMo's LN carries no learnable scale/bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    arch_type="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    nonparametric_ln=True,
    source="[arXiv:2402.00838]",
)
