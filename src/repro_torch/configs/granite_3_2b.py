"""granite-3-2b — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model=2048, 32 q heads (head_dim 64), 8 kv heads, d_ff=8192 (swiglu),
vocab=49155.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    arch_type="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    source="[hf:ibm-granite/granite-3.0-2b-base]",
)
