"""llama-3.2-vision-90b — VLM with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment].

100L total (80 self + 20 cross-attn in 5-layer superblocks), d_model=8192,
64 q heads (head_dim 128), 8 kv heads, d_ff=28672, vocab=128256.
The ViT/projector frontend is a stub: ``input_specs`` provides pre-projected
patch embeddings (num_vision_tokens x d_model).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_vision_tokens=1601,   # 1 tile x (40x40 patches + 1 cls), mllama
    rope_theta=500_000.0,
    source="[hf:meta-llama/Llama-3.2-11B-Vision]",
)
