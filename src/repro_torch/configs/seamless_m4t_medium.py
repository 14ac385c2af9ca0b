"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596].

12L per side, d_model=1024, 16 heads (head_dim 64, MHA), d_ff=4096 (gelu),
vocab=256206 (text).  The mel-spectrogram + conformer audio frontend is a
stub: ``input_specs`` provides precomputed frame embeddings.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    encdec=True,
    ffn_type="gelu",
    source="[arXiv:2308.11596]",
)
