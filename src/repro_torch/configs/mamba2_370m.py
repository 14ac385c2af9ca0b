"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L, d_model=1024, d_ff=0 (the Mamba2 block subsumes the MLP), vocab=50280,
ssm_state N=128; expand=2 -> d_inner=2048, headdim P=64 -> 32 SSM heads.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    source="[arXiv:2405.21060]",
)
