"""granite-4.0-h-small — hybrid Mamba2 / NoPE GQA decoder with a sparse MoE
in every layer [hf:ibm-granite/granite-4.0-h-small].

40 layers at d_model=4096 in the published ``layer_types`` order: 36 Mamba2
mixers (128 heads x 64, ssm_state 128, one group, conv 4 with bias, expand
2, gated RMSNorm) and 4 GQA attention mixers (32 q / 8 kv heads at
head_dim 128, no positional embedding, softmax scale
``attention_multiplier``) at indices 5, 15, 25 and 35.  Every layer's
mixer is followed by a dropless 72-expert top-10 MoE (expert width 768,
SiLU-gated) plus a shared expert of width 1,536.  The embedding is scaled
by 12, each block's output by 0.22 before the residual add, the logits
divided by 16; the head is tied to the embedding; RMSNorm eps 1e-5;
vocab=100352.

The port's registry lists it beside the reference's ten ids
(``configs.PORT_ONLY``): the JAX package has no such model.  Its fields
beyond ``ArchConfig``'s live on :class:`GraniteHybridConfig`, which
extends it, so the reference's configurations keep their fields.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.models.config import ArchConfig

#: the published ``layer_types``: M a Mamba2 mixer, A an attention mixer
PATTERN = "MMMMMAMMMMMMMMMAMMMMMMMMMAMMMMMMMMMAMMMM"


@dataclass(frozen=True)
class GraniteHybridConfig(ArchConfig):
    """A granitemoehybrid model: ``layer_pattern`` gives each layer's mixer
    (``M`` Mamba2, ``A`` attention), in order; every layer then runs the
    routed MoE (``num_experts``, ``experts_per_token``, width ``d_ff``) and
    the shared expert (width ``shared_d_ff``).  The port runs the head tied
    to the embedding only (``tie_word_embeddings``, as published)."""
    layer_pattern: str = ""
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0   # the softmax scale
    logits_scaling: float = 1.0
    position_embedding_type: str = "nope"
    tie_word_embeddings: bool = True
    rms_norm_eps: float = 1e-5

    def reduced(self) -> "GraniteHybridConfig":
        """Smoke-test variant: both kinds of mixer (Mamba2, attention,
        Mamba2), 4 experts top-2 and the shared expert, small widths, the
        published scalars."""
        base = ArchConfig.reduced(self)
        return replace(base, layer_pattern="MAM", num_layers=3, experts_per_token=2,
                       shared_d_ff=min(self.shared_d_ff, 256))


CONFIG = GraniteHybridConfig(
    name="granite-4.0-h-small",
    arch_type="granite_hybrid",
    num_layers=len(PATTERN),
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    num_experts=72,
    experts_per_token=10,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    layer_pattern=PATTERN,
    shared_d_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    source="[hf:ibm-granite/granite-4.0-h-small]",
)
