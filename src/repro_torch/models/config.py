"""Architecture configuration for the model zoo.

A copy of the reference's ``repro.models.config``, field for field, so a
configuration means the same model in both packages.  One ``ArchConfig``
instance per architecture lives in ``repro_torch/configs/<id>.py``;
reduced smoke variants derive from the same dataclass via ``reduced()``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.utils.padding import pad_to_multiple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attn-free SSM)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    source: str = ""                # citation ([arXiv:...] / [hf:...])

    # attention details
    window: int | None = None       # sliding-window attention
    ring_kv_cache: bool = False     # SWA decode: cache only the last `window`
                                    # positions (ring buffer) — beyond-paper
    qkv_bias: bool = False          # qwen1.5
    nonparametric_ln: bool = False  # olmo
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 2
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0              # N
    ssm_head_dim: int = 64          # P
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssd_chunk: int = 64             # SSD chunk length (XLA path)
    ssd_compute_dtype: str = "float32"  # intra-chunk tensor dtype (§Perf: bfloat16)

    # hybrid (zamba2): one *shared* attention block applied after every
    # ``attn_every`` mamba blocks
    attn_every: int = 0

    # VLM (llama-3.2-vision): a cross-attention layer every ``cross_attn_every``
    # layers; vision frontend is a stub providing ``num_vision_tokens``
    # pre-projected patch embeddings
    cross_attn_every: int = 0
    num_vision_tokens: int = 0

    # audio (seamless): encoder-decoder; ``num_layers`` applies to each side;
    # frontend stub provides pre-computed audio frame embeddings
    encdec: bool = False
    ffn_type: str = "swiglu"        # swiglu | gelu

    # numerics / distribution
    dtype: str = "bfloat16"
    # physical padding for the fixed model axis (set by the launcher;
    # 0 = no padding).  Logical config stays exact.
    pad_heads_to: int = 0
    pad_kv_heads_to: int = 0
    pad_vocab_to_multiple: int = 256

    # ------------------------------------------------------------------ api
    @property
    def d_inner(self) -> int:       # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def physical_heads(self) -> int:
        if self.pad_heads_to:
            return pad_to_multiple(self.num_heads, self.pad_heads_to)
        return self.num_heads

    @property
    def physical_kv_heads(self) -> int:
        if self.pad_kv_heads_to:
            # GQA kv replication: pad kv heads up to the model-axis size by
            # physically repeating groups (vLLM/MaxText practice)
            if self.num_kv_heads < self.pad_kv_heads_to:
                return self.pad_kv_heads_to
            return pad_to_multiple(self.num_kv_heads, self.pad_kv_heads_to)
        return self.num_kv_heads

    @property
    def physical_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.pad_vocab_to_multiple)

    def with_padding(self, model_axis: int) -> "ArchConfig":
        """Return a copy physically padded for an N-way tensor-parallel axis."""
        return replace(
            self,
            pad_heads_to=model_axis if self.num_heads else 0,
            pad_kv_heads_to=model_axis if self.num_kv_heads else 0,
            pad_vocab_to_multiple=max(self.pad_vocab_to_multiple, model_axis),
        )

    def unit_dims(self) -> list[tuple[str, int]]:
        """Layer-group unit dimensions for dry-run cost extrapolation.

        Returns [(unit_name, real_count)] such that total cost is affine in
        each count; ``with_unit_counts`` builds the small variants."""
        if self.arch_type == "hybrid":
            n_super, tail = divmod(self.num_layers, self.attn_every)
            dims = [("super", n_super)]
            if tail:
                dims.append(("tail", tail))
            return dims
        if self.arch_type == "vlm":
            return [("super", self.num_layers // self.cross_attn_every)]
        return [("layers", self.num_layers)]

    def with_unit_counts(self, counts: dict) -> "ArchConfig":
        if self.arch_type == "hybrid":
            n_super, tail = divmod(self.num_layers, self.attn_every)
            c_super = counts.get("super", n_super)
            c_tail = counts.get("tail", tail)
            return replace(self, num_layers=self.attn_every * c_super + c_tail)
        if self.arch_type == "vlm":
            c = counts.get("super", self.num_layers // self.cross_attn_every)
            return replace(self, num_layers=self.cross_attn_every * c)
        return replace(self, num_layers=counts.get("layers", self.num_layers))

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers (or superblocks), small dims."""
        return replace(
            self,
            num_layers=min(self.num_layers, 2 * max(self.attn_every, 1)
                           if self.attn_every else
                           (2 * max(self.cross_attn_every, 1) if self.cross_attn_every else 2)),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            head_dim=64,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            moe_capacity_factor=8.0,   # no drops at smoke-test scale

            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            window=min(self.window, 64) if self.window else None,
            num_vision_tokens=min(self.num_vision_tokens, 16)
            if self.num_vision_tokens
            else 0,
            dtype="float32",
            pad_heads_to=0,
            pad_kv_heads_to=0,
            pad_vocab_to_multiple=8,
        )


# the four assigned input shapes ---------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
