"""The benchmark's roofline and FLOP counts: the kernels' bounds at the
shapes of the port's kernel table (B=4, S=512; 32/32 heads and 32/8 heads
at Dh 64) are its bound column, and the matrix-product FLOPs of one
prefill are what ``launch/roofline.py`` counts on meta tensors."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import modelflops
from perfbench.harness import load_config, load_module

#: (kernel, query heads, kv heads) -> bound in µs at B=4, S=512, Dh 64, bf16
KERNEL_TABLE = {
    ("flash_attention", 32, 32): 10.02,
    ("flash_attention", 32, 8): 6.26,
    ("flash_attention_bwd", 32, 32): 20.11,
    ("flash_attention_bwd", 32, 8): 12.60,
}


@pytest.mark.parametrize("kernel,hq,hkv", sorted(KERNEL_TABLE))
def test_bound_matches_kernel_table(kernel, hq, hkv):
    c = {"dtype": "bfloat16", "num_heads": hq, "num_kv_heads": hkv, "head_dim": 64}
    seconds, by = load_module("rooflines", kernel).bound_s(c, 4, 512)
    assert by == "bytes"
    assert round(seconds * 1e6, 2) == pytest.approx(KERNEL_TABLE[kernel, hq, hkv], abs=0.011)


def test_prefill_matmul_flops_match_meta_count():
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import StepCounter
    from repro_torch.models import init_params, prefill

    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2)
    c = dataclasses.asdict(cfg)
    params = init_params(torch.Generator(), cfg, device="meta")
    tokens = torch.empty((2, 256), dtype=torch.long, device="meta")
    with torch.no_grad(), StepCounter() as counter:
        prefill(params, cfg, tokens, 256)
    want = modelflops.matmul_flops(c, 2, 256, cfg.physical_vocab, block_k=256)
    assert counter.flops == want


def test_model_flops_of_the_cells():
    g = load_config("granite-3-2b")
    assert modelflops.body_params(g) == 40 * 60_817_408
    # the head once per sequence in prefill: a tenth of a percent of the work
    assert modelflops.prefill_flops(g, 4, 2048) == 4 * (
        2 * 2_432_696_320 * 2048 + 4 * 32 * 64 * 2048 * 2049 // 2 * 40 + 2 * 2048 * 49155)
    assert modelflops.train_flops(g, 4, 512) > 3 * modelflops.prefill_flops(g, 4, 512)
