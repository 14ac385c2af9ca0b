"""granite-4.0-h-small's cell on the CPU, at the configuration's reduced
size in f32: the port against the plain reference
(``reference/granite_hybrid.py``) on seeded weights (``weights_hybrid``):
the logits, the caches a prefill leaves (Mamba2 states and attention K/V),
prefill then decode against the reference's full forward, the dropless MoE
against the uncut reference at a skewed load; the fp8 control fails the
tolerance; the configuration file resolves; a whole run reads ``correct``
and loads no JAX, each planted fault fails it, a traced run reads the
cell's span metrics; the reference imports nothing of the program; the
model FLOPs, the rooflines and the roofline metric of the grouped
products."""
from __future__ import annotations

import dataclasses
import json
import math
import time

import pytest
import torch
import torch.nn.functional as F

from perfbench import control, faults_hybrid, harness, modelflops_hybrid, spans, weights_hybrid
from perfbench.harness import Trace
from perfbench.reference import granite_hybrid as ref
from perfbench.test_perfbench_manifest import _fresh

CELL = "granite-4.0-h-small.prefill-4x2k"
#: the port in f32 against the f32 reference: one function in two orders
#: of summation (the SSD in chunks of 64 against 256, the closed-form final
#: state, blockwise attention, the grouped combine), rounding alone,
#: measured at most 1.3e-6 of the scale; 1e-4 leaves room on that side,
#: and the fp8 control departs by 1e-2 or more (test below)
TOL = 1e-4
#: the check's limits at the reduced size in f32, for the same reason
LIMITS = {"logit_gap_max": TOL, "kv_gap_max": TOL, "ssm_gap_max": TOL}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def reduced():
    from repro_torch.configs import get_config

    cfg = get_config("granite-4.0-h-small").reduced()
    return cfg, dataclasses.asdict(cfg)


def rel(got, want) -> float:
    return float((got - want).norm() / want.norm())


def tokens(cfg, b: int, s: int, seed: int):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("seed,s", [(11, 40), (12, 300)])
def test_forward_matches_reference(seed, s):
    from repro_torch.models import forward

    cfg, c = reduced()
    params = weights_hybrid.make(cfg, seed, "cpu")
    toks = tokens(cfg, 2, s, seed)
    with torch.no_grad():
        port, _, _ = forward(params, cfg, toks)
        want = ref.all_logits(params, c, toks, ref.Precision())
    assert rel(port, want) < TOL


def test_prefill_caches_match_reference():
    """The Mamba2 layers' final states and the attention layers' keys and
    values that a prefill leaves are the reference's."""
    from repro_torch.models import prefill

    cfg, c = reduced()
    params = weights_hybrid.make(cfg, 13, "cpu")
    toks = tokens(cfg, 2, 270, 13)
    pos = torch.tensor([0, 31, 200, 269])
    heads = torch.arange(cfg.ssm_heads)
    with torch.no_grad():
        _, cache = prefill(params, cfg, toks, 272)
        keep = ref.Keep(pos, heads)
        ref.last_logits(params, c, toks, ref.Precision(), keep)
    g = cache["granite_hybrid"]
    assert rel(g["mamba"]["ssm"], torch.stack(keep.ssm)) < TOL
    for name, want in (("k", keep.k), ("v", keep.v)):
        assert rel(g["attn"][name][..., pos, :], torch.stack(want)) < TOL
        assert not g["attn"][name][..., 270:, :].any()


@pytest.mark.parametrize("prompt", [1, 33])
def test_prefill_then_decode_matches_reference_forward(prompt):
    from repro_torch.models import decode_step, prefill

    cfg, c = reduced()
    params = weights_hybrid.make(cfg, 14 + prompt, "cpu")
    steps = 6
    toks = tokens(cfg, 2, prompt + steps, prompt)
    with torch.no_grad():
        want = ref.all_logits(params, c, toks, ref.Precision(), start=prompt - 1)
        logits, cache = prefill(params, cfg, toks[:, :prompt], prompt + steps)
        got = [logits]
        for t in range(prompt, prompt + steps):
            logits, cache = decode_step(params, cfg, toks[:, t], cache)
            got.append(logits)
    assert rel(torch.stack(got[:-1], 1), want[:, :steps]) < TOL
    assert rel(got[-1], want[:, -1]) < TOL


def test_dropless_moe_matches_uncut_reference():
    """At a load skewed so that the capacity path drops (one expert in every
    token's top k), the port's dropless MoE is the reference's, which
    computes every assignment."""
    from repro_torch.models.moe import moe_apply, moe_apply_dropless, moe_init

    cfg, c = reduced()
    gen = torch.Generator().manual_seed(15)
    params = moe_init(gen, cfg, device="cpu")
    u = torch.randn(cfg.d_model, generator=gen)
    x = torch.randn(80, cfg.d_model, generator=gen) + 6.0 * u
    params["router"][:, 0] = u / u.norm()
    with torch.no_grad():
        want = ref.moe(params, c, x, ref.Precision())
        got, _ = moe_apply_dropless(params, cfg, x)
        capped, _ = moe_apply(params, dataclasses.replace(cfg, moe_capacity_factor=1.25), x)
    assert rel(got, want) < TOL
    assert rel(capped, want) > 1e-2


def test_fp8_control_fails_the_tolerance():
    cfg, c = reduced()
    params = weights_hybrid.make(cfg, 16, "cpu")
    toks = tokens(cfg, 2, 64, 16)
    pos, heads = torch.tensor([5, 63]), torch.arange(cfg.ssm_heads)
    with torch.no_grad():
        keep, low = ref.Keep(pos, heads), ref.Keep(pos, heads)
        want = ref.last_logits(params, c, toks, ref.Precision(), keep)
        got = ref.last_logits(params, c, toks, ref.Precision(fp8=True), low)
    gaps = [rel(got, want), rel(torch.stack(low.k), torch.stack(keep.k)),
            rel(torch.stack(low.ssm), torch.stack(keep.ssm))]
    assert min(gaps) > 1e-2, gaps


def test_config_file_resolves_to_the_registry_entry():
    from repro_torch.configs import all_configs, get_config

    c = harness.load_config("granite-4.0-h-small")
    cfg = harness.arch_config(c)
    assert cfg == get_config(c["registry"]) and cfg.layer_pattern == c["layer_pattern"]
    assert c["layer_pattern"] == "".join("M" if t == "mamba" else "A" for t in c["layer_types"])
    assert c["reduced"] == ["mamba_chunk_size"] and c["published"]["mamba_chunk_size"] == 256
    assert "granite-4.0-h-small" not in {cf.name for cf in all_configs().values()}
    with pytest.raises(ValueError, match="shared_d_ff"):
        harness.arch_config(dict(c, shared_d_ff=1024))


def test_reference_imports_nothing_of_the_program():
    mods = _fresh("import perfbench.reference.granite_hybrid")
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & set(mods)


def tiny(**check):
    """The cell at a tiny size and its reduced configuration, the limits
    those of the f32 comparison (``LIMITS``)."""
    cfg, c = reduced()
    wl = harness.load_workload(CELL)
    wl.update(batch=2, prompt_len=40, max_len=48, pool=3, warmup=1, limits=dict(LIMITS),
              check={"sample": 3, "block": 2, "positions": 3, "ssm_heads": 4, **check})
    return wl, c, cfg


def test_a_run_loads_no_jax():
    code = f"""
import dataclasses, time, torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from perfbench import harness
wl = harness.load_workload({CELL!r})
wl.update(batch=2, prompt_len=24, max_len=24, pool=2, warmup=1,
          check={{"sample": 1, "block": 1, "positions": 2, "ssm_heads": 2}})
cfg = get_config("granite-4.0-h-small").reduced()
res = harness.run_cell(wl, 2**40 + 3, 0.05, False, "cpu", time.perf_counter(),
                       c=dataclasses.asdict(cfg), cfg=cfg)
assert res["correct"], res
assert set(res["checks"]) == {{"logit_gap_max", "kv_gap_max", "ssm_gap_max"}}
"""
    mods = _fresh(code)
    assert "repro_torch" in mods
    assert not {"jax", "jaxlib", "flax", "repro"} & set(mods)


def test_sound_run_is_correct():
    wl, c, cfg = tiny()
    res = harness.run_cell(wl, 2**33 + 5, 0.05, False, "cpu", time.perf_counter(), c=c, cfg=cfg)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults_hybrid.FAULTS)
def test_planted_fault_is_caught(fault):
    """Each fault reads above a limit.  The capacity fault runs at a
    capacity factor of 1, which drops assignments at this size."""
    wl, c, cfg = tiny()
    if fault == "capacity":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=1.0)
    got = faults_hybrid.readings(wl, 2**33 + 5, 0.05, fault, "cpu", c=c, cfg=cfg)
    assert any(got[k] > LIMITS[k] for k in LIMITS), got


def test_altered_token_is_caught(monkeypatch):
    import repro_torch.models as models

    monkeypatch.setattr(models, "prefill", control.altered(models.prefill))
    wl, c, cfg = tiny()
    res = harness.run_cell(wl, 2**33 + 5, 0.05, False, "cpu", time.perf_counter(), c=c, cfg=cfg)
    assert not res["correct"] and res["checks"]["logit_gap_max"]["value"] > TOL


def test_control_readings_on_the_same_interface():
    wl, c, cfg = tiny()
    got = control.readings(wl, 7, 0.05, True, "cpu", c=c, cfg=cfg)
    assert set(got) == {"program", "control"} and set(got["control"]) == set(LIMITS)
    assert max(got["control"].values()) > TOL >= max(got["program"].values())


def test_traced_run_reads_the_span_metrics():
    wl, c, cfg = tiny()
    res = harness.run_cell(wl, 2**33 + 9, 0.05, True, "cpu", time.perf_counter(), c=c, cfg=cfg)
    got = res["metrics"]
    for name in ("host_ms.prefill.mamba", "host_ms.prefill.moe", "host_ms.prefill.attention",
                 "host_ms.prefill.cache", "program_idle_ms.prefill", "mfu.prefill",
                 "dispatch_ms.prefill"):
        assert got[name]["value"] >= 0, name
    assert got["syncs.prefill"]["value"] == 0
    # a CPU run launches no kernel of the card, so the rooflines read nothing
    assert "ssd_scan_roofline" not in got and "moe_experts_roofline" not in got
    assert "host_ms.prefill.ffn" not in got


def test_spans_nest_by_layer_inside_each_call():
    from repro_torch.models import prefill

    cfg, _ = reduced()
    params = weights_hybrid.make(cfg, 17, "cpu")
    toks = tokens(cfg, 1, 16, 17)
    with torch.no_grad():
        trace = harness.profile(lambda: [prefill(params, cfg, toks, 16) for _ in range(2)], 2,
                                torch.device("cpu"))
    parsed = spans.parse(trace)
    calls = [s for s in parsed if s.name == "prefill"]
    assert len(calls) == 2
    for call in calls:
        names = [s.name for s in parsed if s.parent is not None and s.start >= call.start
                 and s.end <= call.end]
        n_m, n_a = cfg.layer_pattern.count("M"), cfg.layer_pattern.count("A")
        assert (names.count("mamba"), names.count("attention"), names.count("moe"),
                names.count("cache")) == (n_m, n_a, cfg.num_layers, 1)


def test_weights_follow_the_published_initialisations():
    cfg, _ = reduced()
    a, b = weights_hybrid.make(cfg, 18, "cpu"), weights_hybrid.make(cfg, 18, "cpu")
    m = a["groups"]["granite_hybrid"]["mamba"]
    assert "head" not in a
    assert float(m["a_log"].min()) >= 0.0 and float(m["a_log"].max()) <= math.log(16.0)
    dt = F.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    for (_, x), (_, y) in zip(weights_hybrid.weights.leaf_paths(a),
                              weights_hybrid.weights.leaf_paths(b)):
        assert torch.equal(x, y)


def test_model_flops_at_the_published_widths():
    c = harness.load_config("granite-4.0-h-small")
    d = 4096
    mamba = d * (2 * 8192 + 2 * 128 + 128) + 8192 * d
    attn = d * (32 + 16) * 128 + 32 * 128 * d
    ffn = d * 72 + 10 * 3 * d * 768 + 3 * d * 1536
    assert modelflops_hybrid.body_params(c) == 36 * mamba + 4 * attn + 40 * ffn
    s = 2048
    want = 4 * (2 * (36 * mamba + 4 * attn + 40 * ffn) * s + 4 * 128 * 64 * 128 * s * 36
                + 4 * 32 * 128 * (s * (s + 1) // 2) * 4 + 2 * d * 100352)
    assert modelflops_hybrid.prefill_flops(c, 4, s) == want
    assert 138e12 < want < 140e12


def test_rooflines_at_the_cell_shape():
    from perfbench.rooflines import moe_experts, ssd_scan

    c = harness.load_config("granite-4.0-h-small")
    t_moe, by_moe = moe_experts.bound_s(c, 4, 2048)
    assert by_moe == "operations"
    assert t_moe == pytest.approx(2 * 8192 * 10 * 3 * 4096 * 768 / 989.4e12)
    t_ssd, by_ssd = ssd_scan.bound_s(c, 4, 2048)
    assert by_ssd == "bytes"
    x_bytes = 4 * 2048 * 128 * 64 * 2
    assert t_ssd == pytest.approx((2 * x_bytes + 4 * 2048 * 128 * 4 + 2 * 4 * 2048 * 128 * 2
                                   + 2 * 128 * 4) / 3.35e12)


def test_moe_experts_roofline_reads_mangled_names():
    """The metric matches the grouped GEMM by the substrings its roofline
    lists, in names the harness's matcher does not take."""
    from types import SimpleNamespace

    from perfbench.rooflines import moe_experts

    metric = harness.load_module("metrics", "moe_experts_roofline")
    c = harness.load_config("granite-4.0-h-small")
    name = "_ZN7cutlass13device_kernelIN2at4cuda6detail17GroupProblemShapeEE"
    prep = "void at::cuda::detail::prepare_grouped_gemm_data<float>(float*)"
    kernels = [(name, 0.0, 1000.0)] * 6 + [(prep, 0.0, 2.0)] * 6 + [("other", 0.0, 1e6)]
    trace = Trace(kernels, [], [], {"moe_experts": 2}, 1)
    run = SimpleNamespace(profile=trace, c=c, shape=(4, 2048))
    bound, _ = moe_experts.bound_s(c, 4, 2048)
    assert metric.read(run) == pytest.approx(100 * bound / (3 * 1000e-6 + 3 * 2e-6))
    assert trace.kernel_times(moe_experts.KERNELS).keys() == {prep}
    assert metric.read(SimpleNamespace(profile=Trace(kernels, [], [], {}, 1), c=c,
                                       shape=(4, 2048))) is None
    assert metric.read(SimpleNamespace(profile=None)) is None


def test_cell_reports_its_new_metrics():
    manifest = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.metric_names(CELL, "per_layer")}
    assert {"host_ms.prefill.mamba", "host_ms.prefill.moe", "ssd_scan_roofline",
            "moe_experts_roofline", "flash_attention_roofline"} <= names
    assert "host_ms.prefill.ffn" not in names
    assert {m["name"] for m in harness.metric_names(CELL, "end_to_end")} == \
        {"prefill_tok_s", "ttft_p95_ms", "setup_s"}
    assert any(c["name"] == "granite-4.0-h-small" for c in manifest["configs"])
