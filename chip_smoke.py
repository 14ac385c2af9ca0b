#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

1. Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a) and prints the card, its power limit and the versions.
2. Holds every kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, and times both (CUDA events over CUDA-graph
   replays, median), beside the least time the card could take and the
   launch floor (a one-element fill timed the same way); ``csr_spmm``'s
   per-edge-type entry also beside the four-pass composition it replaced,
   and the graph kernels at ragged widths, D=1, D=40 and all-masked rows;
   then the CUDA kernels one stage-1 call issues (``torch.profiler``).  ``stage2_score``
   is also checked at other depths, heads, batches and widths (the ring of
   weight tiles at H=130 and H=256), with the shared-memory plan of each
   case, and a batch of 128 against the same rows in launches of 16, bit
   for bit.
3. Runs the Lambda slice end to end for gcn, gat and sage: synthetic
   transactions -> DDS communities -> ``BatchLayer.refresh`` (stage 1 on the
   card, embeddings into the KV store) -> ``SpeedLayer.score`` over every
   order with history (micro-batches of 16, and one of 128) ->
   ``split_equivalence_check`` against the monolithic forward; the B=128
   scores must equal the B=16 ones bit for bit.  The kernel launch
   counters are zeroed just before and read just after, and the run fails
   if a kernel of the path never launched, or if a community's stage 1
   launched its aggregation kernel other than once per GNN layer (GCN's
   four edge types in one ``csr_spmm`` launch).  Then a breakdown of one
   scoring micro-batch (KV lookup, stage-2 call, the card's busy share).
4. Streams the same world through ``repro_torch.stream.StreamingEngine``
   (10,089 checkout events at 400/s; ingest -> community-local stage-1
   refresh on every closed window -> micro-batched stage 2) for gcn, gat and
   sage at one worker, with the launch counters zeroed just before and read
   just after: throughput, latency percentiles, flushes, refreshes, where
   the time goes; the run fails unless ``stage2_score`` launched once per
   flush and the aggregation kernel once per GNN layer of every stage-1
   call.  On the first 2,000 events: four workers against one and
   community-local against whole-graph refresh, bit for bit; the async
   refresh against the sync one (store bytes, exact launch counts); the
   replay against the monolithic forward (1e-4) and against the host's
   plain path (scores 1e-5, KV embeddings 2e-5); the typed attack stream at
   one and four workers; then the kernels at the stream's own shapes (one
   full stage-1 bin, N=4096 D=32; ``stage2_score`` at B=2, its rows against
   B=16 bit for bit, and typed at every bucket).
5. Serves the same stream through the facade,
   ``repro_torch.service.FraudService``: for gcn, gat and sage the streaming
   facade against a bare ``StreamingEngine`` in the order engine, facade,
   facade, engine (scores and KV bytes bit for bit, exact launches,
   events/s of all four, the card's busy share); for gcn
   the batch facade against ``BatchLayer``/``SpeedLayer`` (bit for bit,
   ``score_equivalence_check`` ≤ 1e-4), a hot swap to a
   ``register_perturbed(0, 0.0)`` clone (bit for bit) and shadow scoring
   (divergence 0 for the clone, a perturbed canary's alert); crash →
   ``FraudService.restore`` → resume at four crash points over the first
   2,000 events with a checkpoint and a hot swap in the feed (bit for bit,
   with the checkpoint's seconds and bytes and the recovery's seconds);
   then the hybrid GNN -> GBDT head on the typed attack stream (N=4 == N=1
   bit for bit, its embedding against the host's plain path within 1e-5, a
   WAL/checkpoint restore bit for bit).
6. Holds the zoo's kernels (``ssd_scan``, ``flash_attention``,
   ``gqa_decode``) against their plain versions at the zamba2-1.2b serving
   shapes, at the decoder group's (B=4, S=512, heads 32/8 at Dh 64, 16/16,
   40/40, 56/8, 32/8 and 48/8 at Dh 128; decode over a 544-slot cache with
   per-sequence ``kv_len``; mixtral's 4,096 window over a 4,608-token
   prompt), at the cross-attention shapes of step 13 and at ragged ones,
   f32 and bf16, timed beside their bounds and
   ``scaled_dot_product_attention`` as a yardstick (with a boolean mask
   where a window or per-sequence ``kv_len`` needs one).  Then ``rope``
   against its plain version (forward bit for bit, backward within
   tolerance and in the input's layout) at granite-3-2b's prefill shapes
   (timed beside the bytes bound), Dh 128, decode at positions 4,095 and
   100,000, the zoo's three thetas and ragged widths.
7. Serves zamba2-1.2b at full width and depth in bf16 through
   ``repro_torch.launch.serve.serve`` (random weights from a seed): prefill
   4 prompts of 512 tokens, decode 32 tokens, with the launch counters
   zeroed just before and read just after (exact counts); then where the
   time of prefill and of a decode step goes (``torch.profiler``).  Then
   the decoder group the same way: granite-3-2b at full width and depth
   (40 layers), olmo-1b (16, full), qwen1.5-32b and yi-34b (8 layers),
   phi3.5-moe (4) and mixtral-8x22b (2) at full width, and mixtral at B=1
   over a 4,608-token prompt with 16 decode steps, as published and with
   the ring KV cache.
8. In f32 at full width, the kernel path's logits (forward, prefill and 4
   decode steps) against the port's plain path on the host, and prefill ->
   decode consistency on the card and on the host: zamba2-1.2b and
   granite-3-2b at full depth, phi3.5-moe at 2 layers (its forward also at
   the published capacity factor, which drops assignments; every routing
   choice of the card equal to the host's); and mixtral's window: prefill
   of 4,608 tokens -> 16 decode steps against the forward on the card, as
   published and with the ring cache wrapping.
9. Training (``repro_torch.train``): the two backward kernels
   (``csr_spmm_bwd``, ``edge_softmax_bwd``, one launch a call) against
   their plain versions at the first community's stage-1 shapes and, for
   ``csr_spmm_bwd``, a learn-cell fine-tune window's (timed, with bounds,
   the launch floor, ``torch.sparse.mm`` and the no-grad forward kernels
   beside them) and at ragged ones, each called twice for the same bits;
   one train step on the card against the same step on the
   host's plain path (f32, and f64 as the anchor), for gcn, gat and sage at
   ``lnn_fraud``'s width; then Table 3's pipeline (GBDT, MLP on the card,
   LNN for gcn, gat and sage through ``train_lnn``, 3 epochs each) with the
   launch counters zeroed just before the training runs and read just
   after, ms per synchronized step, the card's busy share over one step and
   test ROC-AUC/AP beside the baselines'.
10. Prints one JSON line with every kernel's numbers, then the result line.
11. (Run after step 5.)  The process backend (``repro_torch.stream.procpool``):
   the stream (gcn, a hot swap after event 5,000) through
   ``StreamingEngine(backend="process")`` at N = 1, 2 and 4 shard
   processes between two inline replays, each with events/s, latency and
   the card's busy share (``nvidia-smi``: the kernels run in the
   children); the children's launch counters zeroed just before and read
   just after, summed over them (``stage2_score`` once per flush,
   ``csr_spmm`` once per GNN layer of every stage-1 call, none in the
   parent); scores and KV bytes equal to the inline replay's bit for bit;
   each child's card memory and seconds from spawn to warmed; then on the
   first 2,000 events a checkpoint → restore → resume and ``worker_kill``
   at N=4 (a SIGKILLed child restored, every order answered once), bit for
   bit against the inline facade.
12. (Run after step 11.)  The continuous-learning plane and the HTTP
   gateway (``repro_torch.learn``, ``repro_torch.gateway``) at the fraud
   width on ``benchmarks/learning_bench.py``'s drifting attack stream:
   serve, shadow-observe and take a learner step every 16 events (WAL tap
   -> rolling fine-tune on the card -> GBDT refit -> shadow-gated
   promotion), then an injected regression rolled back; learn off, on, on,
   off (events/s, latency, per fire the fine-tune's seconds and ms a step
   and the refit's seconds, every decision, ring recall frozen against
   recovered, the card's busy share); launches exact against the run's
   own record; the incumbent untouched across every fire; one window's
   fine-tune on the card against the host's plain path; the spawned
   trainer against the inline fine-tune, bit for bit, with the spawn's
   seconds and card memory; and the gateway over a socket against the
   in-process service bit for bit, with its checkpoint route and a
   restoring reboot.
14. (Run after step 13.)  The zoo's training (``forward_train``, the two
   backward kernels ``flash_attention_bwd`` and ``ssd_scan_bwd``): each
   backward kernel against its plain version in ``kernels/ref.py`` at every
   shape the zoo's forward runs (zamba2's, the decoder group's, the cross
   shapes, mamba2-370m's N=128, ragged), f32 within GRAD_TOL of the
   gradient's scale and bf16 within 2e-2 of it, called twice for the same
   bits, the saving forward's output equal to the no-grad forward's bit for
   bit; timed beside the bound, the launch floor and sdpa's backward.  Then
   zamba2-1.2b at full width and depth in bf16 through
   ``launch.train.train_arch`` (B=4 x 512, 8 steps; the launch counters
   zeroed just before and read just after: 6 ``flash_attention`` + 6
   ``flash_attention_bwd`` and 38 ``ssd_scan`` + 38 ``ssd_scan_bwd`` a step;
   ms a synchronized step, peak memory, finite losses, the card's busy
   share over a profiled step); then one train step's loss and gradients on
   the card against the host's plain path in f32 (and f64, the anchor) for
   the six groups and zamba2 at full width with one superblock.
13. (Run after step 8.)  Cross attention, the zoo's last two groups:
   seamless-m4t-medium (audio ``enc``/``dec``) at full width and depth in
   bf16 through ``serve()``, its encoder over 512 frames and over the
   launcher's 32, and llama-3.2-vision-90b (``vlm_super``) at full width,
   10 of its 100 layers, over its 1,601 vision tokens (B=4 prompts of 512
   tokens, 32 decode steps, exact launches: ``flash_attention`` once per
   attention application of the prefill, the encoder's included,
   ``gqa_decode`` once per self or cross layer and step; where the time
   goes); then f32 at full width against the host's plain path with
   prefill -> decode consistency on the card (the cross caches): seamless
   at full depth, llama at one superblock, B=1, a 64-token prompt.  Step 6
   holds both kernels at these shapes (non-causal, Sq != Sk, a static
   cache with every slot valid).

Any failure raises, and the exit code is then not 0.  Run from the root of
the repository:  python3 chip_smoke.py
(``python3 chip_smoke.py --zoo-kernels`` runs steps 1 and 6 only, ``--zoo``
steps 1, 6, 7 and 8,
``--fraud-kernels`` steps 1 and 2's fraud kernels, ``--train`` steps 1
and 9, ``--stream`` steps 1 and 4, ``--service`` steps 1 and 5,
``--procs`` steps 1 and 11, ``--learn`` steps 1 and 12, ``--cross``
steps 1, 6 and 13, and ``--zoo-train`` steps 1 and 14: a
quick build, check and timing, with no result line.  Copied into an older tree, ``--fraud-kernels``
times that tree's kernels too, for an A/B in one call.)
"""
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3, NVIDIA data sheet
F32_FLOP_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12     # H100 SXM bf16 dense tensor-core peak
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
EQUIV_ATOL = 1e-4            # split_equivalence_check bound
MICRO_BATCH = 16
GRAPH_INNER = 20             # calls captured per CUDA graph when timing
GRAPH_REPLAYS = 15
DEVICE = "cuda"
ZOO_ARCH = "zamba2-1.2b"
ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS = 4, 512, 32
SSD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}   # of the output's scale
# bf16 ssd_scan against ref.ssd_scan_mma_ref, which rounds where the kernel
# rounds: only f32 summation order and exp2 differ, which can move an output
# by one bf16 step, at most 2^-7 of the scale
SSD_MMA_TOL = 1e-2
# the bf16 backward kernels against ref.{flash_attention,ssd_scan}_bwd_mma_ref,
# which round where the kernels round: each gradient, of its scale
GRAD_MMA_TOL = 1e-2
ZOO_TOL = 5e-4               # whole-model logits, of their scale
# the decoder group: granite-3-2b at full width and depth, the other five
# configurations at full width, cut in depth to ~11 GB of bf16 weights each
DEC_ARCH = "granite-3-2b"
DEC_CUTS = (("olmo-1b", 16), ("qwen1.5-32b", 8), ("yi-34b", 8),
            ("phi3.5-moe-42b-a6.6b", 4), ("mixtral-8x22b", 2))
# (Hq, Hkv, Dh) of granite, olmo, qwen, yi, phi3.5-moe and mixtral
DEC_HEADS = ((32, 8, 64), (16, 16, 128), (40, 40, 128), (56, 8, 128), (32, 8, 128),
             (48, 8, 128))
DEC_LONG_SEQ, DEC_LONG_TOKENS = 4608, 16    # mixtral at B=1: the 4,096 window bites
DEC_MOE_LAYERS = 2           # phi3.5-moe's depth in the f32 agreement
# cross attention: seamless-m4t-medium at full width and depth (its encoder
# over 512 frames, and the launcher's 32), llama-3.2-vision-90b at full
# width cut to 2 of its 20 superblocks (10 of 100 layers, ~21 GB of bf16)
AUDIO_ARCH, VLM_ARCH = "seamless-m4t-medium", "llama-3.2-vision-90b"
AUDIO_FRAMES, LAUNCHER_FRAMES = 512, 32
VLM_LAYERS = 10
AUDIO_AGREE_FRAMES = 100     # f32 agreement: frames off the 64-key tile
VLM_AGREE_SEQ = 64           # ... llama at one superblock, B=1: the host's plain path in ~1 min
COLD_SETS = 6                # inputs rotated to time gqa_decode and ssd_scan cold in L2
# backward kernels against their plain versions (f32, sums over the reverse
# index in another order than the plain version's index_add_)
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)
STEP_LOSS_RTOL = 1e-5        # one train step, card against the host's plain path
STEP_GRAD_TOL = 2e-5         # ... each gradient leaf, of its scale
TRAIN_EPOCHS = 3             # per GNN type in the Table 3 phase
TIMED_STEPS = 20             # synchronized train steps timed per GNN type
# the zoo's training: zamba2-1.2b at full width and depth through the
# launcher; one step card against host for the six groups (reduced) and
# zamba2 at full width, one superblock, with the host's f64 as the anchor
ZOO_TRAIN_STEPS = 8
ZOO_TRAIN_ARCHS = ("granite-3-2b", "phi3.5-moe-42b-a6.6b", "mamba2-370m", "zamba2-1.2b",
                   "llama-3.2-vision-90b", "seamless-m4t-medium")
ZOO_STEP_LOSS_RTOL = 1e-5    # one zoo train step, card against host: the loss
ZOO_STEP_LEAF_TOL = 1e-4     # ... each gradient leaf, of its scale, beyond the host's f32 error
ZOO_STEP_FULL_SEQ = 128      # zamba2 at full width, one superblock: B=1, two SSD chunks
# the dry-run tools (launch.dryrun): the records of these two configurations
# at full width and depth on the 16x16 fake mesh, computed in this many
# spawned processes after the card has run the same step builders
DRYRUN_ARCHS = ("granite-3-2b", "zamba2-1.2b")
DRYRUN_WORKERS = 6
H100_PEAK_BF16 = 989.4e12    # dense bf16 FLOP/s, NVIDIA data sheet (launch.mesh)
QUICK_TIME_MS = 2.0          # calls slower than this are timed over a few plain calls
STREAM_RATE = 400.0          # checkout events per virtual second
STREAM_CHECK_EVENTS = 2000   # the stream's first events, replayed by every check
STREAM_SCORE_TOL = 1e-5      # a replay's scores, card against the host's plain path
STREAM_STORE_TOL = 2e-5      # ... its KV embeddings (stage 1's graph aggregations)


def time_ms(*fns) -> float:
    """Median device time of one call: GRAPH_INNER calls, taking ``fns`` in
    turn, are captured in one CUDA graph, each replay is timed with CUDA
    events.  Calls that rotate over inputs larger than the L2 cache find
    them cold."""
    for fn in fns * 3:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(GRAPH_INNER):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_INNER)
    del graph
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype=torch.float32) -> tuple[float, str]:
    """The least time in ms for moving ``nbytes`` and doing ``flops`` on
    inputs of ``dtype``, and which of the two bounds it."""
    rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(out, want, dtype_name: str) -> float:
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype_name])
    return float((out.float() - want.float()).abs().max())


def compare_scaled(out, want, tol: float, what: str) -> tuple[float, float]:
    """max |out - want| and that over max |want|; raise if the second is
    above ``tol``."""
    err = float((out.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max|d| {err:.3e} > {tol:g} of the scale {scale:.3e}")
    return err, err / scale


def profiled(fn, also=()) -> tuple[float, float, list, int]:
    """Host-clock seconds of ``fn()`` ended by a synchronize, the card's busy
    share over them, the five kernels with the most device time (ms) and
    after them every other kernel whose name holds one of the strings in
    ``also``, and the number of kernels launched.  Device time sums the
    kernel events of the ``torch.profiler`` trace, each once (an aten op's
    self device time repeats the time of the kernels it launched, and a
    kernel launched through ctypes has no aten op)."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel: dict = {}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    for e in kernels:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time_total * 1e-3
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    top = ranked[:5] + [kv for kv in ranked[5:] if any(a in kv[0] for a in also)]
    busy = sum(per_kernel.values()) * 1e-3 / wall
    return wall, busy, [(name[:60], ms) for name, ms in top], len(kernels)


def score_breakdown(speed_layer, requests) -> dict:
    """Where one ``SpeedLayer.score`` micro-batch spends its time: host-clock
    medians of the KV lookup and of the stage-2 call (inputs already on the
    card, ended by a synchronize), and the card's busy share over the scoring
    loop (:func:`profiled`)."""
    from repro_torch.core import lnn_stage2_online
    from repro_torch.serve.kvstore import pack_key

    dev, k = speed_layer.device, speed_layer.k_max
    batches = [requests[i:i + MICRO_BATCH] for i in range(0, len(requests), MICRO_BATCH)]
    lookup, call = [], []
    for reqs in batches:
        keys = [[pack_key(e, t) for e, t in r.entity_keys] for r in reqs]
        t0 = time.perf_counter()
        emb, mask = speed_layer.store.lookup_batch(keys, k)
        lookup.append(time.perf_counter() - t0)
        feats = np.stack([r.features for r in reqs]).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (emb, mask, feats)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            lnn_stage2_online(speed_layer.params, speed_layer.cfg, *args,
                              pack=speed_layer.pack)
        torch.cuda.synchronize()
        call.append(time.perf_counter() - t0)
    _, busy, _, _ = profiled(lambda: [speed_layer.score(reqs) for reqs in batches])
    return dict(lookup_ms=float(np.median(lookup)) * 1e3,
                stage2_call_ms=float(np.median(call)) * 1e3,
                device_busy_share=busy)


def stage2_launcher(flat, gnn: str, typed: bool):
    """``(call(emb, mask, feats, slot_type), pack)``: this tree's
    ``stage2_score`` kernel on the weights ``flat``, packed once.  A tree
    from before the pack (its kernel takes ``flat`` on every call) gives
    ``pack`` None, so that ``--fraud-kernels`` can time it in an A/B."""
    from repro_torch.kernels import stage2_score as s2

    if not hasattr(s2, "pack_stage2_params"):
        return (lambda emb, mask, feats, st: s2.stage2_score_cuda(emb, mask, feats, flat, gnn, st),
                None)
    pack = s2.pack_stage2_params(flat, gnn, typed)
    return (lambda emb, mask, feats, st: s2.stage2_score_cuda(emb, mask, feats, pack, st), pack)


def stage1_trace(dev, graph, feat_dim: int) -> dict:
    """What one ``lnn_stage1`` call on a community issues on the card, for
    gcn, gat and sage at the slice's widths: its CUDA kernels (copies and
    fills apart), those of them that are the port's graph kernels, their
    device time (``torch.profiler``), and the host clock of the call."""
    from repro_torch.core import LNNConfig, lnn_init, lnn_stage1

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = {}
    for gnn in ("gcn", "gat", "sage"):
        cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                        feat_dim=feat_dim)
        params = lnn_init(torch.Generator().manual_seed(1), cfg, device=dev)
        with torch.no_grad():
            lnn_stage1(params, cfg, graph)       # warm-up
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                lnn_stage1(params, cfg, graph)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
        ours = [e for e in kernels if "csr_spmm" in e.name or "edge_softmax" in e.name]
        row = dict(kernels=len(kernels), copies=len(events) - len(kernels),
                   graph_kernels=len(ours),
                   device_us=sum(e.device_time_total for e in kernels),
                   graph_kernel_us=sum(e.device_time_total for e in ours), host_ms=wall * 1e3)
        rows[gnn] = row
        print(f"stage-1 trace {gnn}: one lnn_stage1 call (N={graph.num_nodes} "
              f"D={graph.max_deg} H=64, {cfg.num_gnn_layers - 1} layers) issues "
              f"{row['kernels']} CUDA kernels ({row['graph_kernels']} csr_spmm/edge_softmax) "
              f"and {row['copies']} copies/fills; kernel device time {row['device_us']:.2f} us "
              f"({row['graph_kernel_us']:.2f} us in csr_spmm/edge_softmax); host "
              f"{row['host_ms']:.3f} ms (profiled)")
    return rows


def fraud_kernel_checks(dev, batches, feat_dim: int) -> dict:
    """The fraud slice's three kernels against their plain versions on the
    card: ``csr_spmm`` (the single call, and the per-edge-type mean GCN runs
    in one launch, beside the four-pass composition it replaced) and
    ``edge_softmax`` at the stage-1 shapes of the first community,
    ``stage2_score`` at the config's and the slice's widths over every bucket
    (timed, with bounds), then at other depths, heads, batches and widths
    (checked only); then what one stage-1 call issues on the card.  Prints
    the launch floor beside.  In an older tree without the per-edge-type
    entry, the composition alone is timed, for an A/B in one call."""
    from repro_torch.core import LNNConfig, lnn_init
    from repro_torch.core.hetero import ENTITY_TYPE_NAMES
    from repro_torch.kernels import csr_spmm as spmm_module
    from repro_torch.kernels import ref
    from repro_torch.kernels.csr_spmm import csr_spmm_cuda
    from repro_torch.kernels.edge_softmax import edge_softmax_agg_cuda
    from repro_torch.kernels.stage2_score import flatten_stage2_params

    etype_mean_cuda = getattr(spmm_module, "csr_spmm_etype_mean_cuda", None)

    results = {}
    failures = []
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    g0 = batches[0].graph.to(dev)
    n, deg, hdim = g0.num_nodes, g0.max_deg, 64
    stage1_mask = (g0.nbr_mask * (g0.nbr_etype != 3)).contiguous()
    w_mean = stage1_mask / stage1_mask.sum(-1, keepdim=True).clamp_min(1.0)
    nnz = int((w_mean != 0).sum())
    h = randn(n, hdim)

    # csr_spmm: the per-edge-type / SAGE mean of stage 1, f32 and bf16
    rows_i = torch.arange(n, device=dev)[:, None].expand(n, deg)
    keep = w_mean != 0
    sparse = torch.sparse_coo_tensor(
        torch.stack([rows_i[keep], g0.nbr_idx.long()[keep]]), w_mean[keep],
        (n, n)).coalesce().to_sparse_csr()
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        hx = h.to(dt)
        err = compare(csr_spmm_cuda(hx, g0.nbr_idx, w_mean),
                      ref.csr_spmm_ref(hx, g0.nbr_idx, w_mean), name)
        es = hx.element_size()
        b_ms, b_by = bound(2 * n * hdim * es + 2 * n * deg * 4, 2 * nnz * hdim)
        case = dict(shape=f"N={n} D={deg} H={hdim} {name}", max_abs_err=err,
                    ms=time_ms(lambda: csr_spmm_cuda(hx, g0.nbr_idx, w_mean)),
                    plain_ms=time_ms(lambda: ref.csr_spmm_ref(hx, g0.nbr_idx, w_mean)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if dt == torch.float32:
            lib_err = float((torch.sparse.mm(sparse, h) - ref.csr_spmm_ref(
                h, g0.nbr_idx, w_mean)).abs().max())
            case["library_ms"] = time_ms(lambda: torch.sparse.mm(sparse, h))
            case["library_max_abs_err"] = lib_err
        results.setdefault("csr_spmm", []).append(case)
        print(f"csr_spmm     {case['shape']:<34} max|d|={err:.2e} "
              f"kernel {case['ms'] * 1e3:8.2f} us  plain {case['plain_ms'] * 1e3:8.2f} us  "
              f"bound {b_ms * 1e3:6.3f} us ({b_by})"
              + (f"  torch.sparse.mm {case['library_ms'] * 1e3:8.2f} us "
                 f"(max|d| {case['library_max_abs_err']:.2e})"
                 if case["library_ms"] is not None else ""))

    # csr_spmm's per-edge-type mean: GCN's aggregation of stage 1, E=4 planes
    # (type 3 masked out there, so its plane is zeros); beside it the
    # composition that ran it until the kernel took all types in one launch:
    # per type five elementwise ops and a csr_spmm launch, then a stack
    n_types = 4

    def type_weights(mask, etype, e):
        w = mask * (etype == e)
        return w / w.sum(-1, keepdim=True).clamp_min(1.0)

    def composition(hx, idx, mask, etype, gather):
        return torch.stack([gather(hx, idx, type_weights(mask, etype, e))
                            for e in range(n_types)])

    def etype_mean(hx, idx, mask, etype):
        return etype_mean_cuda(hx, idx, mask, etype, n_types)

    def etype_plain(hx, idx, mask, etype):   # ref.csr_spmm_etype_mean_ref's loop
        return composition(hx, idx, mask, etype, ref.csr_spmm_ref)

    et = g0.nbr_etype
    valid = (stage1_mask != 0) & (et >= 0) & (et < n_types)
    rows_t = et.long() * n + rows_i
    sparse_t = torch.sparse_coo_tensor(
        torch.stack([rows_t[valid], g0.nbr_idx.long()[valid]]),
        torch.stack([type_weights(stage1_mask, et, e) for e in range(n_types)]).sum(0)[valid],
        (n_types * n, n)).coalesce().to_sparse_csr()
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        hx = h.to(dt)
        args_t = (hx, g0.nbr_idx, stage1_mask, et)
        want = etype_plain(*args_t)
        es = hx.element_size()
        b_ms, b_by = bound(3 * n * deg * 4 + n * hdim * es + n_types * n * hdim * es,
                           2 * int(valid.sum()) * hdim)
        case = dict(shape=f"N={n} D={deg} H={hdim} E={n_types} {name}",
                    composition_max_abs_err=compare(
                        composition(*args_t, csr_spmm_cuda), want, name),
                    composition_ms=time_ms(lambda: composition(*args_t, csr_spmm_cuda)),
                    max_abs_err=None, ms=None, plain_ms=time_ms(lambda: etype_plain(*args_t)),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if etype_mean_cuda is not None:
            case["max_abs_err"] = compare(etype_mean(*args_t), want, name)
            case["ms"] = time_ms(lambda: etype_mean(*args_t))
        if dt == torch.float32:
            case["library_max_abs_err"] = float(
                (torch.sparse.mm(sparse_t, h).view(n_types, n, hdim) - want).abs().max())
            case["library_ms"] = time_ms(lambda: torch.sparse.mm(sparse_t, h))
        results.setdefault("csr_spmm_etype_mean", []).append(case)
        print(f"csr_spmm per-edge-type mean {case['shape']}: "
              + (f"one launch max|d|={case['max_abs_err']:.2e} kernel {case['ms'] * 1e3:8.2f} us"
                 if case["ms"] is not None else "one launch: not in this tree")
              + f"  four-pass composition (4 x csr_spmm + 20 elementwise + stack) max|d|="
              f"{case['composition_max_abs_err']:.2e} {case['composition_ms'] * 1e3:8.2f} us"
              f"  plain {case['plain_ms'] * 1e3:8.2f} us  bound {b_ms * 1e3:6.3f} us ({b_by})"
              + (f"  torch.sparse.mm {case['library_ms'] * 1e3:8.2f} us "
                 f"(max|d| {case['library_max_abs_err']:.2e})"
                 if case["library_ms"] is not None else ""))

    # edge_softmax: the GAT layer of stage 1 (orders and padding rows are
    # all-masked there)
    z, s_src, s_dst = randn(n, hdim), randn(n), randn(n)
    bias = (randn(n, deg) * 0.1).contiguous()
    all_masked = int((stage1_mask.sum(-1) == 0).sum())
    most_valid = int((stage1_mask != 0).sum(-1).max())
    if all_masked == 0:
        raise AssertionError("edge_softmax check needs all-masked rows")
    args = (z, s_src, s_dst, g0.nbr_idx, stage1_mask, bias)
    err = compare(edge_softmax_agg_cuda(*args), ref.edge_softmax_agg_ref(*args), "float32")
    n_edges = int((stage1_mask > 0).sum())
    b_ms, b_by = bound(2 * n * hdim * 4 + 2 * n * 4 + 3 * n * deg * 4,
                       n_edges * (2 * hdim + 8))
    case = dict(shape=f"N={n} D={deg} H={hdim} f32 ({all_masked} rows all-masked, "
                      f"at most {most_valid} valid slots a row)",
                max_abs_err=err, ms=time_ms(lambda: edge_softmax_agg_cuda(*args)),
                plain_ms=time_ms(lambda: ref.edge_softmax_agg_ref(*args)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    results["edge_softmax"] = [case]
    print(f"edge_softmax {case['shape']:<34} max|d|={err:.2e} "
          f"kernel {case['ms'] * 1e3:8.2f} us  plain {case['plain_ms'] * 1e3:8.2f} us  "
          f"bound {b_ms * 1e3:6.3f} us ({b_by})")

    # the floor any single launch in a CUDA graph pays on this card
    tiny = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: tiny.zero_())
    print(f"launch floor: one-element fill {floor_ms * 1e3:6.2f} us (same timing as the kernels)")

    # stage2_score: the config's widths (F=48) over every bucket and B=200,
    # untyped and typed (T=4); then the slice's own widths (F=12)
    def stage2_case(gnn, typed, b, f, k=8, h=64, layers=3, mlp=(64, 32), masked="some",
                    timed=True):
        cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=layers, hidden_dim=h,
                        mlp_dims=mlp, feat_dim=f,
                        entity_types=ENTITY_TYPE_NAMES if typed else ())
        params = lnn_init(torch.Generator().manual_seed(7), cfg, device=dev)
        flat = flatten_stage2_params(params, gnn)
        call, pack = stage2_launcher(flat, gnn, typed)
        mask = (torch.rand(b, k, generator=gen) < 0.7).float()
        mask[::5] = 0.0                      # cold-start rows: all slots empty
        if masked == "all":
            mask[:] = 0.0
        mask = mask.to(dev)
        emb = (randn(b, k, h) * mask[..., None]).contiguous()
        feats = randn(b, f)
        st = None
        if typed:
            st = torch.randint(-1, len(ENTITY_TYPE_NAMES), (b, k), generator=gen,
                               dtype=torch.int32).to(dev)
        out = call(emb, mask, feats, st)
        want = ref.stage2_score_ref(emb, mask, feats, flat, gnn, st)
        err = compare(out, want, "float32")
        if not torch.isfinite(out).all():
            raise AssertionError(f"stage2_score {gnn} B={b}: non-finite logits")
        same_bits = None
        if b == 128:   # the same rows in launches of MICRO_BATCH give the same bits
            parts = [call(*(t[i:i + MICRO_BATCH] for t in (emb, mask, feats)),
                          None if st is None else st[i:i + MICRO_BATCH])
                     for i in range(0, b, MICRO_BATCH)]
            same_bits = torch.equal(torch.cat(parts), out)
        plan = None
        if pack is not None:
            from repro_torch.kernels.stage2_score import smem_optin, stage2_plan
            p = stage2_plan(pack, k, smem_optin(dev.index))
            plan = (f"{'resident' if p.whole else 'ring'} {p.rows} rows/block "
                    f"{p.n_tiles} tiles {p.smem_bytes} B")
            if p.whole != (h <= 64):
                raise AssertionError(f"stage2_score H={h}: expected the "
                                     f"{'resident' if h <= 64 else 'ring'} plan, got {plan}")
        shape = (f"{gnn} {'typed T=4' if typed else 'untyped'} B={b} K={k} H={h} F={f}"
                 + ("" if (layers, mlp) == (3, (64, 32)) else f" L={layers} mlp={mlp}")
                 + (" all-masked" if masked == "all" else ""))
        case = dict(shape=shape, max_abs_err=err, ms=None, plain_ms=None, bound_ms=None,
                    bound_by=None, library_ms=None, plan=plan, same_bits=same_bits)
        if not timed:
            return case
        t = len(ENTITY_TYPE_NAMES)
        wbytes = sum(x.numel() * 4 for x in flat)
        nbytes = 4 * (b * k * h + b * k + b * f + b + (b * k if typed else 0)) + wbytes
        dims = (h + f,) + tuple(mlp) + (1,)
        per_row = f * h + (layers - 1) * h * h + sum(a * c for a, c in zip(dims, dims[1:]))
        per_row += 2 * h * h + k * h if gnn != "gat" else (k + 2) * h * h + 3 * k * h + h
        flops = 2 * b * per_row
        if typed:
            flops += 2 * int(((st >= 0) & (st < t)).sum()) * h * h
        case["bound_ms"], case["bound_by"] = bound(nbytes, flops)
        case["ms"] = time_ms(lambda: call(emb, mask, feats, st))
        case["plain_ms"] = time_ms(lambda: ref.stage2_score_ref(emb, mask, feats, flat, gnn, st))
        case["launch_floor_ms"] = floor_ms
        return case

    def report(case):
        results.setdefault("stage2_score", []).append(case)
        line = f"stage2_score {case['shape']:<34} max|d|={case['max_abs_err']:.2e}"
        if case["ms"] is not None:
            line += (f" kernel {case['ms'] * 1e3:8.2f} us  plain {case['plain_ms'] * 1e3:8.2f} us"
                     f"  bound {case['bound_ms'] * 1e3:6.3f} us ({case['bound_by']})"
                     f"  floor {floor_ms * 1e3:5.2f} us")
        if case["plan"] is not None:
            line += f"  [{case['plan']}]"
        if case["same_bits"] is not None:
            line += f"  {MICRO_BATCH}-row launches: {'same' if case['same_bits'] else 'OTHER'} bits"
            if not case["same_bits"]:
                failures.append(f"stage2_score {case['shape']}: B={MICRO_BATCH} launches differ")
        print(line)

    cases = [(g, ty, b, 48) for g in ("gcn", "gat", "sage") for ty in (False, True)
             for b in (1, 2, 4, 8, 16, 32, 64, 128, 200)]
    cases += [(g, False, b, feat_dim) for g in ("gcn", "gat", "sage")
              for b in (MICRO_BATCH, 128)]
    for g, ty, b, f in cases:
        report(stage2_case(g, ty, b, f))

    # every branch of the chain, checked but not timed: 2 and 4 GNN layers
    # (1 and 3 tower layers) under four heads (one layer of width 1, and
    # width-1 and wider heads after it), one row, a batch with every slot
    # empty; then ragged and wide sizes, where the weights exceed the
    # shared memory and stream through the ring (H=130 at K=5, as the
    # reference tests; H=256, whose matrices are streamed in row tiles)
    for g in ("gcn", "gat", "sage"):
        for layers in (2, 4):
            for mlp in ((), (1,), (32,), (128, 64, 32)):
                report(stage2_case(g, False, MICRO_BATCH, feat_dim, layers=layers, mlp=mlp,
                                   timed=False))
        report(stage2_case(g, False, 1, feat_dim, timed=False))
        for ty in (False, True):
            report(stage2_case(g, ty, MICRO_BATCH, 48, masked="all", timed=False))
            report(stage2_case(g, ty, 37, 48, k=5, h=130, timed=False))
        report(stage2_case(g, True, 9, 48, h=256, timed=False))

    # ragged sizes, checked but not timed, each with every 7th row
    # all-masked and random edge types in [0, 4): the reference tests' N=257
    # and H=130 (two column blocks), D=40 and D=33 for the loops over chunks
    # of 32 slots, D=1; H=64 (a float2 a lane, bf16 pairs), H=256 (16-byte
    # loads), H=96 (a lane's second column group past the row), H=12 (scalar
    # loads, lanes idle); and h starting one element past a 16-byte boundary
    rgen = torch.Generator().manual_seed(1)
    for n_r, d_r, h_r, offset in ((257, 7, 130, 0), (257, 40, 130, 0), (257, 1, 64, 0),
                                  (257, 40, 64, 0), (300, 24, 256, 0), (100, 33, 96, 0),
                                  (64, 5, 12, 0), (257, 24, 64, 1)):
        idx_r = torch.randint(0, n_r, (n_r, d_r), generator=rgen, dtype=torch.int32).to(dev)
        et_r = torch.randint(0, 4, (n_r, d_r), generator=rgen, dtype=torch.int32).to(dev)
        mask_r = (torch.rand(n_r, d_r, generator=rgen) < 0.6).float()
        mask_r[::7] = 0.0
        mask_r = mask_r.to(dev)
        x_r = randn(n_r * h_r + offset)[offset:].view(n_r, h_r)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            xd = x_r.to(dt) if not offset else \
                torch.empty(n_r * h_r + offset, dtype=dt, device=dev)[offset:].view(n_r, h_r)
            if offset:
                xd.copy_(x_r)
            errs[f"csr_spmm {name}"] = compare(csr_spmm_cuda(xd, idx_r, mask_r),
                                               ref.csr_spmm_ref(xd, idx_r, mask_r), name)
            if etype_mean_cuda is not None:
                errs[f"per-type {name}"] = compare(etype_mean(xd, idx_r, mask_r, et_r),
                                                   etype_plain(xd, idx_r, mask_r, et_r), name)
        args_r = (x_r, randn(n_r), randn(n_r), idx_r, mask_r, (randn(n_r, d_r) * 0.1))
        errs["edge_softmax"] = compare(edge_softmax_agg_cuda(*args_r),
                                       ref.edge_softmax_agg_ref(*args_r), "float32")
        print(f"ragged N={n_r} D={d_r} H={h_r}{' h offset 1' if offset else ''} "
              f"({int((mask_r.sum(-1) == 0).sum())} rows all-masked): "
              + ", ".join(f"{k} max|d|={v:.2e}" for k, v in errs.items()))
    results["stage1_trace"] = stage1_trace(dev, g0, feat_dim)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("\n".join(failures))
    return results


def _warp_order_sum(vals, ptr):
    """out[r] = the sum of ``vals[ptr[r]:ptr[r + 1]]`` in the order a warp
    takes it: chunks of 32 (lanes past the end hold 0), each summed by the
    xor butterfly of offsets 16, 8, 4, 2, 1, the chunks added in turn from
    0.  Float32 adds on the card round as the kernel's do, so this gives
    the kernel's bits for numbers it summed that way."""
    n = ptr.numel() - 1
    cnt = ptr.long().diff()
    lanes = torch.arange(32, device=vals.device)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    for c in range(int((cnt.max() + 31) // 32) if n else 0):
        pos = ptr.long()[:-1, None] + c * 32 + lanes
        live = c * 32 + lanes < cnt[:, None]
        v = torch.where(live, vals[pos.clamp(max=max(vals.numel() - 1, 0))],
                        torch.zeros((), dtype=vals.dtype, device=vals.device))
        for o in (16, 8, 4, 2, 1):
            v = v + v[:, lanes ^ o]
        out = out + v[:, 0]
    return out


def _learn_window_graph(dev):
    """A fine-tune window of the learn cell (§12) as the learner builds it:
    the drifting stream's first 256 events (the window's most), typed gcn
    at ``lnn_fraud``'s width, ``EngineConfig``'s DDS settings (history
    "all", 8, max_deg 32), with its reverse-slot index on the card."""
    from repro_torch.core import ENTITY_TYPE_NAMES, LNNConfig
    from repro_torch.data import AttackConfig
    from repro_torch.learn import drifting_attack_stream
    from repro_torch.learn.trainer import _materialize_window
    from repro_torch.stream import EngineConfig

    events, _, _ = drifting_attack_stream(AttackConfig(**LEARN_ATTACK), rate_per_s=LEARN_RATE)
    rows = [(ev.snapshot, ev.arrival, tuple(ev.entities), np.asarray(ev.features, np.float32),
             float(ev.label)) for ev in events[:256]]
    cfg = LNNConfig(gnn_type="gcn", num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                    feat_dim=len(rows[0][3]), pos_weight=3.0, entity_types=ENTITY_TYPE_NAMES)
    eng = EngineConfig()
    _, pg = _materialize_window(cfg, rows, entity_history=eng.entity_history,
                                max_history=eng.max_history, max_deg=eng.max_deg, device=dev)
    return pg


def grad_kernel_checks(dev, graph) -> dict:
    """The two backward kernels against their plain versions on the card:
    at the stage-1 shapes of the first community (``graph``, on the card with
    its reverse-slot index) and of a learn-cell fine-tune window, timed
    beside the plain version, the bound, the launch floor and, for
    ``csr_spmm``'s, ``torch.sparse.mm`` with the transposed matrix, and with
    the no-grad forward kernels timed beside them (with a hash of their
    output's bits, which an A/B against an older tree compares); then at
    ragged shapes (D=1, 24, 33, 40; H=12, 64, 96, 130; all-masked rows, a
    source row of in-degree > 64 and, for ``edge_softmax``, logits of
    exactly 0), checked only.  Each case runs the kernel twice and fails
    unless the two give the same bits.  Where the forward saves what its
    backward reads (per-type slot weights, the softmax's max and sum), the
    saved numbers are checked against their plain versions, the forward's
    output under grad against the no-grad one bit for bit, and
    ``edge_softmax``'s ds_src and ds_dst against its d_bias summed in the
    kernel's order, bit for bit (both of an edge's warps give the same
    dlogit)."""
    import hashlib

    from repro_torch.kernels import ref
    from repro_torch.kernels.csr_spmm import (csr_spmm_bwd_cuda, csr_spmm_cuda,
                                              csr_spmm_etype_mean_bwd_cuda,
                                              csr_spmm_etype_mean_cuda)
    from repro_torch.kernels.edge_softmax import edge_softmax_agg_bwd_cuda, edge_softmax_agg_cuda

    gen = torch.Generator().manual_seed(4)
    results: dict = {"forward_no_grad": []}
    failures: list = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    tiny = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: tiny.zero_())

    def etype_bwd(do_e, idx, mask, et, rev):
        """The per-type backward from the weights its forward saved."""
        h0 = torch.zeros(idx.shape[0], do_e.shape[2], device=dev)
        out, wslot = csr_spmm_etype_mean_cuda(h0, idx, mask, et, do_e.shape[0], save_weights=True)
        torch.cuda.synchronize()
        if not torch.equal(out, csr_spmm_etype_mean_cuda(h0, idx, mask, et, do_e.shape[0])):
            failures.append("csr_spmm_etype_mean: the output under grad differs from no-grad's")
        try:
            torch.testing.assert_close(wslot, ref.etype_mean_weights_ref(mask, et, do_e.shape[0]),
                                       **TOL["float32"])
        except AssertionError as e:
            failures.append(f"csr_spmm_etype_mean saved weights: {e}")
        return lambda: (csr_spmm_etype_mean_bwd_cuda(do_e, wslot, et, *rev),)

    def softmax_bwd(do, args, rev):
        """The backward from the output and the max and sum its forward saved."""
        out, stats = edge_softmax_agg_cuda(*args, save_stats=True)
        torch.cuda.synchronize()
        if not torch.equal(out, edge_softmax_agg_cuda(*args)):
            failures.append("edge_softmax: the output under grad differs from no-grad's")
        try:
            torch.testing.assert_close(stats, ref.edge_softmax_stats_ref(*args[1:]),
                                       **TOL["float32"])
        except AssertionError as e:
            failures.append(f"edge_softmax saved max and sum: {e}")

        return lambda: edge_softmax_agg_bwd_cuda(do, out, stats, *args, *rev)

    def check(name, shape, kernel, plain, timing=None, extra=None):
        """``kernel()`` and ``plain()`` give tuples of tensors; ``timing`` is
        (bytes, operations, library call or None, design bytes) for a timed
        case: the bound counts the bytes the function needs, and the bytes
        this design reads beyond them (what its forward saved) stand beside
        it as their time at the memory rate; ``extra(got)`` checks more and
        returns a note."""
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            try:
                torch.testing.assert_close(g, w, **GRAD_TOL)
            except AssertionError as e:
                failures.append(f"{name} {shape}: {e}")
            err = max(err, float((g - w).abs().max()))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            failures.append(f"{name} {shape}: two calls gave other bits")
        case = dict(shape=shape, max_abs_err=err, same_bits=same, ms=None, plain_ms=None,
                    bound_ms=None, bound_by=None, library_ms=None, launch_floor_ms=floor_ms)
        line = f"{name:<16} {shape:<48} max|d|={err:.2e} {'same' if same else 'OTHER'} bits"
        if extra is not None:
            line += " " + extra(got)
        if timing is not None:
            nbytes, flops, library, design_bytes = timing
            case["bound_ms"], case["bound_by"] = bound(nbytes, flops)
            case["design_overhead_ms"] = design_bytes / HBM_BYTES_PER_S * 1e3
            case["ms"] = time_ms(lambda: kernel())
            case["plain_ms"] = time_ms(lambda: plain())
            line += (f"  kernel {case['ms'] * 1e3:8.2f} us  plain {case['plain_ms'] * 1e3:8.2f} us"
                     f"  bound {case['bound_ms'] * 1e3:6.3f} us ({case['bound_by']})"
                     f"  floor {floor_ms * 1e3:5.2f} us")
            if design_bytes:
                line += (f"  (+{case['design_overhead_ms'] * 1e3:.3f} us reading what the "
                         "forward saved)")
            if library is not None:
                case["library_max_abs_err"] = float((library() - want[0]).abs().max())
                case["library_ms"] = time_ms(library)
                line += (f"  torch.sparse.mm {case['library_ms'] * 1e3:8.2f} us "
                         f"(max|d| {case['library_max_abs_err']:.2e})")
        results.setdefault(name, []).append(case)
        print(line)

    def softmax_sums(idx, rev):
        """ds_src and ds_dst against d_bias summed in the kernel's order."""
        n, d = idx.shape

        def note(got):
            _, ds_src, ds_dst, dbias = got
            flat = dbias.flatten()
            src_ok = torch.equal(ds_src, _warp_order_sum(flat[rev[1].long()], rev[0]))
            ptr = torch.arange(0, n * d + 1, d, device=dev, dtype=torch.int32)
            dst_ok = torch.equal(ds_dst, _warp_order_sum(flat, ptr))
            if not (src_ok and dst_ok):
                failures.append(f"edge_softmax_bwd N={n} D={d}: ds_src {src_ok} / ds_dst "
                                f"{dst_ok} equal to d_bias summed in the kernel's order")
            return f"(ds_src, ds_dst = d_bias summed: {src_ok}, {dst_ok})"
        return note

    def forward_times(what, h, idx, w, mask, et, args):
        """The no-grad forward kernels at these inputs: time and a hash of
        the output's bits."""
        row = {"shape": what}
        for name, fn in (("csr_spmm", lambda: csr_spmm_cuda(h, idx, w)),
                         ("csr_spmm_etype_mean", lambda: csr_spmm_etype_mean_cuda(h, idx, mask,
                                                                                  et, 4)),
                         ("edge_softmax", lambda: edge_softmax_agg_cuda(*args))):
            bits = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
            row[name] = dict(ms=time_ms(fn), bits=bits)
        row["csr_spmm_etype_mean_saving_ms"] = time_ms(
            lambda: csr_spmm_etype_mean_cuda(h, idx, mask, et, 4, save_weights=True))
        row["edge_softmax_saving_ms"] = time_ms(
            lambda: edge_softmax_agg_cuda(*args, save_stats=True))
        results["forward_no_grad"].append(row)
        print(f"forward (no grad) {what}: " + "; ".join(
            f"{k} {row[k]['ms'] * 1e3:.2f} us bits {row[k]['bits']}"
            for k in ("csr_spmm", "csr_spmm_etype_mean", "edge_softmax"))
            + "; under grad, saving for the backward: per-type "
            f"{row['csr_spmm_etype_mean_saving_ms'] * 1e3:.2f} us, edge_softmax "
            f"{row['edge_softmax_saving_ms'] * 1e3:.2f} us")

    def transposed(idx, weights, planes=None):
        """The sparse matrix of the backward, dh = A^T dout, in CSR: row
        idx[i, d], column i (or planes[i, d] * N + i, for a dout of 4
        planes), value weights[i, d]."""
        n, d = idx.shape
        rows_i = torch.arange(n, device=dev)[:, None].expand(n, d)
        cols = rows_i if planes is None else planes * n + rows_i
        keep = weights != 0
        width = n if planes is None else 4 * n
        return torch.sparse_coo_tensor(torch.stack([idx.long()[keep], cols[keep]]),
                                       weights[keep], (n, width)).coalesce().to_sparse_csr()

    def timed_cases(g, what, softmax=True):
        """The timed cases at graph ``g``'s shapes (orders and padding
        all-masked, as stage 1 and the final hop mask them)."""
        n, deg, hdim = g.num_nodes, g.max_deg, 64
        rev = g.rev
        mask = (g.nbr_mask * (g.nbr_etype != 3)).contiguous()
        w_mean = (mask / mask.sum(-1, keepdim=True).clamp_min(1.0)).contiguous()
        nnz = int((mask != 0).sum())
        idx, et = g.nbr_idx, g.nbr_etype
        dout, dout_e = randn(n, hdim), randn(4, n, hdim)
        shape = f"{what}N={n} D={deg} H={hdim} f32 ({nnz} valid slots)"
        a_t = transposed(idx, w_mean)
        check("csr_spmm_bwd", shape,
              lambda: (csr_spmm_bwd_cuda(dout, w_mean, *rev),),
              lambda: (ref.csr_spmm_bwd_ref(dout, w_mean, *rev),),
              (2 * n * hdim * 4 + n * deg * 4 + tensor_bytes(*rev), 2 * nnz * hdim,
               lambda: torch.sparse.mm(a_t, dout), 0))
        a_te = transposed(idx, ref.etype_mean_weights_ref(mask, et, 4), et.long())
        check("csr_spmm_bwd", shape.replace("f32", "E=4 f32 per-type"),
              etype_bwd(dout_e, idx, mask, et, rev),
              lambda: (ref.csr_spmm_etype_mean_bwd_ref(dout_e, mask, et, *rev),),
              (5 * n * hdim * 4 + 2 * n * deg * 4 + tensor_bytes(*rev), 2 * nnz * hdim,
               lambda: torch.sparse.mm(a_te, dout_e.view(4 * n, hdim)), 0))
        z, s_src, s_dst, bias = randn(n, hdim), randn(n), randn(n), (randn(n, deg) * 0.1)
        args = (z, s_src, s_dst, idx, mask, bias)
        if softmax:
            # the function reads dout, z, s_src, s_dst and the slots and writes dz,
            # ds_src, ds_dst and d_bias; this design also reads the forward's output
            # and its max and sum
            check("edge_softmax_bwd", shape, softmax_bwd(dout, args, rev),
                  lambda: ref.edge_softmax_agg_bwd_ref(dout, *args, *rev),
                  (3 * n * hdim * 4 + 4 * n * 4 + 4 * n * deg * 4 + tensor_bytes(*rev),
                   nnz * (4 * hdim + 16), None, n * hdim * 4 + 2 * n * 4),
                  softmax_sums(idx, rev))
        forward_times(shape, randn(n, hdim), idx, w_mean, mask, et, args)

    timed_cases(graph, "")
    timed_cases(_learn_window_graph(dev), "learn window gcn ", softmax=False)

    # ragged: every 7th row all-masked, slot 0 of every other row pointing at
    # row 3 (in-degree > 64), random edge types; for edge_softmax, slot 0 of
    # every third row with a pre-activation of exactly 0
    rgen = torch.Generator().manual_seed(5)
    for n_r, d_r, h_r in ((160, 1, 64), (160, 24, 64), (160, 33, 64), (257, 40, 12),
                          (257, 24, 96), (257, 33, 130)):
        idx_r = torch.randint(0, n_r, (n_r, d_r), generator=rgen, dtype=torch.int32)
        mask_r = (torch.rand(n_r, d_r, generator=rgen) < 0.6).float()
        mask_r[:, 0], idx_r[:, 0] = 1.0, 3
        mask_r[::7] = 0.0
        et_r = torch.randint(0, 4, (n_r, d_r), generator=rgen, dtype=torch.int32)
        et_r[5, 0] = 6                                     # outside the vocabulary
        idx_r, mask_r, et_r = idx_r.to(dev), mask_r.to(dev), et_r.to(dev)
        rev_r = ref.reverse_slots_ref(idx_r, mask_r)
        w_r = (mask_r * torch.rand(n_r, d_r, generator=rgen).to(dev)).contiguous()
        do, do_e = randn(n_r, h_r), randn(4, n_r, h_r)
        z_r, ss_r, sd_r, b_r = randn(n_r, h_r), randn(n_r), randn(n_r), randn(n_r, d_r) * 0.1
        rows = torch.arange(1, n_r, 3, device=dev)
        b_r[rows, 0] = 0.0
        sd_r[rows] = -ss_r[idx_r[rows, 0].long()]
        args_r = (z_r, ss_r, sd_r, idx_r, mask_r, b_r.contiguous())
        shape_r = (f"ragged N={n_r} D={d_r} H={h_r} (in-degree of row 3: "
                   f"{int(rev_r[0][4] - rev_r[0][3])})")
        check("csr_spmm_bwd", shape_r, lambda: (csr_spmm_bwd_cuda(do, w_r, *rev_r),),
              lambda: (ref.csr_spmm_bwd_ref(do, w_r, *rev_r),))
        check("csr_spmm_bwd", shape_r + " per-type", etype_bwd(do_e, idx_r, mask_r, et_r, rev_r),
              lambda: (ref.csr_spmm_etype_mean_bwd_ref(do_e, mask_r, et_r, *rev_r),))
        check("edge_softmax_bwd", shape_r + " zero logits", softmax_bwd(do, args_r, rev_r),
              lambda: ref.edge_softmax_agg_bwd_ref(do, *args_r, *rev_r),
              extra=softmax_sums(idx_r, rev_r))
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"{len(failures)} backward kernel case(s) failed:\n"
                             + "\n".join(failures))
    return results


def _loss_and_grads(params, cfg, graph):
    """The LNN loss on ``graph`` and its gradient with respect to every
    leaf of ``params``, by autograd."""
    from repro_torch.core import lnn_loss
    from repro_torch.params import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = lnn_loss(tree_unflatten(params, leaves), cfg, graph)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.detach().cpu() for g in grads]


def train_step_agreement(dev, batches, split, feat_dim: int) -> dict:
    """One train step's loss and gradients on the card against the same on
    the host's plain path, from the same parameters (``lnn_fraud``'s width,
    random from a seed), on the first community with train labels, for gcn,
    gat and sage.  The loss within STEP_LOSS_RTOL; each gradient leaf within
    STEP_GRAD_TOL of its scale (max |g|) of the host's f64 gradient, and of
    the host's f32 gradient up to that one's own distance from the f64 one
    (leaves whose gradient cancels, GAT's final-hop attention vectors, carry
    f32 rounding of ~1e-5 of their scale on any device)."""
    from repro_torch.core import LNNConfig, lnn_init
    from repro_torch.kernels import _build
    from repro_torch.params import flatten_paths, from_numpy, to_numpy, tree_map
    from repro_torch.train.loop import train_masks

    masks = train_masks(batches, split)
    k = next(i for i, m in enumerate(masks) if m.sum() > 0)
    m = torch.from_numpy(masks[k])
    g_dev = batches[k].graph.to(dev).with_rev()._replace(label_mask=m.to(dev))
    g_cpu = batches[k].graph.to("cpu")._replace(label_mask=m)
    g_f64 = g_cpu._replace(**{f: getattr(g_cpu, f).double()
                              for f in ("features", "nbr_mask", "label", "label_mask")})
    rows = {}
    for gnn in ("gcn", "gat", "sage"):
        cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                        feat_dim=feat_dim, pos_weight=3.0)
        params = lnn_init(torch.Generator().manual_seed(2), cfg, device=dev)
        _build.reset_launches()
        loss_card, g_card = _loss_and_grads(params, cfg, g_dev)
        counts = dict(_build.LAUNCHES)
        p_cpu = from_numpy(to_numpy(params), "cpu")
        loss_cpu, g_host = _loss_and_grads(p_cpu, cfg, g_cpu)
        loss_f64, g_exact = _loss_and_grads(tree_map(lambda t: t.double(), p_cpu), cfg, g_f64)
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        worst = (0.0, 0.0, 0.0, "")
        for (path, _), gc, gh, ge in zip(flatten_paths(params), g_card, g_host, g_exact):
            scale = float(ge.abs().max())
            to_exact = float((gc.double() - ge).abs().max()) / scale
            beyond_host = float(((gc - gh).abs().double() - (gh.double() - ge).abs()).max()) / scale
            raw = float((gc - gh).abs().max()) / scale
            worst = max(worst, (max(to_exact, beyond_host), to_exact, raw, path))
            if to_exact > STEP_GRAD_TOL or beyond_host > STEP_GRAD_TOL:
                raise AssertionError(f"train step {gnn} {path}: card gradient off by "
                                     f"{to_exact:.2e} of scale from f64, {beyond_host:.2e} "
                                     f"beyond the host f32's own error (limit {STEP_GRAD_TOL:g})")
        if not loss_rel <= STEP_LOSS_RTOL:
            raise AssertionError(f"train step {gnn}: loss {loss_card} on the card, {loss_cpu} "
                                 f"on the host ({loss_rel:.2e} relative)")
        bwd = "edge_softmax_bwd" if gnn == "gat" else "csr_spmm_bwd"
        if counts[bwd] == 0:
            raise AssertionError(f"train step {gnn}: {bwd} never launched")
        rows[gnn] = dict(loss_card=loss_card, loss_host=loss_cpu, loss_f64=loss_f64,
                         loss_rel=loss_rel, worst_leaf=worst[3], worst_of_scale=worst[0],
                         worst_to_f64=worst[1], worst_raw_card_vs_host=worst[2],
                         launches={k_: v for k_, v in counts.items() if v})
        print(f"train step {gnn} (N={g_dev.num_nodes} community {k}, {int(m.sum())} train "
              f"labels): loss card {loss_card:.7f} host {loss_cpu:.7f} ({loss_rel:.1e} rel, "
              f"limit {STEP_LOSS_RTOL:g}); worst leaf {worst[3]}: {worst[1]:.1e} of scale from "
              f"the host's f64, card vs host f32 {worst[2]:.1e} (limit {STEP_GRAD_TOL:g} beyond "
              f"the host's own f32 error); launches {rows[gnn]['launches']}")
    return rows


def table3_phase(dev) -> dict:
    """Table 3's pipeline (``benchmarks/table3.py``) at the fraud slice's
    data size on the card: GBDT on the raw features, the MLP and the LNN on
    the GBDT-encoded ones, ``lnn_fraud``'s width, TRAIN_EPOCHS epochs per GNN
    type.  The launch counters are zeroed just before each ``train_lnn``
    run and read just after; then TIMED_STEPS synchronized steps (host
    clock, median, and their launches per step) and one profiled step.
    Fails on a loss that is not finite or a last epoch's loss not below the
    first's; no gate on AUC."""
    from repro_torch.baselines import GBDTConfig, train_gbdt
    from repro_torch.baselines.mlp import MLPConfig, predict_mlp, train_mlp
    from repro_torch.core import LNNConfig, lnn_loss
    from repro_torch.data import (SynthConfig, build_communities, generate_transactions,
                                  make_split_masks, standardize_features)
    from repro_torch.kernels import _build
    from repro_torch.train.loop import evaluate_lnn, train_lnn, train_masks
    from repro_torch.train.metrics import binary_metrics
    from repro_torch.train.optim import adamw, cosine_schedule, grad_step

    t0 = time.perf_counter()
    static, _ = generate_transactions(SynthConfig(num_users=3000, num_rings=50,
                                                  feature_noise=0.8, seed=1))
    split = make_split_masks(static.order_snapshot)
    feats, _ = standardize_features(static.order_features, split == 0)
    y = static.labels
    tr, va, te = split == 0, split == 1, split == 2
    t1 = time.perf_counter()
    gbdt = train_gbdt(feats[tr], y[tr], GBDTConfig(), feats[va], y[va])
    gbdt_s = time.perf_counter() - t1
    m_gbdt = binary_metrics(y[te], gbdt.predict_proba(feats[te]))
    enc = np.concatenate([feats, gbdt.leaf_value_features(feats)], 1)
    mu, sd = enc[tr].mean(0), enc[tr].std(0) + 1e-6
    enc = ((enc - mu) / sd).astype(np.float32)
    t1 = time.perf_counter()
    mlp = train_mlp(enc[tr], y[tr], enc[va], y[va], MLPConfig(pos_weight=3.0, seed=0),
                    device=dev)
    mlp_s = time.perf_counter() - t1
    m_mlp = binary_metrics(y[te], predict_mlp(mlp, enc[te]))
    static.order_features = enc
    batches = build_communities(static, community_size=256, max_deg=24, seed=0)
    masks = train_masks(batches, split)
    steps_per_epoch = sum(int(m.sum() > 0) for m in masks)
    print(f"table3 data: {len(y)} orders, {int(tr.sum())} train, features {feats.shape[1]} raw "
          f"+ {len(gbdt.trees)} GBDT-encoded = {enc.shape[1]}, {len(batches)} communities "
          f"({steps_per_epoch} with train labels); GBDT {gbdt_s:.2f} s (host), MLP "
          f"{mlp_s:.2f} s (card); set-up {time.perf_counter() - t0:.2f} s")
    rows = {"gbdt": m_gbdt, "mlp": m_mlp, "feat_dim": int(enc.shape[1]),
            "steps_per_epoch": steps_per_epoch, "launches": {}}
    tgraphs = [b.graph.to(dev).with_rev()._replace(label_mask=torch.from_numpy(m).to(dev))
               for b, m in zip(batches, masks) if m.sum() > 0][:TIMED_STEPS]
    expected = {"gcn": "csr_spmm_bwd", "gat": "edge_softmax_bwd", "sage": "csr_spmm_bwd"}
    for gnn in ("gcn", "gat", "sage"):
        cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                        feat_dim=enc.shape[1], pos_weight=3.0)
        torch.cuda.synchronize()
        _build.reset_launches()
        t1 = time.perf_counter()
        res = train_lnn(batches, split, cfg, epochs=TRAIN_EPOCHS, patience=6, seed=0,
                        device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        counts = dict(_build.LAUNCHES)
        for name, c in counts.items():
            rows["launches"][name] = rows["launches"].get(name, 0) + c
        losses = [h["train_loss"] for h in res.history]
        if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"table3 {gnn}: epoch losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"table3 {gnn}: the loss did not fall: {losses}")
        if counts[expected[gnn]] == 0:
            raise AssertionError(f"table3 {gnn}: {expected[gnn]} was never launched")
        m = evaluate_lnn(res.params, cfg, batches, split, 2, device=dev)

        # synchronized steps from the trained weights, their launches, one profiled
        init_fn, update_fn = adamw(cosine_schedule(3e-3, 1000, 10), weight_decay=1e-4)
        state = {"p": res.params, "s": init_fn(res.params)}

        def step(g):
            state["p"], state["s"], _ = grad_step(lambda q: lnn_loss(q, cfg, g), state["p"],
                                                  state["s"], update_fn)

        step(tgraphs[0])                     # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        times = []
        for g in tgraphs:
            t1 = time.perf_counter()
            step(g)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        per_step = {k_: v / len(tgraphs) for k_, v in _build.LAUNCHES.items() if v}
        wall, busy, top, n_kernels = profiled(lambda: step(tgraphs[1]))
        row = dict(epoch_losses=losses, val_ap=[h["val_ap"] for h in res.history],
                   epoch_s=[h["seconds"] for h in res.history], train_s=train_s,
                   step_ms_median=float(np.median(times)) * 1e3, launches_per_step=per_step,
                   profiled_step_ms=wall * 1e3, busy_share=busy, kernels_per_step=n_kernels,
                   top=top, test=m, launches=counts)
        rows[gnn] = row
        print(f"table3 {gnn}: epoch losses {', '.join(f'{x:.5f}' for x in losses)}; val AP "
              f"{', '.join(f'{x:.4f}' for x in row['val_ap'])}; s/epoch "
              f"{', '.join(f'{x:.2f}' for x in row['epoch_s'])} (eval included); step "
              f"{row['step_ms_median']:.2f} ms median over {len(times)} synchronized; "
              f"launches per step {per_step}; profiled step {row['profiled_step_ms']:.2f} ms, "
              f"card busy {busy:.1%} over {n_kernels} kernels; test ROC-AUC "
              f"{m['roc_auc']:.4f} AP {m['average_precision']:.4f} (GBDT "
              f"{m_gbdt['roc_auc']:.4f}/{m_gbdt['average_precision']:.4f}, MLP "
              f"{m_mlp['roc_auc']:.4f}/{m_mlp['average_precision']:.4f}); launches in "
              f"train_lnn {counts}")
        print(f"table3 {gnn} top device time in one step: "
              + "; ".join(f"{name} {ms * 1e3:.2f} us" for name, ms in top))
    return rows


def training(dev, batches, split, feat_dim: int) -> dict:
    """Step 7: the backward kernels, one step against the host, Table 3."""
    results = grad_kernel_checks(dev, batches[0].graph.to(dev).with_rev())
    results["train_step"] = train_step_agreement(dev, batches, split, feat_dim)
    results["table3"] = table3_phase(dev)
    print("train: " + json.dumps({k: results[k] for k in ("train_step", "table3")}))
    return results


def zoo_kernel_checks(dev) -> dict:
    """The zoo's three kernels against their plain versions on the card: at
    the zamba2-1.2b serving shapes (timed, with bounds and the library
    yardstick) and at ragged shapes (checked only), in f32 and bf16; then
    ``rope`` at the decoder group's shapes (:func:`rope_checks`)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gqa_decode import gqa_decode_cuda
    from repro_torch.kernels.ref import blockwise_attention
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    gen = torch.Generator().manual_seed(2)
    results: dict = {}
    failures: list = []

    def check(out, want, dtype_name, what) -> float:
        """max |out - want|; a case out of tolerance is recorded, and the
        checks go on so that one run shows every failing case."""
        try:
            return compare(out, want, dtype_name)
        except AssertionError as e:
            failures.append(f"{what}: {e}")
            return float((out.float() - want.float()).abs().max())

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def report(name, case):
        results.setdefault(name, []).append(case)
        line = f"{name:<15} {case['shape']:<44} max|d|={case['max_abs_err']:.2e}"
        if case.get("split_max_abs_err") is not None:
            line += f" (split ref {case['split_max_abs_err']:.2e})"
        if case.get("mma_max_abs_err") is not None:
            line += (f" (mma ref {case['mma_max_abs_err']:.2e}, "
                     f"{case['mma_err_of_scale']:.1e} of scale)")
        if case.get("ms") is not None:
            line += (f" kernel {case['ms'] * 1e3:8.2f} us  plain {case['plain_ms'] * 1e3:8.2f} us"
                     f"  bound {case['bound_ms'] * 1e3:6.2f} us ({case['bound_by']})")
        if case.get("library_ms") is not None:
            line += (f"  sdpa {case['library_ms'] * 1e3:8.2f} us "
                     f"(max|d| {case['library_max_abs_err']:.2e})")
        print(line)

    def check_scaled(out, want, tol, what) -> tuple[float, float]:
        """max |out - want| and that over the scale of ``want``; a case out of
        tolerance is recorded, as in :func:`check`."""
        try:
            return compare_scaled(out, want, tol, what)
        except AssertionError as e:
            failures.append(str(e))
            err = float((out.float() - want.float()).abs().max())
            return err, err / float(want.float().abs().max())

    # ssd_scan: x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N], d [H]
    def ssd_inputs(b, s, h, p, n, dtype):
        x, bm, cm = randn(b, s, h, p, dtype=dtype), randn(b, s, n, dtype=dtype), \
            randn(b, s, n, dtype=dtype)
        dt = (torch.rand(b, s, h, generator=gen) * 0.19 + 0.01).to(dev)
        return x, dt, bm, cm

    def ssd_case(b, s, h, p, n, dtype, timed):
        name = str(dtype).split(".")[-1]
        x, dt, bm, cm = ssd_inputs(b, s, h, p, n, dtype)
        a = -(torch.rand(h, generator=gen) * 1.5 + 0.5).to(dev)
        d = randn(h)
        args = (x, dt, a, bm, cm, d)
        out = ssd_scan_cuda(*args)
        if s % 64 == 0:   # the model's CPU choice: chunked at cfg.ssd_chunk
            plain = lambda: ref.ssd_chunked_ref(*args, chunk=64)  # noqa: E731
        else:
            plain = lambda: ref.ssd_scan_ref(*args)  # noqa: E731
        shape = f"B={b} S={s} H={h} P={p} N={n} {name}"
        err, rel = check_scaled(out, plain(), SSD_TOL[name], f"ssd_scan {shape}")
        case = dict(shape=shape, max_abs_err=err, err_of_scale=rel,
                    tol_of_scale=SSD_TOL[name], ms=None, plain_ms=None, bound_ms=None,
                    bound_by=None, library_ms=None)
        if dtype == torch.bfloat16 and hasattr(ref, "ssd_scan_mma_ref"):
            # the kernel's own roundings (an older tree, in an A/B, has no model)
            case["mma_max_abs_err"], case["mma_err_of_scale"] = check_scaled(
                out, ref.ssd_scan_mma_ref(*args), SSD_MMA_TOL,
                f"ssd_scan {shape} against the kernel's rounding model")
        if timed:
            q = 64   # the kernel's chunk: C·Bᵀ, W·x, C·S and Bᵀ·x per chunk and head
            flops = b * h * -(-s // q) * 2 * (q * q * n + q * q * p + 2 * q * n * p)
            case["bound_ms"], case["bound_by"] = bound(tensor_bytes(*args, out), flops, dtype)
            case["ms"] = time_ms(lambda: ssd_scan_cuda(*args))
            case["plain_ms"] = time_ms(plain)
            # cold in L2, as in a prefill: the graph rotates over COLD_SETS
            # inputs of this shape, more bytes than the L2 holds
            sets = [ssd_inputs(b, s, h, p, n, dtype) for _ in range(COLD_SETS)]
            case["cold_ms"] = time_ms(*(
                lambda x=xs, dt=dts, bm=bs, cm=cs: ssd_scan_cuda(x, dt, a, bm, cm, d)
                for xs, dts, bs, cs in sets))
            print(f"ssd_scan        {shape:<44} cold in L2 ({COLD_SETS} input sets, "
                  f"{COLD_SETS * tensor_bytes(*sets[0]) / 1e6:.1f} MB): kernel "
                  f"{case['cold_ms'] * 1e3:8.2f} us")
            del sets
        report("ssd_scan", case)

    # flash_attention: q [B,Hq,Sq,Dh], k/v [B,Hkv,Sk,Dh], q aligned to the keys' end
    def flash_case(b, hq, hkv, sq, sk, dh, causal, window, dtype, timed):
        name = str(dtype).split(".")[-1]
        q, k, v = randn(b, hq, sq, dh, dtype=dtype), randn(b, hkv, sk, dh, dtype=dtype), \
            randn(b, hkv, sk, dh, dtype=dtype)
        out = flash_attention_cuda(q, k, v, causal, window)
        plain = lambda: blockwise_attention(q, k, v, causal=causal, window=window,  # noqa: E731
                                            block_k=min(512, sk))
        want = plain()
        shape = (f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} Dh={dh} "
                 f"{'causal' if causal else 'full'} w={window} {name}")
        err = check(out, want, name, f"flash_attention {shape}")
        if not torch.isfinite(out).all():
            failures.append(f"flash_attention {shape}: non-finite output")
        case = dict(shape=shape,
                    max_abs_err=err, ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                    library_ms=None)
        if timed:
            qpos = torch.arange(sq)[:, None] + (sk - sq)
            kpos = torch.arange(sk)[None, :]
            keep = torch.ones(sq, sk, dtype=torch.bool)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            flops = 4 * dh * b * hq * int(keep.sum())
            case["bound_ms"], case["bound_by"] = bound(tensor_bytes(q, k, v, out), flops, dtype)
            case["ms"] = time_ms(lambda: flash_attention_cuda(q, k, v, causal, window))
            case["plain_ms"] = time_ms(plain)
            if window is None and (sq == sk or not causal):
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, is_causal=causal, enable_gqa=hq != hkv)
            else:   # the band as a boolean mask
                band = keep.to(dev)
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q, k, v, attn_mask=band, enable_gqa=hq != hkv)
            case["library_max_abs_err"] = float((sdpa().float() - want.float()).abs().max())
            case["library_ms"] = time_ms(sdpa)
        report("flash_attention", case)

    # gqa_decode: q [B,Hq,Dh], the cache k/v [B,Hkv,S,Dh], kv_len [B]
    def gqa_case(b, hq, hkv, s, dh, window, lens, dtype, timed):
        name = str(dtype).split(".")[-1]
        q, k, v = randn(b, hq, dh, dtype=dtype), randn(b, hkv, s, dh, dtype=dtype), \
            randn(b, hkv, s, dh, dtype=dtype)
        # lens None: every slot valid, kv_len None (a cross layer's static cache)
        kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
        out = gqa_decode_cuda(q, k, v, kv_len, window)
        plain = lambda: ref.gqa_decode_ref(q, k, v, kv_len, window)  # noqa: E731
        want = plain()
        shape = (f"B={b} Hq={hq} Hkv={hkv} S={s} Dh={dh} w={window} "
                 f"kv_len={'all' if lens is None else lens} {name}")
        lens = [s] * b if lens is None else lens
        err = check(out, want, name, f"gqa_decode {shape}")
        split_err = check(out, ref.gqa_decode_split_ref(q, k, v, kv_len, window), name,
                          f"gqa_decode {shape} against the split arithmetic")
        case = dict(shape=shape,
                    max_abs_err=err, split_max_abs_err=split_err, ms=None, plain_ms=None,
                    bound_ms=None, bound_by=None, library_ms=None)
        if timed:
            rows = sum(max(min(n, s) - (max(n - window, 0) if window else 0), 0) for n in lens)
            moved = tensor_bytes(q, out, *([] if kv_len is None else [kv_len])) \
                + 2 * rows * hkv * dh * k.element_size()
            case["bound_ms"], case["bound_by"] = bound(moved, 4 * dh * hq * rows, dtype)
            case["ms"] = time_ms(lambda: gqa_decode_cuda(q, k, v, kv_len, window))
            case["plain_ms"] = time_ms(plain)
            mask = None
            if kv_len is None or (window is None and min(lens) == s):
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[:, :, None], k, v, enable_gqa=hq != hkv)[:, :, 0]
            else:   # per-sequence kv_len (and window) as a boolean mask [B, 1, 1, S]
                pos = torch.arange(s, device=dev)[None, :]
                mask = pos < kv_len[:, None].long()
                if window is not None:
                    mask &= pos >= kv_len[:, None].long() - window
                mask = mask[:, None, None, :]
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=hq != hkv)[:, :, 0]
            case["library_max_abs_err"] = float((sdpa().float() - want.float()).abs().max())
            case["library_ms"] = time_ms(sdpa)
            # cold in L2, as in the decode step: the graph rotates over
            # COLD_SETS caches of this shape, more bytes than the L2 holds
            sets = [(randn(*k.shape, dtype=dtype), randn(*v.shape, dtype=dtype))
                    for _ in range(COLD_SETS)]
            case["cold_ms"] = time_ms(*(
                lambda k=kc, v=vc: gqa_decode_cuda(q, k, v, kv_len, window) for kc, vc in sets))
            case["cold_library_ms"] = time_ms(*(
                lambda k=kc, v=vc: F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=hq != hkv)
                for kc, vc in sets))
            print(f"gqa_decode      {case['shape']:<44} cold in L2 ({COLD_SETS} caches, "
                  f"{COLD_SETS * tensor_bytes(k, v) / 1e6:.1f} MB): kernel "
                  f"{case['cold_ms'] * 1e3:8.2f} us  sdpa {case['cold_library_ms'] * 1e3:8.2f} us")
            del sets
        report("gqa_decode", case)

    s_max = ZOO_SEQ + ZOO_TOKENS
    for dtype in (torch.float32, torch.bfloat16):
        # the zamba2-1.2b serving shapes: 64 SSM heads of P=64, N=64; 32 heads of 64
        ssd_case(ZOO_BATCH, ZOO_SEQ, 64, 64, 64, dtype, timed=True)
        flash_case(ZOO_BATCH, 32, 32, ZOO_SEQ, ZOO_SEQ, 64, True, None, dtype, timed=True)
        gqa_case(ZOO_BATCH, 32, 32, s_max, 64, None, [s_max] * ZOO_BATCH, dtype, timed=True)
        # ragged: padded last chunks (and mamba2-370m's N=128); GQA rep 4 with a
        # window; Dh=128 with q shorter than the keys; q longer than the keys
        # (rows with no valid key); per-sequence kv_len with a window
        ssd_case(2, 200, 8, 64, 64, dtype, timed=False)
        ssd_case(2, 77, 4, 64, 128, dtype, timed=False)
        # one short chunk, and P=40: a block's 64 columns, 40 of them valid;
        # P=96: two blocks across P, the second with 32 valid columns
        ssd_case(2, 40, 3, 40, 64, dtype, timed=False)
        ssd_case(1, 130, 2, 96, 64, dtype, timed=False)
        flash_case(2, 16, 4, 200, 200, 64, True, 64, dtype, timed=False)
        flash_case(2, 4, 2, 100, 130, 128, False, None, dtype, timed=False)
        flash_case(1, 4, 2, 130, 100, 64, True, None, dtype, timed=False)
        # the tensor-core kernel's edges: fewer rows than one mma tile, one
        # past a tile, Dh=128 over ragged tiles, a window crossing tile edges
        # with q shorter and longer than the keys
        for sq in (1, 17, 65):
            flash_case(2, 4, 4, sq, sq, 64, True, None, dtype, timed=False)
        flash_case(1, 8, 8, 300, 300, 128, True, None, dtype, timed=False)
        flash_case(1, 16, 4, 150, 250, 64, True, 64, dtype, timed=False)
        flash_case(1, 8, 2, 130, 100, 128, True, 40, dtype, timed=False)
        gqa_case(4, 32, 8, s_max, 64, 128, [1, 37, 300, s_max], dtype, timed=False)
        gqa_case(4, 16, 4, 300, 128, None, [5, 64, 65, 300], dtype, timed=False)
        # no valid position (kv_len 0; a window wholly past S) gives mean(v);
        # split edges; rep 16 at Dh=128; a cache of one row
        gqa_case(4, 8, 2, 128, 64, None, [0, 1, 64, 65], dtype, timed=False)
        gqa_case(4, 4, 4, 96, 64, 16, [0, 5, 120, 100], dtype, timed=False)
        gqa_case(2, 32, 2, 300, 128, None, [300, 129], dtype, timed=False)
        gqa_case(2, 4, 4, 1, 64, None, [1, 0], dtype, timed=False)
        # the decoder group's serving shapes (GQA rep 1, 2, 4, 6 and 7; Dh 64
        # and 128); per-sequence kv_len in decode; mixtral's 4,096 window
        # over a 4,608-token prompt
        dec_lens = [s_max, s_max - 1, 400, 273]
        for hq, hkv, dh in DEC_HEADS:
            flash_case(ZOO_BATCH, hq, hkv, ZOO_SEQ, ZOO_SEQ, dh, True, None, dtype, timed=True)
            gqa_case(ZOO_BATCH, hq, hkv, s_max, dh, None, dec_lens, dtype, timed=True)
        flash_case(1, 48, 8, DEC_LONG_SEQ, DEC_LONG_SEQ, 128, True, 4096, dtype, timed=True)
        long_max = DEC_LONG_SEQ + DEC_LONG_TOKENS
        gqa_case(1, 48, 8, long_max, 128, 4096, [long_max], dtype, timed=True)
        # cross attention, non-causal with Sq != Sk and every key valid:
        # llama-3.2-vision's self (rep 8) and cross layers (1,601 vision tokens
        # = 3·512 + 65: a ragged last key tile; 25 decode splits of 64 and one
        # of a single slot); seamless's encoder (non-causal self at 512 and 32
        # frames, the 512 case also its cross shape), cross over 32 frames
        # (fewer keys than one tile; one decode split) and its decoder's self
        # attention
        vlm_tv = get_config(VLM_ARCH).num_vision_tokens
        flash_case(ZOO_BATCH, 64, 8, ZOO_SEQ, ZOO_SEQ, 128, True, None, dtype, timed=True)
        flash_case(ZOO_BATCH, 64, 8, ZOO_SEQ, vlm_tv, 128, False, None, dtype, timed=True)
        gqa_case(ZOO_BATCH, 64, 8, s_max, 128, None, dec_lens, dtype, timed=True)
        gqa_case(ZOO_BATCH, 64, 8, vlm_tv, 128, None, None, dtype, timed=True)
        for frames in (AUDIO_FRAMES, LAUNCHER_FRAMES):
            flash_case(ZOO_BATCH, 16, 16, frames, frames, 64, False, None, dtype, timed=True)
            gqa_case(ZOO_BATCH, 16, 16, frames, 64, None, None, dtype, timed=True)
        flash_case(ZOO_BATCH, 16, 16, ZOO_SEQ, LAUNCHER_FRAMES, 64, False, None, dtype,
                   timed=True)
        flash_case(ZOO_BATCH, 16, 16, ZOO_SEQ, ZOO_SEQ, 64, True, None, dtype, timed=True)
        gqa_case(ZOO_BATCH, 16, 16, s_max, 64, None, dec_lens, dtype, timed=True)
        # ragged: one query row over the vision tokens; a static cache of one
        # slot, of one split plus one slot
        flash_case(2, 8, 2, 1, vlm_tv, 64, False, None, dtype, timed=False)
        gqa_case(2, 8, 2, 1, 64, None, None, dtype, timed=False)
        gqa_case(2, 8, 2, 65, 128, None, None, dtype, timed=False)
    # f32 takes any N and P: N and P not multiples of 4 take its scalar loads
    ssd_case(1, 70, 2, 6, 10, torch.float32, timed=False)
    results["rope"] = rope_checks(dev, gen, failures)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"{len(failures)} zoo kernel case(s) out of tolerance:\n"
                             + "\n".join(failures))
    return results


def _ulps(a, b) -> int:
    """The largest distance in units in the last place between two tensors
    of one float dtype (same-signed values: their bit patterns' distance)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return int((a.view(ints).long() - b.view(ints).long()).abs().max()) if a.numel() else 0


def rope_checks(dev, gen, failures: list) -> list:
    """``rope`` against its plain version on the card (``ref.rope_ref``, the
    eager chain the models ran before), x the projection's transposed view
    of [B, S, H, Dh]: granite-3-2b's prefill (32/8 heads, Dh 64, 4 x 2,048
    and 2 x 4,096), Dh 128 (olmo, yi), decode at S = 1 (positions 4,095 and
    100,000), the three thetas of the zoo, and ragged widths (the kernel's
    one-element path).  The forward should give the same bits (where not,
    the largest distance in ulps, and whether the kernel's cosines and
    sines, read back by rotating a unit vector, equal the plain chain's);
    the backward (the rotation by the negated angles, written in x's
    layout) within TOL of autograd through the plain version.  The prefill
    shapes are timed beside their bytes bound and the plain chain."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rope import freq_table, rope_cuda

    rows = []

    def case(b, h, s, dh, pos0, theta, dtype, timed=False, view=True):
        name = str(dtype).split(".")[-1]
        base = torch.randn(b, s, h, dh, generator=gen).to(dev, dtype)
        x = base.transpose(1, 2) if view else base.transpose(1, 2).contiguous()
        out = rope_cuda(x, pos0, theta)
        want = ref.rope_ref(x, pos0, theta)
        shape = (f"B={b} H={h} S={s} Dh={dh} pos0={pos0} theta={theta:g} "
                 f"{'view' if view else 'contiguous'} {name}")
        row = dict(shape=shape, same_bits=bool(torch.equal(out, want)),
                   max_abs_err=float((out.float() - want.float()).abs().max()),
                   max_ulps=_ulps(out, want), contiguous=out.is_contiguous())
        try:
            compare(out, want, name)
        except AssertionError as e:
            failures.append(f"rope {shape}: {e}")
        if not row["same_bits"]:
            # x1 = 1, x2 = 0: the kernel writes its cosines, then its sines
            unit = torch.cat([torch.ones(1, 1, s, dh // 2), torch.zeros(1, 1, s, dh // 2)],
                             -1).to(dev)
            trig = rope_cuda(unit, pos0, theta)[0, 0]
            angles = torch.arange(pos0, pos0 + s, device=dev)[:, None].float() \
                * freq_table(dh, float(theta), dev)
            row["cos_same"] = bool(torch.equal(trig[:, :dh // 2], torch.cos(angles)))
            row["sin_same"] = bool(torch.equal(trig[:, dh // 2:], torch.sin(angles)))
        dy = torch.randn(b, h, s, dh, generator=gen).to(dev, dtype)
        dx = rope_cuda(dy, pos0, theta, inverse=True, out_stride=x.stride())
        xr = x.detach().requires_grad_(True)
        ref.rope_ref(xr, pos0, theta).backward(dy)
        try:
            row["bwd_max_abs_err"] = compare(dx, xr.grad, name)
        except AssertionError as e:
            failures.append(f"rope backward {shape}: {e}")
            row["bwd_max_abs_err"] = float((dx.float() - xr.grad.float()).abs().max())
        row["bwd_in_x_layout"] = dx.stride() == x.stride()
        if not row["bwd_in_x_layout"]:
            failures.append(f"rope backward {shape}: strides {dx.stride()}, x's {x.stride()}")
        line = (f"rope            {shape:<52} same bits {row['same_bits']} "
                f"(max {row['max_ulps']} ulp, max|d| {row['max_abs_err']:.2e}"
                + (f", cos same {row['cos_same']}, sin same {row['sin_same']}"
                   if not row["same_bits"] else "")
                + f"); bwd max|d| {row['bwd_max_abs_err']:.2e} in x's layout "
                f"{row['bwd_in_x_layout']}")
        if timed:
            nbytes = tensor_bytes(x, out) + dh // 2 * 4
            row["bound_ms"], row["bound_by"] = bound(nbytes, 3 * x.numel(), dtype)
            row["ms"] = time_ms(lambda: rope_cuda(x, pos0, theta))
            row["bwd_ms"] = time_ms(lambda: rope_cuda(dy, pos0, theta, inverse=True,
                                                      out_stride=x.stride()))
            row["plain_ms"] = time_ms(lambda: ref.rope_ref(x, pos0, theta))
            line += (f"\n                kernel {row['ms'] * 1e3:8.2f} us  bwd "
                     f"{row['bwd_ms'] * 1e3:8.2f} us  plain {row['plain_ms'] * 1e3:8.2f} us  "
                     f"bound {row['bound_ms'] * 1e3:6.2f} us ({row['bound_by']}): "
                     f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
        print(line)
        rows.append(row)

    for dtype in (torch.bfloat16, torch.float32):
        for b, s in ((4, 2048), (2, 4096)):      # granite-3-2b's prefill cells: q, k
            case(b, 32, s, 64, 0, 1e4, dtype, timed=True)
            case(b, 8, s, 64, 0, 1e4, dtype, timed=True)
        case(4, 16, 512, 128, 0, 1e4, dtype)      # olmo-1b
        case(4, 56, 512, 128, 0, 5e6, dtype)      # yi-34b
        case(4, 64, 512, 128, 0, 5e5, dtype)      # llama-3.2-vision
        for pos0, theta in ((4095, 1e4), (100_000, 1e4), (4095, 5e5), (100_000, 5e6)):
            case(4, 32, 1, 64, pos0, theta, dtype)
            case(4, 8, 1, 128, pos0, theta, dtype)
        # ragged: Dh 72 (36 pairs: bf16 takes one element a load), Dh 6, a
        # contiguous input, S past a block
        case(2, 3, 17, 72, 5, 1e4, dtype)
        case(1, 2, 33, 6, 0, 5e5, dtype)
        case(2, 4, 300, 64, 7, 1e4, dtype, view=False)
    return rows


def _attn_launches(cfg) -> tuple[int, int]:
    """Attention applications per prefill (one flash_attention launch each)
    and per decode step (one gqa_decode launch each): a vlm's every layer,
    self or cross; an audio model's encoder self, decoder self and cross
    layers in prefill, and the decoder's two in decode."""
    if cfg.arch_type in ("dense", "moe", "vlm"):
        return cfg.num_layers, cfg.num_layers
    if cfg.arch_type == "hybrid":
        return (cfg.num_layers // cfg.attn_every,) * 2
    if cfg.arch_type == "audio":
        return 3 * cfg.num_layers, 2 * cfg.num_layers
    return 0, 0


def _rope_launches(cfg) -> tuple[int, int]:
    """``rope`` launches per prefill and per decode step: two (q and the
    keys) per self-attention application, none in cross attention or in a
    NoPE model."""
    if getattr(cfg, "position_embedding_type", "rope") == "nope":
        return 0, 0
    n_prefill, n_step = _attn_launches(cfg)
    cross = {"vlm": cfg.num_layers // max(cfg.cross_attn_every, 1),
             "audio": cfg.num_layers}.get(cfg.arch_type, 0)
    return 2 * (n_prefill - cross), 2 * (n_step - cross)


def serve_row(dev, cfg, batch: int, seq: int, tokens: int, *, label: str = "",
              warm: bool = False, profile: bool = True, frames: int = LAUNCHER_FRAMES) -> dict:
    """``cfg`` with random weights served through ``serve()`` on the card:
    prefill ``batch`` prompts of ``seq`` tokens (with a vlm's vision tokens,
    an audio model's ``frames`` frames), decode ``tokens``.  The launch
    counters are zeroed just before the run and read just after, and must
    be exactly one ``flash_attention`` per attention application of the
    prefill, one ``gqa_decode`` per attention application of each step
    (:func:`_attn_launches`), two ``rope`` per self-attention application
    (:func:`_rope_launches`), one ``ssd_scan`` per Mamba2 layer and nothing
    else; every logit finite.  With ``profile``, where the time of prefill
    and of a decode step goes (the same weights and inputs,
    ``torch.profiler``)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.models import decode_step, init_params, prefill

    name = f"zoo {cfg.name}{label}"
    if warm:
        serve(cfg, batch, seq, 2, seed=0, device=dev, frames=frames)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    _build.reset_launches()
    out = serve(cfg, batch, seq, tokens, seed=0, device=dev, frames=frames)
    counts = dict(_build.LAUNCHES)

    n_prefill, n_step = _attn_launches(cfg)
    rope_prefill, rope_step = _rope_launches(cfg)
    expected = dict.fromkeys(counts, 0)
    expected.update(ssd_scan=cfg.num_layers if cfg.arch_type in ("ssm", "hybrid") else 0,
                    flash_attention=n_prefill, gqa_decode=n_step * tokens,
                    rope=rope_prefill + rope_step * tokens)
    if counts != expected:
        raise AssertionError(f"{name}: launches {counts}, expected {expected}")
    ids = out["token_ids"]
    if tuple(ids.shape) != (batch, tokens + 1) or not out["all_finite"]:
        raise AssertionError(f"{name}: token ids {tuple(ids.shape)}, finite {out['all_finite']}")
    # ids index the embedding table: the greedy decode takes the argmax over
    # the padded head, as the reference's does
    if int(ids.min()) < 0 or int(ids.max()) >= cfg.physical_vocab:
        raise AssertionError(f"{name}: token id outside the embedding table")
    row = dict(arch=cfg.name, dtype=cfg.dtype, layers=cfg.num_layers, batch=batch,
               prompt_len=seq, tokens=tokens, prefill_s=out["prefill_s"],
               decode_s=out["decode_s"], ms_per_step=out["ms_per_step"],
               tokens_per_s=out["tokens_per_s"],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=counts)
    if cfg.arch_type == "vlm":
        row["vision_tokens"] = cfg.num_vision_tokens
    if cfg.arch_type == "audio":
        row["frames"] = frames
    print(f"{name} {cfg.dtype} B={batch} S={seq}: prefill {out['prefill_s']:.4f} s, "
          f"decode {out['ms_per_step']:.2f} ms/step ({out['tokens_per_s']:.1f} tok/s) over "
          f"{tokens} steps, peak {row['peak_gib']:.2f} GiB, launches {counts}")
    if not profile:
        return row

    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    prompts, extra = serve_inputs(cfg, batch, seq, 0, frames, device=dev)
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, cfg, prompts, seq + tokens, extra)

    steps = min(8, tokens)   # within the cache's capacity

    def run_decode():
        tok = state["logits"].argmax(-1)
        for _ in range(steps):
            logits, state["cache"] = decode_step(params, cfg, tok, state["cache"])
            tok = logits.argmax(-1)

    with torch.no_grad():
        wall, busy, top, n = profiled(run_prefill)
        row.update(prefill_profiled_ms=wall * 1e3, prefill_busy_share=busy, prefill_top=top,
                   prefill_kernels=n)
        wall, busy, top, n = profiled(run_decode)
        row.update(step_profiled_ms=wall * 1e3 / steps, decode_busy_share=busy,
                   decode_top=[(k, ms / steps) for k, ms in top],
                   step_kernels=n / steps)
    del params, state, extra
    torch.cuda.empty_cache()
    print(f"{name} card busy: prefill {row['prefill_busy_share']:.1%} of "
          f"{row['prefill_profiled_ms']:.2f} ms ({row['prefill_kernels']} kernels), decode "
          f"{row['decode_busy_share']:.1%} of {row['step_profiled_ms']:.2f} ms/step "
          f"({row['step_kernels']:.0f} kernels per step) (profiled)")
    for phase in ("prefill_top", "decode_top"):   # device ms per prefill, per step
        print(f"{name} {phase}: " + "; ".join(f"{k} {ms:.3f} ms" for k, ms in row[phase]))
    return row


def zoo_slice(dev) -> dict:
    """zamba2-1.2b at full width and depth in bf16 through the serving entry
    point; launch counts of the counted run; where the time goes."""
    from repro_torch.configs import get_config

    return serve_row(dev, get_config(ZOO_ARCH), ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS, warm=True)


class RouteLog:
    """Within ``with``: every MoE layer call of ``models.transformer``
    records its tokens' expert choices [T, k] (on the host) and how many of
    its assignments dropped."""

    def __enter__(self):
        from repro_torch.models import moe, transformer

        self.choices, self.dropped = [], 0
        self._apply = apply = transformer.moe_apply

        def recording(params, cfg, x, full_capacity=False):
            _, _, idx = moe.moe_route(params, x, cfg.experts_per_token)
            cap = moe.moe_capacity(cfg, x.shape[0], full_capacity)
            slot = moe.moe_dispatch(idx, cfg.num_experts, cap)[1]
            self.choices.append(idx.cpu())
            self.dropped += int((slot == cfg.num_experts * cap).sum())
            return apply(params, cfg, x, full_capacity=full_capacity)

        transformer.moe_apply = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer

        transformer.moe_apply = self._apply


def zoo_agreement(dev, cfg=None, seed: int = 1, batch: int = 2, seq: int = 128,
                  frames: int = LAUNCHER_FRAMES) -> dict:
    """f32 at full width: the kernel path's forward, prefill and 4 decode
    logits against the port's plain path on the host, and prefill -> decode
    consistency on the card and on the host (the depth of many blocks with
    random weights amplifies f32 rounding, so the host's own consistency is
    the floor the card is read against), each within ZOO_TOL of the logits'
    scale; ``batch`` sequences of ``seq`` prompt tokens, with a vlm's
    vision tokens or an audio model's ``frames`` frames, drawn as
    ``serve()`` draws them.  ``cfg`` defaults to zamba2-1.2b at full depth.

    For a MoE config the published capacity factor drops assignments, and
    decode runs at full capacity, so the forward is first held card against
    host at the published factor (drops counted), and the rest runs at a
    factor that drops nothing (checked).  Every routing choice of the card
    must equal the host's (counted, and the run fails on one)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_inputs
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.params import tree_map

    if cfg is None:
        cfg = get_config(ZOO_ARCH)
    full_depth = get_config(cfg.name).num_layers
    cfg = dataclasses.replace(cfg, dtype="float32")
    moe = cfg.arch_type == "moe"
    # E slots per k·T/E: cap >= k·T, so nothing can drop
    nodrop = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.num_experts)) if moe else cfg
    b, s, n_dec = batch, seq, 4
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    tokens, extra = serve_inputs(cfg, b, s + n_dec, seed, frames, device="cpu")

    def run(p, device):
        tok = tokens.to(device)
        ext = {k: t.to(device) for k, t in extra.items()}
        outs, published = [], None
        with torch.no_grad():
            if moe:
                with RouteLog() as published:
                    outs.append(forward(p, cfg, tok)[0])
            with RouteLog() as log:
                full, _, _ = forward(p, nodrop, tok, ext)
                last, cache = prefill(p, nodrop, tok[:, :s], s + n_dec, ext)
                steps = []
                for i in range(n_dec):
                    lg, cache = decode_step(p, nodrop, tok[:, s + i], cache)
                    steps.append(lg)
        outs = [t.float().cpu() for t in [full, last, torch.stack(steps, 1)] + outs]
        return outs, published, log

    t0 = time.perf_counter()
    card, card_pub, card_log = run(params, dev)
    t1 = time.perf_counter()
    host, host_pub, host_log = run(tree_map(lambda t: t.cpu(), params), "cpu")
    t2 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    pairs = [("forward", card[0], host[0]), ("prefill", card[1], host[1]),
             ("decode", card[2], host[2]),
             ("card prefill vs forward", card[1], card[0][:, s - 1]),
             ("card decode vs forward", card[2], card[0][:, s:]),
             # the same check on the host: the model's own rounding floor
             ("host prefill vs forward", host[1], host[0][:, s - 1]),
             ("host decode vs forward", host[2], host[0][:, s:])]
    if moe:
        pairs.insert(0, ("forward at the published capacity", card[3], host[3]))
    gaps = {what: compare_scaled(got, want, ZOO_TOL, f"zoo f32 {cfg.name} {what}")[1]
            for what, got, want in pairs}
    depth = ("full width and depth" if cfg.num_layers == full_depth else
             f"full width, depth {cfg.num_layers} of {full_depth}")
    if cfg.arch_type == "vlm":
        depth += f", {cfg.num_vision_tokens} vision tokens"
    if cfg.arch_type == "audio":
        depth += f", {frames} frames"
    line = (f"zoo f32 {cfg.name} {depth}, B={b} S={s} + {n_dec} decode steps: "
            "max|d| over the logits' scale: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
            + f" (limit {ZOO_TOL:g}); card {t1 - t0:.2f} s, host plain path {t2 - t1:.2f} s")
    if moe:
        differ = sum(int((c != h).sum()) for logs in ((card_pub, host_pub), (card_log, host_log))
                     for c, h in zip(logs[0].choices, logs[1].choices))
        calls = len(card_pub.choices) + len(card_log.choices)
        if (len(card_pub.choices), len(card_log.choices)) != \
                (len(host_pub.choices), len(host_log.choices)):
            raise AssertionError(f"zoo f32 {cfg.name}: {calls} MoE calls on the card, "
                                 f"{len(host_pub.choices) + len(host_log.choices)} on the host")
        choices = sum(c.numel() for c in card_pub.choices + card_log.choices)
        gaps.update(routing_choices=choices, routing_differ=differ,
                    dropped_published=card_pub.dropped, dropped_nodrop=card_log.dropped)
        line += (f"; routing: {differ} of {choices} choices differ card vs host over {calls} "
                 f"MoE calls; {card_pub.dropped} assignments dropped at capacity factor "
                 f"{cfg.moe_capacity_factor:g} (host {host_pub.dropped}), "
                 f"{card_log.dropped} at {nodrop.moe_capacity_factor:g}")
        if differ or card_log.dropped or host_log.dropped or \
                card_pub.dropped != host_pub.dropped:
            print(line)
            raise AssertionError(f"zoo f32 {cfg.name}: {differ} routing choices differ, "
                                 f"{card_log.dropped}/{host_log.dropped} drops at capacity "
                                 f"factor {nodrop.moe_capacity_factor:g}")
    print(line)
    return gaps


def window_consistency(dev) -> dict:
    """mixtral-8x22b at full width, 2 layers, f32, B=1: a prompt of
    DEC_LONG_SEQ tokens (past the 4,096 window) -> DEC_LONG_TOKENS decode
    steps, as published (a full cache, the window masking it) and with the
    ring cache (4,096 slots, wrapping), each against the forward over the
    whole sequence on the card, within ZOO_TOL of the logits' scale; at a
    capacity factor that drops nothing (checked), since decode runs at full
    capacity."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                              moe_capacity_factor=float(cfg.num_experts))   # cap >= k·T
    s, n_dec = DEC_LONG_SEQ, DEC_LONG_TOKENS
    params = init_params(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, s + n_dec))).to(dev)
    gaps = {}
    with torch.no_grad(), RouteLog() as log:
        full = forward(params, cfg, tokens)[0].float()
        for ring in (False, True):
            c = dataclasses.replace(cfg, ring_kv_cache=ring)
            last, cache = prefill(params, c, tokens[:, :s], s + n_dec)
            slots = cache["decoder"]["k"].shape[-2]
            if slots != (cfg.window if ring else s + n_dec):
                raise AssertionError(f"mixtral window: {slots} cache slots (ring {ring})")
            steps = []
            for i in range(n_dec):
                lg, cache = decode_step(params, c, tokens[:, s + i], cache)
                steps.append(lg.float())
            tag = "ring" if ring else "published"
            gaps[f"{tag} prefill vs forward"] = compare_scaled(
                last.float(), full[:, s - 1], ZOO_TOL, f"mixtral window {tag} prefill")[1]
            gaps[f"{tag} decode vs forward"] = compare_scaled(
                torch.stack(steps, 1), full[:, s:], ZOO_TOL, f"mixtral window {tag} decode")[1]
    del params, full, cache
    torch.cuda.empty_cache()
    if log.dropped:
        raise AssertionError(f"mixtral window: {log.dropped} assignments dropped at capacity "
                             f"factor {cfg.moe_capacity_factor:g}")
    print(f"zoo f32 {cfg.name} full width, depth 2 of 56, B=1 S={s} + {n_dec} decode steps "
          f"(window {cfg.window}; the ring's {cfg.window} slots take the prompt's last "
          f"{cfg.window} positions at p % {cfg.window}): "
          "max|d| over the logits' scale: " + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
          + f" (limit {ZOO_TOL:g}), 0 assignments dropped at capacity factor "
          f"{cfg.moe_capacity_factor:g}")
    return gaps


def decoder_phase(dev) -> dict:
    """The zoo's decoder group on the card: granite-3-2b at full width and
    depth in bf16 through ``serve()`` (exact launches, where the time goes);
    the other five configurations at full width, cut in depth (DEC_CUTS);
    mixtral at B=1 over a prompt past its window, as published and with the
    ring cache; then the f32 agreements: granite-3-2b at full depth and
    phi3.5-moe at DEC_MOE_LAYERS layers against the host's plain path, and
    the window's prefill -> decode consistency."""
    import dataclasses

    from repro_torch.configs import get_config

    rows = [serve_row(dev, get_config(DEC_ARCH), ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS, warm=True)]
    for arch, depth in DEC_CUTS:
        cfg = get_config(arch)
        cut = f" (depth {depth} of {cfg.num_layers})" if depth < cfg.num_layers else ""
        rows.append(serve_row(dev, dataclasses.replace(cfg, num_layers=depth), ZOO_BATCH,
                              ZOO_SEQ, ZOO_TOKENS, label=cut))
        rows[-1]["full_layers"] = cfg.num_layers
    mixtral = dataclasses.replace(get_config("mixtral-8x22b"), num_layers=2)
    for ring in (False, True):
        rows.append(serve_row(dev, dataclasses.replace(mixtral, ring_kv_cache=ring), 1,
                              DEC_LONG_SEQ, DEC_LONG_TOKENS, profile=False,
                              label=f" (depth 2 of 56, {'ring' if ring else 'no ring'})"))
        rows[-1].update(full_layers=56, ring_kv_cache=ring)
    agreement = {DEC_ARCH: zoo_agreement(dev, get_config(DEC_ARCH), seed=1)}
    moe_cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), num_layers=DEC_MOE_LAYERS)
    agreement[moe_cfg.name] = zoo_agreement(dev, moe_cfg, seed=2)
    agreement["mixtral-8x22b window"] = window_consistency(dev)
    launches = dict.fromkeys(rows[0]["launches"], 0)
    for row in rows:
        for name, c in row["launches"].items():
            launches[name] += c
    return dict(rows=rows, f32_agreement_of_scale=agreement, launches=launches)


def cross_phase(dev) -> dict:
    """Cross attention on the card: seamless-m4t-medium at full width and
    depth in bf16 through ``serve()`` with its encoder over AUDIO_FRAMES
    frames and over the launcher's 32, and llama-3.2-vision-90b at full
    width, VLM_LAYERS of its 100 layers, over its 1,601 vision tokens
    (exact launches, where the time goes); then the f32 agreements against
    the host's plain path with prefill -> decode consistency (which holds
    the cross caches): seamless at full depth, llama at one superblock."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    audio, vlm = get_config(AUDIO_ARCH), get_config(VLM_ARCH)
    cut = dataclasses.replace(vlm, num_layers=VLM_LAYERS)
    rows = [serve_row(dev, audio, ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS, warm=True,
                      frames=AUDIO_FRAMES, label=f" ({AUDIO_FRAMES} frames)"),
            serve_row(dev, audio, ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS,
                      label=f" ({LAUNCHER_FRAMES} frames)"),
            serve_row(dev, cut, ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS,
                      label=f" (depth {VLM_LAYERS} of {vlm.num_layers}, "
                            f"{vlm.num_vision_tokens} vision tokens)")]
    rows[-1]["full_layers"] = vlm.num_layers
    agreement = {
        AUDIO_ARCH: zoo_agreement(dev, audio, seed=4, frames=AUDIO_AGREE_FRAMES),
        VLM_ARCH: zoo_agreement(dev, dataclasses.replace(vlm, num_layers=vlm.cross_attn_every),
                                seed=5, batch=1, seq=VLM_AGREE_SEQ)}
    launches = dict.fromkeys(rows[0]["launches"], 0)
    for row in rows:
        for name, c in row["launches"].items():
            launches[name] += c
    seconds = time.perf_counter() - t0
    print(f"cross phase: {seconds:.1f} s")
    return dict(rows=rows, f32_agreement_of_scale=agreement, launches=launches, seconds=seconds)


def time_call_ms(fn) -> float:
    """Device time of one call: :func:`time_ms` (CUDA-graph replays), or for
    a call slower than QUICK_TIME_MS the mean of a few calls between CUDA
    events (launch overhead is then below the noise)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = start.elapsed_time(end)
    if one < QUICK_TIME_MS:
        return time_ms(fn)
    reps = 3 if one > 20 else 5
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def zoo_grad_kernel_checks(dev) -> dict:
    """The two backward kernels of the zoo's training against their plain
    versions on the card, at every shape the zoo's forward runs and at
    ragged ones, f32 and bf16: ``flash_attention_bwd`` (and the saving
    forward: its output bit for bit the no-grad forward's, its row
    logsumexp against ``ref.attention_lse_ref``) and ``ssd_scan_bwd``.  Each
    gradient within GRAD_TOL (f32) or 2e-2 (bf16) of its scale, bf16 also
    within GRAD_MMA_TOL of the tensor-core kernels' plain models
    (``ref.{flash_attention,ssd_scan}_bwd_mma_ref``); two calls give the
    same bits.  bf16 shapes (and f32 at zamba2's) are timed beside the
    bound, the launch floor and, for attention, sdpa's backward
    (``torch.autograd.grad`` through ``scaled_dot_product_attention``, its
    forward's time taken off).  Then shapes a kernel does not take (the
    bf16 scan's N, either scan's shared memory just past a block's) must
    raise before any launch."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    gen = torch.Generator().manual_seed(3)
    results: dict = {}
    failures: list = []
    tiny = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: tiny.zero_())
    tol = {"float32": GRAD_TOL["atol"], "bfloat16": TOL["bfloat16"]["atol"],
           "mma": GRAD_MMA_TOL}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    def worst_of_scale(got, want, name, what) -> tuple[float, float]:
        """max |d| and that over the scale, the worst over the gradients; a
        case out of tolerance is recorded and the checks go on."""
        worst = (0.0, 0.0)
        for g, w, label in zip(got, want, what):
            if g is None:
                continue
            err = float((g.float() - w.float()).abs().max())
            rel = err / max(float(w.float().abs().max()), 1e-30)
            if not torch.isfinite(g).all() or rel > tol[name]:
                failures.append(f"{label}: max|d| {err:.3e}, {rel:.2e} of scale "
                                f"(limit {tol[name]:g})")
            worst = max(worst, (rel, err))
        return worst[1], worst[0]

    def report(kernel, case):
        results.setdefault(kernel, []).append(case)
        line = (f"{kernel:<19} {case['shape']:<50} max|d|={case['max_abs_err']:.2e} "
                f"({case['err_of_scale']:.1e} of scale) same bits {case['same_bits']}")
        if case.get("mma_max_abs_err") is not None:
            line += (f" (mma ref {case['mma_max_abs_err']:.2e}, "
                     f"{case['mma_err_of_scale']:.1e} of scale)")
        if case.get("ms") is not None:
            line += (f" kernel {case['ms'] * 1e3:9.2f} us  bound {case['bound_ms'] * 1e3:7.2f} us "
                     f"({case['bound_by']})  floor {floor_ms * 1e3:4.2f} us")
        if case.get("plain_ms") is not None:
            line += f"  plain {case['plain_ms'] * 1e3:9.2f} us"
        if case.get("library_ms") is not None:
            line += f"  sdpa bwd {case['library_ms'] * 1e3:9.2f} us"
        if case.get("design_overhead_ms"):
            line += (f"  (+{case['design_overhead_ms'] * 1e3:.2f} us moving its scratch at the "
                     "memory rate)")
        print(line)

    def flash_case(b, hq, hkv, sq, sk, dh, causal, window, dtype, timed, plain_timed=False):
        name = str(dtype).split(".")[-1]
        q, k, v, dout = (randn(b, hq, sq, dh, dtype=dtype), randn(b, hkv, sk, dh, dtype=dtype),
                         randn(b, hkv, sk, dh, dtype=dtype), randn(b, hq, sq, dh, dtype=dtype))
        shape = (f"B={b} Hq={hq} Hkv={hkv} Sq={sq} Sk={sk} Dh={dh} "
                 f"{'causal' if causal else 'full'} w={window} {name}")
        plain_out = flash_attention_cuda(q, k, v, causal, window)
        out, lse = flash_attention_cuda(q, k, v, causal, window, save_lse=True)
        if not torch.equal(out, plain_out):
            failures.append(f"flash_attention {shape}: the saving forward changed the output")
        lse_err = float((lse - ref.attention_lse_ref(q, k, causal, window)).abs().max())
        if not lse_err <= 1e-4:
            failures.append(f"flash_attention {shape}: row logsumexp off by {lse_err:.2e}")
        args = (q, k, v, out, dout, lse, causal, window)
        got = flash_attention_bwd_cuda(*args)
        same = all(torch.equal(a, c) for a, c in zip(got, flash_attention_bwd_cuda(*args)))
        if not same:
            failures.append(f"flash_attention_bwd {shape}: two calls differ")
        err, rel = worst_of_scale(got, ref.flash_attention_bwd_ref(*args), name,
                                  [f"flash_attention_bwd {shape} d{x}" for x in "qkv"])
        case = dict(shape=shape, max_abs_err=err, err_of_scale=rel, tol_of_scale=tol[name],
                    same_bits=same, forward_bits_kept=torch.equal(out, plain_out),
                    lse_max_abs_err=lse_err, ms=None, plain_ms=None, bound_ms=None,
                    bound_by=None, library_ms=None, launch_floor_ms=floor_ms)
        if dtype == torch.bfloat16:
            case["mma_max_abs_err"], case["mma_err_of_scale"] = worst_of_scale(
                got, ref.flash_attention_bwd_mma_ref(*args), "mma",
                [f"flash_attention_bwd {shape} d{x} (mma ref)" for x in "qkv"])
        if timed:
            qpos = torch.arange(sq)[:, None] + (sk - sq)
            kpos = torch.arange(sk)[None, :]
            keep = torch.ones(sq, sk, dtype=torch.bool)
            if causal:
                keep &= kpos <= qpos
            if window is not None:
                keep &= kpos > qpos - window
            # S, dP, dV, dK and dQ over the valid pairs; q, k, v, out, dout
            # and lse read, dq, dk, dv written
            flops = 10 * dh * b * hq * int(keep.sum())
            moved = tensor_bytes(q, k, v, out, dout, lse, *got)
            case["bound_ms"], case["bound_by"] = bound(moved, flops, dtype)
            case["ms"] = time_call_ms(lambda: flash_attention_bwd_cuda(*args))
            if plain_timed:
                case["plain_ms"] = time_call_ms(lambda: ref.flash_attention_bwd_ref(*args))
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            mask = None if window is None and (sq == sk or not causal) else keep.to(dev)

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                      is_causal=causal and mask is None,
                                                      enable_gqa=hq != hkv)
            # autograd issues the backward on the forward's stream, so the
            # forward is captured with it, then timed alone and taken off
            case["library_ms"] = (
                time_call_ms(lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dout))
                - time_call_ms(sdpa))
        report("flash_attention_bwd", case)

    def ssd_case(b, s, h, p, n, dtype, timed, plain_timed=False):
        name = str(dtype).split(".")[-1]
        x, dy = randn(b, s, h, p, dtype=dtype), randn(b, s, h, p, dtype=dtype)
        bm, cm = randn(b, s, n, dtype=dtype), randn(b, s, n, dtype=dtype)
        dt = (torch.rand(b, s, h, generator=gen) * 0.19 + 0.01).to(dev)
        a = -(torch.rand(h, generator=gen) * 1.5 + 0.5).to(dev)
        d = randn(h)
        args = (x, dt, a, bm, cm, d, dy)
        shape = f"B={b} S={s} H={h} P={p} N={n} {name}"
        got = ssd_scan_bwd_cuda(*args)
        same = all(torch.equal(u, w) for u, w in zip(got, ssd_scan_bwd_cuda(*args)))
        if not same:
            failures.append(f"ssd_scan_bwd {shape}: two calls differ")
        err, rel = worst_of_scale(got, ref.ssd_scan_bwd_ref(*args), name,
                                  [f"ssd_scan_bwd {shape} d{w}" for w in
                                   ("x", "dt", "a", "b", "c", "d")])
        case = dict(shape=shape, max_abs_err=err, err_of_scale=rel, tol_of_scale=tol[name],
                    same_bits=same, ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                    library_ms=None, launch_floor_ms=floor_ms)
        if dtype == torch.bfloat16:
            case["mma_max_abs_err"], case["mma_err_of_scale"] = worst_of_scale(
                got, ref.ssd_scan_bwd_mma_ref(*args), "mma",
                [f"ssd_scan_bwd {shape} d{w} (mma ref)" for w in ("x", "dt", "a", "b", "c", "d")])
        if timed:
            q, nc = 64, -(-s // 64)
            # per chunk and head: C·Bᵀ and dY·Xᵀ, the intra-chunk dx, db and
            # dc (Q x Q x N or P each), and six Q x N x P products (the state
            # recomputed, C·H, H·dy, R·x, Rᵀ·b, the state's gradient)
            flops = 2 * b * h * nc * (3 * q * q * n + 2 * q * q * p + 6 * q * n * p)
            case["bound_ms"], case["bound_by"] = bound(
                tensor_bytes(*args, *(g for g in got if g is not None)), flops, dtype)
            # what the design moves beyond that, each written once and read
            # once: the recomputed states (bf16: and their gradients) and the
            # per-head db and dc
            scratch = 4 * b * h * ((2 if dtype == torch.bfloat16 else 1) * nc * n * p + 2 * s * n)
            case["design_overhead_ms"] = 2 * scratch / HBM_BYTES_PER_S * 1e3
            case["ms"] = time_call_ms(lambda: ssd_scan_bwd_cuda(*args))
            if plain_timed:
                case["plain_ms"] = time_call_ms(lambda: ref.ssd_scan_bwd_ref(*args))
        report("ssd_scan_bwd", case)

    vlm_tv = get_config(VLM_ARCH).num_vision_tokens
    for dtype in (torch.bfloat16, torch.float32):
        bf = dtype == torch.bfloat16
        # zamba2-1.2b's training shapes, then mamba2-370m's N=128
        ssd_case(ZOO_BATCH, ZOO_SEQ, 64, 64, 64, dtype, timed=True, plain_timed=True)
        flash_case(ZOO_BATCH, 32, 32, ZOO_SEQ, ZOO_SEQ, 64, True, None, dtype, timed=True,
                   plain_timed=True)
        ssd_case(ZOO_BATCH, ZOO_SEQ, 32, 64, 128, dtype, timed=bf)
        # the decoder group's (granite, olmo, qwen, yi, phi3.5-moe, mixtral)
        # and mixtral's 4,096 window over 4,608 tokens
        for hq, hkv, dh in DEC_HEADS:
            flash_case(ZOO_BATCH, hq, hkv, ZOO_SEQ, ZOO_SEQ, dh, True, None, dtype, timed=bf)
        flash_case(1, 48, 8, DEC_LONG_SEQ, DEC_LONG_SEQ, 128, True, 4096, dtype, timed=bf)
        # the cross shapes: llama's self and cross layers, seamless's encoder
        # (512 and 32 frames), cross over 32 frames and decoder self
        flash_case(ZOO_BATCH, 64, 8, ZOO_SEQ, ZOO_SEQ, 128, True, None, dtype, timed=bf)
        flash_case(ZOO_BATCH, 64, 8, ZOO_SEQ, vlm_tv, 128, False, None, dtype, timed=bf)
        for frames in (AUDIO_FRAMES, LAUNCHER_FRAMES):
            flash_case(ZOO_BATCH, 16, 16, frames, frames, 64, False, None, dtype, timed=bf)
        flash_case(ZOO_BATCH, 16, 16, ZOO_SEQ, LAUNCHER_FRAMES, 64, False, None, dtype,
                   timed=bf)
        flash_case(ZOO_BATCH, 16, 16, ZOO_SEQ, ZOO_SEQ, 64, True, None, dtype, timed=bf)
        # ragged: padded last chunks; f32 small N and P (the reduced
        # configs' 32 x 32), N and P not multiples of 4; bf16 (N 64 or 128,
        # P a multiple of 8) P of 32, 8 and 72 (two column tiles, not a
        # multiple of 16); q tiles past Sq, key tiles past Sk, a window
        # across tile edges, q longer than the keys (rows with no valid
        # key), one query row over the vision tokens
        ssd_case(2, 200, 4, 64, 64, dtype, timed=False)
        if bf:
            ssd_case(1, 77, 2, 32, 64, dtype, timed=False)
            ssd_case(1, 70, 2, 8, 128, dtype, timed=False)
            ssd_case(2, 130, 3, 72, 64, dtype, timed=False)
        else:
            ssd_case(1, 77, 2, 32, 32, dtype, timed=False)
            ssd_case(1, 70, 2, 6, 10, dtype, timed=False)
        flash_case(2, 16, 4, 200, 200, 64, True, 64, dtype, timed=False)
        flash_case(2, 4, 2, 100, 130, 128, False, None, dtype, timed=False)
        flash_case(1, 4, 2, 130, 100, 64, True, None, dtype, timed=False)
        flash_case(1, 8, 2, 130, 100, 128, True, 40, dtype, timed=False)
        flash_case(2, 4, 4, 17, 17, 64, True, None, dtype, timed=False)
        flash_case(2, 8, 2, 1, vlm_tv, 64, False, None, dtype, timed=False)
    # shapes a backward kernel does not take raise before any launch: the
    # bf16 kernel's N outside (64, 128), and each kernel's shared memory
    # just past a block's (the guards count what the launchers ask for)
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import SMEM_OPTIN, bwd_mma_smem_bytes, bwd_smem_bytes
    for n, p, dtype, need in ((32, 64, torch.bfloat16, None),
                              (64, 143, torch.float32, bwd_smem_bytes(64, 143)),
                              (128, 216, torch.bfloat16, bwd_mma_smem_bytes(128, 216))):
        x, dy = randn(1, 64, 1, p, dtype=dtype), randn(1, 64, 1, p, dtype=dtype)
        bm, cm = randn(1, 64, n, dtype=dtype), randn(1, 64, n, dtype=dtype)
        dt, a = torch.full((1, 64, 1), 0.1, device=dev), torch.full((1,), -1.0, device=dev)
        before = _build.LAUNCHES["ssd_scan_bwd"]
        try:
            ssd_scan_bwd_cuda(x, dt, a, bm, cm, None, dy)
            failures.append(f"ssd_scan_bwd N={n} P={p} {dtype}: no ValueError")
        except ValueError as e:
            print(f"ssd_scan_bwd        N={n} P={p} {str(dtype).split('.')[-1]}: refused before "
                  f"any launch ({e})")
        if need is not None and not need > SMEM_OPTIN:
            failures.append(f"ssd_scan_bwd N={n} P={p}: {need} bytes is not past the limit")
        if _build.LAUNCHES["ssd_scan_bwd"] != before:
            failures.append(f"ssd_scan_bwd N={n} P={p} {dtype}: launched")
    torch.cuda.synchronize()
    if failures:
        raise AssertionError(f"{len(failures)} zoo backward case(s) out of tolerance:\n"
                             + "\n".join(failures))
    return results


def _zoo_loss_and_grads(params, cfg, batch) -> tuple[float, list]:
    """``forward_train``'s loss (f32, no remat) and its gradient with respect
    to every leaf, on the tensors' device."""
    from repro_torch.models.transformer import forward_train
    from repro_torch.params import tree_leaves, tree_unflatten

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = forward_train(tree_unflatten(params, leaves), cfg, batch, use_remat=False)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for g, p in zip(grads, leaves)]


def zoo_step_agreement(dev) -> dict:
    """One zoo train step's loss and gradients on the card against the same
    on the host's plain path, f32, from the same parameters (random from a
    seed, drawn on the host) and batch (``launch.train.arch_batch``): the
    six groups' reduced configs at B=2 x 64, and zamba2-1.2b at full width
    with one superblock (6 Mamba2 blocks and the shared attention) at B=1 x
    ZOO_STEP_FULL_SEQ; the host's f64 evaluation of the same step is the
    anchor.  The loss within ZOO_STEP_LOSS_RTOL; each leaf within
    ZOO_STEP_LEAF_TOL of its scale (max |g| in f64) of the host's f32
    gradient, beyond that one's own distance from the f64 one (printed
    beside).  The hybrid's reduced case takes two superblocks of two Mamba2
    blocks, as tests/test_torch_zoo_train.py does: over the 12 blocks of
    ``reduced()`` the gradient is so ill-conditioned that scaling the
    weights by 1 + 1e-7 N(0, 1) moves a leaf 3e-4 of its scale in f32 (on
    the host; 2e-4 in f64 at 3e-7), more than the limit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.train import arch_batch
    from repro_torch.models import init_params
    from repro_torch.params import flatten_paths, tree_map

    cases = []
    for arch in ZOO_TRAIN_ARCHS:
        cfg = get_config(arch).reduced()
        if arch == ZOO_ARCH:   # two superblocks of two Mamba2 blocks, as the CPU tests
            cfg = dataclasses.replace(cfg, num_layers=4, attn_every=2)
        cases.append((f"{arch} reduced", cfg, 2, 64))
    full = get_config(ZOO_ARCH)
    cases.append((f"{ZOO_ARCH} full width, one superblock",
                  dataclasses.replace(full, num_layers=full.attn_every, dtype="float32"), 1,
                  ZOO_STEP_FULL_SEQ))
    rows = {}
    for seed, (label, cfg, b, s) in enumerate(cases):
        t0 = time.perf_counter()
        p_cpu = init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        batch = arch_batch(cfg, b, s, np.random.default_rng(seed), "cpu")
        _build.reset_launches()
        loss_card, g_card = _zoo_loss_and_grads(tree_map(lambda t: t.to(dev), p_cpu), cfg,
                                                {k: v.to(dev) for k, v in batch.items()})
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        g_card = [g.cpu() for g in g_card]
        loss_host, g_host = _zoo_loss_and_grads(p_cpu, cfg, batch)
        loss_f64, g_exact = _zoo_loss_and_grads(
            tree_map(lambda t: t.double(), p_cpu), dataclasses.replace(cfg, dtype="float64"),
            {k: v.double() if v.is_floating_point() else v for k, v in batch.items()})
        loss_rel = abs(loss_card - loss_host) / abs(loss_host)
        worst = (0.0, 0.0, 0.0, 0.0, "")
        for (path, _), gc, gh, ge in zip(flatten_paths(p_cpu), g_card, g_host, g_exact):
            scale = max(float(ge.abs().max()), 1e-300)
            beyond = float(((gc - gh).abs().double() - (gh.double() - ge).abs()).max()) / scale
            worst = max(worst, (beyond, float((gc.double() - ge).abs().max()) / scale,
                                float((gh.double() - ge).abs().max()) / scale,
                                float((gc - gh).abs().max()) / scale, path))
        del g_card, g_host, g_exact, p_cpu
        torch.cuda.empty_cache()
        want = [k for k, runs in (("flash_attention_bwd", cfg.arch_type != "ssm"),
                                  ("ssd_scan_bwd", cfg.arch_type in ("ssm", "hybrid"))) if runs]
        missing = [k for k in want if not counts.get(k)]
        rows[label] = dict(loss_card=loss_card, loss_host=loss_host, loss_f64=loss_f64,
                           loss_rel=loss_rel, worst_leaf=worst[4], worst_of_scale=worst[0],
                           card_to_f64=worst[1], host_to_f64=worst[2], card_vs_host=worst[3],
                           launches=counts, batch=b, seq=s, layers=cfg.num_layers,
                           d_model=cfg.d_model)
        print(f"zoo train step {label} (B={b} S={s}, {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}): loss card {loss_card:.7f} host {loss_host:.7f} f64 "
              f"{loss_f64:.7f} ({loss_rel:.1e} rel, limit {ZOO_STEP_LOSS_RTOL:g}); worst leaf "
              f"{worst[4]}: card vs host f32 {worst[3]:.1e} of scale, {worst[0]:.1e} beyond the "
              f"host's own f32 error (limit {ZOO_STEP_LEAF_TOL:g}); to f64: card {worst[1]:.1e}, "
              f"host {worst[2]:.1e}; launches {counts}; {time.perf_counter() - t0:.1f} s")
        if missing or not loss_rel <= ZOO_STEP_LOSS_RTOL or not worst[0] <= ZOO_STEP_LEAF_TOL:
            raise AssertionError(f"zoo train step {label}: loss {loss_rel:.2e} relative, leaf "
                                 f"{worst[4]} {worst[0]:.2e} of scale beyond the host's f32 "
                                 f"error, kernels never launched {missing}")
    return rows


def zoo_train_phase(dev) -> dict:
    """The zoo's training on the card: the backward kernels' checks, then
    zamba2-1.2b at full width and depth in bf16 through
    ``launch.train.train_arch`` (B=4 x 512, ZOO_TRAIN_STEPS steps, in a
    temporary working directory, where it writes its checkpoint) with exact
    launch counts, then one profiled step (the same entry's step builder,
    fresh weights) and the card-against-host agreement."""
    import argparse
    import os
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.train.optim import adamw

    t0 = time.perf_counter()
    kernels = zoo_grad_kernel_checks(dev)
    cfg = get_config(ZOO_ARCH)
    args = argparse.Namespace(paper=False, gnn="gcn", arch=ZOO_ARCH, reduced=False,
                              steps=ZOO_TRAIN_STEPS, epochs=1, batch=ZOO_BATCH, seq=ZOO_SEQ,
                              lr=3e-4, users=600, rings=6, seed=0, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _build.reset_launches()
            out = launch_train.train_arch(args)
            counts = dict(_build.LAUNCHES)
            ckpt_mb = os.path.getsize(out["checkpoint"]) / 2**20
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_attn = cfg.num_layers // cfg.attn_every
    expected = dict.fromkeys(counts, 0)
    expected.update(flash_attention=n_attn * args.steps, flash_attention_bwd=n_attn * args.steps,
                    ssd_scan=cfg.num_layers * args.steps,
                    ssd_scan_bwd=cfg.num_layers * args.steps,
                    rope=2 * n_attn * args.steps, rope_bwd=2 * n_attn * args.steps)
    if counts != expected:
        raise AssertionError(f"zoo train: launches {counts}, expected {expected}")
    if not all(np.isfinite(out["loss"] + out["grad_norm"])):
        raise AssertionError(f"zoo train: losses {out['loss']}, norms {out['grad_norm']}")
    step_ms = [t * 1e3 for t in out["step_s"]]
    row = dict(arch=ZOO_ARCH, dtype=cfg.dtype, layers=cfg.num_layers, batch=args.batch,
               seq=args.seq, steps=args.steps, loss=out["loss"], grad_norm=out["grad_norm"],
               lr=out["lr"], step_ms=step_ms, median_step_ms=float(np.median(step_ms[1:])),
               tokens_per_s=args.batch * args.seq / float(np.median(step_ms[1:])) * 1e3,
               peak_gib=peak, checkpoint_mib=ckpt_mb, launches=counts)
    print(f"zoo train {ZOO_ARCH} {cfg.dtype} full width and depth ({cfg.num_layers} Mamba2 "
          f"+ {n_attn} shared attention) B={args.batch} S={args.seq}, {args.steps} steps "
          f"through launch.train.train_arch: {row['median_step_ms']:.1f} ms a synchronized "
          f"step (median of steps 2-{args.steps}; the first {step_ms[0]:.1f} ms), "
          f"{row['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB, losses "
          + " ".join(f"{v:.4f}" for v in out["loss"])
          + f", grad norms {out['grad_norm'][0]:.3f}..{out['grad_norm'][-1]:.3f}, checkpoint "
          f"{ckpt_mb:.0f} MiB, launches {counts}")

    # where a step's time goes: the same step builder on fresh weights
    params = init_params(torch.Generator(device=dev).manual_seed(1), cfg, device=dev)
    opt = adamw(args.lr)[0](params)
    step = make_train_step(cfg, use_remat=False, lr=args.lr)
    batch = launch_train.arch_batch(cfg, args.batch, args.seq, np.random.default_rng(1), dev)
    state = {"params": params, "opt": opt}

    def run_step():
        state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)

    run_step()
    wall, busy, top, n = profiled(run_step, also=("flash_attention_bwd", "ssd_scan_bwd"))
    row.update(step_profiled_ms=wall * 1e3, step_busy_share=busy, step_top=top,
               step_kernels=n)
    del params, opt, state, batch
    torch.cuda.empty_cache()
    print(f"zoo train {ZOO_ARCH} card busy: {busy:.1%} of {wall * 1e3:.1f} ms a step "
          f"({n} kernels) (profiled); top: " + "; ".join(f"{k} {ms:.2f} ms" for k, ms in top))
    agreement = zoo_step_agreement(dev)
    seconds = time.perf_counter() - t0
    print(f"zoo train phase: {seconds:.1f} s")
    return dict(kernels=kernels, row=row, agreement=agreement, launches=counts,
                seconds=seconds)


def _dryrun_records(pool_result) -> list:
    """The dry-run's 16x16 records (from the spawned processes), printed."""
    records = pool_result.get(timeout=900)
    for rec in records:
        if rec["status"] == "skip":
            print(f"dryrun {rec['arch']} {rec['shape']} 16x16: skipped ({rec['reason']})")
            continue
        coll = rec["coll_detail"]
        kinds = ", ".join(f"{k} {coll['counts'][k]}x {coll['bytes'][k] / 1e9:.3f} GB"
                          for k in coll["bytes"] if coll["counts"][k])
        print(f"dryrun {rec['arch']} {rec['shape']} 16x16 (the dry-run's model, on the "
              f"host CPU; H100 constants): {rec['hlo_gflops'] / 1e6:.3f} PFLOP, "
              f"{rec['hlo_gbytes'] / 1e3:.3f} TB unfused, collectives per card "
              f"{kinds or 'none'}, per-device arguments "
              f"{rec['bytes_per_device']['argument_size_in_bytes'] / 2**30:.3f} GiB; "
              f"t_compute {rec['t_compute'] * 1e3:.3f} ms, t_memory {rec['t_memory'] * 1e3:.3f} "
              f"ms, t_collective {rec['t_collective'] * 1e3:.3f} ms -> {rec['bottleneck']} "
              f"(traced in {rec['t_trace_s']:.1f} s)")
    return records


def _host_record(cfg, shape, **kw) -> dict:
    """The dry-run's record of ``cfg``'s step on the one-device meta mesh
    (the card's shapes): its cost and per-device bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import analyze

    cost, mem, _ = dryrun.count_step(cfg, make_host_mesh("meta"), shape, **kw)
    rec = analyze(cfg, shape, "host", 1, cost, memory_stats=mem)
    return {"t_compute": rec.t_compute, "model_flops": rec.model_gflops * 1e9,
            "flops": cost["flops"], "args_bytes": mem["argument_size_in_bytes"]}


def _dryrun_card_row(name, host, args, seconds, steps, card, launches) -> dict:
    """One card run of a step builder beside its dry-run: the argument bytes
    (exactly), the measured time against t_compute and the model FLOPs."""
    from repro_torch.params import tree_leaves

    allocated = sum(t.numel() * t.element_size() for t in tree_leaves(list(args))
                    if isinstance(t, torch.Tensor))
    if allocated != host["args_bytes"]:
        raise AssertionError(f"dryrun {name}: the dry-run's arguments are {host['args_bytes']} "
                             f"bytes, the card's tensors {allocated}")
    per_step = seconds / steps
    mfu = host["model_flops"] / (per_step * H100_PEAK_BF16)
    peak = torch.cuda.max_memory_allocated()
    print(f"dryrun host {name}: arguments {allocated} B on the card = {host['args_bytes']} B in "
          f"the dry-run (max_memory_allocated {peak / 2**30:.2f} GiB); the dry-run's t_compute "
          f"{host['t_compute'] * 1e3:.3f} ms, measured {per_step * 1e3:.3f} ms a step, "
          f"model_flops / (measured x 989.4e12) = {mfu:.4f} on {card}; launches {launches}")
    return dict(args_bytes=allocated, dryrun_args_bytes=host["args_bytes"],
                peak_bytes=peak, t_compute_ms=host["t_compute"] * 1e3,
                measured_ms=per_step * 1e3, model_flops=host["model_flops"],
                counted_flops=host["flops"], mfu=mfu, launches=launches)


def _equal_trees(a, b, what: str) -> None:
    from repro_torch.params import tree_leaves

    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        if not same:
            raise AssertionError(f"dryrun {what}: not bit for bit")


def _grow_cache(cfg, cache, batch: int, max_len: int, dev):
    """A prefill's cache of the prompt's length copied into a zero cache of
    ``max_len`` slots, as ``prefill`` merges its own."""
    from repro_torch.models import init_cache
    from repro_torch.params import tree_map

    def one(dst, src):
        if dst.shape == src.shape:
            return src
        dst[..., :src.shape[-2], :] = src
        return dst

    full = init_cache(cfg, batch, max_len, device=dev)
    return {k: v if k == "pos" else tree_map(one, full[k], v) for k, v in cache.items()}


def dryrun_phase(dev) -> dict:
    """The zoo's dry-run tools (``repro_torch.launch.{mesh,steps,roofline,
    dryrun}``).  On the card, the step builders over the one-device host
    mesh (``make_step``): granite-3-2b's prefill of 4 x 512 and 32 decode
    steps, and zamba2-1.2b's train step at 4 x 512, each bit for bit
    against the one-card entry points on the same inputs (``serve()``, as
    ``serve_row`` runs it, ``prefill``/``decode_step``, and
    ``make_train_step`` as ``zoo_train_phase``'s ``train_arch`` builds it),
    with exact launch counts; each beside the dry-run's record of the same
    step on the one-device mesh: argument bytes equal to the card's
    tensors' exactly, and its t_compute beside the measured time.  Then,
    in DRYRUN_WORKERS spawned processes (the dry-run uses no device; this
    machine is only where it runs), the records of granite-3-2b and
    zamba2-1.2b at all four shapes on the 16x16 fake mesh, at full width
    and depth."""
    import functools
    import logging
    import multiprocessing

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve, serve_inputs
    from repro_torch.launch.steps import make_step, make_train_step
    from repro_torch.launch.train import arch_batch
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.config import INPUT_SHAPES, InputShape
    from repro_torch.train.optim import adamw

    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    rows = {}
    mesh = make_host_mesh(dev)

    # granite-3-2b: prefill 4 x 512, then 32 greedy decode steps
    cfg = get_config("granite-3-2b")
    b, s, t = ZOO_BATCH, ZOO_SEQ, ZOO_TOKENS
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    prompts, extra = serve_inputs(cfg, b, s, 0, device=dev)
    p_shape, d_shape = InputShape("prefill", s, b, "prefill"), InputShape("decode", s + t, b,
                                                                          "decode")
    prefill_fn, _ = make_step(cfg, mesh, p_shape)
    serve_fn, _ = make_step(cfg, mesh, d_shape)
    # the step's token ids are int32, as the reference's specs (serve() takes
    # the int64 draws; the embedding lookup reads either alike)
    batch = {"tokens": prompts.to(torch.int32), **extra}
    prefill_fn(params, batch)            # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t1 = time.perf_counter()
    logits, cache = prefill_fn(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launches != {"flash_attention": cfg.num_layers, "rope": 2 * cfg.num_layers}:
        raise AssertionError(f"dryrun granite prefill: launches {launches}")
    rows["granite_prefill"] = _dryrun_card_row(
        f"granite-3-2b prefill B={b} S={s}", _host_record(cfg, p_shape),
        (params, batch), prefill_s, 1, card, launches)
    with torch.no_grad():
        want_logits, want_cache = prefill(params, cfg, prompts, s + t, extra)
    _equal_trees(logits, want_logits, "granite prefill logits")
    cache = _grow_cache(cfg, cache, b, s + t, dev)
    _equal_trees(cache, want_cache, "granite prefill cache")
    tok = logits.argmax(-1).to(torch.int32)
    dec_args, ids, steps, step_s = (params, tok, cache), [tok], [], 0.0
    _build.reset_launches()
    for _ in range(t):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = serve_fn(params, tok, cache)
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t1
        tok = logits.argmax(-1).to(torch.int32)
        steps.append(logits)
        ids.append(tok)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if launches != {"gqa_decode": cfg.num_layers * t, "rope": 2 * cfg.num_layers * t}:
        raise AssertionError(f"dryrun granite decode: launches {launches}")
    want_tok = want_logits.argmax(-1)
    with torch.no_grad():
        for i in range(t):
            want_logits, want_cache = decode_step(params, cfg, want_tok, want_cache)
            _equal_trees(steps[i], want_logits, f"granite decode step {i} logits")
            want_tok = want_logits.argmax(-1)
    _equal_trees(cache, want_cache, "granite decode cache")
    served = serve(cfg, b, s, t, seed=0, device=dev)
    if not torch.equal(torch.stack(ids, 1).cpu().long(), served["token_ids"]):
        raise AssertionError("dryrun granite: token ids differ from serve()'s")
    rows["granite_decode"] = _dryrun_card_row(
        f"granite-3-2b decode B={b} over {s + t} slots, {t} steps",
        _host_record(cfg, d_shape), dec_args, step_s, t, card, launches)
    del params, cache, want_cache, dec_args, served, steps
    torch.cuda.empty_cache()

    # zamba2-1.2b: one train step at 4 x 512, as the zoo-train phase's
    cfg = get_config(ZOO_ARCH)
    shape = InputShape("train", s, b, "train")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    opt = adamw(3e-4)[0](params)
    batch = arch_batch(cfg, b, s, np.random.default_rng(0), dev)
    train_fn, _ = make_step(cfg, mesh, shape, use_remat=False)
    # the steps with PyTorch's deterministic algorithms (the embedding's
    # gradient sums repeated token rows), so that two runs can agree bit
    # for bit; the hand-written kernels have no atomics either way
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    train_fn(params, opt, batch)         # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t1 = time.perf_counter()
    got = train_fn(params, opt, batch)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    n_attn = cfg.num_layers // cfg.attn_every
    if launches != {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
                    "ssd_scan": cfg.num_layers, "ssd_scan_bwd": cfg.num_layers,
                    "rope": 2 * n_attn, "rope_bwd": 2 * n_attn}:
        raise AssertionError(f"dryrun zamba2 train: launches {launches}")
    rows["zamba2_train"] = _dryrun_card_row(
        f"zamba2-1.2b train B={b} S={s}", _host_record(cfg, shape, use_remat=False),
        (params, opt, batch), train_s, 1, card, launches)
    want = make_train_step(cfg, use_remat=False, lr=3e-4)(params, opt, batch)
    torch.use_deterministic_algorithms(deterministic)
    _equal_trees(got, want, "zamba2 train step")
    print(f"dryrun host: the three steps through make_step equal the one-card entry "
          f"points bit for bit (zamba2 loss {float(got[2]['loss']):.6f})")
    del params, opt, got, want
    torch.cuda.empty_cache()

    # the 16x16 records, after the card's runs (whose host clocks the
    # processes would otherwise share), the longest first
    order = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    tasks = [(arch, shape, "single") for shape in order for arch in DRYRUN_ARCHS]
    pool = multiprocessing.get_context("spawn").Pool(
        DRYRUN_WORKERS, initializer=logging.disable, initargs=(logging.WARNING,))
    try:
        records = _dryrun_records(pool.starmap_async(
            functools.partial(dryrun.run_one, save=False, extrapolate=False), tasks))
    finally:
        pool.close()
        pool.join()
    # granite-3-2b is pure full attention: long_500k is skipped, as the reference's
    status = {(r["arch"], r["shape"]): r["status"] for r in records}
    if status != {task[:2]: "skip" if task[:2] == ("granite-3-2b", "long_500k") else "ok"
                  for task in tasks}:
        raise AssertionError(f"dryrun: records {status}")
    launches = {}
    for row in rows.values():
        for name, c in row["launches"].items():
            launches[name] = launches.get(name, 0) + c
    seconds = time.perf_counter() - t0
    print(f"dryrun phase: {seconds:.1f} s")
    return dict(records=records, card=rows, launches=launches, seconds=seconds,
                shapes=list(INPUT_SHAPES))


def _timed(obj, name: str, log: list) -> None:
    """Wrap ``obj.name`` so that each call appends its host-clock seconds to
    ``log`` (two clock reads a call)."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            log.append(time.perf_counter() - t0)

    setattr(obj, name, wrapper)


def _store_contents(store) -> dict:
    """key -> (value bytes, model version) of every entry of every shard (of
    an inline store, or gathered out of the process backend's children)."""
    return {k: (np.asarray(v).tobytes(), mv)
            for shard in store.shard_items() for k, v, _ver, _st, mv in shard}


def _host_gap(scores, host_scores, store, host_store, what: str) -> tuple[float, float]:
    """max |score| and max |embedding| gaps of the card's replay from the host's
    plain path, raising beyond STREAM_SCORE_TOL / STREAM_STORE_TOL."""
    if set(scores) != set(host_scores):
        raise AssertionError(f"{what}: the card and the host scored other orders")
    orders = sorted(scores)
    s, hs = np.asarray([scores[o] for o in orders]), np.asarray([host_scores[o] for o in orders])
    c, hc = _store_contents(store), _store_contents(host_store)
    if set(c) != set(hc):
        raise AssertionError(f"{what}: the card and the host wrote other KV keys")
    keys = sorted(c)
    v = np.stack([np.frombuffer(c[k][0], np.float32) for k in keys])
    hv = np.stack([np.frombuffer(hc[k][0], np.float32) for k in keys])
    np.testing.assert_allclose(s, hs, atol=STREAM_SCORE_TOL, rtol=STREAM_SCORE_TOL,
                               err_msg=f"{what}: scores, card against host")
    np.testing.assert_allclose(v, hv, atol=STREAM_STORE_TOL, rtol=STREAM_STORE_TOL,
                               err_msg=f"{what}: KV embeddings, card against host")
    if [c[k][1] for k in keys] != [hc[k][1] for k in keys]:
        raise AssertionError(f"{what}: version stamps differ between card and host")
    return float(np.abs(s - hs).max()), float(np.abs(v - hv).max())


def stage1_scope_rows(params, cfg, ingester, dev) -> dict:
    """Stage 1 on one bin of communities (the first ones by id, up to 2,048
    nodes, padded to its pow2) and on the whole graph (padded to its pow2),
    as the refresh runs them: each entity row of the bin against the same
    entity's row of the whole graph, with the dense products as
    ``torch.matmul`` and as ``core.layers.row_stable_matmul``.  Returns
    ``{mm: (rows that differ, rows, max |d|)}``."""
    from repro_torch.core import lnn_stage1, pad_graph
    from repro_torch.core.layers import row_stable_matmul

    def pow2(n):
        b = 64
        while b < n:
            b *= 2
        return b

    part = ingester.partitioner
    picked, nodes = [], 0
    for c in sorted({part.community_of(e) for e in part.assignment()}):
        if picked and nodes + ingester.community_node_count(c) > 2048:
            break
        picked.append(c)
        nodes += ingester.community_node_count(c)
    sub, whole = ingester.materialize_communities(picked), ingester.materialize()
    g_sub = pad_graph(sub.coo, num_nodes=pow2(sub.coo.num_nodes), max_deg=32).to(dev)
    g_whole = pad_graph(whole.coo, num_nodes=pow2(whole.coo.num_nodes), max_deg=32).to(dev)
    rows = [(i, whole.entity_snap_ids[pair]) for pair, i in sub.entity_snap_ids.items()]
    out = {}
    for name, mm in (("torch.matmul", torch.matmul), ("row_stable_matmul", row_stable_matmul)):
        with torch.no_grad():
            h_sub = lnn_stage1(params, cfg, g_sub, mm=mm).cpu().numpy()
            h_whole = lnn_stage1(params, cfg, g_whole, mm=mm).cpu().numpy()
        d = np.abs(h_sub[[i for i, _ in rows]] - h_whole[[j for _, j in rows]]).max(-1)
        out[name] = (int((d > 0).sum()), len(rows), float(d.max()))
    out["bin_nodes"], out["whole_nodes"] = g_sub.num_nodes, g_whole.num_nodes
    return out


def stream_kernel_cases(dev, graph, floor_ms: float) -> dict:
    """The three kernels of the streaming path at its own shapes: ``csr_spmm``
    (both entries) and ``edge_softmax`` on one full stage-1 bin of the
    stream (``graph``, on the card), ``stage2_score`` at the B=2 bucket
    (timed, with bounds, against the plain version; its rows against the
    same rows in a B=16 launch, bit for bit) and, typed, at every bucket."""
    from repro_torch.core import LNNConfig, lnn_init
    from repro_torch.core.hetero import ENTITY_TYPE_NAMES
    from repro_torch.kernels import ref
    from repro_torch.kernels.csr_spmm import csr_spmm_cuda, csr_spmm_etype_mean_cuda
    from repro_torch.kernels.edge_softmax import edge_softmax_agg_cuda
    from repro_torch.kernels.stage2_score import flatten_stage2_params

    gen = torch.Generator().manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    n, deg, hdim = graph.num_nodes, graph.max_deg, 64
    mask = (graph.nbr_mask * (graph.nbr_etype != 3)).contiguous()    # stage 1's slots
    w_mean = mask / mask.sum(-1, keepdim=True).clamp_min(1.0)
    nnz = int((w_mean != 0).sum())
    shape = f"N={n} D={deg} H={hdim} float32 (streaming bin, {nnz} valid slots)"
    h = randn(n, hdim)
    cases = {}
    rows_i = torch.arange(n, device=dev)[:, None].expand(n, deg)
    keep = w_mean != 0
    sparse = torch.sparse_coo_tensor(torch.stack([rows_i[keep], graph.nbr_idx.long()[keep]]),
                                     w_mean[keep], (n, n)).coalesce().to_sparse_csr()
    b_ms, b_by = bound(2 * n * hdim * 4 + 2 * n * deg * 4, 2 * nnz * hdim)
    cases["csr_spmm"] = dict(
        shape=shape, max_abs_err=compare(csr_spmm_cuda(h, graph.nbr_idx, w_mean),
                                         ref.csr_spmm_ref(h, graph.nbr_idx, w_mean), "float32"),
        ms=time_ms(lambda: csr_spmm_cuda(h, graph.nbr_idx, w_mean)),
        plain_ms=time_ms(lambda: ref.csr_spmm_ref(h, graph.nbr_idx, w_mean)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: torch.sparse.mm(sparse, h)),
        launch_floor_ms=floor_ms)
    et = graph.nbr_etype
    args_t = (h, graph.nbr_idx, mask, et)
    valid = int(((mask != 0) & (et >= 0) & (et < 4)).sum())
    b_ms, b_by = bound(3 * n * deg * 4 + n * hdim * 4 + 4 * n * hdim * 4, 2 * valid * hdim)
    cases["csr_spmm_etype_mean"] = dict(
        shape=f"N={n} D={deg} H={hdim} E=4 float32 (streaming bin)",
        max_abs_err=compare(csr_spmm_etype_mean_cuda(*args_t, 4),
                            ref.csr_spmm_etype_mean_ref(*args_t, 4), "float32"),
        ms=time_ms(lambda: csr_spmm_etype_mean_cuda(*args_t, 4)),
        plain_ms=time_ms(lambda: ref.csr_spmm_etype_mean_ref(*args_t, 4)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    z, s_src, s_dst = randn(n, hdim), randn(n), randn(n)
    args = (z, s_src, s_dst, graph.nbr_idx, mask, (randn(n, deg) * 0.1).contiguous())
    b_ms, b_by = bound(2 * n * hdim * 4 + 2 * n * 4 + 3 * n * deg * 4, nnz * (2 * hdim + 8))
    cases["edge_softmax"] = dict(
        shape=shape, max_abs_err=compare(edge_softmax_agg_cuda(*args),
                                         ref.edge_softmax_agg_ref(*args), "float32"),
        ms=time_ms(lambda: edge_softmax_agg_cuda(*args)),
        plain_ms=time_ms(lambda: ref.edge_softmax_agg_ref(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, launch_floor_ms=floor_ms)

    # stage2_score at the smallest bucket, lnn_fraud's widths, F=12
    k, f, b = 8, 12, 2
    cfg = LNNConfig(gnn_type="gcn", num_gnn_layers=3, hidden_dim=hdim, mlp_dims=(64, 32),
                    feat_dim=f)
    params = lnn_init(torch.Generator().manual_seed(7), cfg, device=dev)
    flat = flatten_stage2_params(params, "gcn")
    call, _ = stage2_launcher(flat, "gcn", False)
    mask16 = (torch.rand(16, k, generator=gen) < 0.7).float()
    mask16[1] = 0.0                                       # a cold-start row
    mask16 = mask16.to(dev)
    emb16 = (randn(16, k, hdim) * mask16[..., None]).contiguous()
    feats16 = randn(16, f)
    emb, msk, feats = emb16[:b].contiguous(), mask16[:b].contiguous(), feats16[:b].contiguous()
    out = call(emb, msk, feats, None)
    wbytes = sum(x.numel() * 4 for x in flat)
    dims = (hdim + f, 64, 32, 1)
    per_row = f * hdim + 2 * hdim * hdim + sum(a * c for a, c in zip(dims, dims[1:]))
    per_row += 2 * hdim * hdim + k * hdim
    b_ms, b_by = bound(4 * (b * k * hdim + b * k + b * f + b) + wbytes, 2 * b * per_row)
    same = torch.equal(call(emb16, mask16, feats16, None)[:b], out)
    cases["stage2_score"] = dict(
        shape=f"gcn untyped B={b} K={k} H={hdim} F={f}",
        max_abs_err=compare(out, ref.stage2_score_ref(emb, msk, feats, flat, "gcn"), "float32"),
        ms=time_ms(lambda: call(emb, msk, feats, None)),
        plain_ms=time_ms(lambda: ref.stage2_score_ref(emb, msk, feats, flat, "gcn")),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, launch_floor_ms=floor_ms,
        same_bits_as_b16=same)
    if not same:
        raise AssertionError("stage2_score: B=2 rows differ from the same rows at B=16")

    # typed GAT, the attack stream's model, at every bucket, with untagged slots
    cfg_t = LNNConfig(gnn_type="gat", num_gnn_layers=3, hidden_dim=hdim, mlp_dims=(64, 32),
                      feat_dim=f, entity_types=ENTITY_TYPE_NAMES)
    params_t = lnn_init(torch.Generator().manual_seed(8), cfg_t, device=dev)
    flat_t = flatten_stage2_params(params_t, "gat")
    call_t, _ = stage2_launcher(flat_t, "gat", True)
    typed_errs = {}
    for bb in (2, 4, 8, 16):
        st = torch.randint(-1, len(ENTITY_TYPE_NAMES), (bb, k), generator=gen,
                           dtype=torch.int32)
        st[0] = -1                                     # every slot untagged
        st = st.to(dev)
        args2 = (emb16[:bb].contiguous(), mask16[:bb].contiguous(), feats16[:bb].contiguous())
        typed_errs[bb] = compare(call_t(*args2, st),
                                 ref.stage2_score_ref(*args2, flat_t, "gat", st), "float32")
    cases["stage2_score_typed"] = dict(shape=f"gat typed T=4 K={k} H={hdim} F={f}",
                                       max_abs_err_by_bucket=typed_errs)
    for name in ("csr_spmm", "csr_spmm_etype_mean", "edge_softmax", "stage2_score"):
        c = cases[name]
        print(f"stream {name:<19} {c['shape']:<44} max|d|={c['max_abs_err']:.2e} "
              f"kernel {c['ms'] * 1e3:8.2f} us  plain {c['plain_ms'] * 1e3:8.2f} us  "
              f"bound {c['bound_ms'] * 1e3:6.3f} us ({c['bound_by']})  floor "
              f"{floor_ms * 1e3:5.2f} us"
              + (f"  torch.sparse.mm {c['library_ms'] * 1e3:8.2f} us"
                 if c["library_ms"] is not None else "")
              + ("  B=16 rows: same bits" if name == "stage2_score" else ""))
    print(f"stream stage2_score {cases['stage2_score_typed']['shape']}: max|d| by bucket "
          + ", ".join(f"B={bb} {e:.2e}" for bb, e in typed_errs.items()))
    return cases


def stream_phase(dev) -> dict:
    """The streaming engine (``repro_torch.stream``) at the fraud slice's world
    as a stream: a full replay per GNN type with the launch counters zeroed
    just before and read just after, where its time goes, then the
    bit-identity and agreement checks on the stream's first events, the
    typed attack stream, and the kernels at the stream's shapes."""
    from repro_torch.core import ENTITY_TYPE_NAMES, LNNConfig, lnn_forward, lnn_init, pad_graph
    from repro_torch.data import (AttackConfig, SynthConfig, generate_attack_stream,
                                  generate_event_stream)
    from repro_torch.kernels import _build
    from repro_torch.params import from_numpy, to_numpy
    from repro_torch.serve import host_sigmoid
    from repro_torch.stream import EngineConfig, StreamingEngine

    t_phase = time.perf_counter()
    events, static, _ = generate_event_stream(
        SynthConfig(num_users=3000, num_rings=50, feature_noise=0.8, seed=1),
        rate_per_s=STREAM_RATE)
    feat_dim = static.order_features.shape[1]
    head = events[:STREAM_CHECK_EVENTS]
    tiny = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: tiny.zero_())
    launches = {name: 0 for name in _build.LAUNCHES}
    rows, full_bin = [], {}
    for gnn in ("gcn", "gat", "sage"):
        cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                        feat_dim=feat_dim, pos_weight=3.0)
        params = lnn_init(torch.Generator().manual_seed(1), cfg, device=dev)
        agg = "edge_softmax" if gnn == "gat" else "csr_spmm"

        # ---- the full replay, counted and timed
        eng = StreamingEngine(params, cfg, EngineConfig())
        eng.warmup()
        t_ingest, t_refresh, t_stage1, t_lookup, t_stage2 = [], [], [], [], []
        _timed(eng.ingester, "ingest", t_ingest)
        _timed(eng.refresher, "on_windows_closed", t_refresh)
        _timed(eng.store, "lookup_batch_versioned", t_lookup)
        _timed(eng.pool.workers[0].scorer, "_score", t_stage2)
        run_stage1 = eng.refresher._run_stage1

        def stage1(pgs, *args, _run=run_stage1):
            if "graph" not in full_bin:
                full_bin.update(graph=next((pg for pg in pgs if pg.num_nodes == 4096), None))
                if full_bin["graph"] is None:
                    del full_bin["graph"]
            t0 = time.perf_counter()
            try:
                return _run(pgs, *args)
            finally:
                t_stage1.append(time.perf_counter() - t0)

        eng.refresher._run_stage1 = stage1
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rep = eng.replay(events, warmup=False)
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        summary = rep.summary()
        st = eng.refresher.stats
        if len(rep.results) != len(events):
            raise AssertionError(f"stream {gnn}: {len(rep.results)} results for "
                                 f"{len(events)} events")
        scores = np.asarray([r.score for r in rep.results])
        if not (np.all(np.isfinite(scores)) and np.all((scores >= 0) & (scores <= 1))):
            raise AssertionError(f"stream {gnn}: scores not finite probabilities")
        for name in ("stage2_score", agg):
            if counts[name] == 0:
                raise AssertionError(f"stream {gnn}: kernel {name} was never launched")
        if counts["stage2_score"] != summary["flushes"]:
            raise AssertionError(f"stream {gnn}: stage2_score launched {counts['stage2_score']} "
                                 f"times for {summary['flushes']} flushes")
        per_call = cfg.num_gnn_layers - 1
        if counts[agg] != st["stage1_launches"] * per_call:
            raise AssertionError(f"stream {gnn}: {agg} launched {counts[agg]} times for "
                                 f"{st['stage1_launches']} stage-1 calls x {per_call}")
        for name, c in counts.items():
            launches[name] += c
        pct = rep.percentiles_ms()
        row = dict(
            gnn=gnn, events=len(events), wall_s=wall, events_per_s=len(events) / wall,
            latency_ms=pct, mean_service_ms=summary["mean_service_ms"],
            flushes=summary["flushes"], size_flushes=summary["size_flushes"],
            deadline_flushes=summary["deadline_flushes"], mean_batch=summary["mean_batch"],
            refreshes=st["refreshes"], stage1_launches=st["stage1_launches"],
            nodes_padded=st["nodes_padded"], communities_refreshed=st["communities_refreshed"],
            refresher_s=st["seconds"], entities_written=st["entities_written"],
            store_size=len(eng.store), store_misses=eng.store.stats["misses"],
            staleness=rep.staleness_summary(), launches=counts,
            ingest_s=float(np.sum(t_ingest)), refresh_s=float(np.sum(t_refresh)),
            stage1_calls_s=float(np.sum(t_stage1)), kv_lookup_s=float(np.sum(t_lookup)),
            stage2_call_s=float(np.sum(t_stage2)),
            kv_lookup_ms_median=float(np.median(t_lookup)) * 1e3,
            stage2_call_ms_median=float(np.median(t_stage2)) * 1e3)
        row["other_s"] = wall - sum(row[k] for k in ("ingest_s", "refresh_s", "kv_lookup_s",
                                                     "stage2_call_s"))
        print(f"stream {gnn}: {len(events)} events in {wall:.3f} s ({row['events_per_s']:.1f} "
              f"events/s, wall), latency p50 {pct['p50']:.3f} p95 {pct['p95']:.3f} p99 "
              f"{pct['p99']:.3f} ms (virtual queue wait + measured service), service mean "
              f"{row['mean_service_ms']:.3f} ms, {row['flushes']} flushes ({row['size_flushes']} "
              f"size / {row['deadline_flushes']} deadline), mean batch {row['mean_batch']:.2f}; "
              f"{row['refreshes']} refreshes, {row['stage1_launches']} stage-1 calls, "
              f"{row['nodes_padded']} nodes padded, refresher {row['refresher_s']:.3f} s; store "
              f"{row['store_size']} entries, {row['store_misses']} misses; staleness "
              f"{row['staleness']}; launches {counts}")
        print(f"stream {gnn} time: ingest {row['ingest_s']:.3f} s, refresh {row['refresh_s']:.3f} "
              f"s (stage-1 calls {row['stage1_calls_s']:.3f} s), KV lookup {row['kv_lookup_s']:.3f}"
              f" s ({row['kv_lookup_ms_median']:.3f} ms median a flush), stage-2 call "
              f"{row['stage2_call_s']:.3f} s ({row['stage2_call_ms_median']:.3f} ms median a "
              f"flush), other {row['other_s']:.3f} s")

        # ---- the ladder on the stream's first events
        base = StreamingEngine(params, cfg, EngineConfig())
        got = {}
        with torch.no_grad():
            wall_p, busy, top, n_kernels = profiled(lambda: got.update(rep=base.replay(head)))
        rep1 = got["rep"]
        s1, c1 = rep1.scores_by_order(), _store_contents(base.store)
        eng4 = StreamingEngine(params, cfg, EngineConfig(num_workers=4))
        rep4 = eng4.replay(head)
        served = sum(1 for w in rep4.summary()["workers"] if w["requests"] > 0)
        if rep4.scores_by_order() != s1 or served < 2:
            raise AssertionError(f"stream {gnn}: N=4 scores differ from N=1 "
                                 f"({served} workers served)")
        whole = StreamingEngine(params, cfg, EngineConfig(community_local=False))
        rep_w = whole.replay(head)
        c_w = _store_contents(whole.store)
        if c_w != c1 or rep_w.scores_by_order() != s1:
            diff = [k for k in c1 if c_w.get(k) != c1[k]]
            worst = max((float(np.abs(np.frombuffer(c1[k][0], np.float32)
                                      - np.frombuffer(c_w[k][0], np.float32)).max())
                         for k in diff if k in c_w), default=float("nan"))
            raise AssertionError(f"stream {gnn}: community-local and whole-graph refresh "
                                 f"differ in {len(diff)} of {len(c1)} KV entries (max|d| "
                                 f"{worst:.3e})")
        asy = StreamingEngine(params, cfg, EngineConfig(async_refresh=True))
        asy.warmup()
        torch.cuda.synchronize()
        _build.reset_launches()
        rep_a = asy.replay(head, warmup=False)
        asy.close()
        a_counts = dict(_build.LAUNCHES)
        a_st = asy.refresher.stats
        if (a_counts["stage2_score"] != rep_a.summary()["flushes"]
                or a_counts[agg] != a_st["stage1_launches"] * per_call):
            raise AssertionError(f"stream {gnn} async: launches {a_counts} for "
                                 f"{rep_a.summary()['flushes']} flushes and "
                                 f"{a_st['stage1_launches']} stage-1 calls")
        if _store_contents(asy.store) != c1:
            raise AssertionError(f"stream {gnn}: the async refresh drained to other bytes")
        pg = pad_graph(base.ingester.materialize().coo, max_deg=32).to(dev)
        with torch.no_grad():
            full = host_sigmoid(lnn_forward(params, cfg, pg).cpu().numpy())
        mono = max(abs(s1[ev.order_id] - float(full[i])) for i, ev in enumerate(head))
        if not (mono <= EQUIV_ATOL and rep1.staleness_summary()["max"] == 0
                and base.store.stats["misses"] == 0):
            raise AssertionError(f"stream {gnn}: replay against the monolithic forward "
                                 f"{mono:.3e} (limit {EQUIV_ATOL}), staleness "
                                 f"{rep1.staleness_summary()}, misses "
                                 f"{base.store.stats['misses']}")
        scope = stage1_scope_rows(params, cfg, base.ingester, dev)
        if scope["row_stable_matmul"][0]:
            raise AssertionError(f"stream {gnn}: stage-1 rows of a bin differ from the whole "
                                 f"graph's: {scope}")
        host = StreamingEngine(from_numpy(to_numpy(params), "cpu"), cfg, EngineConfig(),
                               device="cpu")
        score_gap, store_gap = _host_gap(s1, host.replay(head).scores_by_order(), base.store,
                                         host.store, f"stream {gnn}")
        row.update(check_events=len(head), workers_served=served, kv_entries=len(c1),
                   stage1_scope_rows=scope,
                   monolithic_gap=mono, host_score_gap=score_gap, host_store_gap=store_gap,
                   async_launches=a_counts, head_profiled_s=wall_p, head_busy_share=busy,
                   head_top=top, head_kernels=n_kernels)
        rows.append(row)
        print(f"stream {gnn} checks on the first {len(head)} events: N=4 == N=1 bit for bit "
              f"({served} workers served); community-local == whole-graph: {len(c1)} KV "
              f"entries, bytes and stamps, and every score; async == sync store bytes, "
              f"launches exact ({a_counts['stage2_score']} stage2_score, {a_counts[agg]} {agg}); "
              f"monolithic forward max|d| {mono:.2e} (limit {EQUIV_ATOL}); host plain path: "
              f"scores max|d| {score_gap:.2e} (limit {STREAM_SCORE_TOL}), KV max|d| "
              f"{store_gap:.2e} (limit {STREAM_STORE_TOL}); card busy {busy:.1%} of "
              f"{wall_p:.3f} s ({n_kernels} kernels, profiled)")
        print(f"stream {gnn} stage-1 rows, a bin of {scope['bin_nodes']} nodes against the "
              f"whole graph of {scope['whole_nodes']}: "
              + "; ".join(f"{mm} {scope[mm][0]} of {scope[mm][1]} entity rows differ (max|d| "
                          f"{scope[mm][2]:.2e})" for mm in ("torch.matmul", "row_stable_matmul")))
        print(f"stream {gnn} top device time over the {len(head)} events: "
              + "; ".join(f"{name} {ms:.3f} ms" for name, ms in top))

    # ---- the typed attack stream, once
    ev_a, _ = generate_attack_stream(AttackConfig(), rate_per_s=STREAM_RATE)
    cfg_t = LNNConfig(gnn_type="gat", num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                      feat_dim=feat_dim, pos_weight=3.0, entity_types=ENTITY_TYPE_NAMES)
    params_t = lnn_init(torch.Generator().manual_seed(2), cfg_t, device=dev)
    typed1 = StreamingEngine(params_t, cfg_t, EngineConfig())
    s_t1 = typed1.replay(ev_a).scores_by_order()
    rep_t4 = StreamingEngine(params_t, cfg_t, EngineConfig(num_workers=4)).replay(ev_a)
    if rep_t4.scores_by_order() != s_t1:
        raise AssertionError("stream typed gat: N=4 scores differ from N=1")
    host_t = StreamingEngine(from_numpy(to_numpy(params_t), "cpu"), cfg_t, EngineConfig(),
                             device="cpu")
    t_gap = _host_gap(s_t1, host_t.replay(ev_a).scores_by_order(), typed1.store,
                      host_t.store, "stream typed gat")
    typed = dict(events=len(ev_a), kv_entries=len(typed1.store),
                 workers_served=sum(1 for w in rep_t4.summary()["workers"]
                                    if w["requests"] > 0),
                 host_score_gap=t_gap[0], host_store_gap=t_gap[1])
    print(f"stream typed gat (attack stream, {len(ev_a)} events, T=4): N=4 == N=1 bit for bit "
          f"({typed['workers_served']} workers served); host plain path: scores max|d| "
          f"{t_gap[0]:.2e}, KV max|d| {t_gap[1]:.2e} ({typed['kv_entries']} entries)")

    if "graph" not in full_bin:
        raise AssertionError("stream: no stage-1 bin of 4096 nodes in the replay")
    cases = stream_kernel_cases(dev, full_bin["graph"].to(dev), floor_ms)
    seconds = time.perf_counter() - t_phase
    print(f"stream phase: {seconds:.1f} s")
    return dict(rows=rows, typed=typed, kernel_cases=cases, launches=launches,
                launch_floor_ms=floor_ms, seconds=seconds, rate_per_s=STREAM_RATE)


SERVICE_HEAD = STREAM_CHECK_EVENTS   # the crash runs replay the stream's first events
SERVICE_CHECKPOINT_AT = 500          # ... with a checkpoint after this event
SERVICE_SWAP_AT = 1000               # ... and a hot swap after this one
SERVICE_CRASH_POINTS = ("ingest.after", "flush.before_score", "refresh.before_puts",
                        "checkpoint.mid")
SHADOW_FRACTION = 0.1


def _merge(merged: dict, responses) -> dict:
    """Fold delivered responses into ``order_id -> (score, model_version)``;
    a duplicate delivery must agree bit for bit (exactly once, as an
    idempotent consumer sees it)."""
    for r in responses:
        if not r.admitted:
            continue
        oid, val = r.request.tag.order_id, (r.score, r.model_version)
        if oid in merged and merged[oid] != val:
            raise AssertionError(f"service: duplicate delivery disagrees for order {oid}: "
                                 f"{merged[oid]} vs {val}")
        merged[oid] = val
    return merged


def _drive(svc, events, start=0, *, swap=None, checkpoint_at=None, out=None, ckpt_log=None):
    """Feed ``events[start:]`` through ``svc.submit`` and drain: ``swap =
    (index, params, version)`` hot-swaps after ``events[index]``,
    ``checkpoint_at`` writes a checkpoint after that event (its seconds
    and path appended to ``ckpt_log``).  Responses land in ``out`` as they
    are delivered."""
    out = [] if out is None else out
    for i in range(start, len(events)):
        out.extend(svc.submit(events[i]))
        if swap is not None and i == swap[0]:
            svc.load_model(swap[1], version=swap[2])
        if checkpoint_at is not None and i == checkpoint_at:
            t0 = time.perf_counter()
            path = svc.checkpoint()
            if ckpt_log is not None:
                ckpt_log.append((time.perf_counter() - t0, path))
    out.extend(svc.drain())
    return out


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def service_phase(dev) -> dict:
    """The serving facade (``repro_torch.service.FraudService``) on the
    card, on the streaming cell's world: the streaming facade against a
    bare engine for gcn, gat and sage (bit for bit, exact launches, events/s
    of both, the card's busy share); the batch facade against
    ``BatchLayer``/``SpeedLayer`` (bit for bit); a hot swap to a clone and
    shadow scoring (divergence 0, a canary's alert); crash → restore →
    resume at four crash points, bit for bit, with the checkpoint's and the
    recovery's times; and the hybrid GNN -> GBDT head on the typed attack
    stream (N=4 == N=1, the embedding against the host's plain path, a
    WAL/checkpoint restore bit for bit)."""
    import tempfile

    import repro_torch.stream.workers as workers_mod
    from repro_torch.core import ENTITY_TYPE_NAMES, LNNConfig, lnn_init, lnn_stage2_embed
    from repro_torch.data import (AttackConfig, SynthConfig, build_communities,
                                  generate_attack_stream, generate_event_stream,
                                  generate_transactions, make_split_masks, standardize_features)
    from repro_torch.kernels import _build
    from repro_torch.models.hybrid import HybridModel, embed_rows, train_hybrid
    from repro_torch.params import from_numpy, to_numpy
    from repro_torch.serve import BatchLayer, KVStore, SpeedLayer, history_requests
    from repro_torch.service import FraudService, ModelSection, ServiceConfig
    from repro_torch.stream import CheckoutEvent, StreamingEngine
    from repro_torch.utils import crashpoint
    from repro_torch.utils.crashpoint import SimulatedCrash

    t_phase = time.perf_counter()
    events, static, _ = generate_event_stream(
        SynthConfig(num_users=3000, num_rings=50, feature_noise=0.8, seed=1),
        rate_per_s=STREAM_RATE)
    feat_dim = static.order_features.shape[1]
    head = events[:SERVICE_HEAD]
    launches = {name: 0 for name in _build.LAUNCHES}
    out: dict = {"events": len(events), "rate_per_s": STREAM_RATE}

    def lnn_cfg(gnn, **kw):
        return LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                         feat_dim=feat_dim, pos_weight=3.0, **kw)

    def service_cfg(cfg, **sections):
        return ServiceConfig(model=ModelSection.from_lnn_config(cfg)).replace(**sections)

    def counted(fn):
        """``fn()`` with the launch counters zeroed just before and read just
        after; returns (result, wall seconds, counts)."""
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        for name, c in counts.items():
            launches[name] += c
        return res, wall, counts

    # ---- 1. the streaming facade against a bare engine, full stream
    rows, facade_params = [], {}
    for gnn in ("gcn", "gat", "sage"):
        cfg = lnn_cfg(gnn)
        params = lnn_init(torch.Generator().manual_seed(1), cfg, device=dev)
        facade_params[gnn] = params
        agg = "edge_softmax" if gnn == "gat" else "csr_spmm"
        per_call = cfg.num_gnn_layers - 1

        def bare_run():
            bare = StreamingEngine(params, cfg, service_cfg(cfg).to_engine_config())
            bare.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bare_rep = bare.replay(events, warmup=False)
            torch.cuda.synchronize()
            return bare, bare_rep, time.perf_counter() - t0

        def facade_run():
            svc = FraudService(service_cfg(cfg), params).build().warmup()
            rep, wall, counts = counted(lambda: svc.replay(events, warmup=False))
            st = svc.stats()
            st1 = svc.engine.refresher.stats["stage1_launches"]
            if counts["stage2_score"] != st.flushes or counts[agg] != st1 * per_call:
                raise AssertionError(f"service {gnn}: launches {counts} for {st.flushes} "
                                     f"flushes and {st1} stage-1 calls x {per_call}")
            return svc, rep, wall, counts, st, st1

        # engine, facade, facade, engine: neither side always runs first
        bare, bare_rep, bare_wall = bare_run()
        svc, rep, wall, counts, st, st1 = facade_run()
        svc_b, rep_b, wall_b, _, _, _ = facade_run()
        bare_b, bare_rep_b, bare_wall_b = bare_run()
        s, s_bare = rep.scores_by_order(), bare_rep.scores_by_order()
        for what, got_s in (("facade", s), ("second facade", rep_b.scores_by_order()),
                            ("second bare engine", bare_rep_b.scores_by_order())):
            if got_s != s_bare or len(got_s) != len(events):
                diff = sum(1 for o in s_bare if got_s.get(o) != s_bare[o])
                raise AssertionError(f"service {gnn}: {what} scores differ from the bare "
                                     f"engine's in {diff} of {len(s_bare)} orders")
        c, c_bare = _store_contents(svc.store), _store_contents(bare.store)
        if c != c_bare or _store_contents(svc_b.store) != c or \
                _store_contents(bare_b.store) != c:
            raise AssertionError(f"service {gnn}: facade KV bytes differ from the bare "
                                 f"engine's ({len(c)} vs {len(c_bare)} entries)")
        del svc_b, bare_b
        pct, bare_pct = rep.percentiles_ms(), bare_rep.percentiles_ms()
        head_svc = FraudService(service_cfg(cfg), params).build().warmup()
        got = {}
        with torch.no_grad():
            wall_p, busy, top, n_kernels = profiled(
                lambda: got.update(rep=head_svc.replay(head, warmup=False)))
        if gnn == "gcn":
            out["head_scores"] = got["rep"].scores_by_order()
        # the order engine, facade, facade, engine: each side's mean of two
        ratio = (bare_wall + bare_wall_b) / (wall + wall_b)
        row = dict(gnn=gnn, wall_s=wall, events_per_s=len(events) / wall,
                   bare_wall_s=bare_wall, bare_events_per_s=len(events) / bare_wall,
                   order="engine, facade, facade, engine",
                   facade_walls_s=[wall, wall_b], bare_walls_s=[bare_wall, bare_wall_b],
                   facade_over_bare_events_per_s=ratio,
                   latency_ms=pct, bare_latency_ms=bare_pct, flushes=st.flushes,
                   refreshes=st.refreshes, stage1_launches=st1, kv_entries=len(c),
                   launches=counts, head_profiled_s=wall_p, head_busy_share=busy,
                   head_kernels=n_kernels, head_top=top)
        rows.append(row)
        print(f"service {gnn}: FraudService(streaming) {len(events)} events in {wall:.3f} s "
              f"({row['events_per_s']:.1f} events/s, wall; bare engine {bare_wall:.3f} s, "
              f"{row['bare_events_per_s']:.1f} events/s); in the order engine, facade, facade, "
              f"engine: engine {bare_wall:.3f}/{bare_wall_b:.3f} s, facade {wall:.3f}/"
              f"{wall_b:.3f} s, facade/engine events/s {ratio:.3f}; latency p50 {pct['p50']:.3f} p99 "
              f"{pct['p99']:.3f} ms (bare p50 {bare_pct['p50']:.3f} p99 {bare_pct['p99']:.3f}); "
              f"scores and {len(c)} KV entries equal to the bare engine's bit for bit; "
              f"launches {counts} ({st.flushes} flushes, {st1} stage-1 calls); card busy "
              f"{busy:.1%} of {wall_p:.3f} s over the first {len(head)} events "
              f"({n_kernels} kernels, profiled)")
    out["streaming"] = rows

    # ---- 2. the batch facade against BatchLayer / SpeedLayer
    static_b, _ = generate_transactions(SynthConfig(num_users=3000, num_rings=50,
                                                    feature_noise=0.8, seed=1))
    split = make_split_masks(static_b.order_snapshot)
    static_b.order_features, _ = standardize_features(static_b.order_features, split == 0)
    batches = build_communities(static_b, community_size=256, max_deg=24)
    requests = history_requests(batches)
    cfg = LNNConfig(gnn_type="gcn", num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                    feat_dim=batches[0].graph.features.shape[1], pos_weight=3.0)
    params = lnn_init(torch.Generator().manual_seed(1), cfg, device=dev)
    store = KVStore(cfg.hidden_dim)
    BatchLayer(params, cfg, store, device=dev).refresh(batches)
    speed = SpeedLayer(params, cfg, store, k_max=8, device=dev)
    want = np.concatenate([speed.score(requests[i:i + MICRO_BATCH])
                           for i in range(0, len(requests), MICRO_BATCH)])
    svc = FraudService(service_cfg(cfg, mode="batch"), params).build().warmup()

    def batch_run():
        svc.refresh(batches)
        return [svc.score(requests[i:i + MICRO_BATCH])
                for i in range(0, len(requests), MICRO_BATCH)]

    chunks, b_wall, b_counts = counted(batch_run)
    got = np.asarray([r.score for chunk in chunks for r in chunk])
    if not np.array_equal(got, want):
        raise AssertionError(f"service batch: facade scores differ from SpeedLayer's "
                             f"(max {float(np.abs(got - want).max()):.3e})")
    if _store_contents(svc.store) != _store_contents(store):
        raise AssertionError("service batch: facade KV bytes differ from BatchLayer's")
    gap = svc.score_equivalence_check(batches, atol=EQUIV_ATOL)
    per_refresh = b_counts["csr_spmm"] / len(batches)
    if per_refresh != cfg.num_gnn_layers - 1 or b_counts["stage2_score"] != len(chunks):
        raise AssertionError(f"service batch: launches {b_counts} for {len(batches)} "
                             f"communities and {len(chunks)} score calls")
    out["batch"] = dict(communities=len(batches), requests=len(requests),
                        score_calls=len(chunks), wall_s=b_wall, equivalence_gap=gap,
                        launches=b_counts)
    print(f"service batch gcn: refresh of {len(batches)} communities + {len(requests)} requests "
          f"in {len(chunks)} calls of {MICRO_BATCH} in {b_wall:.3f} s; scores equal to "
          f"BatchLayer/SpeedLayer's bit for bit (and the KV bytes); score_equivalence_check "
          f"{gap:.3e} (limit {EQUIV_ATOL}); launches {b_counts}")

    # ---- 3. hot swap to a clone, shadow scoring, a canary
    cfg = lnn_cfg("gcn")
    params = facade_params["gcn"]
    svc = FraudService(service_cfg(cfg), params).build()
    clone = svc.register_perturbed(0, 0.0)
    canary = svc.register_perturbed(0, 0.05, seed=1)
    svc.warmup()
    svc.enable_shadow(clone, fraction=SHADOW_FRACTION, threshold=0.0)
    half, delivered, observed = len(head) // 2, [], [0]

    def swap_run():
        for i, ev in enumerate(head):
            res = svc.submit(ev)
            observed[0] += svc.shadow_observe(res)
            delivered.extend(res)
            if i == half:
                out["clone_shadow"] = svc.shadow_stats()
                svc.activate_model(clone)
                svc.enable_shadow(canary, fraction=SHADOW_FRACTION, threshold=1e-3)
        res = svc.drain()
        observed[0] += svc.shadow_observe(res)
        delivered.extend(res)

    _, sw_wall, sw_counts = counted(swap_run)
    scores = {r.request.tag.order_id: r.score for r in delivered}
    if scores != out.pop("head_scores"):
        raise AssertionError("service: a hot swap to a register_perturbed(0, 0.0) clone moved "
                             "a score")
    cl, can = out["clone_shadow"], svc.shadow_stats()
    if not (cl["sampled"] > 0 and cl["divergence_max"] == 0.0 and not cl["alert_active"]):
        raise AssertionError(f"service: clone shadow {cl}")
    if not (can["alert_active"] and can["divergence_max"] > 1e-3):
        raise AssertionError(f"service: the canary's alert did not trip: {can}")
    versions = [r.model_version for r in delivered]
    shadow_launches = sw_counts["stage2_score"] - svc.stats().flushes
    if versions != sorted(versions) or set(versions) != {0, 1} or shadow_launches <= 0:
        raise AssertionError(f"service: swap versions {sorted(set(versions))}, shadow "
                             f"launches {shadow_launches}")
    out["swap"] = dict(events=len(head), wall_s=sw_wall, shadow_sampled=observed[0],
                       shadow_launches=shadow_launches, launches=sw_counts,
                       clone_divergence_max=cl["divergence_max"],
                       canary_divergence_max=can["divergence_max"], canary_alerts=can["alerts"])
    print(f"service swap gcn ({len(head)} events): hot swap to a register_perturbed(0, 0.0) "
          f"clone after event {half}: every score equal bit for bit; shadow at fraction "
          f"{SHADOW_FRACTION}: clone divergence max {cl['divergence_max']} over "
          f"{cl['sampled']} samples, canary (scale 0.05) divergence max "
          f"{can['divergence_max']:.3e}, {can['alerts']} alerts; {observed[0]} shadow samples "
          f"in {shadow_launches} shadow stage2_score launches; launches {sw_counts}")

    # ---- 4. WAL, checkpoint, crash -> restore -> resume
    swap_params = lnn_init(torch.Generator().manual_seed(2), cfg, device=dev)
    swap = (SERVICE_SWAP_AT, swap_params, 1)

    def make():
        return FraudService(service_cfg(cfg), params).build()

    fired: dict = {}
    fire = crashpoint.fire

    def counting_fire(name):
        fired[name] = fired.get(name, 0) + 1
        fire(name)

    crashpoint.fire = counting_fire
    try:
        with tempfile.TemporaryDirectory() as root:
            ckpts: list = []
            base = make().enable_wal(root)
            want = _merge({}, _drive(base, head, swap=swap, checkpoint_at=SERVICE_CHECKPOINT_AT,
                                     ckpt_log=ckpts))
            want_store = _store_contents(base.store)
            base_ckpt = (ckpts[0][0], _dir_bytes(ckpts[0][1]))
            base.close()
    finally:
        crashpoint.fire = fire
    crash_rows = []
    for point in SERVICE_CRASH_POINTS:
        # a crash about two thirds of the way in (the checkpoint's own: at it)
        hit = 1 if point.startswith("checkpoint") else max(1, fired[point] * 2 // 3)
        with tempfile.TemporaryDirectory() as root:
            svc = make().enable_wal(root)
            delivered, ckpt_log, crashed = [], [], None
            crashpoint.arm(point, hit=hit)
            try:
                _drive(svc, head, swap=swap, checkpoint_at=SERVICE_CHECKPOINT_AT, out=delivered,
                       ckpt_log=ckpt_log)
            except SimulatedCrash as exc:
                crashed = exc
            finally:
                crashpoint.disarm()
            svc.wal.close()
            if crashed is None:
                raise AssertionError(f"service crash {point}: hit {hit} never fired")
            ckpt_bytes = _dir_bytes(ckpt_log[0][1]) if ckpt_log else 0
            ckpt_s = ckpt_log[0][0] if ckpt_log else float("nan")
            torch.cuda.synchronize()
            svc2 = FraudService.restore(root)
            rec = svc2.last_recovery
            merged = _merge(_merge({}, delivered), rec["responses"])
            resume = svc2.engine.ingester.num_events
            if resume > swap[0] and svc2.model_version < swap[2]:
                svc2.load_model(swap[1], version=swap[2])
            _merge(merged, _drive(svc2, head, start=resume,
                                  swap=swap if resume <= swap[0] else None,
                                  checkpoint_at=(SERVICE_CHECKPOINT_AT
                                                 if resume <= SERVICE_CHECKPOINT_AT else None)))
            if merged != want or _store_contents(svc2.store) != want_store:
                diff = sum(1 for o in want if merged.get(o) != want[o])
                raise AssertionError(f"service crash {point}: after restore {diff} of "
                                     f"{len(want)} scores differ, or the KV bytes do")
            replayed = rec["replayed_records"]
            crash_rows.append(dict(
                point=point, hit=hit, resume=resume, checkpoint=rec["checkpoint"] is not None,
                replayed_records=replayed, restore_s=rec["seconds"],
                replayed_per_s=replayed / rec["seconds"], checkpoint_s=ckpt_s,
                checkpoint_bytes=ckpt_bytes, model_version=svc2.model_version))
            svc2.close()
            print(f"service crash at {point} (hit {hit}): restore in {rec['seconds']:.3f} s "
                  f"({'from a checkpoint' if rec['checkpoint'] else 'from genesis'}, "
                  f"{replayed} WAL records replayed, {replayed / rec['seconds']:.1f} records/s), "
                  f"resumed at event {resume}: merged scores and KV bytes equal to the "
                  f"uninterrupted run's bit for bit; "
                  + (f"checkpoint {ckpt_s:.3f} s, {ckpt_bytes} bytes" if ckpt_log
                     else "the crash came before the checkpoint committed"))
    out["crash"] = dict(events=len(head), checkpoint_at=SERVICE_CHECKPOINT_AT,
                        swap_at=SERVICE_SWAP_AT, fired=fired, rows=crash_rows,
                        uninterrupted_checkpoint_s=base_ckpt[0],
                        uninterrupted_checkpoint_bytes=base_ckpt[1])

    # ---- 5. the hybrid GNN -> GBDT head on the typed attack stream
    ev_a, _ = generate_attack_stream(AttackConfig(), rate_per_s=STREAM_RATE)
    cfg_t = lnn_cfg("gat", entity_types=ENTITY_TYPE_NAMES)
    params_t = lnn_init(torch.Generator().manual_seed(2), cfg_t, device=dev)
    half = len(ev_a) // 2
    trainer = FraudService(service_cfg(cfg_t), params_t).build()
    trainer.replay(ev_a[:half])
    eng = trainer.engine
    keys = [eng.ingester.builder.entity_keys(ev.entities, ev.snapshot) for ev in ev_a[:half]]
    emb, mask, _ = trainer.store.lookup_batch_versioned(keys, trainer.config.engine.k_max)
    st = eng.pool.workers[0].scorer._slot_types(keys)
    feats = np.stack([ev.features for ev in ev_a[:half]]).astype(np.float32)
    t_args = [torch.from_numpy(a).to(dev) for a in (emb, mask, feats, st)]
    x = embed_rows(params_t, cfg_t, *t_args[:3], t_args[3])
    hy = train_hybrid(params_t, cfg_t, x, np.asarray([ev.label for ev in ev_a[:half]]),
                      device=dev)
    # the embedding: the card against the host's plain path, and a row's
    # bits at B=2 against the same rows at B=16 (unchunked, and embed_rows)
    params_h = from_numpy(to_numpy(params_t), "cpu")
    x_host = embed_rows(params_h, cfg_t, *(t.cpu() for t in t_args[:3]), t_args[3].cpu())
    embed_gap = float(np.abs(x - x_host).max())
    if not embed_gap <= STREAM_SCORE_TOL:
        raise AssertionError(f"service hybrid: embedding card against host {embed_gap:.3e}")
    with torch.no_grad():
        full16 = lnn_stage2_embed(params_t, cfg_t, *(t[:16] for t in t_args[:3]),
                                  slot_type=t_args[3][:16]).cpu().numpy()
        pairs = np.concatenate([lnn_stage2_embed(params_t, cfg_t, *(t[i:i + 2] for t in t_args[:3]),
                                                 slot_type=t_args[3][i:i + 2]).cpu().numpy()
                                for i in range(0, 16, 2)])
    unchunked_rows = int((pairs != full16).any(1).sum())
    pairs_rows = np.concatenate([embed_rows(params_t, cfg_t, *(t[i:i + 2] for t in t_args[:3]),
                                            t_args[3][i:i + 2]) for i in range(0, 16, 2)])
    chunked_rows = int((pairs_rows != x[:16]).any(1).sum())
    if chunked_rows:
        raise AssertionError(f"service hybrid: embed_rows rows at B=2 differ from B=16 in "
                             f"{chunked_rows} of 16")
    t_embed, t_gbdt, hyb = [], [], {}
    _timed(workers_mod, "embed_rows", t_embed)
    _timed(hy.gbdt, "predict_proba", t_gbdt)
    try:
        for n in (1, 4):
            svc = FraudService(service_cfg(cfg_t, engine={"num_workers": n}), hy).build().warmup()
            del t_embed[:], t_gbdt[:]
            rep, h_wall, h_counts = counted(lambda: svc.replay(ev_a, warmup=False))
            hyb[n] = dict(scores=rep.scores_by_order(), wall_s=h_wall, launches=h_counts,
                          flushes=svc.stats().flushes, embed_ms=float(np.median(t_embed)) * 1e3,
                          gbdt_ms=float(np.median(t_gbdt)) * 1e3, embeds=len(t_embed),
                          served=sum(1 for w in svc.stats().workers if w["requests"] > 0))
    finally:
        workers_mod.embed_rows = embed_rows
        del hy.gbdt.predict_proba
    if hyb[4]["scores"] != hyb[1]["scores"] or hyb[4]["served"] < 2:
        raise AssertionError(f"service hybrid: N=4 scores differ from N=1 "
                             f"({hyb[4]['served']} workers served)")
    if hyb[1]["embeds"] != hyb[1]["flushes"] or hyb[1]["launches"]["stage2_score"] != 0:
        raise AssertionError(f"service hybrid: {hyb[1]['embeds']} embeddings for "
                             f"{hyb[1]['flushes']} flushes, launches {hyb[1]['launches']}")
    # the booster is a step function of its inputs: an embedding within
    # the gap of a bin edge lands in another bin on the card than on the
    # host, and only such a row may get another probability
    bin_rows = (hy.gbdt.bin_data(x) != hy.gbdt.bin_data(x_host)).any(1)
    prob_rows = hy.gbdt.predict_proba(x) != hy.gbdt.predict_proba(x_host)
    if (prob_rows & ~bin_rows).any():
        raise AssertionError("service hybrid: a probability differs between card and host "
                             "with every GBDT bin equal")
    host = FraudService(service_cfg(cfg_t), HybridModel(params_h, cfg_t, hy.gbdt),
                        device="cpu").build()
    host_s = host.replay(ev_a).scores_by_order()
    orders = sorted(host_s)
    d = np.abs(np.asarray([hyb[1]["scores"][o] for o in orders])
               - np.asarray([host_s[o] for o in orders]))
    score_gap, score_rows = float(d.max()), int((d > 0).sum())
    # rung 7: a typed hybrid service restores from its WAL and checkpoint
    with tempfile.TemporaryDirectory() as root:
        svc = FraudService(service_cfg(cfg_t), params_t).build().enable_wal(root)
        svc.replay(ev_a[:half])
        svc.activate_model(svc.register_model(hy, version=1))
        svc.checkpoint()
        svc.replay(ev_a[half:], warmup=False)
        restored = FraudService.restore(root)
        snap = max(ev.snapshot for ev in ev_a) + 1
        probes = [CheckoutEvent(order_id=90_000 + i, snapshot=snap,
                                entities=ev.entities, features=ev.features, label=ev.label,
                                arrival=ev_a[-1].arrival + 1.0 + i)
                  for i, ev in enumerate(ev_a[-16:])]
        s1 = svc.replay(probes, warmup=False).scores_by_order()
        s2 = restored.replay(probes, warmup=False).scores_by_order()
        if s1 != s2 or restored.model_version != 1:
            raise AssertionError("service hybrid: the restored typed hybrid service scores "
                                 "other bits")
    out["hybrid"] = dict(events=len(ev_a), train_rows=half, embed_gap=embed_gap,
                         unchunked_rows_b2_vs_b16=unchunked_rows, chunked_rows_b2_vs_b16=0,
                         train_rows_other_bin=int(bin_rows.sum()),
                         train_rows_other_prob=int(prob_rows.sum()),
                         host_score_gap=score_gap, host_score_rows=score_rows,
                         **{f"n{n}": {k: v for k, v in hyb[n].items() if k != "scores"}
                            for n in (1, 4)})
    print(f"service hybrid typed gat (attack stream, {len(ev_a)} events, GBDT of "
          f"{len(hy.gbdt.trees)} trees on {half} embeddings): N=4 == N=1 bit for bit "
          f"({hyb[4]['served']} workers served); embedding card against host max|d| "
          f"{embed_gap:.2e} (limit {STREAM_SCORE_TOL}); of the {half} training embeddings "
          f"{int(bin_rows.sum())} fall in another GBDT bin on the card than on the host, "
          f"{int(prob_rows.sum())} of them with another probability (none with equal bins); "
          f"the replay's scores against the host's: {score_rows} of {len(orders)} differ, max|d| "
          f"{score_gap:.2e}; rows at "
          f"B=2 against B=16: lnn_stage2_embed {unchunked_rows} of 16 differ, embed_rows 0; "
          f"per flush: embed_rows {hyb[1]['embed_ms']:.3f} ms, GBDT predict "
          f"{hyb[1]['gbdt_ms']:.3f} ms (medians over {hyb[1]['flushes']} flushes); "
          f"{len(hyb[1]['scores'])} events in {hyb[1]['wall_s']:.3f} s; WAL/checkpoint "
          f"restore scores 16 probes bit for bit (rung 7)")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"service phase: {out['seconds']:.1f} s")
    return out


PROCS_WORKERS = (1, 2, 4)            # shard processes per process-backend replay
PROCS_SWAP_AT = 5000                 # the full replays hot-swap after this event
PROCS_KILL_HIT = 8                   # worker_kill: the 8th SCORE post SIGKILLs its child


class _BusySampler:
    """The card's busy share over a run, across every process on it:
    ``nvidia-smi``'s ``utilization.gpu`` (the share of its sample period in
    which a kernel ran) polled every 100 ms by a child ``nvidia-smi`` that
    is stopped when the run ends.  ``share`` is None where it gave no
    sample.  The profiler traces one process only, and the process
    backend's kernels run in the shard processes."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]
        self.samples = len(vals)
        self.share = sum(vals) / len(vals) / 100.0 if vals else None


def _smi_memory_used_mib() -> float | None:
    """The card's used memory (MiB) as ``nvidia-smi`` reads it, None where
    it reads none."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    return float(out[0]) if out and out[0].replace(".", "", 1).isdigit() else None


def _smi_compute_apps() -> dict:
    """pid -> MiB of every process with a context on the card, as
    ``nvidia-smi --query-compute-apps=pid,used_memory`` lists them (in a
    container the pids may be the host's, or none may be listed)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mib = (x.strip() for x in line.split(","))
        if pid.isdigit() and mib.replace(".", "", 1).isdigit():
            apps[int(pid)] = float(mib)
    return apps


def procs_phase(dev) -> dict:
    """The process backend (``repro_torch.stream.procpool``): each speed-layer
    worker a spawned shard process with its own CUDA context on the card,
    owning its KV shard, its ``stage2_score`` launches and the stage-1 bins
    of a refresh.  The full stream (gcn, a hot swap after event 5,000) at
    N = 1, 2 and 4 processes between two inline replays (inline, process,
    process, process, inline), each with events/s, latency and the card's
    busy share, the children's launch counters zeroed just before and read
    just after (summed over the children: ``stage2_score`` once per flush,
    ``csr_spmm`` once per GNN layer of every stage-1 call, none in the
    parent); scores and KV bytes equal the inline replay's bit for bit.
    Then, on the first 2,000 events against the inline facade: a
    checkpoint → restore → resume and a ``worker_kill`` at four children
    (SIGKILL of a child, restart counted, the flush re-dispatched once),
    bit for bit;
    and what a child costs: its context's memory and seconds from spawn to
    the end of its warmup."""
    import tempfile

    from repro_torch.core import LNNConfig, lnn_init
    from repro_torch.data import SynthConfig, generate_event_stream
    from repro_torch.kernels import _build
    from repro_torch.service import FraudService, ModelSection, ServiceConfig
    from repro_torch.stream import EngineConfig, StreamingEngine
    from repro_torch.utils import crashpoint

    t_phase = time.perf_counter()
    events, static, _ = generate_event_stream(
        SynthConfig(num_users=3000, num_rings=50, feature_noise=0.8, seed=1),
        rate_per_s=STREAM_RATE)
    head = events[:STREAM_CHECK_EVENTS]
    cfg = LNNConfig(gnn_type="gcn", num_gnn_layers=3, hidden_dim=64, mlp_dims=(64, 32),
                    feat_dim=static.order_features.shape[1], pos_weight=3.0)
    params = lnn_init(torch.Generator().manual_seed(1), cfg, device=dev)
    params2 = lnn_init(torch.Generator().manual_seed(2), cfg, device=dev)
    per_call = cfg.num_gnn_layers - 1
    launches = {name: 0 for name in _build.LAUNCHES}
    out: dict = {"events": len(events), "rate_per_s": STREAM_RATE, "swap_at": PROCS_SWAP_AT}

    # ---- the full stream: inline, process N=1, 2, 4, inline
    def replay(backend, n):
        torch.cuda.synchronize()
        mem0 = _smi_memory_used_mib()
        t0 = time.perf_counter()
        eng = StreamingEngine(params, cfg, EngineConfig(num_workers=n, backend=backend))
        try:
            row = dict(backend=backend, workers=n)
            if backend == "process":
                ready = eng.pool.warmup()
                mem1 = _smi_memory_used_mib()
                row.update(spawn_to_ready_s=ready, start_s=time.perf_counter() - t0,
                           card_mib_added=(None if None in (mem0, mem1) else mem1 - mem0),
                           compute_apps_mib=_smi_compute_apps())
                eng.pool.child_launches(reset=True)
            else:
                eng.warmup()
            torch.cuda.synchronize()
            _build.reset_launches()
            results = []
            with _BusySampler() as busy:
                t0 = time.perf_counter()
                for i, ev in enumerate(events):
                    results.extend(eng.submit(ev))
                    if i == PROCS_SWAP_AT:
                        eng.load_model(params2, 1)
                results.extend(eng.flush())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            parent_counts = dict(_build.LAUNCHES)
            if backend == "process":
                counts = eng.pool.child_launches()
                if any(parent_counts[k] for k in ("stage2_score", "csr_spmm")):
                    raise AssertionError(f"procs N={n}: the parent launched {parent_counts}")
            else:
                counts = parent_counts
            flushes = eng.pool.stats["flushes"]
            st1 = eng.refresher.stats["stage1_launches"]
            if counts["stage2_score"] != flushes or counts["csr_spmm"] != st1 * per_call:
                raise AssertionError(f"procs {backend} N={n}: launches {counts} for {flushes} "
                                     f"flushes and {st1} stage-1 calls x {per_call}")
            if len(results) != len(events):
                raise AssertionError(f"procs {backend} N={n}: {len(results)} results")
            lat = np.asarray([r.queued_s + r.service_s for r in results]) * 1e3
            p50, p99 = np.percentile(lat, (50, 99))
            row.update(wall_s=wall, events_per_s=len(events) / wall,
                       latency_ms={"p50": float(p50), "p99": float(p99)},
                       busy_share=busy.share, busy_samples=busy.samples, flushes=flushes,
                       stage1_calls=st1, launches=counts,
                       scores={r.request.tag.order_id: (r.score, r.model_version)
                               for r in results},
                       store=_store_contents(eng.store))
            return row
        finally:
            eng.close()

    runs = [replay("inline", 1)] + [replay("process", n) for n in PROCS_WORKERS] \
        + [replay("inline", 1)]
    base = runs[0]
    for row in runs[1:]:
        if row["scores"] != base["scores"] or row["store"] != base["store"]:
            diff = sum(1 for o in base["scores"] if row["scores"].get(o) != base["scores"][o])
            raise AssertionError(f"procs {row['backend']} N={row['workers']}: {diff} scores "
                                 f"differ from the inline replay's, or the KV bytes do")
        if row["backend"] == "process":
            for name, c in row["launches"].items():
                launches[name] += c
    for row in runs:
        busy = "not measured" if row["busy_share"] is None else f"{row['busy_share']:.1%}"
        extra = ""
        if row["backend"] == "process":
            added = row["card_mib_added"]
            mem = ("not measured" if added is None else
                   f"+{added:.0f} MiB ({added / row['workers']:.0f} MiB a child: its context "
                   "and its tensors)")
            extra = (f"; spawn to warmed {', '.join(f'{x:.2f}' for x in row['spawn_to_ready_s'])}"
                     f" s per child ({row['start_s']:.2f} s for all), card memory {mem}, "
                     f"compute apps (pid: MiB) {row['compute_apps_mib']}")
        print(f"procs {row['backend']} N={row['workers']}: {len(events)} events in "
              f"{row['wall_s']:.3f} s ({row['events_per_s']:.1f} events/s, wall), latency p50 "
              f"{row['latency_ms']['p50']:.3f} p99 {row['latency_ms']['p99']:.3f} ms, card busy "
              f"{busy} ({row['busy_samples']} nvidia-smi samples); {row['flushes']} flushes, "
              f"{row['stage1_calls']} stage-1 calls, launches stage2_score "
              f"{row['launches']['stage2_score']} csr_spmm {row['launches']['csr_spmm']}"
              + (" (summed over the children, none in the parent)"
                 if row["backend"] == "process" else "") + extra)
    print(f"procs: every process replay's {len(base['scores'])} scores and {len(base['store'])} "
          f"KV entries equal the inline replay's bit for bit, across the hot swap after event "
          f"{PROCS_SWAP_AT}")
    out["replays"] = [{k: v for k, v in row.items() if k not in ("scores", "store")}
                      for row in runs]

    # ---- the first 2,000 events: checkpoint -> restore -> resume, worker_kill
    def service_cfg(backend, n):
        return ServiceConfig(model=ModelSection.from_lnn_config(cfg)).replace(
            engine={"num_workers": n}, workers={"backend": backend})

    swap = (SERVICE_SWAP_AT, params2, 1)
    inline = FraudService(service_cfg("inline", 4), params).build()
    want = _merge({}, _drive(inline, head, swap=swap))
    want_store = _store_contents(inline.store)
    inline.close()

    with tempfile.TemporaryDirectory() as root:
        svc = FraudService(service_cfg("process", 4), params).build().enable_wal(root)
        delivered: list = []
        crash_at = 3 * len(head) // 4
        for i, ev in enumerate(head[:crash_at]):
            delivered.extend(svc.submit(ev))
            if i == swap[0]:
                svc.load_model(swap[1], version=swap[2])
            if i == SERVICE_CHECKPOINT_AT:
                svc.checkpoint()
        # the crash: no flush, no drain; the shard processes and the WAL go
        svc.engine.pool.shutdown()
        svc.wal.close()
        t0 = time.perf_counter()
        svc2 = FraudService.restore(root)
        restore_s = time.perf_counter() - t0
        try:
            rec = svc2.last_recovery
            merged = _merge(_merge({}, delivered), rec["responses"])
            resume = svc2.engine.ingester.num_events
            _merge(merged, _drive(svc2, head, start=resume))
            if merged != want or _store_contents(svc2.store) != want_store:
                diff = sum(1 for o in want if merged.get(o) != want[o])
                raise AssertionError(f"procs restore: {diff} of {len(want)} scores differ "
                                     "from the inline run's, or the KV bytes do")
        finally:
            svc2.close()
    out["restore"] = dict(workers=4, crash_at=crash_at, checkpoint_at=SERVICE_CHECKPOINT_AT,
                          restore_s=restore_s, recovery_s=rec["seconds"],
                          replayed_records=rec["replayed_records"], resume=resume)
    print(f"procs restore (N=4, {len(head)} events): checkpoint after event "
          f"{SERVICE_CHECKPOINT_AT}, hot swap after {SERVICE_SWAP_AT}, crash at {crash_at}; "
          f"FraudService.restore in {restore_s:.3f} s (four fresh shard processes re-seeded; "
          f"{rec['replayed_records']} WAL records replayed), resumed at event {resume}: merged "
          f"scores and KV bytes equal to the inline run's bit for bit")

    # worker_kill at four children here (the CPU tests hold N=1 and N=4):
    # each spawn costs ~7-11 s of this phase
    svc = FraudService(service_cfg("process", 4), params).build()
    restarts_s: list = []
    pool = svc.engine.pool
    restart = pool._restart_child

    def timed_restart(wid):
        # respawn, model chain, journal, until the new child answers
        t0 = time.perf_counter()
        restart(wid)
        pool._children[wid].request({"cmd": "ping"})
        restarts_s.append(time.perf_counter() - t0)

    pool._restart_child = timed_restart
    try:
        crashpoint.arm("worker_kill", hit=PROCS_KILL_HIT)
        try:
            got = _drive(svc, head, swap=swap)
        finally:
            crashpoint.disarm()
        restarts = sum(row["restarts"] for row in pool.worker_summary())
        answered = sorted(r.request.tag.order_id for r in got)
        if restarts != 1 or len(restarts_s) != 1 or pool.dead_workers() != 0:
            raise AssertionError(f"procs worker_kill: {restarts} restarts counted, "
                                 f"{len(restarts_s)} performed")
        if answered != sorted(ev.order_id for ev in head):
            raise AssertionError("procs worker_kill: orders answered other than once each")
        if _merge({}, got) != want or _store_contents(svc.store) != want_store:
            raise AssertionError("procs worker_kill: scores or KV bytes differ from the "
                                 "inline run's")
    finally:
        svc.close()
    print(f"procs worker_kill N=4 (hit {PROCS_KILL_HIT}, {len(head)} events, hot swap after "
          f"{SERVICE_SWAP_AT}): one SIGKILLed child respawned, restored and answering in "
          f"{restarts_s[0]:.3f} s (restart counted once), every order answered once, scores "
          f"and KV bytes equal to the inline run's bit for bit")
    out["worker_kill"] = dict(workers=4, hit=PROCS_KILL_HIT, restarts=restarts,
                              restart_s=restarts_s[0])
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"procs phase: {out['seconds']:.1f} s")
    return out


LEARN_ATTACK = dict(num_buyers=160, num_rings=6, ring_size=8, num_snapshots=16, num_bursts=1,
                    num_bin_runs=1, seed=0)   # benchmarks/learning_bench.py's full run
LEARN_RATE = 500.0            # checkout events per virtual second
LEARN_STEP_EVERY = 16         # a learner step after every 16 events
LEARN_TAIL = 40               # the stream's last events: the injected regression
LEARN_BUDGET = 0.15           # review budget of every recall figure
LEARN_CHECK_STEPS = 3         # card against host: fine-tune steps from one warm start
LEARN_LOSS_RTOL = 1e-5        # ... each step's loss, relative
LEARN_LEAF_TOL = 1e-4         # ... each tuned leaf, of its scale
LEARN_EMBED_TOL = 1e-5        # ... the GBDT refit's stage-2 embeddings
WIRE_ATTACK = dict(LEARN_ATTACK, num_buyers=400)   # the same stream, 2,723 events
WIRE_EVENTS = 2000            # events the gateway scores against the in-process service
WIRE_BATCH = 10               # events per batched /v1/score body
WIRE_RESUME = 500             # events the rebooted gateway scores after the checkpoint


def learn_service_config(feat_dim: int, **gateway):
    """The learn cell's ``ServiceConfig``: ``lnn_fraud``'s width (gcn, 3 GNN
    layers, hidden 64, MLP (64, 32), pos_weight 3) typed with the four
    entity types, ``benchmarks/learning_bench.py``'s engine (one worker,
    micro-batches of 8, K=4) and learn section (windows of 48-256 examples
    every 48, 25 Adam steps at lr 1e-2, the hybrid head with 20 trees,
    shadow-gated promotion at recall@0.15)."""
    from repro_torch.core import ENTITY_TYPE_NAMES
    from repro_torch.service import ServiceConfig

    return ServiceConfig.from_dict({
        "mode": "streaming",
        "model": {"gnn_type": "gcn", "num_gnn_layers": 3, "hidden_dim": 64,
                  "mlp_dims": [64, 32], "feat_dim": int(feat_dim), "pos_weight": 3.0,
                  "entity_types": list(ENTITY_TYPE_NAMES)},
        "engine": {"num_workers": 1, "max_batch": 8, "k_max": 4},
        "gateway": gateway,
        "learn": {"enabled": True, "min_window": 48, "max_window": 256, "stride": 48,
                  "steps": 25, "lr": 1e-2, "optimizer": "adam", "head": "hybrid",
                  "gbdt_trees": 20, "min_eval": 32, "min_eval_pos": 3,
                  "eval_budget": LEARN_BUDGET, "eval_max": 96, "promote_margin": 0.01,
                  "rollback_margin": 0.10, "watch_min_eval": 48},
    })


class _MemorySampler:
    """The card's used memory (``nvidia-smi``) and the compute apps listed
    on it, polled every 250 ms on a thread while a block runs: the peak
    used MiB over the block, and every pid other than this one seen with
    a context (a spawned child's)."""

    def __enter__(self):
        import os
        import threading

        self.base = _smi_memory_used_mib()
        self.peak, self.apps, self._stop = self.base, {}, threading.Event()
        me = os.getpid()

        def poll():
            while not self._stop.wait(0.25):
                used = _smi_memory_used_mib()
                if used is not None and (self.peak is None or used > self.peak):
                    self.peak = used
                for pid, mib in _smi_compute_apps().items():
                    if pid != me:
                        self.apps[pid] = max(mib, self.apps.get(pid, 0.0))

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        self.added = None if None in (self.base, self.peak) else self.peak - self.base


def learn_wire(dev, params, feat_dim: int, scratch: str) -> dict:
    """The gateway (``repro_torch.gateway``) on 127.0.0.1 with the learn
    cell's config against the in-process service, on the drifting stream at
    400 buyers (the typed model takes typed entities): its first 2,000
    events over ``POST /v1/score`` (single bodies, then batched) bit for
    bit, wire against in-process latency, ``/metrics`` and ``/v1/stats``
    from one snapshot, ``/admin/train`` and ``/v1/learn/stats``,
    ``/admin/checkpoint``; then a fresh ``serve_gateway`` on the same
    directory restores on the card and scores the next 500 events as the
    uninterrupted service does, bit for bit."""
    import http.client
    import tempfile

    from repro_torch.data import AttackConfig
    from repro_torch.gateway import serve_gateway
    from repro_torch.learn import drifting_attack_stream
    from repro_torch.service import FraudService

    wevents, _, _ = drifting_attack_stream(AttackConfig(**WIRE_ATTACK), rate_per_s=LEARN_RATE)
    head = wevents[:WIRE_EVENTS]
    resume = wevents[WIRE_EVENTS:WIRE_EVENTS + WIRE_RESUME]
    root = tempfile.mkdtemp(dir=scratch)
    wsc = learn_service_config(feat_dim, checkpoint_dir=root)

    ref = FraudService(wsc, params, device=dev).build().warmup()
    want, proc_ms = {}, []
    for ev in head:
        t0 = time.perf_counter()
        res = ref.submit(ev)
        proc_ms.append((time.perf_counter() - t0) * 1e3)
        want.update({r.request.tag.order_id: r.score for r in res})
    want_head = dict(want)
    for ev in resume:
        want.update({r.request.tag.order_id: r.score for r in ref.submit(ev)})
    want.update({r.request.tag.order_id: r.score for r in ref.drain()})
    ref.close()

    def body(ev):
        return {"order_id": ev.order_id, "snapshot": ev.snapshot, "entities": list(ev.entities),
                "features": ev.features.tolist(), "label": float(ev.label),
                "arrival": ev.arrival}

    def post(conn, path, payload):
        raw = json.dumps(payload).encode()
        conn.request("POST", path, raw, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    def get(conn, path):
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()

    got, wire_ms = {}, []
    gw = serve_gateway(wsc, params, device=dev)
    try:
        port = gw.port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        half = len(head) // 2
        for ev in head[:half]:
            t0 = time.perf_counter()
            status, reply = post(conn, "/v1/score", {"event": body(ev)})
            wire_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"learn wire: /v1/score answered {status}: {reply}")
            got.update({r["order_id"]: r["score"] for r in reply["results"]})
        for i in range(half, len(head), WIRE_BATCH):
            status, reply = post(conn, "/v1/score",
                                 {"events": [body(ev) for ev in head[i:i + WIRE_BATCH]]})
            if status != 200:
                raise AssertionError(f"learn wire: /v1/score answered {status}: {reply}")
            got.update({r["order_id"]: r["score"] for r in reply["results"]})
        if got != want_head:
            diff = sum(1 for o in want_head if got.get(o) != want_head[o])
            raise AssertionError(f"learn wire: {diff} of {len(want_head)} scores differ from the "
                                 "in-process service's, or the sets do")
        status, stats = get(conn, "/v1/stats")
        status2, metrics = get(conn, "/metrics")
        if (status, status2) != (200, 200):
            raise AssertionError(f"learn wire: /v1/stats {status}, /metrics {status2}")
        snap = json.loads(stats)["service"]
        lines = metrics.splitlines()
        for key in ("requests", "scored", "flushes", "refreshes", "store_size"):
            name = f"repro_service_{key}" + ("" if key == "store_size" else "_total")
            if f"{name} {snap[key]}" not in lines:
                raise AssertionError(f"learn wire: /metrics lacks '{name} {snap[key]}'")
        status, trained_reply = post(conn, "/admin/train", {"force": True})
        if status != 200 or trained_reply["trained"] is None:
            raise AssertionError(f"learn wire: /admin/train answered {status}: {trained_reply}")
        status, learn_stats = get(conn, "/v1/learn/stats")
        learn_stats = json.loads(learn_stats)
        if status != 200 or learn_stats["fires"] != 1:
            raise AssertionError(f"learn wire: /v1/learn/stats answered {status}: {learn_stats}")
        status, ck = post(conn, "/admin/checkpoint", {})
        if status != 200:
            raise AssertionError(f"learn wire: /admin/checkpoint answered {status}: {ck}")
        conn.close()
    finally:
        gw.close()     # the service object is abandoned: the simulated crash
        if gw.learner is not None:
            gw.learner.close()
    t0 = time.perf_counter()
    gw2 = serve_gateway(wsc, None, device=dev)
    boot_s = time.perf_counter() - t0
    try:
        rec = gw2.service.last_recovery
        if rec is None or gw2.service.engine.ingester.num_events != len(head):
            raise AssertionError("learn wire: the reboot did not restore the checkpoint")
        conn = http.client.HTTPConnection("127.0.0.1", gw2.port, timeout=120)
        for ev in resume:
            status, reply = post(conn, "/v1/score", {"event": body(ev)})
            if status != 200:
                raise AssertionError(f"learn wire: /v1/score answered {status}: {reply}")
            got.update({r["order_id"]: r["score"] for r in reply["results"]})
        status, reply = post(conn, "/admin/drain", {})
        if status != 200:
            raise AssertionError(f"learn wire: /admin/drain answered {status}: {reply}")
        got.update({r["order_id"]: r["score"] for r in reply["results"]})
        status, learn_stats2 = get(conn, "/v1/learn/stats")
        learn_stats2 = json.loads(learn_stats2)
        if status != 200 or learn_stats2["state"] != learn_stats["state"]:
            raise AssertionError(f"learn wire: after the reboot /v1/learn/stats answered "
                                 f"{status}: {learn_stats2}")
        conn.close()
    finally:
        gw2.close()
        if gw2.learner is not None:
            gw2.learner.close()
        gw2.service.close()
    if got != want:
        diff = sum(1 for o in want if got.get(o) != want[o])
        raise AssertionError(f"learn wire: after the reboot {diff} of {len(want)} scores differ "
                             "from the uninterrupted service's")
    wp = np.percentile(wire_ms, (50, 99))
    pp = np.percentile(proc_ms, (50, 99))
    out = dict(events=len(head), resume=len(resume), single_bodies=half,
               wire_ms={"p50": float(wp[0]), "p99": float(wp[1])},
               in_process_ms={"p50": float(pp[0]), "p99": float(pp[1])},
               train=trained_reply, learn_state=learn_stats["state"],
               learn_state_after_boot=learn_stats2["state"], boot_s=boot_s,
               recovery_s=rec["seconds"], replayed_records=rec["replayed_records"])
    print(f"learn wire: FraudGateway on 127.0.0.1:{port}, the first {len(head)} events of "
          f"the drifting stream at {WIRE_ATTACK['num_buyers']} buyers ({half} single bodies, "
          f"then bodies of {WIRE_BATCH}) scored over POST /v1/score bit for bit as the "
          f"in-process service; per request wire p50 "
          f"{wp[0]:.3f} p99 {wp[1]:.3f} ms against in-process submit p50 {pp[0]:.3f} p99 "
          f"{pp[1]:.3f} ms (keep-alive, one client); /metrics and /v1/stats from one snapshot; "
          f"POST /admin/train: {json.dumps(trained_reply['trained'])}, state "
          f"{learn_stats['state']}; POST /admin/checkpoint, then serve_gateway on the same "
          f"directory restored in {boot_s:.3f} s ({rec['replayed_records']} WAL records "
          f"replayed, learner re-attached in state {learn_stats2['state']}) and scored the next "
          f"{len(resume)} events: all {len(want)} scores equal the uninterrupted service's bit "
          "for bit")
    return out


def learn_phase(dev) -> dict:
    """The continuous-learning plane (``repro_torch.learn``) and the HTTP
    gateway (``repro_torch.gateway``) on the card, at the fraud width
    (:func:`learn_service_config`), on ``benchmarks/learning_bench.py``'s
    drifting attack stream: serve, shadow-observe and take a learner step
    every 16 events (WAL tap -> rolling fine-tune on the card -> GBDT refit
    on the host -> shadow-gated promotion), then an injected regression
    on the last 40 events, rolled back.  The loop with the learn plane on
    and off, in the order off, on, on, off: events/s, latency, per fire the
    window, fine-tune seconds (synchronized), ms per step and refit
    seconds, every decision, phase B's ring recall frozen against
    recovered, the card's busy share; the launch counters zeroed just
    before the first learn-on run and read just after, exact against the
    count the run's own record gives (``stage2_score`` once per flush and
    shadow batch of an MLP-headed version, ``csr_spmm`` once per stage-1
    layer of every refresh and refit and once per GNN layer of every
    fine-tune step, ``csr_spmm_bwd`` once per GNN layer of every step); the
    two learn-on runs equal bit for bit, and so the two learn-off runs; the
    incumbent's scores and leaves bit for bit across every fire.  Then one
    window's fine-tune on the card against the host's plain path (losses,
    leaves, the refit's embeddings), the inline fine-tune against the
    spawned trainer's bit for bit (with the spawn-to-result seconds and the
    child's card memory), and the gateway on 127.0.0.1: the first 2,000
    events of the drifting stream at 400 buyers over ``POST /v1/score`` against the
    in-process service bit for bit, wire against in-process latency,
    ``/metrics`` and ``/v1/stats`` from one snapshot, ``/admin/train`` and
    ``/v1/learn/stats``, ``/admin/checkpoint``, then a fresh
    ``serve_gateway`` on the same directory restoring on the card and
    scoring the next 500 events as the uninterrupted service does."""
    import math
    import shutil
    import tempfile

    import repro_torch.learn.trainer as trainer_mod
    import repro_torch.models.hybrid as hybrid_mod
    from repro_torch.core import lnn_init, lnn_stage2_online
    from repro_torch.data import AttackConfig
    from repro_torch.kernels import _build
    from repro_torch.learn import (ContinuousLearner, RollingWindowTrainer, WindowPolicy,
                                   drifting_attack_stream, recall_at_budget)
    from repro_torch.learn.promote import PromotionController
    from repro_torch.models.hybrid import HybridModel
    from repro_torch.params import flatten_paths, from_numpy, to_numpy, tree_leaves
    from repro_torch.service import FraudService
    from repro_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip-smoke-learn-")
    events, patterns, split = drifting_attack_stream(AttackConfig(**LEARN_ATTACK),
                                                     rate_per_s=LEARN_RATE)
    is_ring = {ev.order_id: p == "ring" for ev, p in zip(events, patterns)}
    feat_dim = int(events[0].features.shape[0])
    sc = learn_service_config(feat_dim)
    cfg, ls = sc.to_lnn_config(), sc.learn
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device=dev)
    per_step = cfg.num_gnn_layers          # csr_spmm and csr_spmm_bwd per fine-tune step
    per_call = cfg.num_gnn_layers - 1      # csr_spmm per stage-1 call
    cap = max(2, sc.engine.max_batch)      # rows of one shadow stage-2 call
    main_events, tail = events[:-LEARN_TAIL], events[-LEARN_TAIL:]
    out: dict = {"events": len(events), "split": int(split), "rate_per_s": LEARN_RATE,
                 "config": sc.to_dict()}
    print(f"learn world: drifting attack stream {LEARN_ATTACK}, {len(events)} events (drift at "
          f"{split}, {sum(is_ring.values())} ring orders), gcn typed, 3 layers, hidden 64, MLP "
          f"(64, 32); learn section {json.dumps(sc.to_dict()['learn'])}")

    # a fixed probe for the incumbent: 64 requests of random KV rows on the card
    g = torch.Generator().manual_seed(5)
    probe = (torch.randn((64, sc.engine.k_max, cfg.hidden_dim), generator=g).to(dev),
             (torch.rand((64, sc.engine.k_max), generator=g) > 0.3).float().to(dev),
             torch.randn((64, feat_dim), generator=g).to(dev),
             torch.randint(-1, len(cfg.entity_types), (64, sc.engine.k_max),
                           generator=g).to(torch.int32).to(dev))

    def probe_scores(p):
        with torch.no_grad():
            return lnn_stage2_online(p, cfg, *probe[:3], slot_type=probe[3]).cpu().numpy()

    def live(learn: bool, count: bool, probe_fires: bool) -> dict:
        """One pass of the stream through a fresh service (WAL and the
        scheduled checkpointer on either way); the learn plane and the
        injected regression when ``learn``."""
        svc = FraudService(sc, params, device=dev).build().warmup()
        svc.enable_wal(tempfile.mkdtemp(dir=scratch))
        svc.enable_auto_checkpoint(every_windows=4, keep_last=3)
        pool = svc.engine.pool
        learner = ContinuousLearner(svc) if learn else None
        fires: list = []
        need = {"stage2_score": 0, "csr_spmm": 0, "csr_spmm_bwd": 0}
        if learner is not None:
            tr = learner.trainer
            train, fit = tr.train, tr._fit_hybrid

            def timed_train(p):
                fires.append({"at_event": len(rows)})
                if probe_fires:
                    before = [t.clone() for t in tree_leaves(p)]
                    scores = probe_scores(p)
                t0 = time.perf_counter()
                res = train(p)
                fires[-1].update(window=res.window, train_s=time.perf_counter() - t0,
                                 loss_first=res.losses[0], loss_last=res.losses[-1])
                if probe_fires:
                    same = (all(torch.equal(a, b) for a, b in zip(before, tree_leaves(p)))
                            and np.array_equal(scores, probe_scores(p)))
                    if not same:
                        raise AssertionError("learn: a fine-tune moved the incumbent")
                    fires[-1]["incumbent_same_bits"] = True
                # the steps, and the hybrid refit's stage 1
                need["csr_spmm"] += res.steps * per_step + per_call * (res.head == "hybrid")
                need["csr_spmm_bwd"] += res.steps * per_step
                return res

            def timed_fit(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model = fit(*args)
                torch.cuda.synchronize()
                fires[-1]["refit_s"] = time.perf_counter() - t0
                return model

            tr.train, tr._fit_hybrid = timed_train, timed_fit

        rows: list = []          # (is_ring, label, score, version, ms) per admitted response
        iter_ms: list = []
        step_ms: list = []
        decisions: list = []     # (event index, decision)

        def serve(ev, watcher=None):
            mlp = not isinstance(svc.model_params(), HybridModel)
            f0 = pool.stats["flushes"]
            res = svc.submit(ev)
            need["stage2_score"] += (pool.stats["flushes"] - f0) * mlp
            observe(res)
            return watcher.step() if watcher is not None else None

        def observe(res):
            sh = svc.shadow_stats()
            n = svc.shadow_observe(res)
            if n and not isinstance(svc.model_params(sh["version"]), HybridModel):
                need["stage2_score"] += math.ceil(n / cap)
            for r in res:
                if r.admitted:
                    tag = r.request.tag
                    rows.append((float(is_ring[tag.order_id]), float(tag.label),
                                 float(r.score), int(r.model_version),
                                 (r.queued_s + r.service_s) * 1e3))

        def drain():
            mlp = not isinstance(svc.model_params(), HybridModel)
            f0 = pool.stats["flushes"]
            res = svc.drain()
            need["stage2_score"] += (pool.stats["flushes"] - f0) * mlp
            observe(res)

        torch.cuda.synchronize()
        if count:
            _build.reset_launches()
        st1_0 = svc.engine.refresher.stats["stage1_launches"]
        with _BusySampler() as busy:
            t0 = time.perf_counter()
            for i, ev in enumerate(main_events):
                t1 = time.perf_counter()
                serve(ev)
                if learner is not None and (i + 1) % LEARN_STEP_EVERY == 0:
                    t2 = time.perf_counter()
                    d = learner.step()["decision"]
                    step_ms.append((time.perf_counter() - t2) * 1e3)
                    if d:
                        decisions.append((i, d))
                iter_ms.append((time.perf_counter() - t1) * 1e3)
            drain()
            if learner is not None:
                d = learner.step()["decision"]
                if d:
                    decisions.append((len(main_events) - 1, d))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        main_rows = len(rows)
        row = {"learn": learn, "wall_s": wall, "events_per_s": len(main_events) / wall,
               "busy_share": busy.share, "busy_samples": busy.samples}
        if learner is not None:
            # the injected regression: a perturbed clone of the promotee
            promoted = svc.model_version
            bad = svc.register_perturbed(promoted, scale=3.0, seed=0)
            svc.activate_model(bad)
            svc.enable_shadow(promoted, fraction=1.0, threshold=0.25, collect_eval=96,
                              role="last_good")
            watcher = PromotionController.attach(svc, watch_min_eval=8, rollback_margin=0.10)
            rolled = None
            for j, ev in enumerate(tail):
                rolled = serve(ev, watcher)
                if rolled is not None:
                    break
            drain()
            if not (rolled and rolled["action"] == "rollback"
                    and svc.model_version == promoted and svc.stats().rollbacks >= 1):
                raise AssertionError(f"learn: the injected regression was not rolled back "
                                     f"({rolled})")
            row["regression"] = {"promoted": promoted, "bad": bad, "after_events": j + 1,
                                 "decision": rolled}
            learner.close()
        else:
            for ev in tail:
                serve(ev)
            drain()
        torch.cuda.synchronize()
        st1 = svc.engine.refresher.stats["stage1_launches"] - st1_0
        need["csr_spmm"] += st1 * per_call
        lat = np.asarray([r[4] for r in rows[:main_rows]])
        row.update(stage1_calls=st1, flushes=pool.stats["flushes"], need=need, fires=fires,
                   decisions=decisions, iter_ms=iter_ms, step_ms=step_ms,
                   latency_ms={"p50": float(np.percentile(lat, 50)),
                               "p99": float(np.percentile(lat, 99))},
                   scores=[(r[2], r[3]) for r in rows])
        if count:
            row["launches"] = dict(_build.LAUNCHES)
            got = {k: row["launches"][k] for k in need}
            if got != need:
                raise AssertionError(f"learn: launches {got}, the run's record needs {need}")
        row["window"] = learner.trainer._window() if learner is not None else None
        # recall: phase-B responses of a pre-drift version (frozen) against a
        # post-drift promotee's (recovered), on the main loop's responses
        if learner is not None:
            promos = [(i, d) for i, d in decisions if d.get("action") == "promote"]
            pre = {0} | {d["candidate"] for i, d in promos if i < split}
            b_rows = rows[split:main_rows]
            frozen = [(r[0], r[2]) for r in b_rows if r[3] in pre]
            recovered = [(r[0], r[2]) for r in b_rows if r[3] not in pre]

            def recall(rs):
                return (float("nan") if not rs else
                        recall_at_budget([r[0] for r in rs], [r[1] for r in rs], LEARN_BUDGET))

            row.update(frozen_ring_recall=recall(frozen), recovered_ring_recall=recall(recovered),
                       frozen_n=len(frozen), recovered_n=len(recovered),
                       promotions_after_drift=sum(1 for i, _ in promos if i >= split))
            if not row["promotions_after_drift"]:
                raise AssertionError("learn: no shadow-gated promotion after the drift")
        svc.close()
        return row

    real_fine_tune = trainer_mod._fine_tune
    fire_times: list = []

    def timed_fine_tune(p, c, pg, optimizer, lr, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_fine_tune(p, c, pg, optimizer, lr, steps)
        torch.cuda.synchronize()
        fire_times.append((time.perf_counter() - t0, steps, pg.num_nodes))
        return res

    trainer_mod._fine_tune = timed_fine_tune
    try:
        runs = []
        for learn, count, probe_fires in ((False, False, False), (True, True, False),
                                          (True, False, True), (False, False, False)):
            n0 = len(fire_times)
            row = live(learn, count, probe_fires)
            for f, (secs, steps, nodes) in zip(row["fires"], fire_times[n0:]):
                f.update(fine_tune_s=secs, ms_per_step=secs / steps * 1e3, steps=steps,
                         graph_nodes=nodes)
            runs.append(row)
    finally:
        trainer_mod._fine_tune = real_fine_tune
    off, on, on2, off2 = runs
    for a, b, what in ((on, on2, "learn-on"), (off, off2, "learn-off")):
        if a["scores"] != b["scores"] or a["decisions"] != b["decisions"]:
            first = next((i for i, (x, y) in enumerate(zip(a["scores"], b["scores"])) if x != y),
                         min(len(a["scores"]), len(b["scores"])))
            raise AssertionError(
                f"learn: the two {what} runs differ from response {first} on "
                f"({len(a['scores'])} and {len(b['scores'])} responses); decisions "
                f"{[(i, d['action']) for i, d in a['decisions']]} and "
                f"{[(i, d['action']) for i, d in b['decisions']]}")
    if not all(f.get("incumbent_same_bits") for f in on2["fires"]):
        raise AssertionError("learn: a fire went without the incumbent check")
    for row in runs:
        it = np.asarray(row["iter_ms"])
        busy = "not measured" if row["busy_share"] is None else f"{row['busy_share']:.1%}"
        row["iter_ms_pct"] = {q: float(np.percentile(it, p))
                              for q, p in (("p50", 50), ("p99", 99))}
        row["iter_ms_pct"]["max"] = float(it.max())
        print(f"learn loop ({'on' if row['learn'] else 'off'}): {len(main_events)} events in "
              f"{row['wall_s']:.3f} s ({row['events_per_s']:.1f} events/s, wall, the learner's "
              f"steps included), per event wall p50 {row['iter_ms_pct']['p50']:.3f} p99 "
              f"{row['iter_ms_pct']['p99']:.3f} max {row['iter_ms_pct']['max']:.1f} ms, response "
              f"latency p50 {row['latency_ms']['p50']:.3f} p99 {row['latency_ms']['p99']:.3f} ms "
              f"(virtual queueing + measured service), {row['flushes']} flushes, "
              f"{row['stage1_calls']} stage-1 calls, {len(row['fires'])} fires, card busy {busy} "
              f"({row['busy_samples']} nvidia-smi samples)")
    for f in on["fires"]:
        print(f"learn fire after event {f['at_event']}: window {f['window']}, graph "
              f"{f['graph_nodes']} nodes, fine-tune {f['fine_tune_s']:.3f} s ({f['steps']} steps, "
              f"{f['ms_per_step']:.2f} ms a step, synchronized), GBDT refit "
              f"{f['refit_s']:.3f} s, loss {f['loss_first']:.4f} -> {f['loss_last']:.4f}")
    for i, d in on["decisions"]:
        keep = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()}
        print(f"learn decision after event {i}: {json.dumps(keep)}")
    reg = on["regression"]
    print(f"learn: phase B ring recall@{LEARN_BUDGET}: frozen {on['frozen_ring_recall']:.3f} "
          f"({on['frozen_n']} responses) -> recovered {on['recovered_ring_recall']:.3f} "
          f"({on['recovered_n']}); {on['promotions_after_drift']} promotion(s) after the drift; "
          f"injected regression v{reg['bad']} rolled back to v{reg['promoted']} after "
          f"{reg['after_events']} events ({reg['decision']['reason']})")
    steps_ms = np.asarray(on["step_ms"])
    print(f"learn: learn-on/learn-off events/s {on['events_per_s'] / off['events_per_s']:.3f} "
          f"and {on2['events_per_s'] / off2['events_per_s']:.3f} (in the order off, on, on, "
          f"off: {off['events_per_s']:.1f}, {on['events_per_s']:.1f}, "
          f"{on2['events_per_s']:.1f}, {off2['events_per_s']:.1f}); a learner step p50 "
          f"{np.percentile(steps_ms, 50):.3f} ms, max {steps_ms.max():.1f} ms (a fire)")
    print(f"learn launches (learn-on run 1): {json.dumps(on['launches'])} = the run's record "
          f"{json.dumps(on['need'])}: stage2_score once per flush and shadow batch of an "
          f"MLP-headed version, csr_spmm {per_call} per stage-1 call ({on['stage1_calls']} "
          f"refresh calls, one refit a fire) and {per_step} per fine-tune step, csr_spmm_bwd "
          f"{per_step} per step; the two learn-on runs and the two learn-off runs equal bit "
          f"for bit; the incumbent's 64 probe scores and every leaf the same bits across "
          f"each of the {len(on2['fires'])} fires of run 2")
    out["runs"] = [{k: v for k, v in row.items()
                    if k not in ("scores", "iter_ms", "step_ms", "window")} for row in runs]

    # ---- one window: the card against the host's plain path
    window = on["window"]
    rows_ = [(e.snapshot, e.arrival, e.entities, e.features, e.label) for e in window]
    mat = dict(entity_history=sc.engine.entity_history, max_history=sc.engine.max_history,
               max_deg=sc.engine.max_deg)
    _, pg_c = trainer_mod._materialize_window(cfg, rows_, device=dev, **mat)
    _, pg_h = trainer_mod._materialize_window(cfg, rows_, device="cpu", **mat)
    params_h = from_numpy(to_numpy(params), "cpu")
    tuned_c, loss_c = trainer_mod._fine_tune(params, cfg, pg_c, ls.optimizer, ls.lr,
                                             LEARN_CHECK_STEPS)
    tuned_h, loss_h = trainer_mod._fine_tune(params_h, cfg, pg_h, ls.optimizer, ls.lr,
                                             LEARN_CHECK_STEPS)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loss_c, loss_h))
    host = dict(flatten_paths(to_numpy(tuned_h)))
    leaf_gap, worst = 0.0, ""
    for key, leaf in flatten_paths(to_numpy(tuned_c)):
        gap = float(np.abs(leaf.astype(np.float64) - host[key]).max()) / \
            float(np.abs(host[key]).max())
        if gap > leaf_gap:
            leaf_gap, worst = gap, key
    if not (loss_gap <= LEARN_LOSS_RTOL and leaf_gap <= LEARN_LEAF_TOL):
        raise AssertionError(f"learn card vs host: losses {loss_gap:.3e} relative, leaf {worst} "
                             f"{leaf_gap:.3e} of its scale")
    seen: list = []          # the refit's embeddings: the card's, then the host's
    real_hybrid = hybrid_mod.train_hybrid

    def capture(p, c, emb, labels, **kw):
        seen.append(emb)
        return real_hybrid(p, c, emb, labels, **kw)

    hybrid_mod.train_hybrid = capture
    try:
        for device, tuned, pg in ((dev, tuned_c, pg_c), ("cpu", tuned_c, pg_h)):
            tr = RollingWindowTrainer(cfg, head="hybrid", gbdt_trees=ls.gbdt_trees,
                                      k_max=sc.engine.k_max, max_deg=sc.engine.max_deg,
                                      device=device)
            tr._fit_hybrid(from_numpy(to_numpy(tuned), device),
                           *tr._materialize(window))
    finally:
        hybrid_mod.train_hybrid = real_hybrid
    embed_gap = float(np.abs(seen[0] - seen[1]).max())
    if not embed_gap <= LEARN_EMBED_TOL:
        raise AssertionError(f"learn card vs host: refit embeddings differ by {embed_gap:.3e}")
    out["card_vs_host"] = dict(window=len(window), graph_nodes=pg_c.num_nodes,
                               steps=LEARN_CHECK_STEPS, losses_card=loss_c, losses_host=loss_h,
                               loss_rel_gap=loss_gap, leaf_gap_of_scale=leaf_gap,
                               worst_leaf=worst, embed_gap=embed_gap)
    print(f"learn card vs host ({len(window)}-example window, {pg_c.num_nodes} nodes, "
          f"{LEARN_CHECK_STEPS} {ls.optimizer} steps from one warm start): losses "
          f"{', '.join(f'{x:.6f}' for x in loss_c)} within {loss_gap:.2e} relative, tuned leaves "
          f"within {leaf_gap:.2e} of their scale (worst {worst}), refit embeddings within "
          f"{embed_gap:.2e}")

    # ---- the inline fine-tune against the spawned trainer's, on the card
    trained = {}
    for in_process in (False, True):
        tr = RollingWindowTrainer(
            cfg, WindowPolicy(min_window=ls.min_window, max_window=ls.max_window,
                              stride=ls.stride), optimizer=ls.optimizer, lr=ls.lr,
            steps=ls.steps, head="hybrid", gbdt_trees=ls.gbdt_trees, k_max=sc.engine.k_max,
            max_deg=sc.engine.max_deg, in_process=in_process, device=dev)
        tr.extend(window)
        child = tr._train_in_process
        spawn: dict = {}

        def timed_child(p, w, child=child, spawn=spawn):
            t0 = time.perf_counter()
            with _MemorySampler() as mem:
                res = child(p, w)
            spawn.update(seconds=time.perf_counter() - t0, card_mib_added=mem.added,
                         compute_apps_mib=mem.apps)
            return res

        tr._train_in_process = timed_child
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.train(params)
        torch.cuda.synchronize()
        path = Path(scratch) / f"tuned-{in_process}.npz"
        save_checkpoint(str(path), res.params)
        with np.load(path) as z:
            blobs = {k: z[k].tobytes() for k in z.files}
        trained[in_process] = dict(losses=res.losses, blobs=blobs, seconds=time.perf_counter() - t0,
                                   spawn=spawn, gbdt=res.model.gbdt)
    inl, chl = trained[False], trained[True]
    probe_x = np.random.default_rng(0).normal(0, 1, (64, cfg.hidden_dim + feat_dim))
    if not (inl["losses"] == chl["losses"] and inl["blobs"] == chl["blobs"]
            and np.array_equal(inl["gbdt"].predict_proba(probe_x),
                               chl["gbdt"].predict_proba(probe_x))):
        raise AssertionError("learn: the spawned trainer's fine-tune differs from the inline one")
    sp = chl["spawn"]
    mem = "not measured" if sp["card_mib_added"] is None else f"+{sp['card_mib_added']:.0f} MiB"
    out["in_process"] = dict(window=len(window), steps=ls.steps, inline_s=inl["seconds"],
                             in_process_s=chl["seconds"], spawn_to_result_s=sp["seconds"],
                             card_mib_added=sp["card_mib_added"],
                             compute_apps_mib=sp["compute_apps_mib"])
    print(f"learn in-process ({len(window)}-example window, {ls.steps} steps, hybrid head): the "
          f"spawned trainer's {len(chl['losses'])} losses and {len(chl['blobs'])} tuned leaves "
          f"(npz bytes) and its refit's trees equal the inline fine-tune's bit for bit; a fire "
          f"takes {inl['seconds']:.3f} s inline and {chl['seconds']:.3f} s in-process, of which "
          f"spawn to result {sp['seconds']:.3f} s; the child's card memory {mem} at its peak "
          f"(nvidia-smi memory.used), compute apps (pid: MiB) {sp['compute_apps_mib']}")

    out["wire"] = learn_wire(dev, params, feat_dim, scratch)
    shutil.rmtree(scratch, ignore_errors=True)
    out["launches"] = {name: on["launches"].get(name, 0) for name in _build.LAUNCHES}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"learn phase: {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1

    from repro_torch.core import LNNConfig, lnn_init, lnn_stage1, lnn_stage2_online
    from repro_torch.data import (SynthConfig, build_communities,
                                  generate_transactions, make_split_masks,
                                  standardize_features)
    from repro_torch.kernels import _build
    from repro_torch.params import from_numpy, to_numpy
    from repro_torch.serve import (BatchLayer, KVStore, SpeedLayer, history_requests,
                                   host_sigmoid, split_equivalence_check)
    from repro_torch.serve.kvstore import pack_key

    dev = torch.device(DEVICE)
    # the stream phase drives the bare engine on purpose, beside the facade
    warnings.filterwarnings("ignore", message="constructing StreamingEngine directly",
                            category=DeprecationWarning)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------ 1. environment
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    lib = _build.load_library()
    print(f"kernel library: {'built' if lib.built else 'loaded'} in {lib.seconds:.2f} s "
          f"({lib.path.name})")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    if "--zoo-kernels" in sys.argv[1:]:
        zoo_kernel_checks(dev)
        return 0
    if "--cross" in sys.argv[1:]:
        zoo_kernel_checks(dev)
        print("cross: " + json.dumps(cross_phase(dev)))
        return 0
    if "--zoo" in sys.argv[1:]:
        zoo_kernel_checks(dev)
        zoo = zoo_slice(dev)
        zoo["f32_agreement_of_scale"] = zoo_agreement(dev)
        print("zoo: " + json.dumps(zoo))
        print("decoder: " + json.dumps(decoder_phase(dev)))
        return 0
    if "--stream" in sys.argv[1:]:
        stream_phase(dev)
        return 0
    if "--service" in sys.argv[1:]:
        service_phase(dev)
        return 0
    if "--procs" in sys.argv[1:]:
        procs_phase(dev)
        return 0
    if "--learn" in sys.argv[1:]:
        learn_phase(dev)
        return 0
    if "--zoo-train" in sys.argv[1:]:
        zoo_train_phase(dev)
        return 0
    if "--zoo-grad-kernels" in sys.argv[1:]:
        zoo_grad_kernel_checks(dev)
        return 0
    if "--dryrun" in sys.argv[1:]:
        dryrun_phase(dev)
        return 0

    # ----------------------------------------------------------------- data
    t0 = time.perf_counter()
    static, _ = generate_transactions(SynthConfig(num_users=3000, num_rings=50,
                                                  feature_noise=0.8, seed=1))
    split = make_split_masks(static.order_snapshot)
    static.order_features, _ = standardize_features(static.order_features, split == 0)
    batches = build_communities(static, community_size=256, max_deg=24)
    requests = history_requests(batches)
    feat_dim = batches[0].graph.features.shape[1]
    print(f"data: {static.num_orders} orders, {static.num_entities} entities, "
          f"{len(batches)} communities of {batches[0].graph.num_nodes} padded nodes "
          f"(max_deg {batches[0].graph.max_deg}), {len(requests)} history requests, "
          f"built in {time.perf_counter() - t0:.2f} s on the host")
    if "--fraud-kernels" in sys.argv[1:]:
        fraud_kernel_checks(dev, batches, feat_dim)
        return 0
    if "--train" in sys.argv[1:]:
        training(dev, batches, split, feat_dim)
        return 0

    # ------------------------------------ 2, 6. kernels against their plain versions
    results = fraud_kernel_checks(dev, batches, feat_dim)
    results.update(zoo_kernel_checks(dev))

    # ------------------------------------------------------- 3. the slice
    launches = {name: 0 for name in _build.LAUNCHES}
    expected = {"gcn": ("csr_spmm", "stage2_score"),
                "gat": ("edge_softmax", "stage2_score"),
                "sage": ("csr_spmm", "stage2_score")}
    slice_rows = []
    for gnn in ("gcn", "gat", "sage"):
        cfg = LNNConfig(gnn_type=gnn, num_gnn_layers=3, hidden_dim=64,
                        mlp_dims=(64, 32), feat_dim=feat_dim)
        params = lnn_init(torch.Generator().manual_seed(1), cfg, device=dev)
        store = KVStore(cfg.hidden_dim)
        batch_layer = BatchLayer(params, cfg, store, device=dev)
        speed_layer = SpeedLayer(params, cfg, store, k_max=8, device=dev)
        # warm-up (cuBLAS handles, allocator) before the counted run
        batch_layer.refresh(batches[:1])
        speed_layer.score(requests[:MICRO_BATCH])
        store = KVStore(cfg.hidden_dim)
        batch_layer.store = speed_layer.store = store
        torch.cuda.synchronize()

        _build.reset_launches()
        refresh = batch_layer.refresh(batches)
        # stage 1 per community: one aggregation launch per GNN layer before
        # the last (GCN's four edge types in one csr_spmm launch)
        per_refresh = _build.LAUNCHES[expected[gnn][0]] / len(batches)
        if per_refresh != cfg.num_gnn_layers - 1:
            raise AssertionError(f"{gnn}: {expected[gnn][0]} launched {per_refresh} times per "
                                 f"community refresh, expected {cfg.num_gnn_layers - 1}")
        lat, probs = [], []
        for i in range(0, len(requests), MICRO_BATCH):
            t1 = time.perf_counter()
            probs.append(speed_layer.score(requests[i:i + MICRO_BATCH]))
            lat.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        probs128 = speed_layer.score(requests[:128])
        lat128 = (time.perf_counter() - t1) * 1e3
        gap = split_equivalence_check(speed_layer.score, params, cfg, batches,
                                      atol=EQUIV_ATOL, device=dev)
        counts = dict(_build.LAUNCHES)

        for name in expected[gnn]:
            if counts[name] == 0:
                raise AssertionError(f"{gnn}: kernel {name} was never launched")
        for name, c in counts.items():
            launches[name] += c
        probs = np.concatenate(probs)
        if probs.shape != (len(requests),) or not np.all(np.isfinite(probs)):
            raise AssertionError(f"{gnn}: bad scores, shape {probs.shape}")
        if not np.all((probs >= 0) & (probs <= 1)):
            raise AssertionError(f"{gnn}: scores outside [0, 1]")
        batch_gap = float(np.abs(probs128 - probs[:128]).max())
        if not np.array_equal(probs128, probs[:128]):
            raise AssertionError(f"{gnn}: B=128 and B=16 scores differ (max {batch_gap})")

        # the same inputs through the plain path on the host
        params_cpu = from_numpy(to_numpy(params), "cpu")
        keys = [[pack_key(e, t) for e, t in r.entity_keys] for r in requests[:128]]
        emb, mask = store.lookup_batch(keys, 8)
        feats = np.stack([r.features for r in requests[:128]]).astype(np.float32)
        with torch.no_grad():
            cpu_probs = host_sigmoid(lnn_stage2_online(
                params_cpu, cfg, torch.from_numpy(emb), torch.from_numpy(mask),
                torch.from_numpy(feats)).numpy())
            h_gpu = lnn_stage1(params, cfg, batches[0].graph.to(dev)).cpu()
            h_cpu = lnn_stage1(params_cpu, cfg, batches[0].graph.to("cpu"))
        cpu_gap = float(np.abs(cpu_probs - probs128).max())
        h_gap = float((h_gpu - h_cpu).abs().max())
        if cpu_gap > 1e-5 or h_gap > 1e-4:
            raise AssertionError(f"{gnn}: card vs host plain path: scores {cpu_gap}, "
                                 f"stage 1 {h_gap}")

        lat = np.asarray(lat)
        row = dict(gnn=gnn, refresh_s=refresh["seconds"],
                   entities_written=refresh["entities_written"],
                   score_batches=len(lat), score_p50_ms=float(np.percentile(lat, 50)),
                   score_p99_ms=float(np.percentile(lat, 99)), score_b128_ms=lat128,
                   equivalence_gap=gap, batch_size_gap=batch_gap,
                   host_plain_gap=cpu_gap, stage1_host_gap=h_gap, launches=counts,
                   launches_per_community_refresh={expected[gnn][0]: per_refresh})
        row.update(score_breakdown(speed_layer, requests[:100 * MICRO_BATCH]))
        slice_rows.append(row)
        print(f"slice {gnn}: refresh {refresh['seconds']:.3f} s "
              f"({refresh['entities_written']} embeddings), score B={MICRO_BATCH} "
              f"p50 {row['score_p50_ms']:.3f} ms p99 {row['score_p99_ms']:.3f} ms "
              f"over {len(lat)} batches (of which KV lookup {row['lookup_ms']:.3f} ms, "
              f"stage-2 call {row['stage2_call_ms']:.3f} ms; device busy "
              f"{row['device_busy_share']:.1%}), B=128 {lat128:.3f} ms, "
              f"equivalence gap {gap:.3e}, host gap {cpu_gap:.2e}, stage-1 host gap "
              f"{h_gap:.2e}, launches {counts} ({expected[gnn][0]} {per_refresh:g} per "
              "community refresh)")
    print("slice: " + json.dumps(slice_rows))

    # --------------------------------------------------------- 4. streaming
    stream = stream_phase(dev)
    for name, c in stream["launches"].items():
        launches[name] += c
    print("stream: " + json.dumps(stream))

    # ------------------------------------------------------ 5. the service
    service = service_phase(dev)
    for name, c in service["launches"].items():
        launches[name] += c
    print("service: " + json.dumps(service))

    # -------------------------------------------- 11. the process backend
    procs = procs_phase(dev)
    for name, c in procs["launches"].items():
        launches[name] += c
    print("procs: " + json.dumps(procs))

    # ------------------------------- 12. the learn plane and the gateway
    learn = learn_phase(dev)
    for name, c in learn["launches"].items():
        launches[name] += c
    print("learn: " + json.dumps(learn))

    # ---------------------------------------------------------- 9. training
    results.update(training(dev, batches, split, feat_dim))
    for name, c in results["table3"]["launches"].items():
        launches[name] += c

    # ------------------------------------------------- 7, 8. the zoo slice
    zoo = zoo_slice(dev)
    for name in ("ssd_scan", "flash_attention", "gqa_decode"):
        launches[name] += zoo["launches"][name]
    zoo["f32_agreement_of_scale"] = zoo_agreement(dev)
    print("zoo: " + json.dumps(zoo))
    decoder = decoder_phase(dev)
    for name, c in decoder["launches"].items():
        launches[name] += c
    print("decoder: " + json.dumps(decoder))

    # ----------------------- 13. cross attention: the vlm and audio groups
    cross = cross_phase(dev)
    for name, c in cross["launches"].items():
        launches[name] += c
    print("cross: " + json.dumps(cross))

    # ------------------------------------------------- 14. the zoo's training
    zoo_train = zoo_train_phase(dev)
    for name, c in zoo_train["launches"].items():
        launches[name] += c
    results.update(zoo_train["kernels"])
    print("zoo_train: " + json.dumps({k: v for k, v in zoo_train.items() if k != "kernels"}))

    # -------------------------------------------------- 15. the dry-run tools
    dry = dryrun_phase(dev)
    for name, c in dry["launches"].items():
        launches[name] += c
    print("dryrun: " + json.dumps({k: v for k, v in dry.items() if k != "records"}))

    # ------------------------------------------------------- 10. kernel line
    def pick(name, shape_prefix, shape_suffix=""):
        return next(c for c in results[name] if c["shape"].startswith(shape_prefix)
                    and c["shape"].endswith(shape_suffix))

    chosen = {
        "csr_spmm": pick("csr_spmm", f"N={batches[0].graph.num_nodes} "
                                     f"D={batches[0].graph.max_deg} H=64 float32"),
        "edge_softmax": results["edge_softmax"][0],
        "stage2_score": pick("stage2_score",
                             f"gcn untyped B={MICRO_BATCH} K=8 H=64 F={feat_dim}"),
        # the zoo slice serves in bf16
        "ssd_scan": pick("ssd_scan", f"B={ZOO_BATCH} S={ZOO_SEQ} H=64 P=64 N=64 bfloat16"),
        "flash_attention": pick("flash_attention",
                                f"B={ZOO_BATCH} Hq=32 Hkv=32 Sq={ZOO_SEQ} Sk={ZOO_SEQ} Dh=64 "
                                "causal w=None bfloat16"),
        "gqa_decode": pick("gqa_decode",
                           f"B={ZOO_BATCH} Hq=32 Hkv=32 S={ZOO_SEQ + ZOO_TOKENS} Dh=64 "
                           "w=None", "bfloat16"),
    }
    meta = {
        "csr_spmm": ("src/repro_torch/kernels/csrc/csr_spmm.cu",
                     "src/repro/kernels/csr_spmm.py:53"),
        "edge_softmax": ("src/repro_torch/kernels/csrc/edge_softmax.cu",
                         "src/repro/kernels/edge_softmax.py:56"),
        "stage2_score": ("src/repro_torch/kernels/csrc/stage2_score.cu",
                         "src/repro/kernels/stage2_score.py:242"),
        "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:81"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:97"),
        "gqa_decode": ("src/repro_torch/kernels/csrc/gqa_decode.cu",
                       "src/repro/kernels/gqa_decode.py:86"),
    }
    # the backward kernels: the reference has none (it differentiates its XLA
    # path), so each stands beside the forward's TPU kernel
    reference = ("; the reference has no backward kernel and differentiates its XLA path "
                 "(use_pallas=False)")
    grad_notes = {
        "csr_spmm_bwd": "backward of the forward's kernel: one launch for either entry, a warp "
                        "per source row over the reverse-slot index, a lane per slot, all of "
                        "the row's gathers of dout in flight at once, summed in slot order; the "
                        "per-type entry reads the slot weights its forward wrote under grad"
                        + reference,
        "edge_softmax_bwd": "backward of the forward's kernel: one launch, two warps a row, "
                            "from the forward's output and the softmax max and sum it wrote "
                            "under grad (c = dout . out); the destination warp gathers z of "
                            "the row's valid slots for dlogit, d_bias and ds_dst, the source "
                            "warp walks the reverse-slot index for dz and ds_src, every dot "
                            "product in one layout (32 sums in 31 shuffles), so both give an "
                            "edge the same dlogit" + reference}
    chosen["csr_spmm_bwd"] = results["csr_spmm_bwd"][0]
    chosen["edge_softmax_bwd"] = results["edge_softmax_bwd"][0]
    meta["csr_spmm_bwd"] = meta["csr_spmm"]
    meta["edge_softmax_bwd"] = meta["edge_softmax"]
    # the zoo's training runs bf16 at zamba2-1.2b's shapes
    chosen["flash_attention_bwd"] = pick("flash_attention_bwd",
                                         f"B={ZOO_BATCH} Hq=32 Hkv=32 Sq={ZOO_SEQ} Sk={ZOO_SEQ} "
                                         "Dh=64 causal w=None bfloat16")
    chosen["ssd_scan_bwd"] = pick("ssd_scan_bwd",
                                  f"B={ZOO_BATCH} S={ZOO_SEQ} H=64 P=64 N=64 bfloat16")
    meta["flash_attention_bwd"] = meta["flash_attention"]
    meta["ssd_scan_bwd"] = meta["ssd_scan"]
    grad_notes["flash_attention_bwd"] = (
        "backward of the forward's kernel, whose saving forward writes each row's logsumexp: "
        "delta = rowsum(dout * out), then dk/dv (a block per key tile, over the kv head's q "
        "heads and the q tiles that see it) and dq (a block per q tile), each 64 x 64 tile of "
        "S and dP recomputed; bf16 (this line) FlashAttention-2's backward on mma.sync: 4 "
        "warps of 16 rows, tiles double-buffered by cp.async, S/dP by mma, P and dS rounded "
        "to bf16 as A fragments for dV += P^T dO, dK += dS^T Q, dQ += dS K (ldmatrix.trans); "
        "f32 keeps f32 FMA from shared memory; no atomics" + reference)
    grad_notes["ssd_scan_bwd"] = (
        "backward of the chunked scan; bf16 (this line) chunk-parallel on mma.sync: a states "
        "kernel (a block per 64 columns, head and sequence) writes the state before each chunk "
        "and the state's gradient after it, each chunk's sum one mma product; then a block per "
        "(chunk, head, sequence) does C B^T, dY X^T, C H, dY H^T, X R^T, B R and the three "
        "lower-triangular weighted products on the tensor cores, the elementwise terms, "
        "d(cum) and its prefix sum's reverse in f32; f32 keeps a block per (head, sequence) "
        "on f32 FMA; db, dc (per head) and da, dd summed in order by a last kernel; no "
        "atomics" + reference)
    kernels = []
    for name, case in chosen.items():
        source, replaces = meta[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=case["max_abs_err"],
            atol=(TOL["bfloat16"]["atol"] if "bfloat16" in case["shape"] else
                  GRAD_TOL["atol"] if name.endswith("_bwd") else TOL["float32"]["atol"]),
            ms=case["ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"], library_ms=case["library_ms"],
            shape=case["shape"], cases=len(results[name]),
            **{k: case[k] for k in ("err_of_scale", "tol_of_scale") if k in case}))
    # csr_spmm's second entry, the per-edge-type mean (its launches count
    # under csr_spmm), and the composition it replaced
    etype = next(c for c in results["csr_spmm_etype_mean"] if c["shape"].endswith("float32"))
    kernels[0]["etype_mean"] = {k: etype[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "composition_ms")}
    kernels[0]["cases"] += len(results["csr_spmm_etype_mean"])
    by_name = {entry["name"]: entry for entry in kernels}
    for name in grad_notes:
        entry = by_name[name]
        entry["note"] = grad_notes[name]
        entry["same_bits"] = all(c["same_bits"] for c in results[name])
        entry["launch_floor_ms"] = chosen[name]["launch_floor_ms"]
        # beside the bound: the time at the memory rate of what the design
        # reads beyond the function's inputs (the forward's saved values)
        entry["design_overhead_ms"] = chosen[name].get("design_overhead_ms", 0.0)
    per_type = results["csr_spmm_bwd"][1]
    by_name["csr_spmm_bwd"]["etype_mean"] = {k: per_type[k] for k in (
        "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    # the stream phase: its launches (three full replays) and its own shapes
    case_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for entry in kernels:
        entry["stream_launches"] = stream["launches"][entry["name"]]
        entry["service_launches"] = service["launches"][entry["name"]]
        entry["procs_launches"] = procs["launches"][entry["name"]]
        entry["learn_launches"] = learn["launches"][entry["name"]]
        entry["zoo_train_launches"] = zoo_train["launches"][entry["name"]]
        entry["dryrun_launches"] = dry["launches"].get(entry["name"], 0)
        case = stream["kernel_cases"].get(entry["name"])
        if case is not None:
            entry["stream_case"] = {k: case[k] for k in case_keys}
    by_name["csr_spmm"]["stream_case"]["etype_mean"] = {
        k: stream["kernel_cases"]["csr_spmm_etype_mean"][k] for k in case_keys}
    by_name["stage2_score"]["stream_case"]["same_bits_as_b16"] = \
        stream["kernel_cases"]["stage2_score"]["same_bits_as_b16"]
    # the decoder group's runs: their launches, and each kernel at
    # granite-3-2b's serving shape (bf16)
    for entry in kernels:
        entry["decoder_launches"] = decoder["launches"][entry["name"]]
        entry["cross_launches"] = cross["launches"][entry["name"]]
    by_name["flash_attention"]["decoder_case"] = {k: pick(
        "flash_attention", f"B={ZOO_BATCH} Hq=32 Hkv=8 Sq={ZOO_SEQ} Sk={ZOO_SEQ} Dh=64 "
        "causal w=None bfloat16")[k] for k in case_keys}
    by_name["gqa_decode"]["decoder_case"] = {k: pick(
        "gqa_decode", f"B={ZOO_BATCH} Hq=32 Hkv=8 S={ZOO_SEQ + ZOO_TOKENS} Dh=64 w=None",
        "bfloat16")[k] for k in case_keys}
    # the cross runs: each kernel at llama-3.2-vision's cross layer (bf16)
    by_name["flash_attention"]["cross_case"] = {k: pick(
        "flash_attention", f"B={ZOO_BATCH} Hq=64 Hkv=8 Sq={ZOO_SEQ} Sk=1601 Dh=128 "
        "full w=None bfloat16")[k] for k in case_keys}
    by_name["gqa_decode"]["cross_case"] = {k: pick(
        "gqa_decode", f"B={ZOO_BATCH} Hq=64 Hkv=8 S=1601 Dh=128 w=None kv_len=all",
        "bfloat16")[k] for k in case_keys}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
