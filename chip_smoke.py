#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`), on one card.

    python3 chip_smoke.py        # from the repository root

Drives only the port (no JAX, nothing of `repro`).  Each phase prints its
lines; any failure exits nonzero, and nothing is caught:

  1. build every kernel of the port from `src/repro_torch/kernels/csrc`
     (six sources, one nvcc each, in parallel) for sm_90a and print the
     build time and each kernel's registers, shared memory and spills;
  2. the kernel against its plain PyTorch version on the card, at the four
     SmolLM-360M projection shapes and a ragged one, M = 4 (CUDA-core
     path) and 32 (tensor-core path), f32 and bf16 x, bits 4 and 8: exact
     on integer x with scale 1, else within the f32 bound for two orders
     of one sum, |d| <= (K+2) * 2^-23 * (|x| @ |w|); and a bf16 y equal,
     bit for bit, to the f32 y rounded to nearest even;
  3. a reduced SmolLM (f32, 2 layers, 8-bit planes) on the card against
     the port's plain path on the CPU with the same params: equal greedy
     tokens, logits within 1e-4;
  4. the main path: full SmolLM-360M (32 layers, d_model 960, bf16, 8-bit
     planes, random params from a seeded generator) through
     `serve.engine.generate` (batch 4 x 8-token prompts) and then
     `serve_continuous` (8 requests over 4 slots), with the kernel's
     launch count reset just before and read just after; plus one decode
     step with the kernel against the plain version on the card; that
     every projection of a decode step hands the kernel x in the model's
     dtype and takes y in it (no cast around the kernel), with the step's
     casts counted; and a torch.profiler pass over a short generate
     (device busy share, cast launches);
  5. the kernel's time beside its byte bound, its plain version's and
     `torch.matmul`'s on the dequantised f32 weight, at the four shapes,
     M = 4 and 32, f32 and bf16 x and y, and one trivial kernel timed
     alike;
  6. the CoMeFa step kernel (`csrc/comefa_step.cu`), built in the same
     parallel nvcc run as the bit-plane kernel: build time, registers,
     shared memory and spills;
  7. the step kernel against its plain version (the packed torch scan) and
     the uint8 `reference` engine on the card: seeded random programs,
     shared and per-slot, chain both ways, run_programs with latch resets
     both ways, nb in {1, 2, 6, 7, 16, 17} (warps of six blocks ending
     exactly, early and one block over), plus real chunk programs at the
     main path's shapes; mem, carry and mask must be bit-identical; then
     chained slots past one CTA (nb 78, 79, 160, 624: one CTA, then
     clusters of 2, 4 and 8 through distributed shared memory) against the
     packed scan and the reference engine, the card's
     cudaOccupancyMaxActiveClusters for the 8-CTA cluster, nb = 625
     refused with a ValueError before any launch, and 65,536 unchained
     slots against the packed scan;
  8. the grid path: full-width SmolLM-360M (d_model 960, d_ff 2560, 15/5
     heads, vocab 49152, bf16, 8-bit planes, random seeded params) at
     full depth (32 layers), served by `serve_continuous` with 4 staggered
     requests over a 4-slot `GridLinearExecutor` (broadcast mode, cuda
     engine); every hooked call is also run by a ``backend="reference"``
     executor and must be `torch.equal`; the step kernel's launch count is
     reset just before and read just after, and must equal the grid's
     dispatch count; grid cycles per layer-wave must equal the planner's
     quote;
  9. the per-slot layout on the card: ``recode="naive"`` and ``"auto"`` at
     the tiny serving config of `benchmarks/sim_speed.py` (vocab 64, one
     layer, d_model 32, 6 staggered requests over 2 slots), bit-exact
     against the reference backend;
 10. the step kernel's time for one chunk dispatch (shared program,
     decoded once as the grid's cache does, 4 slots, nb = 16, T = 752)
     with CUDA events, beside its byte and dependency bounds and its
     plain version's time;
 11. the bit-serial and bulk-bitwise kernels (bit transpose and
     untranspose, search-replace, RAID XOR, bit-serial reduce and matmul)
     against their plain versions, bit for bit, at one, ragged and
     block-multiple word counts; the reduce also against the int64 sum
     rounded once; the bit-serial matmul at SmolLM-360M's four projection
     shapes (M=4, 8x8 and 4x4 bits) and ragged ones, exact on integers and
     within the f32 bound of `ref.bitserial_matmul_ref` when scaled, and
     over its binary-MMA tiling: M in {1, 4, 5, 16, 17, 64}, K in {32, 96,
     256, 960, 2560}, N in {1, 8, 100, 320, 2560}, a and w in {1, 3, 8},
     exact on integers and equal to the plain version when scaled;
 12. the paper's workloads composed through `kernels.ops` at real sizes,
     with the six kernels' launch counts reset just before and read just
     after: (a) search-replace of 2^27 16-bit records (bit_transpose ->
     search_replace -> bit_untranspose, against torch.where); (b) RAID
     rebuild of one of 7 data stripes of 2^24 words from the survivors and
     parity; (c) reduction of 2^28 signed 8-bit values against the int64
     sum; (d) one SmolLM-360M layer's 7 projections bit-serially at M=4,
     8x8 bits, against the oracle and, on the same integers, exactly
     against the bit-plane kernel;
 13. the six kernels' times at the phase-12 sizes (CUDA graph and events)
     beside their bounds, their plain versions' and the one PyTorch call
     that computes the same function where there is one; for the
     bit-serial matmul also its launch geometry (CTAs, cluster size), the
     rate its binary MMAs reach and the time of one trivial kernel timed
     the same way (the floor of a call);
 14. the paper's evaluation layer on the step kernel: the six array
     kernels of `kernels.comefa_sim` on the cuda engine at the sizes
     `core/fpga_model/perf.py` prices - eltwise multiply of 100,000 8-bit
     pairs (625 blocks), GEMV [512, 512] (recode naive and auto), GEMM
     [128, 128] @ [128, 128] on 128 chained blocks (2-CTA clusters) alone
     and 4 to a grid, a dot of 2,560 pairs (16 chained blocks, one
     106,816-instruction launch), the int16 FIR (128 taps, 36-bit
     accumulator, 4,096 samples) and one of 12,800 taps (80 blocks,
     clusters) - each exactly equal to its numpy oracle, with the step
     kernel's launch count reset just before and read just after and
     equal to the simulator's dispatches; the unoptimised dot's and
     FIR's modelled cycles equal to `timing`'s closed forms; each call's
     wall time, launches, host syncs, device puts and modelled cycles;
     after the counted path, the step kernel held to its plain version
     (torch.equal on mem, carry and mask from the same state) on the
     GEMM's first and last tiles, the dot's one launch and every dispatch
     of three samples of the long FIR; and `fpga_model.perf.run_all()`'s
     Fig 9 table on one line;

then one JSON line of kernel records (the step kernel's launches are
phase 8's and phase 14's), the card's name and power limit as
nvidia-smi prints them, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import copy
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1.979e15      # H100 SXM int8 tensor cores, dense
BITS = 8
M_DECODE = 4
M_PREFILL = 32      # phase 4's prefill: batch 4 x 8-token prompts
# SmolLM-360M's packed projections (K, N) and how many of each a layer runs
SMOLLM_SHAPES = {(960, 960): 2,      # wq, wo
                 (960, 320): 2,      # wk, wv
                 (960, 2560): 2,     # wi, wg
                 (2560, 960): 1}     # ffn wo
RAGGED = (3, 64, 100)
# depth of phase 8's full-width grid model: all 32 layers, since the phase
# measured 52.8 s at that depth (0.33 s a layer-wave; PERF.md), well under
# the 300 s that would call for a cut
GRID_LAYERS = 32
GRID_SLOTS = 4
# The step kernel's dependency bound: each instruction is at least one
# dependent shared-memory load -> ALU -> store step.  Hopper's
# shared-memory load-to-use latency is about 30 cycles (published
# microbenchmarks; not measured here) and a dependent integer op about 4.
SMEM_LOAD_CYCLES = 30
ALU_CYCLES = 4


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build(nvcc, sources, tags):
    """Build every kernel of the port at once (one nvcc per source), and
    print nvcc's report of each kernel: registers, shared memory, spills."""
    t0 = time.perf_counter()
    libs = nvcc.build(*sources)
    dt = time.perf_counter() - t0
    print(f"[1 build] {len(libs)} sources in {dt:.2f} s, in parallel "
          f"(nvcc {' '.join(nvcc.NVCC_FLAGS)})")
    for tag, lib in zip(tags, libs):
        print(f"[{tag}] {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line or "smem" in line):
                print(f"[{tag}]   {line.strip()}")


def _operands(gen, dev, bits, m, k, n, integer):
    lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
    q = torch.randint(lo, hi, (k, n), generator=gen, device=dev,
                      dtype=torch.int32)
    if integer:
        x = torch.randint(-8, 8, (m, k), generator=gen, device=dev).float()
        scale = torch.ones((1, n), device=dev)
    else:
        x = torch.randn((m, k), generator=gen, device=dev)
        scale = torch.rand((1, n), generator=gen, device=dev) * 0.09 + 0.01
    return x, q, scale


def phase_kernel_vs_plain(bpm, bitplane, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    shapes = [(m, k, n) for m in (M_DECODE, M_PREFILL)
              for k, n in SMOLLM_SHAPES] + [RAGGED, (M_PREFILL,) + RAGGED[1:]]
    for m, k, n in shapes:
        for bits in (4, BITS):
            xi, qi, ones = _operands(gen, dev, bits, m, k, n, integer=True)
            pi = bitplane.pack(qi, bits)
            x, q, scale = _operands(gen, dev, bits, m, k, n, integer=False)
            planes = bitplane.pack(q, bits)
            exact, rounded, ratio = True, True, 0.0
            for xd in (torch.float32, torch.bfloat16):
                yk = bpm.bitplane_matmul(xi.to(xd), pi, ones, bits=bits)
                yp = bpm.bitplane_matmul_plain(xi.to(xd), pi, ones, bits=bits)
                torch.cuda.synchronize()
                exact = exact and torch.equal(yk, yp)
                xx = x.to(xd)
                yk = bpm.bitplane_matmul(xx, planes, scale, bits=bits)
                yp = bpm.bitplane_matmul_plain(xx, planes, scale, bits=bits)
                # a bf16 y (the main path's) is the f32 y rounded once
                yb = bpm.bitplane_matmul(xx, planes, scale, bits=bits,
                                         out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
                rounded = rounded and torch.equal(yb, yk.to(torch.bfloat16))
                bound = (k + 2) * 2.0 ** -23 * (
                    xx.abs().double() @ (q.abs().double() * scale.double()))
                err = (yk - yp).abs().double()
                ratio = max(ratio, float((err / bound).max()))
                worst = max(worst, float(err.max()))
            path = bpm.geometry(m, k, n, _sms())["path"]
            print(f"[2 kernel] M={m} K={k} N={n} bits={bits} ({path} path), "
                  f"x f32 and bf16: integer exact={exact}; float max "
                  f"|d|/bound={ratio:.3f}; bf16 y = f32 y rounded to "
                  f"nearest even: {rounded}")
            if not (exact and rounded and ratio <= 1):
                fail(f"kernel disagrees with plain at M={m} K={k} N={n} "
                     f"bits={bits}")
    return worst


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def phase_reduced(bpm, configs, common, lm, engine, dev):
    cfg = common.reduced(configs.get("smollm-360m"), n_layers=2,
                         quant_bits=BITS)
    cpu_model = lm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    prompt = torch.randint(0, cfg.vocab, (4, 8),
                           generator=torch.Generator().manual_seed(1))
    steps = 8
    tok_cpu = engine.generate(cpu_model, prompt, steps=steps, max_len=17)
    before = bpm.launches
    tok_gpu = engine.generate(gpu_model, prompt.to(dev), steps=steps,
                              max_len=17)
    launched = bpm.launches - before
    l_cpu = lm.forward(cpu_model, prompt)
    l_gpu = lm.forward(gpu_model, prompt.to(dev)).cpu()
    d = float((l_cpu - l_gpu).abs().max())
    same = torch.equal(tok_cpu, tok_gpu.cpu())
    print(f"[3 reduced] f32 2-layer SmolLM, card (kernel) vs CPU (plain): "
          f"greedy tokens equal={same}, forward logits max|d|={d:.3e}, "
          f"kernel launches={launched}")
    if not same or d > 1e-4:
        fail("reduced model on the card disagrees with the CPU")
    if launched != 7 * cfg.n_layers * (prompt.shape[1] + steps):
        fail(f"reduced generate launched the kernel {launched} times")


def _plain_hook(bpm):
    def hook(params, x2, bits):
        return bpm.bitplane_matmul_plain(x2.float(), params["packed"],
                                         params["scale"], bits=bits)
    return hook


def phase_full(bpm, configs, common, lm, engine, dev):
    cfg = configs.get("smollm-360m", quant_bits=BITS)
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in model.state_dict().values())
    print(f"[4 full] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, {BITS}-bit planes; "
          f"{n_params} stored values, init {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, steps = M_DECODE, 8, 24
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    # warm-up (first launches, allocator), not counted
    engine.generate(model, prompt, steps=2, max_len=s + 3)
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    bpm.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(model, prompt, steps=steps, max_len=s + steps + 1)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    rng = torch.Generator().manual_seed(2)
    reqs = []
    for i in range(8):
        plen = 3 + i % 6
        p = torch.randint(0, cfg.vocab, (plen,), generator=rng).numpy()
        reqs.append(engine.Request(p, 4 + (3 * i) % 9))
    stats = {}
    t0 = time.perf_counter()
    outs = engine.serve_continuous(model, reqs, slots=4, max_len=24,
                                   stats=stats)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launched = bpm.launches
    # ---- end of the counted main path ----

    calls = (s + steps) + stats["steps"]
    expect = 7 * cfg.n_layers * calls
    emitted = sum(len(o) for o in outs)
    print(f"[4 full] generate: {b}x{s} prompt, {steps} steps in "
          f"{gen_s:.3f} s = {b * steps / gen_s:.1f} tokens/s, "
          f"{1e3 * gen_s / (s + steps):.2f} ms per decode step")
    print(f"[4 full] serve_continuous: {len(reqs)} requests, {emitted} "
          f"tokens in {serve_s:.3f} s = {emitted / serve_s:.1f} tokens/s, "
          f"{stats['steps']} batched steps, occupancy "
          f"{stats['occupancy']:.3f}")
    print(f"[4 full] bit-plane kernel launches: {launched} (expected 7 x "
          f"{cfg.n_layers} x {calls} decode-path calls = {expect})")
    if launched != expect or launched == 0:
        fail("the main path did not run every projection through the kernel")
    out_cpu = out.cpu()
    if tuple(out_cpu.shape) != (b, steps) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab:
        fail(f"generate returned {tuple(out_cpu.shape)} tokens out of range")
    for r, o in zip(reqs, outs):
        if len(o) != r.steps or o.min() < 0 or o.max() >= cfg.vocab:
            fail("serve_continuous returned a wrong token stream")

    # one decode step, kernel vs plain on the card, from the same cache
    states = lm.decode_state_init(cfg, b, 16, dev)
    for t in range(s):
        _, states = lm.decode_step(model, prompt[:, t:t + 1], states, t)
    saved = [{k: v.clone() for k, v in st.items()} for st in states]
    nxt = out[:, :1].long()
    lk, _ = lm.decode_step(model, nxt, states, s)
    prev = common.set_linear_hook(_plain_hook(bpm))
    try:
        lp, _ = lm.decode_step(model, nxt, saved, s)
    finally:
        common.set_linear_hook(prev)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("non-finite logits")
    d = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    # Both paths sum in f32 in different orders and round every projection
    # output to bf16; a rare 1-ulp bf16 flip (2^-8 relative) is carried by
    # 32 residual layers, so logits are held to 5% of their largest value.
    print(f"[4 full] decode step kernel vs plain on the card: logits "
          f"max|d|={d:.3e}, max|logit|={scale:.3e}, ratio {d / scale:.2e} "
          f"(tolerance 5e-2), argmax agreement {agree:.2f}")
    if d > 5e-2 * scale:
        fail("full-model decode step: kernel and plain disagree")
    calls, casts = _projection_dtypes(
        bpm, lambda: lm.decode_step(model, nxt, saved, s))
    seen = sorted({(str(a), str(b)) for a, b in calls})
    print(f"[4 casts] one decode step: {len(calls)} bit-plane kernel calls, "
          f"(x, y) dtypes {seen}: no cast before or after any packed "
          f"projection; {casts} aten._to_copy casts in the whole step")
    if len(calls) != 7 * cfg.n_layers or \
            any(a != cfg.adtype or b != cfg.adtype for a, b in calls):
        fail("a packed projection casts around the bit-plane kernel")
    step_s = gen_s / (s + steps)
    profile_decode(lambda: engine.generate(model, prompt, steps=4,
                                           max_len=s + 5), s + 4, step_s)
    return launched, step_s


def _projection_dtypes(bpm, run):
    """Run `run()` with every bit-plane kernel call's x and y dtypes
    recorded and every aten._to_copy (a cast) counted by a
    TorchDispatchMode: returns the calls' (x dtype, y dtype) pairs and the
    number of casts."""
    from torch.utils._python_dispatch import TorchDispatchMode
    calls, casts = [], [0]
    real = bpm.bitplane_matmul

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is torch.ops.aten._to_copy:
                casts[0] += 1
            return func(*args, **(kwargs or {}))

    def logged(x, planes, scale, *, bits, out_dtype=torch.float32, **kw):
        calls.append((x.dtype, out_dtype))
        return real(x, planes, scale, bits=bits, out_dtype=out_dtype, **kw)

    bpm.bitplane_matmul = logged
    try:
        with Casts():
            run()
    finally:
        bpm.bitplane_matmul = real
    return calls, casts[0]


def profile_decode(run, calls, step_s):
    """Where a decode call's time goes: device time per call (kernels and
    copies, from torch.profiler) against the unprofiled wall time per
    call, and the largest device and host entries."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    on_dev = [e for e in avg if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in on_dev) / calls
    if dev_us == 0:
        print("[4 profile] the profiler recorded no device time: the "
              "device's busy share is not measured")
        return
    print(f"[4 profile] device busy {dev_us / 1e3:.3f} ms per decode call "
          f"of {1e3 * step_s:.2f} ms wall unprofiled "
          f"({100 * dev_us / (1e6 * step_s):.1f}% busy)")
    cast = [e for e in on_dev if "copy_kernel" in e.key]
    print(f"[4 profile] casts on the device: "
          f"{sum(e.count for e in cast) / calls:.1f} launches and "
          f"{sum(e.self_device_time_total for e in cast) / calls:.1f} us per "
          f"decode call")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[4 profile]   device {e.self_device_time_total / calls:8.1f}"
              f" us/call  {e.count // calls:4d}x  {e.key[:70]}")
    on_host = [e for e in avg if not str(e.device_type).endswith("CUDA")]
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"[4 profile]   host {e.self_cpu_time_total / calls:8.1f}"
              f" us/call  {e.count // calls:4d}x  {e.key[:70]}")


def _time_ms(fn, calls, replays=5):
    """Device time of one ``fn(i)``, from CUDA events around replays of a
    CUDA graph holding ``fn(0) .. fn(calls-1)`` back to back, so that the
    host's launch overhead is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def _copies(nbytes, target=256e6):
    """Distinct operand copies to cycle through so that each call finds
    its weights out of the 50 MB L2, as the main path's 32 layers do."""
    return max(2, min(1000, math.ceil(target / nbytes)))


def phase_timings(bpm, bitplane, dev, smi):
    """Each SmolLM-360M shape at M = 4: the kernel on bf16 x and y (the
    main path's call, the record's numbers) and on f32 x and y; its bound,
    plain version and torch.matmul on the dequantised weight (bf16 and
    f32); then M = 32 (prefill); and one trivial kernel timed alike (the
    floor of a call).  The bound is the larger of the bytes and the
    products at the bf16 tensor-core rate: one bf16 product a weight and
    row for a bf16 x, three (hi, mid, lo) for an f32 x."""
    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    rows = {}
    for (k, n), per_layer in SMOLLM_SHAPES.items():
        row = {}
        for m in (M_DECODE, M_PREFILL):
            x, q, scale = _operands(gen, dev, BITS, m, k, n, integer=False)
            xb = x.to(bf)
            planes = bitplane.pack(q, BITS)
            w = bitplane.dequantize(q, scale)                   # f32 [K, N]
            wb = w.to(bf)
            pc = [planes.clone() for _ in range(_copies(planes.numel() * 4))]
            wc = [w.clone() for _ in range(_copies(w.numel() * 4))]
            wbc = [wb.clone() for _ in range(_copies(wb.numel() * 2))]

            def kernel(xx, od=torch.float32):
                return _time_ms(lambda i: bpm.bitplane_matmul(
                    xx, pc[i % len(pc)], scale, bits=BITS, out_dtype=od),
                    len(pc))

            t = {"f32": kernel(x), "bf16": kernel(xb, bf),
                 "lib": _time_ms(lambda i: torch.matmul(x, wc[i % len(wc)]),
                                 len(wc)),
                 "lib_bf16": _time_ms(
                     lambda i: torch.matmul(xb, wbc[i % len(wbc)]),
                     len(wbc))}
            nbytes = BITS / 8 * k * n + 4 * m * k + 4 * m * n + 4 * n
            t["bytes"] = 1e3 * nbytes / HBM_BYTES_PER_S
            t["bytes_bf16"] = 1e3 * (nbytes - 2 * m * (k + n)) / \
                HBM_BYTES_PER_S
            t["ops_bf16"] = 1e3 * 2 * m * k * n / BF16_FLOP_PER_S
            t["ops"] = 3 * t["ops_bf16"]
            if m == M_DECODE:
                t["plain"] = _time_ms(lambda i: bpm.bitplane_matmul_plain(
                    x, pc[i % len(pc)], scale, bits=BITS), 10)
                t["plain_bf16"] = _time_ms(
                    lambda i: bpm.bitplane_matmul_plain(
                        xb, pc[i % len(pc)], scale, bits=BITS, out_dtype=bf),
                    10)
                out = torch.empty((m, n), device=dev)
                t["floor"] = _time_ms(lambda i: out.zero_(), len(pc))
            geo = bpm.geometry(m, k, n, _sms())

            def bound(suffix=""):
                b, o = t["bytes" + suffix], t["ops" + suffix]
                return (f"{max(b, o) * 1e3:.2f} us ("
                        f"{'bytes' if b >= o else 'operations'})")

            print(f"[5 time] M={m} K={k} N={n} bits={BITS} ({geo['path']} "
                  f"path, {geo['splits']} splits, {geo['ctas']} CTAs): "
                  f"kernel bf16 x and y {t['bf16'] * 1e3:.2f} us, bound "
                  f"{bound('_bf16')}, torch.matmul in bf16 "
                  f"{t['lib_bf16'] * 1e3:.2f} us; kernel f32 x and y "
                  f"{t['f32'] * 1e3:.2f} us, bound {bound()}, "
                  f"{nbytes / t['f32'] / 1e6:.0f} GB/s achieved, "
                  f"torch.matmul in f32 {t['lib'] * 1e3:.2f} us" + (
                      f"; plain bf16 {t['plain_bf16'] * 1e3:.2f} us, f32 "
                      f"{t['plain'] * 1e3:.2f} us; one trivial kernel "
                      f"(zero_ of y) {t['floor'] * 1e3:.2f} us"
                      if m == M_DECODE else "") + f"; {smi}")
            row[m] = t
            del pc, wc, wbc
        rows[(k, n)] = row

    def layer(m, key):
        return sum(rows[s][m][key] * c for s, c in SMOLLM_SHAPES.items())

    dec = {key: layer(M_DECODE, key)
           for key in ("f32", "bf16", "lib", "lib_bf16", "plain",
                       "plain_bf16", "bytes", "ops", "bytes_bf16",
                       "ops_bf16")}
    record = {"ms": dec["bf16"], "plain_ms": dec["plain_bf16"],
              "library_ms": dec["lib_bf16"],
              "bound_ms": max(dec["bytes_bf16"], dec["ops_bf16"]),
              "bound_by": "bytes" if dec["bytes_bf16"] >= dec["ops_bf16"]
              else "operations"}
    print(f"[5 time] one layer's 7 projections (M={M_DECODE}, bf16 x and y "
          f"as the main path calls them): kernel {dec['bf16'] * 1e3:.2f} "
          f"us, bound {record['bound_ms'] * 1e3:.2f} us "
          f"({record['bound_by']}), plain {dec['plain_bf16'] * 1e3:.2f} us, "
          f"torch.matmul {dec['lib_bf16'] * 1e3:.2f} us; f32 x and y: kernel "
          f"{dec['f32'] * 1e3:.2f} us, bound "
          f"{max(dec['bytes'], dec['ops']) * 1e3:.2f} us, plain "
          f"{dec['plain'] * 1e3:.2f} us, torch.matmul {dec['lib'] * 1e3:.2f} "
          f"us; at M={M_PREFILL}: kernel bf16 "
          f"{layer(M_PREFILL, 'bf16') * 1e3:.2f} us (torch.matmul "
          f"{layer(M_PREFILL, 'lib_bf16') * 1e3:.2f} us), f32 "
          f"{layer(M_PREFILL, 'f32') * 1e3:.2f} us (torch.matmul "
          f"{layer(M_PREFILL, 'lib') * 1e3:.2f} us); {smi}")
    return record


# ---------------------------------------------------------------------------
# the CoMeFa grid path: step kernel, grid-served decode, per-slot layout
# ---------------------------------------------------------------------------

def _random_fields(rng, t, isa):
    """Seeded random engine field rows [t, F]: every select, every latch
    control, co-issued port-2 writes (dst2 != dst) included."""
    n = isa.N_ROWS
    cols = dict(
        src1_row=rng.integers(0, n, t), src2_row=rng.integers(0, n, t),
        dst_row=rng.integers(0, n - 2, t), truth_table=rng.integers(0, 16, t),
        pred_sel=rng.integers(0, 4, t), w1_sel=rng.integers(0, 3, t),
        w2_sel=rng.integers(0, 4, t), wp1_en=rng.integers(0, 2, t),
        wp2_en=rng.integers(0, 2, t), c_en=rng.integers(0, 2, t),
        c_rst=rng.integers(0, 2, t), m_en=rng.integers(0, 2, t),
        ext_bit=rng.integers(0, 2, t), b_ext=rng.integers(0, 2, t),
        dst2_row=rng.integers(0, n - 2, t), pred2_sel=rng.integers(0, 4, t))
    return np.stack([cols[f] for f in isa.ENGINE_FIELD_NAMES],
                    axis=1).astype(np.int32)


def _random_grid_state(rng, s, nb, isa):
    mem = rng.integers(0, 2, (s, nb, isa.N_ROWS, isa.N_COLS), dtype=np.uint8)
    mem[:, :, isa.ROW_ZEROS] = 0
    mem[:, :, isa.ROW_ONES] = 1
    carry = rng.integers(0, 2, (s, nb, isa.N_COLS), dtype=np.uint8)
    mask = rng.integers(0, 2, (s, nb, isa.N_COLS), dtype=np.uint8)
    return mem, carry, mask


def _grids_equal(grids):
    ref = grids[0]
    return all(np.array_equal(ref.mem, g.mem)
               and np.array_equal(ref.carry, g.carry)
               and np.array_equal(ref.mask, g.mask)
               and ref.cycles == g.cycles for g in grids[1:])


def _chunk_program(comefa_sim, comefa_exec, k, n, tile_index=1):
    """The broadcast chunk program the main path runs for a (K, N)
    projection at 8-bit weights and activations, as an engine matrix."""
    from repro_torch.core.comefa import schedule
    acc = comefa_exec.acc_bits_for(BITS, BITS, k)
    k_tile = comefa_sim.gemv_batched_k_tile(BITS, BITS, acc)
    plan = schedule.cached_plan_gemv(k, n, BITS, BITS, acc,
                                     k_tile=min(k, k_tile))
    x_rows = comefa_sim._gemv_batched_layout(plan)
    tile = plan.tiles()[tile_index]
    return plan, comefa_sim._gemv_batched_chunk_program(plan, tile, x_rows,
                                                        True)[1]


def phase_step_kernel(cs, comefa_sim, comefa_exec, dev):
    """Step kernel vs its plain version vs the uint8 reference engine."""
    from repro_torch.core.comefa import ComefaGrid, engine_packed, isa
    rng = np.random.default_rng(7)
    checks = launched = 0
    worst = 0
    t0 = time.perf_counter()
    for nb in (1, 2, 6, 7, 16, 17):
        for chain in (False, True):
            s = GRID_SLOTS
            mem, carry, mask = _random_grid_state(rng, s, nb, isa)
            shared = _random_fields(rng, 48, isa)
            per_slot = [_random_fields(rng, int(rng.integers(20, 48)), isa)
                        for _ in range(s)]
            batch = [_random_fields(rng, 16, isa) for _ in range(3)]
            for what in ("shared", "per_slot", "reset", "threaded"):
                grids = []
                for eng in ("cuda", "packed", "reference"):
                    g = ComefaGrid(s, n_blocks=nb, chain=chain, engine=eng,
                                   device=dev)
                    g.mem, g.carry, g.mask = (mem.copy(), carry.copy(),
                                              mask.copy())
                    before = cs.launches
                    if what == "shared":
                        g.run(shared)
                    elif what == "per_slot":
                        g.run_per_slot(per_slot)
                    else:
                        g.run_programs(batch, reset_latches=what == "reset")
                    launched += cs.launches - before
                    grids.append(g)
                checks += 1
                if not _grids_equal(grids):
                    fail(f"step kernel, plain scan and reference engine "
                         f"disagree: nb={nb} chain={chain} {what}")
    print(f"[7 step] random programs: {checks} cases (nb 1/2/6/7/16/17, "
          f"chain both ways, shared / per-slot / run_programs with and "
          f"without latch resets), kernel = plain scan = reference engine "
          f"bit for bit; {launched} kernel launches; "
          f"{time.perf_counter() - t0:.1f} s")
    for k, n in SMOLLM_SHAPES:
        plan, mat = _chunk_program(comefa_sim, comefa_exec, k, n)
        mem, carry, mask = _random_grid_state(rng, GRID_SLOTS,
                                              plan.n_blocks, isa)
        state = [engine_packed.pack_bits(v).to(dev)
                 for v in (mem, carry, mask)]
        prog = torch.tensor(mat, device=dev)
        got = cs.run_packed(*[v.clone() for v in state], prog, chain=False,
                            per_slot=False)
        want = cs.run_packed_plain(*[v.clone() for v in state], prog,
                                   chain=False, per_slot=False)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        worst = max(worst, max(int((a.long() - b.long()).abs().max())
                               for a, b in zip(got, want)))
        print(f"[7 step] chunk program of ({k}, {n}): T={mat.shape[0]}, "
              f"{GRID_SLOTS} slots x nb={plan.n_blocks}: kernel = plain "
              f"{same}")
        if not same:
            fail(f"step kernel disagrees with plain on the ({k}, {n}) "
                 f"chunk program")
    return worst


def phase_chains(cs, dev):
    """Chained slots past one CTA (nb 78 in one CTA; 79, 160 and 624 on
    clusters of 2, 4 and 8) against the packed scan and the reference
    engine; nb 625 refused before any launch; 65,536 unchained slots."""
    from repro_torch.core.comefa import ComefaGrid, engine_packed, isa
    ctas, warps, clusters = cs.max_active_clusters(cs.MAX_CHAIN_BLOCKS)
    print(f"[7 chain] cudaOccupancyMaxActiveClusters: {clusters} clusters "
          f"of {ctas} CTAs x {warps} warps (a {cs.MAX_CHAIN_BLOCKS}-block "
          f"chained slot) at once")
    if clusters < 1:
        fail("the card cannot hold one cluster of a 624-block chained slot")
    rng = np.random.default_rng(17)
    w1 = isa.ENGINE_FIELD_NAMES.index("w1_sel")
    t0 = time.perf_counter()
    for nb in (78, 79, 160, cs.MAX_CHAIN_BLOCKS):
        def prog(t):
            f = _random_fields(rng, t, isa)
            f[:, w1] = 2 * rng.integers(0, 2, t)    # half the steps shift
            return f
        shared = prog(70)
        per_slot = [prog(int(rng.integers(20, 70))) for _ in range(GRID_SLOTS)]
        mem, carry, mask = _random_grid_state(rng, GRID_SLOTS, nb, isa)
        for what in ("shared", "per_slot"):
            grids = []
            for eng in ("cuda", "packed", "reference"):
                g = ComefaGrid(GRID_SLOTS, n_blocks=nb, chain=True,
                               engine=eng, device=dev)
                g.mem, g.carry, g.mask = mem.copy(), carry.copy(), mask.copy()
                before = cs.launches
                g.run(shared) if what == "shared" else g.run_per_slot(per_slot)
                if eng == "cuda" and cs.launches != before + 1:
                    fail(f"chained nb={nb} {what}: no step kernel launch")
                grids.append(g)
            if not _grids_equal(grids):
                fail(f"chained nb={nb} {what}: step kernel, packed scan and "
                     f"reference engine disagree")
        print(f"[7 chain] nb={nb} chained ({cs.ctas_per_slot(nb, True)} CTAs "
              f"a slot), {GRID_SLOTS} slots, shared and per-slot programs: "
              f"kernel = packed scan = reference engine in mem, carry, mask "
              f"and cycles")
    mem = torch.zeros((1, cs.MAX_CHAIN_BLOCKS + 1, isa.N_ROWS,
                       engine_packed.N_WORDS), dtype=torch.int32, device=dev)
    latch = torch.zeros((1, cs.MAX_CHAIN_BLOCKS + 1, engine_packed.N_WORDS),
                        dtype=torch.int32, device=dev)
    before = cs.launches
    try:
        cs.run_packed(mem, latch, latch.clone(),
                      torch.tensor(_random_fields(rng, 4, isa), device=dev),
                      chain=True, per_slot=False)
    except ValueError as e:
        refused = str(e)
    else:
        fail("a 625-block chained slot was not refused")
    if cs.launches != before:
        fail("the refused launch reached the kernel")
    print(f"[7 chain] nb=625 chained: ValueError before any launch: "
          f"{refused}")
    slots = 65536
    gen = torch.Generator(device=dev).manual_seed(18)
    state = [torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                           device=dev, dtype=torch.int32)
             for shape in ((slots, 1, isa.N_ROWS, engine_packed.N_WORDS),
                           (slots, 1, engine_packed.N_WORDS),
                           (slots, 1, engine_packed.N_WORDS))]
    p = torch.tensor(_random_fields(rng, 12, isa), device=dev)
    got = cs.run_packed(*[v.clone() for v in state], p, chain=False,
                        per_slot=False)
    want = cs.run_packed_plain(*[v.clone() for v in state], p, chain=False,
                               per_slot=False)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail("65,536 slots: step kernel and packed scan disagree")
    print(f"[7 chain] {slots} unchained slots of one block, T=12: kernel = "
          f"packed scan; {time.perf_counter() - t0:.1f} s")


class _Probe:
    """Linear hook that runs the grid executor and the reference executor
    on every call and requires equal outputs (`torch.equal`)."""

    def __init__(self, grid_ex, ref_ex):
        self.grid_ex, self.ref_ex = grid_ex, ref_ex
        self.calls = 0

    @property
    def active_mask(self):
        return self.grid_ex.active_mask

    @active_mask.setter
    def active_mask(self, live):
        self.grid_ex.active_mask = live
        self.ref_ex.active_mask = live

    def __call__(self, params, x2, bits):
        yg = self.grid_ex(params, x2, bits)
        yr = self.ref_ex(params, x2, bits)
        if not torch.equal(yg, yr):
            fail(f"grid and reference executors disagree at hooked call "
                 f"{self.calls} (max |d| "
                 f"{float((yg - yr).abs().max()):.3e})")
        self.calls += 1
        return yg


def _grid_dispatches(metrics):
    """Grid dispatches the cuda engine made (the registry's counter)."""
    c = metrics.counter("comefa.dispatches")
    return sum(v for labels, v in c.series().items()
               if ("kind", "grid") in labels and ("engine", "cuda") in labels)


def _layer_quote(comefa_sim, comefa_exec):
    """Modelled grid cycles and chunk dispatches of one layer-wave: the
    port planner's broadcast quote for the 7 projections."""
    cycles = chunks = 0
    for (k, n), count in SMOLLM_SHAPES.items():
        q = comefa_sim._broadcast_quote(
            k, n, BITS, BITS, comefa_exec.acc_bits_for(BITS, BITS, k), True)
        cycles += count * sum(q.compute_cycles)
        chunks += count * len(q.compute_cycles)
    return cycles, chunks


def phase_grid_serve(cs, configs, lm, engine, comefa_exec, comefa_sim,
                     metrics, dev, layers):
    """The grid path at full width: serve_continuous on the CoMeFa grid."""
    cfg = configs.get("smollm-360m", quant_bits=BITS, n_layers=layers)
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    quote, chunks = _layer_quote(comefa_sim, comefa_exec)
    print(f"[8 grid] {cfg.name} at depth {cfg.n_layers}: d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads}/{cfg.kv_heads} "
          f"heads, vocab {cfg.vocab}, {cfg.dtype}, {BITS}-bit planes; "
          f"planner quote {quote} cycles and {chunks} chunk dispatches "
          f"per layer-wave")
    rng = np.random.default_rng(8)
    # staggered: request 0 retires two steps before request 1
    shape = [(2, 2), (3, 3), (2, 3), (3, 2)]
    reqs = [engine.Request(rng.integers(0, cfg.vocab, p), s)
            for p, s in shape]
    probe = _Probe(
        comefa_exec.GridLinearExecutor(slots=GRID_SLOTS, recode=None,
                                       backend="grid"),
        comefa_exec.GridLinearExecutor(slots=GRID_SLOTS, recode=None,
                                       backend="reference"))
    stats = {}
    # ---- the grid path, counted ----
    cs.launches = 0
    disp0 = _grid_dispatches(metrics)
    t0 = time.perf_counter()
    outs = engine.serve_continuous(model, reqs, slots=GRID_SLOTS,
                                   max_len=8, executor=probe, stats=stats)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launched = cs.launches
    dispatched = _grid_dispatches(metrics) - disp0
    # ---- end of the counted grid path ----
    grid_ex = probe.grid_ex
    waves = stats["steps"]               # one wave a step: live <= slots
    emitted = sum(len(o) for o in outs)
    per_layer_wave = serve_s / (cfg.n_layers * waves)
    print(f"[8 grid] serve_continuous: {len(reqs)} requests, {emitted} "
          f"tokens in {serve_s:.2f} s = {emitted / serve_s:.3f} tokens/s; "
          f"{stats['steps']} batched steps, occupancy "
          f"{stats['occupancy']:.3f} (grid {grid_ex.occupancy():.3f}); "
          f"{probe.calls} hooked calls, grid = reference at every one")
    print(f"[8 grid] {waves} waves x {cfg.n_layers} layers: "
          f"{per_layer_wave:.3f} s per layer-wave; step kernel launches "
          f"{launched}, grid dispatches {dispatched}, expected "
          f"{waves * cfg.n_layers * chunks}; grid_cycles "
          f"{grid_ex.grid_cycles} = {grid_ex.grid_cycles / (waves * cfg.n_layers):.0f}"
          f" per layer-wave (quote {quote})")
    if probe.calls != 7 * cfg.n_layers * stats["steps"]:
        fail(f"{probe.calls} hooked calls")
    if launched == 0 or launched != dispatched or \
            launched != waves * cfg.n_layers * chunks:
        fail("the grid path did not run every chunk through the step kernel")
    if grid_ex.grid_cycles != quote * waves * cfg.n_layers:
        fail("grid cycles per layer-wave differ from the planner's quote")
    for r, o in zip(reqs, outs):
        if len(o) != r.steps or o.min() < 0 or o.max() >= cfg.vocab:
            fail("serve_continuous returned a wrong token stream")
    return launched, per_layer_wave, emitted / serve_s


def phase_per_slot(cs, configs, common, lm, engine, comefa_exec, dev):
    """recode naive / auto (per-slot programs) at the tiny serving config."""
    cfg = dataclasses.replace(
        common.reduced(configs.get("smollm-360m"), vocab=64, n_layers=1,
                       d_model=32, d_ff=64, n_heads=2, kv_heads=2,
                       head_dim=16, dtype="float32"), quant_bits=BITS)
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    for recode in ("naive", "auto"):
        reqs = [engine.Request(np.arange(1, 2 + i % 3), 2 + (i * 2) % 5)
                for i in range(6)]
        probe = _Probe(
            comefa_exec.GridLinearExecutor(slots=2, recode=recode,
                                           backend="grid"),
            comefa_exec.GridLinearExecutor(slots=2, backend="reference"))
        before = cs.launches
        t0 = time.perf_counter()
        outs = engine.serve_continuous(model, reqs, slots=2, max_len=12,
                                       executor=probe)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        print(f"[9 per-slot] recode={recode}: {n_tok} tokens in {dt:.2f} s,"
              f" grid = reference at all {probe.calls} hooked calls, "
              f"{probe.grid_ex.grid_cycles / n_tok:.2f} grid cycles per "
              f"token, {cs.launches - before} kernel launches")
        if cs.launches == before:
            fail(f"recode={recode} launched no step kernel")


def phase_step_timing(cs, comefa_sim, comefa_exec, dev, smi):
    """One chunk dispatch of the main path, timed with CUDA events."""
    from repro_torch.core.comefa import engine_packed, isa
    k, n = 960, 2560                       # wi / wg: nb = 16
    plan, mat = _chunk_program(comefa_sim, comefa_exec, k, n)
    t, s, nb = mat.shape[0], GRID_SLOTS, plan.n_blocks
    mem, carry, mask = _random_grid_state(np.random.default_rng(10), s, nb,
                                          isa)
    state = [engine_packed.pack_bits(v).to(dev) for v in (mem, carry, mask)]
    prog = torch.tensor(mat, device=dev)
    dprog = cs.decode(prog)            # once, as the grid's cache does
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    before = cs.launches
    t_kernel = timed(lambda: cs.run_packed(*state, dprog, chain=False,
                                           per_slot=False), 200)
    timing_launches = cs.launches - before
    t_plain = timed(lambda: cs.run_packed_plain(*state, prog, chain=False,
                                                per_slot=False), 2)
    words = s * nb * isa.N_ROWS * engine_packed.N_WORDS
    latch = 2 * s * nb * engine_packed.N_WORDS
    nbytes = 4 * (2 * (words + latch)) + 4 * mat.size
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    # ~30 32-bit logic/shift ops per word per instruction
    t_ops = 1e3 * 30 * s * nb * engine_packed.N_WORDS * t / F32_FLOP_PER_S
    clock = _max_sm_clock_hz()
    t_dep = 1e3 * t * (SMEM_LOAD_CYCLES + ALU_CYCLES) / clock
    print(f"[10 time] one chunk dispatch (T={t}, {s} slots x nb={nb}): "
          f"kernel {t_kernel * 1e3:.2f} us, plain {t_plain * 1e3:.1f} us; "
          f"byte bound {t_bytes * 1e3:.3f} us, operation bound "
          f"{t_ops * 1e3:.3f} us, dependency bound {t_dep * 1e3:.2f} us "
          f"(T x {SMEM_LOAD_CYCLES + ALU_CYCLES} cycles at "
          f"{clock / 1e9:.3f} GHz); kernel / dependency bound "
          f"{t_kernel / t_dep:.1f}; {timing_launches} timing launches; "
          f"{smi}")
    return {"ms": t_kernel, "plain_ms": t_plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dependency_bound_ms": t_dep, "library_ms": None}


def _max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# ---------------------------------------------------------------------------
# the bit-serial and bulk-bitwise kernels (#3-#8), reached through
# kernels.ops: the paper's Sec. III-E multiply, Sec. III-H swizzle and
# Sec. IV-C search-replace, RAID rebuild and reduction
# ---------------------------------------------------------------------------

# kernel -> (its CUDA source, the TPU kernel it replaces)
BITSERIAL_KERNELS = {
    "bitserial_matmul": ("bitserial_matmul.cu",
                         "src/repro/kernels/bitserial_matmul.py:58"),
    "bitserial_reduce": ("bitserial_reduce.cu",
                         "src/repro/kernels/bitserial_reduce.py:46"),
    "bit_transpose": ("bit_transpose.cu",
                      "src/repro/kernels/bit_transpose.py:34"),
    "bit_untranspose": ("bit_transpose.cu",
                        "src/repro/kernels/bit_transpose.py:63"),
    "search_replace": ("bulk_bitwise.cu",
                       "src/repro/kernels/bulk_bitwise.py:38"),
    "raid_xor": ("bulk_bitwise.cu", "src/repro/kernels/bulk_bitwise.py:69"),
}
# the bit-serial matmul's binary-MMA sweep (phase 11): every tiling edge
MMA_SWEEP_M = (1, 4, 5, 16, 17, 64)
MMA_SWEEP_K = (32, 96, 256, 960, 2560)
MMA_SWEEP_N = (1, 8, 100, 320, 2560)
MMA_SWEEP_BITS = (1, 3, 8)
SEARCH_RECORDS, SEARCH_BITS = 1 << 27, 16   # width of benchmarks/tpu_kernels.py:64
RAID_STRIPES, RAID_WORDS = 8, 1 << 24       # 7 data stripes + parity, 64 MiB each
REDUCE_VALUES, REDUCE_BITS = 1 << 28, 8
SERIAL_BITS = 8                             # a = w = 8 for the projections


class Bitserial:
    """The four kernel modules of #3-#8 and their launch counts by name."""

    def __init__(self, bt, bb, bsr, bsm):
        self.bt, self.bb, self.bsr, self.bsm = bt, bb, bsr, bsm
        self.err = dict.fromkeys(BITSERIAL_KERNELS, 0)

    def reset(self):
        for counts in (self.bt.launches, self.bb.launches):
            for name in counts:
                counts[name] = 0
        self.bsr.launches = 0
        self.bsm.launches = 0

    def counts(self):
        return {**self.bt.launches, **self.bb.launches,
                "bitserial_reduce": self.bsr.launches,
                "bitserial_matmul": self.bsm.launches}

    def same(self, name, what, got, want):
        """Fail unless the kernel's output equals the plain version's."""
        torch.cuda.synchronize()
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for a, b in pairs:
            if a.shape != b.shape or a.dtype != b.dtype:
                fail(f"{name} {what}: kernel {a.dtype} {tuple(a.shape)}, "
                     f"plain {b.dtype} {tuple(b.shape)}")
            d = float((a.double() - b.double()).abs().max()) \
                if a.numel() else 0.0
            self.err[name] = max(self.err[name], d)
            if not torch.equal(a, b):
                fail(f"{name} {what}: kernel and plain version differ "
                     f"(max |d| {d:.3e})")


def _signed_values(gen, dev, bits, n):
    """n seeded signed `bits`-bit integers, int32."""
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) if bits < 32 else (1 << 31) - 1
    return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                         dtype=torch.int32)


def _pack_rows(ops, qx, bits):
    """[M, K] ints -> x_packed [M, bits, K/32] through the bit transpose
    (the rows are contiguous runs of K/32 words of each plane)."""
    m, k = qx.shape
    return ops.bit_transpose(qx.reshape(-1), bits=bits) \
        .view(bits, m, k // 32).transpose(0, 1).contiguous()


def _serial_bound(qx, qw, sx, sw):
    """The f32 bound for two orders of one sum, on the dequantised
    product: (K + 2) * 2^-23 * (|qx| @ |qw|) * sx * sw."""
    k = qx.shape[1]
    mag = qx.abs().double() @ qw.abs().double()
    return (k + 2) * 2.0 ** -23 * mag * sx.double() * sw.double(), mag


def phase_bitserial_vs_plain(ks, ops, ref, bitplane, dev):
    """#3-#8 against their plain versions on the card, bit for bit, at
    word counts of one, ragged (17, 300, 24581) and block-multiple (8192)
    size; #4 also against the int64 sum; #3 at SmolLM-360M's projection
    shapes and ragged ones."""
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    cases = 0
    for w in (1, 17, 300, 8192, 3 * 8192 + 5):
        for bits in (1, 6, 8, 16, 32):
            what = f"W={w} bits={bits}"
            vals = _signed_values(gen, dev, bits, 32 * w)
            planes = ks.bt.bit_transpose(vals, bits=bits)
            ks.same("bit_transpose", what, planes,
                    ks.bt.bit_transpose_plain(vals, bits=bits))
            for signed in (True, False):
                ks.same("bit_untranspose", f"{what} signed={signed}",
                        ks.bt.bit_untranspose(planes, bits=bits,
                                              signed=signed),
                        ks.bt.bit_untranspose_plain(planes, bits=bits,
                                                    signed=signed))
            if not torch.equal(ks.bt.bit_untranspose(planes, bits=bits),
                               vals):
                fail(f"bit transpose round trip lost values at {what}")
            key = int(vals[int(torch.randint(0, 32 * w, (1,), generator=gen,
                                              device=dev))])
            ks.same("search_replace", what,
                    ks.bb.search_replace(planes, bits=bits, key=key),
                    ks.bb.search_replace_plain(planes, bits=bits, key=key))
            total = ks.bsr.bitserial_reduce(planes, bits=bits)
            ks.same("bitserial_reduce", what, total,
                    ks.bsr.bitserial_reduce_plain(planes, bits=bits))
            exact = torch.sum(vals, dtype=torch.int64).to(torch.float32)
            if not torch.equal(total, exact):
                fail(f"bitserial_reduce at {what}: {float(total)} is not "
                     f"the int64 sum rounded once, {float(exact)}")
            cases += 5
        for d in (1, 3, 8):
            stripes = torch.randint(-2**31, 2**31 - 1, (d, w), generator=gen,
                                    device=dev, dtype=torch.int32)
            ks.same("raid_xor", f"D={d} W={w}", ks.bb.raid_xor(stripes),
                    ks.bb.raid_xor_plain(stripes))
            cases += 1
    print(f"[11 bitserial] transpose, untranspose (signed and unsigned), "
          f"search-replace, reduce and RAID XOR at W in 1/17/300/8192/24581 "
          f"words, bits 1/6/8/16/32, D 1/3/8: kernel = plain bit for bit in "
          f"{cases} cases; reduce = the int64 sum rounded once to f32")
    smollm = [(M_DECODE, k, n) for k, n in SMOLLM_SHAPES]
    worst = 0.0
    for m, k, n in smollm + [RAGGED, (19, 96, 70), (8, 512, 128)]:
        pairs = [(8, 8), (4, 4)]
        if (m, k, n) not in smollm:
            pairs += [(2, 8), (5, 4), (1, 1)]
        for a, wb in pairs:
            qx = _signed_values(gen, dev, a, m * k).view(m, k)
            qw = _signed_values(gen, dev, wb, k * n).view(k, n)
            xp = _pack_rows(ops, qx, a)
            wp = bitplane.pack(qw, wb, axis=0)
            ones_m = torch.ones((m, 1), device=dev)
            ones_n = torch.ones((1, n), device=dev)
            y = ks.bsm.bitserial_matmul(xp, wp, ones_m, ones_n, a_bits=a,
                                        w_bits=wb)
            what = f"M={m} K={k} N={n} {a}x{wb} bits"
            ks.same("bitserial_matmul", f"{what} integer", y,
                    ks.bsm.bitserial_matmul_plain(xp, wp, ones_m, ones_n,
                                                  a_bits=a, w_bits=wb))
            exact = (qx.long().cpu() @ qw.long().cpu()).to(torch.float32)
            if not torch.equal(y.cpu(), exact):
                fail(f"bitserial_matmul {what}: not the exact integer "
                     f"product")
            sx = torch.rand((m, 1), generator=gen, device=dev) * 0.09 + 0.01
            sw = torch.rand((1, n), generator=gen, device=dev) * 0.09 + 0.01
            y = ks.bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=a, w_bits=wb)
            ks.same("bitserial_matmul", f"{what} scaled", y,
                    ks.bsm.bitserial_matmul_plain(xp, wp, sx, sw, a_bits=a,
                                                  w_bits=wb))
            y_ref = ref.bitserial_matmul_ref(xp, wp, sx, sw, a_bits=a,
                                             w_bits=wb)
            bound, _ = _serial_bound(qx, qw, sx, sw)
            ratio = float(((y - y_ref).abs().double() / bound).max())
            worst = max(worst, ratio)
            if ratio > 1:
                fail(f"bitserial_matmul {what}: beyond the f32 bound of the "
                     f"oracle")
    print(f"[11 bitserial] bitserial_matmul at SmolLM's four shapes (M=4, "
          f"8x8 and 4x4 bits) and (3,64,100), (19,96,70), (8,512,128) at "
          f"five bit pairs: kernel = plain bit for bit, integer operands "
          f"exact, scaled results within {worst:.3f} of the f32 bound "
          f"against ref.bitserial_matmul_ref; "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cases = 0
    for a, wb, m, k, n in itertools.product(MMA_SWEEP_BITS, MMA_SWEEP_BITS,
                                            MMA_SWEEP_M, MMA_SWEEP_K,
                                            MMA_SWEEP_N):
        qx = _signed_values(gen, dev, a, m * k).view(m, k)
        qw = _signed_values(gen, dev, wb, k * n).view(k, n)
        xp = bitplane.pack(qx, a, axis=1).movedim(0, 1).contiguous()
        wp = bitplane.pack(qw, wb, axis=0)
        what = f"M={m} K={k} N={n} {a}x{wb} bits"
        y = ks.bsm.bitserial_matmul(xp, wp, torch.ones((m, 1), device=dev),
                                    torch.ones((1, n), device=dev),
                                    a_bits=a, w_bits=wb)
        if not torch.equal(y, (qx.double() @ qw.double()).float()):
            fail(f"bitserial_matmul {what}: not the exact integer product")
        sx = torch.rand((m, 1), generator=gen, device=dev) * 0.09 + 0.01
        sw = torch.rand((1, n), generator=gen, device=dev) * 0.09 + 0.01
        ks.same("bitserial_matmul", f"{what} scaled",
                ks.bsm.bitserial_matmul(xp, wp, sx, sw, a_bits=a, w_bits=wb),
                ks.bsm.bitserial_matmul_plain(xp, wp, sx, sw, a_bits=a,
                                              w_bits=wb))
        cases += 1
    print(f"[11 bitserial] bitserial_matmul over its binary-MMA tiling: "
          f"M in {MMA_SWEEP_M}, K in {MMA_SWEEP_K}, N in {MMA_SWEEP_N}, "
          f"a and w in {MMA_SWEEP_BITS}: {cases} cases exact on integers "
          f"and = plain bit for bit when scaled; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_workloads(ks, ops, ref, bitplane, dev):
    """The paper's workloads composed through `ops` at real sizes.  The
    launch counts of #3-#8 are reset just before and read just after."""
    gen = torch.Generator(device=dev).manual_seed(12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # ---- the bit-serial path, counted ----
    ks.reset()
    # (a) database search-replace on 2^27 16-bit records
    recs = torch.randint(0, 1 << SEARCH_BITS, (SEARCH_RECORDS,),
                         generator=gen, device=dev, dtype=torch.int32)
    key = int(recs[int(torch.randint(0, SEARCH_RECORDS, (1,), generator=gen,
                                     device=dev))])
    planes = ops.bit_transpose(recs, bits=SEARCH_BITS)
    out, mask = ops.search_replace(planes, bits=SEARCH_BITS, key=key)
    back = ops.bit_untranspose(out, bits=SEARCH_BITS, signed=False)
    # (b) RAID rebuild: 7 data stripes, their parity, stripe 3 lost
    data = torch.randint(-2**31, 2**31 - 1, (RAID_STRIPES - 1, RAID_WORDS),
                         generator=gen, device=dev, dtype=torch.int32)
    parity = ops.raid_xor(data)
    survivors = torch.cat([data[:3], data[4:], parity[None]])
    rebuilt = ops.raid_xor(survivors)
    # (c) reduction of 2^28 signed 8-bit values
    vals = _signed_values(gen, dev, REDUCE_BITS, REDUCE_VALUES)
    vplanes = ops.bit_transpose(vals, bits=REDUCE_BITS)
    total = ops.bitserial_reduce(vplanes, bits=REDUCE_BITS)
    # (d) one SmolLM-360M layer's seven projections, bit-serial, M = 4
    projections = []
    for (k, n), count in SMOLLM_SHAPES.items():
        for _ in range(count):
            x = torch.randn((M_DECODE, k), generator=gen, device=dev)
            w = torch.randn((k, n), generator=gen, device=dev)
            qx, sx = bitplane.quantize(x, SERIAL_BITS, axis=1)
            qw, sw = bitplane.quantize(w, SERIAL_BITS, axis=0)
            xp = _pack_rows(ops, qx, SERIAL_BITS)
            wp = bitplane.pack(qw, SERIAL_BITS, axis=0)
            y = ops.bitserial_matmul(xp, wp, sx, sw, a_bits=SERIAL_BITS,
                                     w_bits=SERIAL_BITS)
            y_int = ops.bitserial_matmul(
                xp, wp, torch.ones_like(sx), torch.ones_like(sw),
                a_bits=SERIAL_BITS, w_bits=SERIAL_BITS)
            projections.append((k, n, qx, sx, qw, sw, xp, wp, y, y_int))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = ks.counts()
    # ---- end of the counted path ----
    print(f"[12 workloads] {dt:.2f} s; kernel launches {launched}")
    expect = {"bit_transpose": 2 + 7, "bit_untranspose": 1,
              "search_replace": 1, "raid_xor": 2, "bitserial_reduce": 1,
              "bitserial_matmul": 14}
    if launched != expect:
        fail(f"the workloads did not run through every kernel as expected "
             f"({expect})")

    hit = recs == key
    shifts = torch.arange(32, device=dev, dtype=torch.int32)
    marked = ((mask[:, None] >> shifts) & 1).reshape(-1).bool()
    replaced = torch.equal(back, torch.where(hit, 0, recs))
    print(f"[12 workloads] (a) search-replace: {SEARCH_RECORDS} "
          f"{SEARCH_BITS}-bit records ({4 * SEARCH_BITS * planes.shape[1] >> 20}"
          f" MiB of planes), key {key} with {int(hit.sum())} matches: "
          f"untransposed output = torch.where(recs == key, 0, recs) "
          f"{replaced}, mask marks exactly the matches "
          f"{torch.equal(marked, hit)}")
    if not (replaced and torch.equal(marked, hit) and int(hit.sum()) > 0):
        fail("search-replace workload is wrong")
    ks.same("bit_transpose", "(a)", planes,
            ks.bt.bit_transpose_plain(recs, bits=SEARCH_BITS))
    ks.same("search_replace", "(a)", (out, mask),
            ks.bb.search_replace_plain(planes, bits=SEARCH_BITS, key=key))
    ks.same("bit_untranspose", "(a)", back,
            ks.bt.bit_untranspose_plain(out, bits=SEARCH_BITS, signed=False))

    ok = torch.equal(rebuilt, data[3])
    print(f"[12 workloads] (b) RAID: {RAID_STRIPES} stripes of "
          f"{RAID_WORDS} words ({4 * RAID_WORDS >> 20} MiB each), data "
          f"stripe 3 lost: raid_xor of the {survivors.shape[0]} survivors "
          f"returns it {ok}")
    if not ok:
        fail("RAID rebuild did not return the lost stripe")
    ks.same("raid_xor", "(b) parity", parity, ks.bb.raid_xor_plain(data))
    ks.same("raid_xor", "(b) rebuild", rebuilt,
            ks.bb.raid_xor_plain(survivors))

    exact = int(torch.sum(vals, dtype=torch.int64))
    got = float(total)
    half_ulp = float(np.spacing(np.float32(abs(exact)))) / 2
    rounded = torch.equal(total, torch.tensor(exact, device=dev)
                          .to(torch.float32))
    print(f"[12 workloads] (c) reduction: {REDUCE_VALUES} signed "
          f"{REDUCE_BITS}-bit values ({4 * REDUCE_BITS * vplanes.shape[1] >> 20}"
          f" MiB of planes): {got:.1f} against torch.sum int64 {exact}: "
          f"|d| {abs(got - exact):.1f} <= half an f32 ulp {half_ulp:.1f}; "
          f"equal to the int64 sum rounded once {rounded}")
    if abs(got - exact) > half_ulp or not rounded:
        fail("bitserial_reduce is not within one f32 rounding of the sum")
    ks.same("bitserial_reduce", "(c)", total,
            ks.bsr.bitserial_reduce_plain(vplanes, bits=REDUCE_BITS))

    worst = 0.0
    for k, n, qx, sx, qw, sw, xp, wp, y, y_int in projections:
        y_ref = ref.bitserial_matmul_ref(xp, wp, sx, sw, a_bits=SERIAL_BITS,
                                         w_bits=SERIAL_BITS)
        bound, mag = _serial_bound(qx, qw, sx, sw)
        worst = max(worst, float(((y - y_ref).abs().double() / bound).max()))
        # every partial sum of either kernel is an integer below 2^24 in
        # magnitude, so both are exact and must be equal
        if float(mag.max()) >= 2 ** 24:
            fail(f"projection ({k}, {n}): |qx| @ |qw| reaches 2^24")
        y_bp = ops.bitplane_matmul(qx.to(torch.float32), wp,
                                   torch.ones_like(sw), bits=SERIAL_BITS)
        if not (torch.isfinite(y).all() and torch.equal(y_int, y_bp)):
            fail(f"projection ({k}, {n}): bit-serial and bit-plane kernels "
                 f"differ on the same integers")
        ks.same("bitserial_matmul", f"(d) ({k}, {n})", y,
                ks.bsm.bitserial_matmul_plain(xp, wp, sx, sw,
                                              a_bits=SERIAL_BITS,
                                              w_bits=SERIAL_BITS))
    print(f"[12 workloads] (d) one SmolLM-360M layer's 7 projections at M="
          f"{M_DECODE}, {SERIAL_BITS}x{SERIAL_BITS} bits (activations "
          f"quantised per row and packed by bit_transpose): within "
          f"{worst:.3f} of the f32 bound against ref.bitserial_matmul_ref, "
          f"and equal to kernels.bitplane_matmul on the same integers")
    if worst > 1:
        fail("bit-serial projections beyond the f32 bound of the oracle")
    return launched, {"recs": recs, "key": key, "planes": planes,
                      "out": out, "data": data, "survivors": survivors,
                      "vals": vals, "vplanes": vplanes,
                      "projections": projections}


def _time_events(fn, reps):
    """Device time of one ``fn()`` from CUDA events around `reps` calls,
    after one warm-up call (for the plain versions, whose allocations do
    not belong in a CUDA graph)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_bitserial_timing(ks, ops, bitplane, data, dev, smi):
    """#3-#8 at the phase-12 sizes: kernel (CUDA graph, events), plain
    version (events), bound and the one library call where there is one."""
    rows = {}

    def row(name, t_kernel, t_plain, t_lib, nbytes, t_ops=0.0, note=""):
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        rows[name] = {"ms": t_kernel, "plain_ms": t_plain,
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "library_ms": t_lib}
        lib = "none" if t_lib is None else f"{t_lib * 1e3:.2f} us"
        print(f"[13 time] {name} {note}: kernel {t_kernel * 1e3:.2f} us, "
              f"bound {rows[name]['bound_ms'] * 1e3:.2f} us "
              f"({rows[name]['bound_by']}; bytes {t_bytes * 1e3:.2f} us, "
              f"{nbytes / t_kernel / 1e6:.0f} GB/s achieved), plain "
              f"{t_plain * 1e3:.1f} us, library {lib}; {smi}")

    recs, key, planes = data["recs"], data["key"], data["planes"]
    out, words = data["out"], data["planes"].shape[1]
    b = SEARCH_BITS
    note = f"({SEARCH_RECORDS} {b}-bit records)"
    row("bit_transpose",
        _time_ms(lambda i: ops.bit_transpose(recs, bits=b), 3, 3),
        _time_events(lambda: ks.bt.bit_transpose_plain(recs, bits=b), 2),
        None, 4 * recs.numel() + 4 * b * words, note=note)
    row("bit_untranspose",
        _time_ms(lambda i: ops.bit_untranspose(out, bits=b, signed=False),
                 3, 3),
        _time_events(lambda: ks.bt.bit_untranspose_plain(out, bits=b,
                                                         signed=False), 2),
        None, 4 * b * words + 4 * recs.numel(), note=note)
    row("search_replace",
        _time_ms(lambda i: ops.search_replace(planes, bits=b, key=key), 3, 3),
        _time_events(lambda: ks.bb.search_replace_plain(planes, bits=b,
                                                        key=key), 3),
        _time_ms(lambda i: torch.where(recs == key, 0, recs), 3, 3),
        4 * b * words + 4 * (b + 1) * words,
        note=f"{note}; library torch.where(recs == key, 0, recs)")
    survivors = data["survivors"]
    d, w = survivors.shape
    row("raid_xor", _time_ms(lambda i: ops.raid_xor(survivors), 3, 3),
        _time_events(lambda: ks.bb.raid_xor_plain(survivors), 3), None,
        4 * (d + 1) * w, note=f"(D={d} survivors of {w} words)")
    vals, vplanes = data["vals"], data["vplanes"]
    row("bitserial_reduce",
        _time_ms(lambda i: ops.bitserial_reduce(vplanes, bits=REDUCE_BITS),
                 3, 3),
        _time_events(lambda: ks.bsr.bitserial_reduce_plain(
            vplanes, bits=REDUCE_BITS), 3),
        _time_ms(lambda i: torch.sum(vals, dtype=torch.int64), 3, 3),
        4 * vplanes.numel(),
        note=f"({REDUCE_VALUES} {REDUCE_BITS}-bit values; library "
             f"torch.sum(values, dtype=torch.int64))")

    # #3: one layer's seven projections, each shape timed once, L2-cold
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    a = SERIAL_BITS
    seen, totals = set(), [0.0] * 5
    for k, n, qx, sx, qw, sw, xp, wp, _, _ in data["projections"]:
        per_layer = SMOLLM_SHAPES[(k, n)]
        if (k, n) in seen:
            continue
        seen.add((k, n))
        wc = [wp.clone() for _ in range(_copies(wp.numel() * 4))]
        xd = bitplane.dequantize(qx, sx)
        wd = bitplane.dequantize(qw, sw)
        wdc = [wd.clone() for _ in range(_copies(wd.numel() * 4))]
        t_kernel = _time_ms(lambda i: ops.bitserial_matmul(
            xp, wc[i % len(wc)], sx, sw, a_bits=a, w_bits=a), len(wc))
        t_plain = _time_events(lambda: ks.bsm.bitserial_matmul_plain(
            xp, wp, sx, sw, a_bits=a, w_bits=a), 5)
        t_lib = _time_ms(lambda i: torch.matmul(xd, wdc[i % len(wdc)]),
                         len(wdc))
        # the floor of this timing: one trivial kernel a graph node
        out = torch.empty((M_DECODE, n), device=wp.device)
        t_floor = _time_ms(lambda i: out.zero_(), len(wc))
        # the function is M*K*N products of a-bit by a-bit integers: two
        # operations each at the int8 tensor-core rate
        t_ops = 1e3 * 2 * M_DECODE * k * n / INT8_OPS_PER_S
        nbytes = a / 8 * k * n + 4 * xp.numel() + 4 * M_DECODE * n + \
            4 * (M_DECODE + n)
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        # the kernel's work: m16n8k256 binary MMAs over its padded tiles,
        # each 16 * 8 * 256 AND + popcount-accumulate bit operations
        geo = ks.bsm.geometry(M_DECODE, k, n, a, a, sms)
        mmas = geo["m_tiles"] * ks.bsm.ROW_TILES * geo["n_tiles"] * \
            ks.bsm.COL_TILES * geo["steps"]
        bit_ops = mmas * 16 * 8 * 256
        print(f"[13 time] bitserial_matmul M={M_DECODE} K={k} N={n} "
              f"{a}x{a} bits: kernel {t_kernel * 1e3:.2f} us, bound "
              f"{max(t_ops, t_bytes) * 1e3:.2f} us (bytes {t_bytes * 1e3:.2f} "
              f"us; int8 products {t_ops * 1e3:.3f} us), plain "
              f"{t_plain * 1e3:.1f} us, torch.matmul on the dequantised f32 "
              f"operands {t_lib * 1e3:.2f} us, one trivial kernel (zero_ of "
              f"y) {t_floor * 1e3:.2f} us; launch: {geo['ctas']} CTAs in "
              f"clusters of {geo['splits']} on {sms} SMs, {mmas} binary "
              f"MMAs = {bit_ops / t_kernel / 1e9:.2f} T bit-ops/s "
              f"achieved; {smi}")
        for i, v in enumerate((t_kernel, t_plain, t_lib, t_bytes, t_ops)):
            totals[i] += per_layer * v
        del wc, wdc
    t_kernel, t_plain, t_lib, t_bytes, t_ops = totals
    rows["bitserial_matmul"] = {
        "ms": t_kernel, "plain_ms": t_plain, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": t_lib}
    print(f"[13 time] bitserial_matmul, one layer's 7 projections: kernel "
          f"{t_kernel * 1e3:.2f} us, bound {max(t_bytes, t_ops) * 1e3:.2f} "
          f"us ({rows['bitserial_matmul']['bound_by']}), plain "
          f"{t_plain * 1e3:.1f} us, torch.matmul {t_lib * 1e3:.2f} us; {smi}")
    return rows


# phase 14: the paper's evaluation layer (`kernels.comefa_sim`'s array
# kernels) on the cuda engine at the sizes the FPGA model prices
# (`core/fpga_model/perf.py`): eltwise's n, gemv's h, the int16 FIR with a
# 36-bit accumulator; GEMMs of 128 blocks (2-CTA clusters) and a FIR of 80
EVAL_BITS = 8
EVAL_ELTWISE_N = 100_000          # perf.eltwise: 625 blocks
EVAL_GEMV_H = 512                 # perf.gemv
EVAL_GEMM = (128, 128, 128)       # m, k, n
EVAL_GEMM_BLOCKS = 128            # 103 tiles, a 2-CTA cluster a slot
EVAL_GEMM_SLOTS = 4
EVAL_DOT_N = 2560                 # 16 chained blocks
EVAL_FIR = (128, 16, 36, 4096)    # taps, tap/sample bits, acc bits, samples
EVAL_FIR_CHECK_SAMPLES = 256      # the unoptimised run held to fir_cycles
EVAL_LONG_FIR = (12_800, 256)     # taps (80 blocks), samples


def _sim_counts(metrics):
    """The simulator's counters, summed over labels: dispatches (all and
    on the cuda engine), modelled cycles, host syncs and device puts."""
    def total(name, engine=None):
        return sum(v for labels, v in
                   metrics.counter(f"comefa.{name}").series().items()
                   if engine is None or ("engine", engine) in labels)
    return {"dispatches": total("dispatches"),
            "cuda": total("dispatches", "cuda"),
            "cycles": total("dispatch_cycles"),
            "host_syncs": total("host_syncs"),
            "device_puts": total("device_puts")}


class _Breakdown:
    """Where one phase-14 call's wall time goes: host seconds in the cuda
    engine's state downloads (`to_host`, which waits for the kernels
    queued before it) and uploads (`to_device`) and in its dispatches
    (`run`: decoding a new program on the device, enqueueing the
    launch), and the step kernel's device time, from CUDA events around
    each launch (an upper bound: onto an idle stream, the time between
    the events includes the launch's own enqueue).  The rest of the wall
    time is host work: building and encoding programs, numpy placement
    and extraction."""

    HOST = ("to_host", "to_device", "run", "run_per_slot")

    def __init__(self, cs, engine):
        self.cs, self.engine, self.launch = cs, engine, cs.run_packed

    def __enter__(self):
        self.host = dict.fromkeys(self.HOST, 0.0)
        self.events = []
        for name in self.HOST:
            def timed(*args, _real=getattr(self.engine, name), _name=name,
                      **kw):
                t0 = time.perf_counter()
                try:
                    return _real(*args, **kw)
                finally:
                    self.host[_name] += time.perf_counter() - t0
            setattr(self.engine, name, timed)

        def launch(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.launch(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        self.cs.run_packed = launch
        return self

    def __exit__(self, *exc):
        for name in self.HOST:
            delattr(self.engine, name)
        self.cs.run_packed = self.launch
        torch.cuda.synchronize()
        self.kernel_s = sum(a.elapsed_time(b) for a, b in self.events) / 1e3
        return False


def _fir_oracle(taps, x, acc_bits):
    """The direct-form FIR in int64, reduced to the accumulator's width
    (the array's adds carry out of its top row and drop the carry)."""
    y = np.convolve(taps.astype(np.int64), x.astype(np.int64))[:len(x)]
    return y & ((1 << acc_bits) - 1)


def _hold_to_plain(engine_packed, label, fn, picks):
    """Run `fn` with the cuda engine's dispatches wrapped: dispatch i, for
    i in `picks`, also runs the same program from the same state through
    the plain version (the packed torch scan, on the card), and the step
    kernel's mem, carry and mask must equal it.  Returns the instructions
    held."""
    cuda, plain = engine_packed.get_engine("cuda"), engine_packed.get_engine(
        "packed")
    seen, held = [0], []

    def run(state, mat, chain, _real=cuda.run):
        i = seen[0]
        seen[0] += 1
        if i not in picks:
            return _real(state, mat, chain)
        ref = plain.run(tuple(t.clone() for t in state), mat, chain)
        out = _real(state, mat, chain)
        for name, got, want in zip(("mem", "carry", "mask"), out, ref):
            if not torch.equal(got, want):
                fail(f"{label}: dispatch {i} ({mat.shape[0]} instructions)"
                     f": the step kernel's {name} differs from the plain "
                     f"version's")
        held.append(int(mat.shape[0]))
        return out
    cuda.run = run
    try:
        fn()
    finally:
        del cuda.run
    if len(held) != len(picks):
        fail(f"{label}: {len(held)} of {len(picks)} dispatches held")
    return held


def phase_eval_layer(cs, comefa_sim, metrics, dev):
    """The six array kernels of `comefa_sim` on the cuda engine, each held
    exactly to its numpy oracle, its step-kernel launches to the
    simulator's dispatches; the unoptimised dot's and FIR's cycles to
    their closed forms.  The step kernel's launch count is set to 0 just
    before and read just after; returns it."""
    from repro_torch.core.comefa import engine_packed, program, schedule
    from repro_torch.core.comefa import timing
    from repro_torch.core.comefa.isa import ceil_log2
    from repro_torch.core.fpga_model import perf
    rng = np.random.default_rng(14)
    ctas = cs.ctas_per_slot(EVAL_GEMM_BLOCKS, True)
    ctas_fir = cs.ctas_per_slot(-(-EVAL_LONG_FIR[0] // 160), True)
    print(f"[14 eval] chained slots of {EVAL_GEMM_BLOCKS} blocks (GEMM) and "
          f"{-(-EVAL_LONG_FIR[0] // 160)} blocks (FIR) run on clusters of "
          f"{ctas} and {ctas_fir} CTAs")
    if ctas < 2 or ctas_fir < 2:
        fail("phase 14's long chains do not reach the cluster path")

    def call(label, fn, want):
        before, l0 = _sim_counts(metrics), cs.launches
        with _Breakdown(cs, engine_packed.get_engine("cuda")) as br:
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        d = {k: v - before[k] for k, v in _sim_counts(metrics).items()}
        launched = cs.launches - l0
        trips = br.host["to_host"] + br.host["to_device"]
        disp = br.host["run"] + br.host["run_per_slot"]
        print(f"[14 eval] {label}: {dt:.3f} s, {launched} step-kernel "
              f"launches, {d['dispatches']} dispatches, {d['host_syncs']} "
              f"host syncs, {d['device_puts']} device puts, {d['cycles']} "
              f"modelled cycles; state round trips {trips:.3f} s "
              f"(downloads {br.host['to_host']:.3f}, uploads "
              f"{br.host['to_device']:.3f}), dispatches {disp:.3f} s, "
              f"step kernel {br.kernel_s * 1e3:.3f} ms on the device, the "
              f"rest (program build and encode, placement) "
              f"{dt - trips - disp:.3f} s")
        if not np.array_equal(np.asarray(got), np.asarray(want)):
            fail(f"{label}: the result differs from the numpy oracle")
        if launched == 0 or launched != d["dispatches"] or \
                d["cuda"] != d["dispatches"]:
            fail(f"{label}: {launched} launches for {d['dispatches']} "
                 f"dispatches ({d['cuda']} on the cuda engine)")
        return d

    bits = EVAL_BITS
    t_phase = time.perf_counter()
    # ---- the evaluation path, counted ----
    cs.launches = 0
    a = rng.integers(0, 1 << bits, EVAL_ELTWISE_N)
    b = rng.integers(0, 1 << bits, EVAL_ELTWISE_N)
    call(f"eltwise_mul of {EVAL_ELTWISE_N} {bits}-bit pairs "
         f"({-(-EVAL_ELTWISE_N // 160)} blocks)",
         lambda: comefa_sim.comefa_eltwise_mul(a, b, bits=bits, device=dev),
         a * b)
    h = EVAL_GEMV_H
    w = rng.integers(0, 1 << bits, (h, h))
    x = rng.integers(0, 1 << bits, h)
    for recode in ("naive", "auto"):
        call(f"gemv [{h}, {h}] x [{h}], {bits}-bit, acc 32, recode={recode}",
             lambda: comefa_sim.comefa_gemv(w, x, w_bits=bits, x_bits=bits,
                                            acc_bits=32, recode=recode,
                                            device=dev),
             (w * x[:, None]).sum(0))
    m, k, n = EVAL_GEMM
    a = rng.integers(0, 1 << bits, (EVAL_GEMM_SLOTS, m, k))
    b = rng.integers(0, 1 << bits, (EVAL_GEMM_SLOTS, k, n))
    gemm_ab = a[0], b[0]
    call(f"gemm [{m}, {k}] @ [{k}, {n}], {bits}-bit, n_blocks "
         f"{EVAL_GEMM_BLOCKS} ({ctas}-CTA clusters)",
         lambda: comefa_sim.comefa_gemm(a[0], b[0], bits=bits,
                                        n_blocks=EVAL_GEMM_BLOCKS,
                                        device=dev),
         a[0] @ b[0])
    call(f"gemm_batched G={EVAL_GEMM_SLOTS} of the same",
         lambda: comefa_sim.comefa_gemm_batched(a, b, bits=bits,
                                                n_blocks=EVAL_GEMM_BLOCKS,
                                                device=dev),
         np.einsum("gmk,gkn->gmn", a, b))
    a = rng.integers(0, 1 << bits, EVAL_DOT_N)
    b = rng.integers(0, 1 << bits, EVAL_DOT_N)
    dot, dot_ab = int((a * b).sum()), (a, b)
    nb = -(-EVAL_DOT_N // 160)
    t0 = time.perf_counter()
    call(f"dot of {EVAL_DOT_N} {bits}-bit pairs ({nb} chained blocks)",
         lambda: comefa_sim.comefa_dot(a, b, bits=bits, device=dev), dot)
    prog = comefa_sim._PROGRAMS[("dot", bits, nb, True)][0]
    d = call("dot, unoptimised",
             lambda: comefa_sim.comefa_dot(a, b, bits=bits, optimized=False,
                                           device=dev), dot)
    raw = comefa_sim._PROGRAMS[("dot", bits, nb, False)][0]
    steps, chain_steps = program.full_reduce_steps(nb)
    closed = (timing.mul_cycles(bits) + steps + chain_steps
              + timing.chained_reduction_cycles(2 * bits, n_blocks=nb))
    print(f"[14 eval] dot programs: {prog.cycles} instructions optimised, "
          f"{raw.cycles} unoptimised = mul_cycles + {steps + chain_steps} "
          f"+ chained_reduction_cycles = {closed}; both calls with their "
          f"builds {time.perf_counter() - t0:.3f} s")
    if raw.cycles != closed or d["cycles"] != closed:
        fail(f"unoptimised dot: {raw.cycles} program cycles, {d['cycles']} "
             f"dispatched, closed form {closed}")
    n_taps, xb, acc, n_samples = EVAL_FIR
    taps = rng.integers(0, 1 << xb, n_taps)
    x = rng.integers(0, 1 << xb, n_samples)
    want = _fir_oracle(taps, x, acc)
    call(f"fir of {n_taps} taps, {xb}-bit taps and samples, {acc}-bit acc, "
         f"{n_samples} samples (1 block)",
         lambda: comefa_sim.comefa_fir(taps, x, tap_bits=xb, x_bits=xb,
                                       acc_bits=acc, device=dev), want)
    xs = x[:EVAL_FIR_CHECK_SAMPLES]
    d = call(f"fir, unoptimised, {len(xs)} samples",
             lambda: comefa_sim.comefa_fir(taps, xs, tap_bits=xb, x_bits=xb,
                                           acc_bits=acc, optimized=False,
                                           device=dev), want[:len(xs)])
    closed = timing.fir_cycles(len(xs), xb, acc, x_values=xs)
    print(f"[14 eval] unoptimised fir: {d['cycles']} cycles, fir_cycles "
          f"{closed}")
    if d["cycles"] != closed:
        fail("unoptimised fir cycles differ from timing.fir_cycles")
    n_taps, n_samples = EVAL_LONG_FIR
    taps = rng.integers(0, 1 << xb, n_taps)
    x = rng.integers(0, 1 << xb, n_samples)
    acc = xb + xb + ceil_log2(n_taps)         # comefa_fir's default
    call(f"fir of {n_taps} taps ({-(-n_taps // 160)} chained blocks, "
         f"{ctas_fir}-CTA clusters), {xb}-bit, {acc}-bit acc, {n_samples} "
         f"samples",
         lambda: comefa_sim.comefa_fir(taps, x, tap_bits=xb, x_bits=xb,
                                       device=dev),
         _fir_oracle(taps, x, acc))
    launched = cs.launches
    # ---- end of the counted evaluation path ----
    print(f"[14 eval] {launched} step-kernel launches in "
          f"{time.perf_counter() - t_phase:.1f} s")
    # the step kernel against its plain version on real programs: the
    # GEMM's first and last tiles (128 blocks, clusters), the dot's one
    # long launch, every dispatch of three samples of the long FIR
    t0 = time.perf_counter()
    n_tiles = sum(1 for _ in schedule.plan_gemm(
        m, k, n, bits, n_blocks=EVAL_GEMM_BLOCKS).tiles())
    held = _hold_to_plain(
        engine_packed, "gemm", lambda: comefa_sim.comefa_gemm(
            *gemm_ab, bits=bits, n_blocks=EVAL_GEMM_BLOCKS, device=dev),
        {0, n_tiles - 1})
    held += _hold_to_plain(
        engine_packed, "dot", lambda: comefa_sim.comefa_dot(
            *dot_ab, bits=bits, device=dev), {0})
    held += _hold_to_plain(
        engine_packed, "long fir", lambda: comefa_sim.comefa_fir(
            taps, x[:3], tap_bits=xb, x_bits=xb, device=dev), set(range(7)))
    print(f"[14 eval] step kernel == plain version (torch.equal on mem, "
          f"carry, mask) on {len(held)} real dispatches of {held} "
          f"instructions: {time.perf_counter() - t0:.1f} s")
    print(f"[14 eval] Fig 9 (perf.run_all): {json.dumps(perf.run_all())}")
    return launched


def main():
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import bit_transpose as bt
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import bitserial_reduce as bsr
    from repro_torch.kernels import bulk_bitwise as bb
    from repro_torch.kernels import comefa_sim, nvcc, ops, ref
    from repro_torch.kernels import comefa_step as cs
    from repro_torch.models import common, lm
    from repro_torch.obs import metrics
    from repro_torch.quant import bitplane
    from repro_torch.serve import comefa_exec, engine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    t_start = time.perf_counter()
    print(f"chip_smoke: torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}) on {torch.cuda.get_device_name(0)}; {smi}")
    ks = Bitserial(bt, bb, bsr, bsm)
    phase_build(nvcc, (bpm.SOURCE, cs.SOURCE, bt.SOURCE, bb.SOURCE,
                       bsr.SOURCE, bsm.SOURCE),
                ("1 build", "6 build") + ("11 build",) * 4)
    worst = phase_kernel_vs_plain(bpm, bitplane, dev)
    phase_reduced(bpm, configs, common, lm, engine, dev)
    launched, step_s = phase_full(bpm, configs, common, lm, engine, dev)
    layer = phase_timings(bpm, bitplane, dev, smi)
    per_step = 32 * layer["ms"]
    print(f"[5 time] 32 layers x 7 kernel launches (bf16 x and y, as the "
          f"main path calls it) = {per_step:.3f} ms of a "
          f"{1e3 * step_s:.2f} ms decode step ({100 * per_step / (1e3 * step_s):.1f}"
          f"% of its wall time); {smi}")
    step_err = phase_step_kernel(cs, comefa_sim, comefa_exec, dev)
    phase_chains(cs, dev)
    step_launched, per_layer_wave, tok_s = phase_grid_serve(
        cs, configs, lm, engine, comefa_exec, comefa_sim, metrics, dev,
        GRID_LAYERS)
    phase_per_slot(cs, configs, common, lm, engine, comefa_exec, dev)
    timing = phase_step_timing(cs, comefa_sim, comefa_exec, dev, smi)
    print(f"[10 time] grid decode at depth {GRID_LAYERS}: {tok_s:.3f} "
          f"tokens/s, {per_layer_wave:.3f} s per layer-wave; {smi}")
    ks.reset()
    phase_bitserial_vs_plain(ks, ops, ref, bitplane, dev)
    in_11 = ks.counts()
    serial_launched, data = phase_workloads(ks, ops, ref, bitplane, dev)
    print(f"[12 workloads] launches in phase 11: {in_11}; in phase 12: "
          f"{serial_launched}")
    serial = phase_bitserial_timing(ks, ops, bitplane, data, dev, smi)
    del data
    eval_launched = phase_eval_layer(cs, comefa_sim, metrics, dev)
    print(f"[14 eval] step kernel launches: phase 8 {step_launched}, "
          f"phase 14 {eval_launched}")
    record = {"kernels": [
        {"name": "bitplane_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
         "replaces": "src/repro/kernels/bitplane_matmul.py:69",
         "launches": launched, "max_abs_err": worst, **layer},
        {"name": "comefa_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/comefa_step.cu",
         "replaces": "src/repro/kernels/comefa_step.py:80",
         "launches": step_launched + eval_launched,
         "max_abs_err": step_err, **timing}]}
    for name, (source, replaces) in BITSERIAL_KERNELS.items():
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": serial_launched[name],
            "max_abs_err": ks.err[name], **serial[name]})
    print(json.dumps(record))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
