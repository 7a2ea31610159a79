#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`), on one card.

    python3 chip_smoke.py        # from the repository root

Drives only the port (no JAX, nothing of `repro`).  Each phase prints its
lines; any failure exits nonzero, and nothing is caught:

  1. build every kernel of the port from `src/repro_torch/kernels/csrc`
     (seven sources, one nvcc each, in parallel) for sm_90a and print the
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
 15. the recurrent and sliding-window families on the bit-plane kernel:
     (a) the kernel at every distinct packed projection shape of
     RecurrentGemma-2B, xLSTM-1.3B, Gemma-2-27B, Gemma-3-27B and
     StarCoder2-7B (K up to 36,864, N down to 256) against its plain
     version with phase 2's tolerances, at M = 4 in bf16 and M = 32 in
     f32, and timed at M = 4 in bf16 beside its byte bound and bf16
     torch.matmul; (b) RecurrentGemma-2B and (c) xLSTM-1.3B at full width
     and depth (26 and 48 layers, bf16, 8-bit planes, random seeded
     params) through `generate` and `serve_continuous` as in phase 4, with
     the kernel's launch count reset just before and read just after and
     equal to the model's packed projections (146 and 180) times the
     decode-path calls; one decode step with the kernel against the plain
     version, logits within 5% of the largest (for xLSTM, whose gates
     carry a one-ulp bf16 flip far, shown in bf16 and held on an f32 copy
     of the activations); every packed projection of that step, kernel
     against plain on the same activations, within the f32 bound plus one
     bf16 ulp; no cast around any packed projection; the device's busy
     share; (d) Gemma-2-27B, Gemma-3-27B and StarCoder2-7B at full width
     and one pattern period deep (2, 6 and 2 layers) through a 4-step
     `generate`, counted alike, with the decode step, casts and busy
     share;
 16. the MoE, encoder-decoder and prefix-LM families on the bit-plane
     kernel: (a) the kernel at every distinct packed projection shape of
     Mixtral-8x7B, Arctic-480B, Whisper-small and PaliGemma-3B against its
     plain version at M = 4 in bf16 and M = 32 in f32 and timed at M = 4
     as in 15a, and at Whisper's cross-attention K and V rows (M = 6,144,
     K = N = 768, bf16), held and timed beside its tensor-core bound and
     bf16 torch.matmul; (b) Mixtral-8x7B at full width, 24 of 32 layers
     (16 where 24 do not fit: the line says which and why), through
     `generate` and `serve_continuous`; (c) Arctic-480B at full width, 2
     of 35 layers, through a 4-step `generate`; (d) Whisper-small at full
     width and depth (12 encoder and 12 decoder layers, seeded frame
     embeddings [4, 1,536, 768]) through `generate`, which encodes once;
     (e) PaliGemma-3B at full width and depth (18 layers): `forward` over
     seeded patch embeddings [4, 256, 2,048] and 8 tokens (last position,
     counted, against the plain version), then `generate` and
     `serve_continuous`; each with launches equal to the packed
     projections times the decode-path calls (plus one encode's), the
     decode step, every projection held, casts, memory and busy share as
     in phase 15;
 17. training, on no kernel (projections are dense and trained; every
     kernel's launch count is reset before the phase and must read 0
     after it): (a) SmolLM-360M at full width and depth in f32, batch 1
     x 128: the loss and every gradient leaf of a step on the card
     against the same step on the CPU from the same params (loss within
     1e-5 relative, each leaf within 1e-3 of its largest |grad|), and
     the first and second moments the update writes; (b) SmolLM-360M in bf16 through
     `train.loop.Trainer`: 8 x 2,048 tokens a step in 2 microbatches,
     30 steps, AdamW at the launcher's defaults, async checkpoints every
     10 steps (keep 2) and the final blocking save: median ms a step,
     tokens/s, the share of the bf16 peak (6 x params x tokens), the
     device's busy share over 3 steps (torch.profiler), peak memory,
     each checkpoint's bytes and times; the mean loss of the last 5
     steps at most 0.9 x the first 5's; (d) 10 steps from (b)'s
     step-30 checkpoint with the f32 and with the int8 second moment,
     the params' moves within 10% of each other; (c) under deterministic
     algorithms, 20 steps, a restart and 10 more equal to 30 straight
     steps bit for bit (params, moments, step); each directory of
     checkpoints is deleted once read, and the most disk they took at
     once is printed; (e) one step of
     RecurrentGemma-2B (26 layers), Whisper-small (12 + 12 layers, 1,536
     frames) and Mixtral-8x7B (2 of 32 layers) at full width: loss and
     gradients finite, every gradient leaf nonzero, a plain SGD probe
     along -grad lowers the loss; ms a step and peak memory;
 18. the distribution layer on one card: (a) `examples/quickstart_torch.py`
     on the CPU and then on the card, with the bit-plane and step
     kernels' launch counts reset just before and read just after: its
     three checks hold and every line equals the CPU run's; (b)
     `launch.mesh.make_host_mesh()`: a (1, 1) ("data", "model") mesh on
     cuda over the one-rank NCCL group it starts; (c)
     `serve.engine.make_jitted_serve_step` on that mesh, full SmolLM-360M
     (32 layers, bf16, 8-bit planes, seeded params), batch 4, phase 4's
     max_len: the decode step captured as one CUDA graph at the first
     call and replayed, primed with an 8-token prompt, then 16 replayed
     steps with the launch count reset just before and read just after
     (224 x 16), and 16 eager `lm.decode_step`s from a copy of the primed
     state on the same tokens, logits and every state tensor
     `torch.equal` at each step; capture time, memory, ms a step replayed
     and eager (medians, same call) and the replay's busy share
     (torch.profiler); a second states list captures its own graph and
     gives the first list's logits; (d) `train.step.make_jitted_train_step`
     on that mesh against `train_step`, SmolLM-360M in f32 at 1 x 128, 2
     steps under deterministic algorithms, bit for bit; (e)
     `parallel.compression.compress_psum` and
     `parallel.pipeline.pipelined_apply` on the one NCCL rank, each
     exactly equal to what one rank must give; (f) #1 and torch.matmul
     against the f64 product of their own operands at PaliGemma's prefix
     projections (M = 1,056) and Whisper's cross K/V (M = 6,144), y in
     f32 (also bf16 torch.mm with f32 y) and in bf16, each one's largest
     gap relative to the largest |y|;
 19. training across ranks, the sharded grid and the launch tools on one
     card: (a) SmolLM-360M in bf16 at full width, 2 x 2,048 tokens,
     deterministic: `Trainer(mesh=make_host_mesh())` for 4 steps with a
     checkpoint every 2, then a second `Trainer` on a new (1, 1) mesh
     restoring step 2 through `restore(shardings=...)` and running to
     step 4, its params and moments bit for bit the first run's; ms a
     step, checkpoint GB, save and restore s; and
     `python -m repro_torch.launch.train --reduced --mesh host --fsdp
     --steps 3` exits 0; (a') phase 17a's step (f32, TF32 off, 1 x 128):
     the card's and the CPU's gradients of three leaves, and each side's
     farthest leaf, against an f64 gradient of the same step on the CPU;
     (b) `comefa_gemv_batched` on `mesh=grid_mesh()` at SmolLM-360M's
     four projection shapes (8-bit, 4 slots) equal to the call without a
     mesh (results, stats, cycles, dispatches), with the step kernel's
     launches counted and equal to the dispatches; one sharded dispatch
     of #2 against the plain packed scan, `torch.equal`; (c) the launch
     tools (a subprocess begun before (a), on a fake process group and
     meta tensors): `dryrun` and `roofline` of SmolLM-360M's three cells
     on the fake 16 x 16 mesh, and the roofline bound of phase 17b's step
     counted on a one-rank fake mesh, printed beside 17b's measured ms a
     step and held below it;
 20. latent attention (DeepSeek-V2-Lite): (a) the absorbed decode kernel
     (`kernels.mla_decode`, built in phase 1) against its plain version
     in f32 on the card, at dsv2-lite-serve's 32 slots x 2,048 cached
     positions, at the published widths (16 heads, latent 512, RoPE 64),
     positions mixed up to 2,047, queries at the serving scale and at 8x:
     within the bound of two f32 orders of the same sums and one bf16
     rounding, and the largest gap under 1e-2 of the largest output;
     (b) its device time (CUDA graph, events) at those positions and
     with every slot at 2,047, beside its bound from
     `bench/metrics/mla_work.py`'s bytes and FLOPs; (c) the whole model
     (27 layers, 64 experts, bf16, 8-bit planes, seeded params) through
     `serve_continuous` at 32 slots, warmed up at the same slots and
     max_len, then with the launch counts set to 0 just before: the
     kernel's launches and ``attention.mla_decodes{path=kernel}`` equal
     27 x the batched steps, the bit-plane kernel's equal the packed
     projections x the steps, and every step replayed from the graph;

then one JSON line of kernel records (the bit-plane kernel's launches are
phases 4's, 15's, 16's and 18's, the step kernel's phase 8's, phase 14's,
phase 18's and phase 19's, the MLA decode kernel's phase 20c's),
the card's name and power limit as nvidia-smi prints them, and the
result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import copy
import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time

# set before CUDA starts: phase 17c runs under deterministic algorithms,
# which need cuBLAS's fixed workspace (this is its size on Hopper anyway)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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


def _kernel_check(bpm, bitplane, gen, dev, m, k, n, bits, dtypes):
    """The kernel against its plain version at one shape and bit width, for
    each x dtype in `dtypes`: exact on integer x with scale 1; within the
    f32 bound for two orders of one sum on float x; a bf16 y equal to the
    f32 y rounded once.  Returns (exact, rounded, max |d|/bound,
    max |d|)."""
    xi, qi, ones = _operands(gen, dev, bits, m, k, n, integer=True)
    pi = bitplane.pack(qi, bits)
    x, q, scale = _operands(gen, dev, bits, m, k, n, integer=False)
    planes = bitplane.pack(q, bits)
    exact, rounded, ratio, worst = True, True, 0.0, 0.0
    for xd in dtypes:
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
    return exact, rounded, ratio, worst


def phase_kernel_vs_plain(bpm, bitplane, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    shapes = [(m, k, n) for m in (M_DECODE, M_PREFILL)
              for k, n in SMOLLM_SHAPES] + [RAGGED, (M_PREFILL,) + RAGGED[1:]]
    for m, k, n in shapes:
        for bits in (4, BITS):
            exact, rounded, ratio, err = _kernel_check(
                bpm, bitplane, gen, dev, m, k, n, bits,
                (torch.float32, torch.bfloat16))
            worst = max(worst, err)
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
    l_cpu, _ = lm.forward(cpu_model, prompt)
    l_gpu = lm.forward(gpu_model, prompt.to(dev))[0].cpu()
    d = float((l_cpu - l_gpu).abs().max())
    same = torch.equal(tok_cpu, tok_gpu.cpu())
    print(f"[3 reduced] f32 2-layer SmolLM, card (kernel) vs CPU (plain): "
          f"greedy tokens equal={same}, forward logits max|d|={d:.3e}, "
          f"kernel launches={launched}")
    if not same or d > 1e-4:
        fail("reduced model on the card disagrees with the CPU")
    if launched != lm.packed_projections(gpu_model) * (prompt.shape[1]
                                                        + steps):
        fail(f"reduced generate launched the kernel {launched} times")


def _plain_hook(bpm, halves=False):
    """The plain version as a linear hook.  With `halves`, the same f32
    function summed in another order (K in two halves, each scaled, then
    added): a second correct version, which shows how far two f32 orders
    of one sum carry through a model."""
    def hook(params, x2, bits):
        packed, scale = params["packed"], params["scale"]
        x2 = x2.float()
        h = packed.shape[1] // 2
        if not halves or h == 0:
            return bpm.bitplane_matmul_plain(x2, packed, scale, bits=bits)
        return (bpm.bitplane_matmul_plain(x2[:, :32 * h], packed[:, :h],
                                          scale, bits=bits)
                + bpm.bitplane_matmul_plain(x2[:, 32 * h:], packed[:, h:],
                                            scale, bits=bits))
    return hook


def _ratio(a, b):
    """max |a - b| over max |b|, and the share of rows whose argmax
    agree."""
    d = float((a - b).abs().max())
    return d / float(b.abs().max()), \
        float((a.argmax(-1) == b.argmax(-1)).float().mean())


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
    b, s, steps = M_DECODE, 8, 24
    prompt, out, gen_s, reqs, outs, stats, serve_s, launched = _counted_run(
        bpm, engine, model, dev, b, s, steps, serve=True)
    calls = (s + steps) + stats["steps"]
    per_call = lm.packed_projections(model)
    expect = per_call * calls
    emitted = sum(len(o) for o in outs)
    print(f"[4 full] generate: {b}x{s} prompt, {steps} steps in "
          f"{gen_s:.3f} s = {b * steps / gen_s:.1f} tokens/s, "
          f"{1e3 * gen_s / (s + steps):.2f} ms per decode step")
    print(f"[4 full] serve_continuous: {len(reqs)} requests, {emitted} "
          f"tokens in {serve_s:.3f} s = {emitted / serve_s:.1f} tokens/s, "
          f"{stats['steps']} batched steps, occupancy "
          f"{stats['occupancy']:.3f}")
    print(f"[4 full] bit-plane kernel launches: {launched} (expected "
          f"{per_call // cfg.n_layers} x {cfg.n_layers} x {calls} "
          f"decode-path calls = {expect})")
    if launched != expect or launched == 0:
        fail("the main path did not run every projection through the kernel")
    _check_tokens(cfg, out, b, steps, reqs, outs)
    _decode_vs_plain(bpm, common, lm, model, prompt, out[:, :1].long(),
                     "4 full", f"{cfg.n_layers} residual layers")
    _check_casts(bpm, lm, model, prompt, out[:, :1].long(), "4 casts")
    step_s = gen_s / (s + steps)
    profile_decode(lambda: engine.generate(model, prompt, steps=4,
                                           max_len=s + 5), s + 4, step_s)
    return launched, step_s


def _counted_run(bpm, engine, model, dev, b, s, steps, serve,
                 enc_inputs=None):
    """The main path of one model: a warm-up, then with the bit-plane
    kernel's launch count reset just before and read just after,
    `generate` (b x s seeded prompt, `steps` new tokens; an
    encoder-decoder encodes `enc_inputs` once) and, with `serve`,
    `serve_continuous` (8 requests over 4 slots).  The warm-up also
    serves one request at the same slots and max_len, so the counted call
    replays the decode step captured there."""
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)

    # warm-up (first launches, allocator, the serving step's capture), not
    # counted
    engine.generate(model, prompt, steps=2, max_len=s + 3,
                    enc_inputs=enc_inputs)
    if serve:
        engine.serve_continuous(model, [engine.Request(np.ones(2, np.int64),
                                                       2)],
                                slots=4, max_len=24)
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    bpm.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(model, prompt, steps=steps, max_len=s + steps + 1,
                          enc_inputs=enc_inputs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    rng = torch.Generator().manual_seed(2)
    reqs, outs, stats, serve_s = [], [], {"steps": 0}, 0.0
    for i in range(8 if serve else 0):
        plen = 3 + i % 6
        p = torch.randint(0, cfg.vocab, (plen,), generator=rng).numpy()
        reqs.append(engine.Request(p, 4 + (3 * i) % 9))
    if serve:
        t0 = time.perf_counter()
        outs = engine.serve_continuous(model, reqs, slots=4, max_len=24,
                                       stats=stats)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    launched = bpm.launches
    # ---- end of the counted main path ----
    return prompt, out, gen_s, reqs, outs, stats, serve_s, launched


def _check_tokens(cfg, out, b, steps, reqs, outs):
    out_cpu = out.cpu()
    if tuple(out_cpu.shape) != (b, steps) or int(out_cpu.min()) < 0 or \
            int(out_cpu.max()) >= cfg.vocab:
        fail(f"generate returned {tuple(out_cpu.shape)} tokens out of range")
    for r, o in zip(reqs, outs):
        if len(o) != r.steps or o.min() < 0 or o.max() >= cfg.vocab:
            fail("serve_continuous returned a wrong token stream")


def _primed(lm, model, prompt, ctx=None):
    """Decode states primed with `prompt` (max_len 16), and a copy; an
    encoder-decoder's steps read the encoder's output `ctx`."""
    s = prompt.shape[1]
    states = lm.decode_state_init(model.cfg, prompt.shape[0], 16,
                                  model.device)
    for t in range(s):
        _, states = lm.decode_step(model, prompt[:, t:t + 1], states, t,
                                   ctx=ctx)
    return states, [{k: v.clone() for k, v in st.items()} for st in states]


class _Routes:
    """`ffn.route` wrapped for the length of a `with`: every MoE layer's
    input and routing is kept in `seen`, in call order.  Given `replay`
    (an earlier run's `seen`), each layer is handed the expert indices,
    queue positions and keep mask recorded at the same place of that run
    instead of its own, so that two decode steps route alike; its gates
    are its own probabilities on those experts, or with `gates` the
    recorded gates too."""

    def __init__(self, ffn, replay=None, gates=False):
        self.ffn, self.replay, self.gates, self.seen = ffn, replay, gates, []

    def __enter__(self):
        self.real = real = self.ffn.route

        def route(w, xg, cfg, capacity):
            out = real(w, xg, cfg, capacity)
            self.seen.append((xg, out))
            if not self.replay:
                return out
            probs = out[0]
            _, rec_gates, idx, pos, keep = self.replay[len(self.seen) - 1][1]
            if self.gates:
                return probs, rec_gates, idx, pos, keep
            gates = probs.gather(-1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            return probs, gates * keep, idx, pos, keep

        self.ffn.route = route
        return self

    def __exit__(self, *exc):
        self.ffn.route = self.real


# how a decode step's kernel-vs-plain gap is held: within 5% of the
# largest logit, or within twice the gap of the plain version summed in
# another f32 order (where the model carries a one-ulp bf16 flip past 5%
# with no kernel in the step), or shown only
FIVE_PERCENT, WITNESS = 5e-2, "witness"
REPLAY_WHAT = {"experts": "experts (its own gates)",
               "routing": "experts and gates"}


def _decode_vs_plain(bpm, common, lm, model, prompt, nxt, tag, depth,
                     hold=FIVE_PERCENT, ctx=None, enc=None, replay=None):
    """One decode step with the kernel against one with its plain version
    on the card, from the same primed states and encoder output `ctx`;
    given `enc`, each plain step reads its own plain encode of `enc`
    instead.  With `replay` ("experts" or "routing"), the plain step
    takes every MoE layer's experts (and with "routing" its gates) from
    the kernel step.  `hold` is FIVE_PERCENT, WITNESS or None; a step
    whose MoE layers route apart is not held.  Returns both steps' MoE
    routings (`_Routes.seen`)."""
    s = prompt.shape[1]
    states, saved = _primed(lm, model, prompt, ctx)
    again = [{k: v.clone() for k, v in st.items()} for st in saved]
    with _Routes(lm.ffn_mod) as kernel_routes:
        lk, _ = lm.decode_step(model, nxt, states, s, ctx=ctx)
    replayed = kernel_routes.seen if replay else None
    gates = replay == "routing"
    prev = common.set_linear_hook(_plain_hook(bpm))
    try:
        ctx_p = ctx if enc is None else lm.encode(model, enc)
        with _Routes(lm.ffn_mod, replayed, gates) as plain_routes:
            lp, _ = lm.decode_step(model, nxt, saved, s, ctx=ctx_p)
        common.set_linear_hook(_plain_hook(bpm, halves=True))
        ctx_r = ctx if enc is None else lm.encode(model, enc)
        with _Routes(lm.ffn_mod, replayed, gates):
            lr, _ = lm.decode_step(model, nxt, again, s, ctx=ctx_r)
    finally:
        common.set_linear_hook(prev)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("non-finite logits")
    ratio, agree = _ratio(lk, lp)
    r_ratio, r_agree = _ratio(lr, lp)
    apart = [] if replay else _apart(kernel_routes.seen, plain_routes.seen)
    # Both paths sum in f32 in different orders and round every projection
    # output to bf16; a rare 1-ulp bf16 flip (2^-8 relative) is carried by
    # the residual layers, so logits are held to 5% of their largest value.
    # The plain version summed in another order shows what the model
    # makes of such flips with no kernel in the step.  A flip that moves a
    # near tie in an MoE router sends a token to other experts, which is
    # another function of the input: such a step is shown, not held.
    limit = None
    if hold is None:
        how = "not held"
    elif apart:
        how = (f"not held: {len(apart)} of {len(plain_routes.seen)} MoE "
               f"layers route apart")
    elif hold == WITNESS:
        limit = 2 * r_ratio
        how = f"tolerance twice the reordered plain version's, {limit:.2e}"
    else:
        limit, how = hold, "tolerance 5e-2"
    print(f"[{tag}] decode step kernel vs plain on the card ({depth}, "
          f"{model.cfg.dtype}" + (
              f", the plain step on the kernel step's {REPLAY_WHAT[replay]}"
              if replay else "") +
          (", each on its own encode" if enc is not None else "") +
          f"): logits max|d|/max|logit| {ratio:.2e} ({how}), argmax "
          f"agreement {agree:.2f}; the plain version in another f32 order "
          f"against it: {r_ratio:.2e}, argmax agreement {r_agree:.2f}")
    if limit is not None and ratio > limit:
        fail(f"{model.cfg.name} decode step: kernel and plain disagree")
    return kernel_routes.seen, plain_routes.seen


def _apart(kernel_seen, plain_seen):
    """The MoE layers whose expert indices, queue positions or keep mask
    differ between two steps' routings."""
    return [j for j, (a, b) in enumerate(zip(kernel_seen, plain_seen))
            if not all(torch.equal(a[1][i], b[1][i]) for i in (2, 3, 4))]


def _routing_report(kernel_seen, plain_seen, cfg, tag):
    """Where the kernel's and the plain decode step first route apart:
    how far the MoE inputs of that layer already were (bf16 rounding
    carried from the layers before) and how close two neighbours among
    the flipped token's top k + 1 router probabilities were (a swap
    inside the top k changes the token's GShard priority, one at its
    edge an expert).  Returns the layers that route apart."""
    differ = _apart(kernel_seen, plain_seen)
    drops = sum(int((~r[4]).sum()) for _, r in kernel_seen)
    if not differ:
        print(f"[{tag}] routing: all {len(kernel_seen)} MoE layers pick "
              f"the same experts in both steps ({drops} (token, choice) "
              f"pairs dropped at capacity)")
        return differ
    j = differ[0]
    (xk, rk), (xp, rp) = kernel_seen[j], plain_seen[j]
    drift = float((xk.float() - xp.float()).abs().max()
                  / xk.float().abs().max())
    p = rk[0].sort(dim=-1, descending=True).values[..., :cfg.top_k + 1]
    flipped = (rk[2] != rp[2]).any(-1)
    gap = float((p[..., :-1] - p[..., 1:]).min(-1).values[flipped].min())
    swapped = bool((rk[2].sort(-1).values == rp[2].sort(-1).values)
                   .all(-1)[flipped].all())
    print(f"[{tag}] routing: {len(differ)} of {len(kernel_seen)} MoE "
          f"layers route some token otherwise in the plain step, the "
          f"first at layer {j}, where the MoE inputs differ by {drift:.2e} "
          f"of their largest entry and two of the token's top "
          f"{cfg.top_k + 1} router probabilities are {gap:.2e} apart ("
          + ("the same experts in the other order, so another priority "
             "at capacity" if swapped else "another expert") +
          f"); {drops} (token, choice) pairs dropped at capacity in the "
          f"kernel step")
    return differ


def _hold_projections(bpm, bitplane, common, lm, model, prompt, nxt, tag,
                      ctx=None):
    """Every packed projection of one decode step held as `_hold_calls`
    holds them."""
    _, saved = _primed(lm, model, prompt, ctx)
    _hold_calls(bpm, bitplane, common, model,
                lambda: lm.decode_step(model, nxt, saved, prompt.shape[1],
                                       ctx=ctx),
                lm.packed_projections(model), tag, "one decode step")


def _hold_calls(bpm, bitplane, common, model, run, want, tag, what):
    """Every packed projection that `run()` calls, through both the kernel
    and its plain version on the same x (the model's real activations):
    the kernel's y, in the model's dtype, within the f32 bound for two
    orders of one sum plus one ulp of that dtype of the plain y; `want`
    calls."""
    calls, worst = [0], [0.0]
    eps = 2.0 ** -7 if model.cfg.adtype == torch.bfloat16 else 2.0 ** -23

    def hook(params, x2, bits):
        packed, scale = params["packed"], params["scale"]
        k = x2.shape[1]
        yk = bpm.bitplane_matmul(x2, packed, scale, bits=bits,
                                 out_dtype=x2.dtype)
        yp = bpm.bitplane_matmul_plain(x2, packed, scale, bits=bits)
        q = bitplane.unpack(packed, bits, axis=0)
        mag = x2.abs().double() @ (q.abs().double() * scale.double())
        f32 = (k + 2) * 2.0 ** -23 * mag
        top = yp.abs().double() + f32
        ulp = torch.exp2(torch.floor(torch.log2(
            top.clamp_min(2.0 ** -126)))) * eps
        d = (yk.double() - yp.double()).abs()
        worst[0] = max(worst[0], float((d / (f32 + ulp)).max()))
        calls[0] += 1
        return yk

    prev = common.set_linear_hook(hook)
    try:
        run()
    finally:
        common.set_linear_hook(prev)
    torch.cuda.synchronize()
    print(f"[{tag}] every packed projection of {what}, kernel vs "
          f"plain on the same activations: {calls[0]} calls, max "
          f"|d|/(f32 bound + one {model.cfg.dtype} ulp) = {worst[0]:.3f}")
    if calls[0] != want or worst[0] > 1:
        fail(f"{model.cfg.name}: a projection's kernel output is outside "
             f"the bound")


def _check_casts(bpm, lm, model, prompt, nxt, tag, ctx=None):
    """Every packed projection of one decode step hands the kernel x in
    the model's dtype and takes y in it."""
    cfg = model.cfg
    _, saved = _primed(lm, model, prompt, ctx)
    calls, casts = _projection_dtypes(
        bpm, lambda: lm.decode_step(model, nxt, saved, prompt.shape[1],
                                    ctx=ctx))
    seen = sorted({(str(a), str(b)) for a, b in calls})
    print(f"[{tag}] one decode step: {len(calls)} bit-plane kernel calls, "
          f"(x, y) dtypes {seen}: no cast before or after any packed "
          f"projection; {casts} aten._to_copy casts in the whole step")
    if len(calls) != lm.packed_projections(model) or \
            any(a != cfg.adtype or b != cfg.adtype for a, b in calls):
        fail("a packed projection casts around the bit-plane kernel")


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


def profile_decode(run, calls, step_s, tag="4 profile"):
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
        print(f"[{tag}] the profiler recorded no device time: the "
              "device's busy share is not measured")
        return
    print(f"[{tag}] device busy {dev_us / 1e3:.3f} ms per decode call "
          f"of {1e3 * step_s:.2f} ms wall unprofiled "
          f"({100 * dev_us / (1e6 * step_s):.1f}% busy)")
    cast = [e for e in on_dev if "copy_kernel" in e.key]
    print(f"[{tag}] casts on the device: "
          f"{sum(e.count for e in cast) / calls:.1f} launches and "
          f"{sum(e.self_device_time_total for e in cast) / calls:.1f} us per "
          f"decode call")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[{tag}]   device {e.self_device_time_total / calls:8.1f}"
              f" us/call  {e.count // calls:4d}x  {e.key[:70]}")
    on_host = [e for e in avg if not str(e.device_type).endswith("CUDA")]
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:6]:
        print(f"[{tag}]   host {e.self_cpu_time_total / calls:8.1f}"
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
    if probe.calls != lm.packed_projections(model) * stats["steps"]:
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


# ---------------------------------------------------------------------------
# phase 15: the recurrent and sliding-window families on the card
# ---------------------------------------------------------------------------

# every distinct packed projection (K, N) of each config
FAMILY_SHAPES = {
    "recurrentgemma-2b": ((2560, 2560), (2560, 256), (2560, 7680),
                          (7680, 2560)),
    "xlstm-1.3b": ((2048, 2048), (2048, 8192)),
    "gemma2-27b": ((4608, 4096), (4608, 2048), (4096, 4608), (4608, 36864),
                   (36864, 4608)),
    "gemma3-27b": ((5376, 4096), (5376, 2048), (4096, 5376), (5376, 21504),
                   (21504, 5376)),
    "starcoder2-7b": ((4608, 4608), (4608, 512), (4608, 18432),
                      (18432, 4608)),
}
# the big three run at full width and one pattern period deep (two layers
# for StarCoder2's one-layer pattern): one period runs every layer kind and
# every projection shape, and full depth (46, 62 and 32 layers) would
# multiply their share of the run's time (decode calls, and the hold of
# every projection, which unpacks each weight) for no new shape
PERIOD_DEPTH = {"gemma2-27b": 2, "gemma3-27b": 6, "starcoder2-7b": 2}
PERIOD_WHY = ("one pattern period runs every layer kind and projection "
              "shape, and full depth would multiply this config's init and "
              "run time for no new shape")


def phase_family_shapes(bpm, bitplane, dev, smi, shapes_by_config, tag):
    """(a) the bit-plane kernel at every new projection shape: held to its
    plain version at M = 4 in bf16 and M = 32 in f32 with phase 2's
    tolerances, then timed at M = 4 in bf16 (CUDA graph and events, the
    weights cycled out of L2) beside its byte bound and bf16 torch.matmul
    on the dequantised bf16 weight."""
    gen = torch.Generator(device=dev).manual_seed(int(tag[:2]))
    bf = torch.bfloat16
    shapes = sorted({kn for v in shapes_by_config.values() for kn in v})
    worst, total = 0.0, {"kernel": 0.0, "bound": 0.0, "lib": 0.0}
    for k, n in shapes:
        held = []
        for m, xd in ((M_DECODE, bf), (M_PREFILL, torch.float32)):
            exact, rounded, ratio, err = _kernel_check(
                bpm, bitplane, gen, dev, m, k, n, BITS, (xd,))
            worst = max(worst, err)
            held.append(f"M={m} {str(xd)[6:]} x: integer exact={exact}, "
                        f"|d|/bound={ratio:.3f}, bf16 y rounded={rounded}")
            if not (exact and rounded and ratio <= 1):
                fail(f"kernel disagrees with plain at M={m} K={k} N={n}")
        t_k, t_bound, t_lib, geo = _time_vs_matmul(bpm, bitplane, gen, dev,
                                                   M_DECODE, k, n)
        total["kernel"] += t_k
        total["bound"] += t_bound
        total["lib"] += t_lib
        print(f"[{tag} kernel] K={k} N={n}: " + "; ".join(held))
        print(f"[{tag} time] K={k} N={n} M={M_DECODE} bf16 x and y "
              f"({geo['splits']} splits, {geo['ctas']} CTAs): kernel "
              f"{t_k * 1e3:.2f} us, byte bound {t_bound * 1e3:.2f} us "
              f"({100 * t_bound / t_k:.0f}% of it), torch.matmul bf16 "
              f"{t_lib * 1e3:.2f} us ({t_lib / t_k:.2f}x the kernel's time);"
              f" {smi}")
    print(f"[{tag} time] {len(shapes)} shapes, one call each at "
          f"M={M_DECODE}: kernel {total['kernel'] * 1e3:.1f} us, byte bound "
          f"{total['bound'] * 1e3:.1f} us, torch.matmul bf16 "
          f"{total['lib'] * 1e3:.1f} us; {smi}")
    return worst


def _time_vs_matmul(bpm, bitplane, gen, dev, m, k, n):
    """The kernel's time at one shape, bf16 x and y (CUDA graph and
    events, the weights cycled out of L2), its bound (the larger of the
    bytes and the products at the bf16 tensor-core rate) and bf16
    torch.matmul's time on the dequantised weight: (kernel ms, bound ms,
    matmul ms, the kernel's geometry)."""
    bf = torch.bfloat16
    x, q, scale = _operands(gen, dev, BITS, m, k, n, integer=False)
    xb = x.to(bf)
    planes = bitplane.pack(q, BITS)
    wb = bitplane.dequantize(q, scale).to(bf)
    pc = [planes.clone() for _ in range(_copies(planes.numel() * 4))]
    wbc = [wb.clone() for _ in range(_copies(wb.numel() * 2))]
    t_k = _time_ms(lambda i: bpm.bitplane_matmul(
        xb, pc[i % len(pc)], scale, bits=BITS, out_dtype=bf), len(pc))
    t_lib = _time_ms(lambda i: torch.matmul(xb, wbc[i % len(wbc)]),
                     len(wbc))
    nbytes = BITS / 8 * k * n + 2 * m * (k + n) + 4 * n
    t_bound = max(1e3 * nbytes / HBM_BYTES_PER_S,
                  1e3 * 2 * m * k * n / BF16_FLOP_PER_S)
    return t_k, t_bound, t_lib, bpm.geometry(m, k, n, _sms())


def _packed_shapes(common, model):
    return {(m.packed.shape[1] * 32, m.packed.shape[2])
            for m in model.modules()
            if isinstance(m, common.PackedLinear) and m.packed is not None}


def phase_family(bpm, bitplane, configs, common, lm, engine, dev, name,
                 tag, shapes, depth=None, why="", full_run=True):
    """One config at full width on the card, 8-bit planes, bf16, `depth`
    layers deep where given (cut for `why`): the counted main path
    (`generate`, 24 steps with `full_run`, else 4; and `serve_continuous`
    with `full_run` for a decoder-only model; a prefix-LM's `forward` over
    patch embeddings first) with launches equal to the packed projections
    times the decode-path calls (plus one encode's); one decode step with
    the kernel against the plain version (logits within 5% of the
    largest; xLSTM's in f32 activations; an MoE's where both steps route
    alike, else on the kernel step's experts; an encoder-decoder's also
    each on its own encode, against the reordered plain version in bf16
    and within 5% in f32); every projection of an encode and of a decode
    step held to the plain version on the same activations; no cast
    around any packed projection; memory above params; and the device's
    busy share of a decode call."""
    over = {"n_layers": depth} if depth else {}
    full = configs.get(name)
    cfg = configs.get(name, quant_bits=BITS, **over)
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.state_dict().values())
    per_call = lm.packed_projections(model)
    per_encode = lm.packed_projections(model, encoder=True)
    if not _packed_shapes(common, model) <= set(shapes):
        fail(f"{name}: packed shapes {sorted(_packed_shapes(common, model))}"
             f" outside phase {tag[:2]}a's list")
    kinds = {}
    for k in cfg.layer_kinds():
        kinds[f"{k[0]}+{k[1]}"] = kinds.get(f"{k[0]}+{k[1]}", 0) + 1
    layers = f"{cfg.n_layers} layers (" + ", ".join(
        f"{v} {k}" for k, v in kinds.items()) + ")"
    if cfg.family == "encdec":
        layers += f" after {cfg.enc_layers} encoder layers"
    cut = f", cut from {full.n_layers}: {why}" if over else ""
    moe = (f", {cfg.n_experts} experts (top {cfg.top_k}, capacity factor "
           f"{cfg.capacity_factor}) of d_ff {cfg.d_ff}"
           if cfg.n_experts else "")
    print(f"[{tag}] {cfg.name}: {layers}{cut}; d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.kv_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}{moe}, vocab {cfg.vocab}, window {cfg.window}, "
          f"{cfg.dtype}, {BITS}-bit planes, "
          f"{'tied' if cfg.tie_embeddings else 'untied'} head; "
          f"{n_params} stored values, init {init_s:.1f} s; {per_call} "
          f"packed projections a decode call" + (
              f", {per_encode} an encode" if per_encode else ""))
    b, s, steps = M_DECODE, 8, 24 if full_run else 4
    enc = ctx = None
    if cfg.family == "encdec":
        enc = torch.randn((b, cfg.frontend_len, cfg.d_model),
                          generator=torch.Generator(device=dev).manual_seed(3),
                          device=dev)
        ctx = lm.encode(model, enc)
    prefix_launched = 0
    if cfg.prefix_lm:
        prefix_launched = _prefix_forward(bpm, bitplane, common, lm, model,
                                          dev, tag)
    prompt, out, gen_s, reqs, outs, stats, serve_s, launched = _counted_run(
        bpm, engine, model, dev, b, s, steps,
        serve=full_run and cfg.family != "encdec", enc_inputs=enc)
    calls = (s + steps) + stats["steps"]
    expect = per_call * calls + per_encode
    print(f"[{tag}] generate: {b}x{s} prompt, {steps} steps in "
          f"{gen_s:.3f} s = {b * steps / gen_s:.1f} tokens/s, "
          f"{1e3 * gen_s / (s + steps):.2f} ms per decode step" + (
              " (one encode included)" if per_encode else ""))
    if reqs:
        emitted = sum(len(o) for o in outs)
        print(f"[{tag}] serve_continuous: {len(reqs)} requests, {emitted} "
              f"tokens in {serve_s:.3f} s = {emitted / serve_s:.1f} "
              f"tokens/s, {stats['steps']} batched steps, occupancy "
              f"{stats['occupancy']:.3f}")
    print(f"[{tag}] bit-plane kernel launches: {launched} (expected "
          f"{per_call} x {calls} decode-path calls" + (
              f" + {per_encode} of one encode" if per_encode else "")
          + f" = {expect})")
    if launched != expect or launched == 0:
        fail(f"{name}: the main path did not run every projection through "
             f"the kernel")
    _check_tokens(cfg, out, b, steps, reqs, outs)
    nxt = out[:, :1].long()
    # xLSTM's exponential gates and normalizer carry a one-ulp bf16 flip of
    # a projection to a large share of the logits (both packages' bf16
    # logits sit far from their f32 logits), so its bf16 logits are shown
    # and the step is held in f32 activations instead, with the same
    # packed weights
    amplifies = cfg.name == "xlstm-1.3b"
    seen = _decode_vs_plain(bpm, common, lm, model, prompt, nxt, tag,
                            f"{cfg.n_layers} layers",
                            hold=None if amplifies else FIVE_PERCENT,
                            ctx=ctx)
    # an MoE turns a bf16 flip that moves a near tie in a router into
    # other experts for a token (and other capacity drops): where its two
    # steps route apart, the plain step is also run on the kernel step's
    # experts, with its own gates and with the kernel step's
    if cfg.n_experts and _routing_report(*seen, cfg, tag):
        for replay, hold in (("experts", WITNESS), ("routing", FIVE_PERCENT)):
            _decode_vs_plain(bpm, common, lm, model, prompt, nxt, tag,
                             f"{cfg.n_layers} layers", hold=hold,
                             replay=replay)
    if enc is not None:
        # 12 encoder layers over 1,536 frames carry a one-ulp bf16 flip
        # far: each plain step on its own encode is held against the
        # reordered plain version in bf16, and within 5% in f32
        _decode_vs_plain(bpm, common, lm, model, prompt, nxt, tag,
                         f"{cfg.n_layers} layers", hold=WITNESS, ctx=ctx,
                         enc=enc)
    if amplifies or enc is not None:
        m32 = copy.deepcopy(model).to(torch.float32)
        m32.cfg = dataclasses.replace(cfg, dtype="float32")
        _decode_vs_plain(bpm, common, lm, m32, prompt, nxt, tag,
                         f"{cfg.n_layers} layers",
                         ctx=None if enc is None else lm.encode(m32, enc),
                         enc=enc)
        del m32
    if enc is not None:
        _hold_calls(bpm, bitplane, common, model,
                    lambda: lm.encode(model, enc), per_encode, tag,
                    "one encode")
    _hold_projections(bpm, bitplane, common, lm, model, prompt, nxt, tag,
                      ctx)
    _check_casts(bpm, lm, model, prompt, nxt, tag, ctx)
    _decode_memory(lm, model, prompt, nxt, tag, ctx)
    step_s = gen_s / (s + steps)
    profile_decode(lambda: engine.generate(model, prompt, steps=4,
                                           max_len=s + 5, enc_inputs=enc),
                   s + 4, step_s, tag)
    del model, ctx, enc
    torch.cuda.empty_cache()
    return launched + prefix_launched, step_s


def _decode_memory(lm, model, prompt, nxt, tag, ctx=None):
    """Device memory of the params, and the most one decode call
    allocates above them and its states (the logits' temporaries: with a
    tied embedding, its f32 copy, as the JAX code takes it)."""
    cfg = model.cfg
    params = sum(t.numel() * t.element_size()
                 for t in model.state_dict().values())
    states, saved = _primed(lm, model, prompt, ctx)
    del saved
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lm.decode_step(model, nxt, states, prompt.shape[1], ctx=ctx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    emb = (f"the f32 copy of the tied embedding is "
           f"{4 * cfg.vocab * cfg.d_model / 1e9:.3f} GB of it"
           if cfg.tie_embeddings else "the head is untied: no f32 copy")
    print(f"[{tag}] device memory: params {params / 1e9:.3f} GB; one "
          f"decode call (batch {prompt.shape[0]}) allocates up to "
          f"{peak / 1e9:.3f} GB above the params and states; {emb}")


def phase_families(bpm, bitplane, configs, common, lm, engine, dev, smi):
    t0 = time.perf_counter()
    worst = phase_family_shapes(bpm, bitplane, dev, smi, FAMILY_SHAPES,
                                "15a")
    launched = {}
    for name, tag in (("recurrentgemma-2b", "15b"), ("xlstm-1.3b", "15c"),
                      ("gemma2-27b", "15d"), ("gemma3-27b", "15d"),
                      ("starcoder2-7b", "15d")):
        cut = name in PERIOD_DEPTH
        launched[name], step_s = phase_family(
            bpm, bitplane, configs, common, lm, engine, dev, name, tag,
            FAMILY_SHAPES[name], depth=PERIOD_DEPTH.get(name),
            why=PERIOD_WHY, full_run=not cut)
        print(f"[{tag}] {name}: {1e3 * step_s:.2f} ms per decode step "
              f"(batch {M_DECODE}); {smi}")
    print(f"[15 families] bit-plane kernel launches on the main paths: "
          f"{launched}; phase 15 took {time.perf_counter() - t0:.1f} s")
    return sum(launched.values()), worst


# ---------------------------------------------------------------------------
# phase 16: the MoE, encoder-decoder and prefix-LM families on the card
# ---------------------------------------------------------------------------

NEW_FAMILY_SHAPES = {
    "mixtral-8x7b": ((4096, 4096), (4096, 1024)),
    "arctic-480b": ((7168, 7168), (7168, 1024), (7168, 4864), (4864, 7168)),
    "whisper-small": ((768, 768), (768, 3072), (3072, 768)),
    "paligemma-3b": ((2048, 2048), (2048, 256), (2048, 16384),
                     (16384, 2048)),
}
# Whisper's cross-attention K and V, projected from the encoder's output
# at every decode step: batch 4 x 1,536 frames of d_model 768
CROSS_KV = (M_DECODE * 1536, 768, 768)
# Mixtral's experts are 2.82 GB a layer in bf16 (the JAX package keeps them
# in the activation dtype), 90.2 GB at full depth: more than the card holds
MIXTRAL_DEPTH = 24
ARCTIC_DEPTH = 2           # one layer's 128 experts are 26.8 GB


def _expert_bytes(cfg):
    return 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * \
        torch.finfo(cfg.adtype).bits // 8


def _mixtral_why(configs):
    full = configs.get("mixtral-8x7b")
    one = _expert_bytes(full)
    total = torch.cuda.get_device_properties(0).total_memory
    return (f"its experts are {one / 1e9:.2f} GB a layer in bf16, "
            f"{full.n_layers * one / 1e9:.1f} GB at full depth, above the "
            f"card's {total / 1e9:.1f} GB; {MIXTRAL_DEPTH} layers "
            f"({MIXTRAL_DEPTH * one / 1e9:.1f} GB of experts) fit")


def _arctic_why(configs):
    full = configs.get("arctic-480b")
    one = _expert_bytes(full)
    return (f"one layer's {full.n_experts} experts are {one / 1e9:.1f} GB "
            f"in bf16 ({full.n_layers * one / 1e9:.0f} GB at full depth), "
            f"so {ARCTIC_DEPTH} layers ({ARCTIC_DEPTH * one / 1e9:.1f} GB "
            f"of experts) are what the card holds")


def phase_cross_rows(bpm, bitplane, dev, smi):
    """The bit-plane kernel at Whisper's cross-attention K and V rows
    (M = 6,144, K = N = 768, bf16 x and y): held to its plain version
    with phase 2's tolerances, and timed beside its bound (bf16 tensor
    cores) and bf16 torch.matmul on the dequantised weight."""
    m, k, n = CROSS_KV
    gen = torch.Generator(device=dev).manual_seed(16)
    exact, rounded, ratio, err = _kernel_check(
        bpm, bitplane, gen, dev, m, k, n, BITS, (torch.bfloat16,))
    t_k, t_bound, t_lib, geo = _time_vs_matmul(bpm, bitplane, gen, dev, m,
                                               k, n)
    flops = 2 * m * k * n
    print(f"[16a kernel] M={m} K={k} N={n} bf16 x ({geo['path']} path, "
          f"{geo['m_tiles']} row tiles x {geo['n_tiles']} column tiles x "
          f"{geo['splits']} splits = {geo['ctas']} CTAs): integer "
          f"exact={exact}, |d|/bound={ratio:.3f}, bf16 y rounded={rounded}")
    print(f"[16a time] M={m} K={k} N={n} bf16 x and y: kernel "
          f"{t_k * 1e3:.2f} us ({flops / t_k / 1e9:.1f} TFLOP/s), bound "
          f"{t_bound * 1e3:.2f} us (operations at the bf16 tensor-core "
          f"rate; {100 * t_bound / t_k:.1f}% of it), torch.matmul bf16 "
          f"{t_lib * 1e3:.2f} us ({t_lib / t_k:.2f}x the kernel's time); "
          f"{smi}")
    if not (exact and rounded and ratio <= 1):
        fail(f"kernel disagrees with plain at M={m} K={k} N={n}")
    return err


def _prefix_forward(bpm, bitplane, common, lm, model, dev, tag):
    """A prefix-LM's forward over seeded patch embeddings [4,
    frontend_len, D] and 8 tokens, last position only: its launches
    counted (one per packed projection); its bf16 logits against the
    plain version's, within twice the gap of the plain version in another
    f32 order (18 layers over 264 positions carry a one-ulp bf16 flip
    past 5% of the largest logit);
    every projection held on its own activations (`_hold_calls`); and the
    logits of an f32 copy (the same packed weights) held within 5% of the
    plain version's largest.  Returns the launches."""
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(4)
    pre = torch.randn((M_DECODE, cfg.frontend_len, cfg.d_model),
                      generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (M_DECODE, 8), generator=gen,
                         device=dev)

    def fwd(m, hook=None):
        if hook is None:
            return lm.forward(m, toks, prefix_embeddings=pre,
                              last_only=True)[0]
        prev = common.set_linear_hook(hook)
        try:
            return fwd(m)
        finally:
            common.set_linear_hook(prev)

    fwd(model)
    torch.cuda.synchronize()
    bpm.launches = 0
    t0 = time.perf_counter()
    lk = fwd(model)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = bpm.launches
    lp = fwd(model, _plain_hook(bpm))
    lr = fwd(model, _plain_hook(bpm, halves=True))
    ratio, agree = _ratio(lk, lp)
    r_ratio, r_agree = _ratio(lr, lp)
    print(f"[{tag}] forward over {cfg.frontend_len} patch embeddings + 8 "
          f"tokens (batch {M_DECODE}, {M_DECODE * (cfg.frontend_len + 8)} "
          f"rows a projection), last position: {1e3 * dt:.2f} ms, logits "
          f"{tuple(lk.shape)}, {launched} kernel launches (expected "
          f"{lm.packed_projections(model)}); bf16 kernel vs plain "
          f"max|d|/max|logit| {ratio:.2e} (tolerance twice the reordered "
          f"plain version's, {2 * r_ratio:.2e}), argmax agreement "
          f"{agree:.2f}; the plain version in another f32 order against it"
          f": {r_ratio:.2e}, argmax agreement {r_agree:.2f}")
    if tuple(lk.shape) != (M_DECODE, 1, cfg.vocab) or \
            not bool(torch.isfinite(lk).all()):
        fail(f"{cfg.name}: prefix forward returned bad logits")
    if ratio > 2 * r_ratio:
        fail(f"{cfg.name}: bf16 prefix forward, kernel and plain disagree "
             f"beyond twice the reordered plain version's gap")
    if launched != lm.packed_projections(model):
        fail(f"{cfg.name}: prefix forward launched the kernel {launched} "
             f"times")
    _hold_calls(bpm, bitplane, common, model, lambda: fwd(model),
                lm.packed_projections(model), tag, "the prefix forward")
    m32 = copy.deepcopy(model).to(torch.float32)
    m32.cfg = dataclasses.replace(cfg, dtype="float32")
    ratio, agree = _ratio(fwd(m32), fwd(m32, _plain_hook(bpm)))
    del m32
    print(f"[{tag}] the prefix forward on an f32 copy (same packed "
          f"weights), kernel vs plain: max|d|/max|logit| {ratio:.2e} "
          f"(tolerance 5e-2), argmax agreement {agree:.2f}")
    if ratio > 5e-2:
        fail(f"{cfg.name}: prefix forward, kernel and plain disagree")
    return launched


def phase_new_families(bpm, bitplane, configs, common, lm, engine, dev,
                       smi):
    t0 = time.perf_counter()
    worst = phase_family_shapes(bpm, bitplane, dev, smi, NEW_FAMILY_SHAPES,
                                "16a")
    worst = max(worst, phase_cross_rows(bpm, bitplane, dev, smi))
    launched = {}
    for name, tag, depth, why, full_run in (
            ("mixtral-8x7b", "16b", MIXTRAL_DEPTH, _mixtral_why(configs),
             True),
            ("arctic-480b", "16c", ARCTIC_DEPTH, _arctic_why(configs),
             False),
            ("whisper-small", "16d", None, "", True),
            ("paligemma-3b", "16e", None, "", True)):
        launched[name], step_s = phase_family(
            bpm, bitplane, configs, common, lm, engine, dev, name, tag,
            NEW_FAMILY_SHAPES[name], depth=depth, why=why,
            full_run=full_run)
        print(f"[{tag}] {name}: {1e3 * step_s:.2f} ms per decode step "
              f"(batch {M_DECODE}); {smi}")
    print(f"[16 families] bit-plane kernel launches on the main paths: "
          f"{launched}; phase 16 took {time.perf_counter() - t0:.1f} s")
    return sum(launched.values()), worst


# ---------------------------------------------------------------------------
# phase 17: training on the card
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 2048, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_KEEP = 30, 10, 2
TRAIN_WARM = 3                 # steps left out of the median
RESTART_AT, RESTART_BATCH = 20, 2   # (c): 2 x 2,048 tokens a step in one
                                    # microbatch, a checkpoint at step 20
INT8_STEPS = 10
CHECK_SEQ = 128                # (a): batch 1 x 128, f32, card vs CPU
V_HOLD = 2 * 1e-3 + 1e-3 ** 2  # (a): v's hold, from the gradients' 1e-3
MIXTRAL_TRAIN_DEPTH = 2
FAMILY_TRAIN = (               # (e): name, tag, depth, batch, seq
    ("recurrentgemma-2b", "17e", None, 2, 512),
    ("whisper-small", "17e", None, 2, 448),
    ("mixtral-8x7b", "17e", MIXTRAL_TRAIN_DEPTH, 2, 512))


class _Training:
    """The port's training modules, imported once."""

    def __init__(self):
        from repro_torch import configs
        from repro_torch.checkpoint import CheckpointManager, manager
        from repro_torch.data import pipeline
        from repro_torch.models import common, lm
        from repro_torch.train import loop, optimizer, step
        self.configs, self.common, self.lm = configs, common, lm
        self.pipeline, self.loop, self.opt, self.step = (
            pipeline, loop, optimizer, step)
        self.CheckpointManager, self.manager = CheckpointManager, manager

    def tcfg(self, total, microbatches=TRAIN_MICRO, int8=False):
        """The launcher's AdamW defaults: lr 3e-3, warmup min(20, steps)."""
        return self.step.TrainConfig(
            adamw=self.opt.AdamWConfig(lr=3e-3, warmup_steps=min(20, total),
                                       total_steps=total,
                                       int8_second_moment=int8),
            microbatches=microbatches)

    def data(self, cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=1234):
        return self.pipeline.SyntheticLM(self.pipeline.DataConfig(
            vocab=cfg.vocab, global_batch=batch, seq_len=seq, seed=seed))


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_train_vs_cpu(tr, dev):
    """(a) SmolLM-360M at full width and depth in f32: the loss and every
    gradient leaf of one step on the card against the same step on the
    CPU from the same params (drawn once on the CPU and copied), then the
    step's AdamW update on each side from those gradients (the rest of
    `train_step`) and the first and second moments it writes (the params
    do not move: the learning rate is 0 at step 0)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(tr.configs.get("smollm-360m"), dtype="float32")
    tcfg = tr.tcfg(TRAIN_STEPS, microbatches=1)
    cpu = tr.step.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                             "cpu")
    gpu = tr.step.state_for(copy.deepcopy(cpu["params"]).to(dev), tcfg)
    batch = tr.data(cfg, batch=1, seq=CHECK_SEQ, seed=7).batch_at(0)
    t1 = time.perf_counter()
    loss_c, _, g_c = tr.step.loss_and_grads(cpu["params"], batch, tcfg)
    cpu_s = time.perf_counter() - t1
    loss_g, _, g_g = tr.step.loss_and_grads(
        gpu["params"], {k: v.to(dev) for k, v in batch.items()}, tcfg)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    worst, worst_name = 0.0, ""
    for name, gc in g_c.items():
        scale = float(gc.abs().max())
        d = float((g_g[name].cpu() - gc).abs().max()) / max(scale, 1e-30)
        if scale == 0 or d > worst:
            worst, worst_name = max(worst, d), name
        if scale == 0 or not d <= 1e-3:
            fail(f"17a {name}: card gradient {d:.3e} of the leaf's largest "
                 f"|grad| ({scale:.3e}) from the CPU's, above 1e-3")
    if not rel <= 1e-5:
        fail(f"17a loss {float(loss_g)!r} on the card, {float(loss_c)!r} on "
             f"the CPU: {rel:.3e} relative, above 1e-5")
    for state, grads in ((cpu, g_c), (gpu, g_g)):
        tr.opt.apply_updates(dict(state["params"].named_parameters()),
                             grads, state["opt"], state["step"], tcfg.adamw)
    def apart(key):
        return max(
            float((gpu["opt"][n][key].float().cpu() - s[key].float())
                  .abs().max())
            / max(float(s[key].float().abs().max()), 1e-30)
            for n, s in cpu["opt"].items())

    m_worst, v_worst = apart("m"), apart("v")
    if not m_worst <= 1e-2:
        fail(f"17a first moment after the update {m_worst:.3e} of the "
             "leaf's largest apart, above 1e-2 (1e-3 plus bf16 rounding)")
    # v = (1 - b2) g^2 from zero: a gradient within e of the leaf's largest
    # |g| puts v within 2e + e^2 of the leaf's largest v
    if not v_worst <= V_HOLD:
        fail(f"17a second moment after the update {v_worst:.3e} of the "
             f"leaf's largest apart, above {V_HOLD:.4g} (2 x 1e-3 + 1e-6)")
    n_params = sum(p.numel() for p in gpu["params"].parameters())
    print(f"[17a] SmolLM-360M f32 ({n_params / 1e6:.1f} M params, "
          f"{cfg.n_layers} layers, remat {cfg.remat}), batch 1 x "
          f"{CHECK_SEQ}: loss {float(loss_g):.6f} on the card, "
          f"{float(loss_c):.6f} on the CPU ({rel:.2e} relative, held at "
          f"1e-5); {len(g_c)} gradient leaves, the farthest {worst:.2e} of "
          f"its largest |grad| ({worst_name}; held at 1e-3); after the "
          f"update the first moment within {m_worst:.2e} (held at 1e-2), "
          f"the second within {v_worst:.2e} (held at {V_HOLD:.4g}); CPU "
          f"step {cpu_s:.1f} s; {time.perf_counter() - t0:.1f} s")


def _time_saves(mgr, log):
    """Record each save's host copy (what the loop waits for) and each
    write (on the save's thread, or in line when blocking)."""
    save, write = mgr.save, mgr._save_sync

    def timed_save(step, tree, blocking=True):
        t0 = time.perf_counter()
        out = save(step, tree, blocking=blocking)
        log.append(("save", step, blocking, time.perf_counter() - t0))
        return out

    def timed_write(step, host):
        t0 = time.perf_counter()
        out = write(step, host)
        log.append(("write", step, _nbytes_host(host),
                    time.perf_counter() - t0))
        return out

    mgr.save, mgr._save_sync = timed_save, timed_write


def _nbytes_host(host):
    return sum(arr.nbytes for _, arr, _ in host)


def _disk_bytes(root):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def _busy_share(run, calls, wall_s, tag):
    """torch.profiler over `calls` calls of `run`, the device's activity
    alone (a step makes tens of thousands of host events, slow to
    gather): device time a call against the unprofiled wall time a call,
    and the largest entries."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            run(i)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    on_dev = [e for e in avg if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in on_dev) / calls
    if dev_us == 0:
        print(f"[{tag}] the profiler recorded no device time: the "
              "device's busy share is not measured")
        return None
    launches = sum(e.count for e in on_dev) / calls
    print(f"[{tag}] device busy {dev_us / 1e3:.2f} ms a step of "
          f"{1e3 * wall_s:.2f} ms wall unprofiled "
          f"({100 * dev_us / (1e6 * wall_s):.1f}% busy), {launches:.0f} "
          "device ops a step")
    for e in sorted(on_dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[{tag}]   device {e.self_device_time_total / calls / 1e3:8.2f}"
              f" ms/step {e.count // calls:5d}x  {e.key[:90]}")
    print(f"[{tag}] profiling took {time.perf_counter() - t0:.1f} s")
    return dev_us / (1e6 * wall_s)


def phase_trainer(tr, dev, smi, root):
    """(b) SmolLM-360M in bf16 at full width through `Trainer.run`:
    8 x 2,048 tokens a step in 2 microbatches, 30 steps, AdamW at the
    launcher's defaults, async checkpoints every 10 steps (keep 2) and
    the final blocking save.  Returns the checkpoint directory."""
    t0 = time.perf_counter()
    cfg = tr.configs.get("smollm-360m")
    tcfg = tr.tcfg(TRAIN_STEPS)
    lcfg = tr.loop.LoopConfig(
        total_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        ckpt_dir=os.path.join(root, "b"), keep_last=TRAIN_KEEP,
        log_every=TRAIN_CKPT_EVERY)
    data = tr.data(cfg)
    trainer = tr.loop.Trainer(cfg, tcfg, lcfg, data, device=dev)
    saves = []
    _time_saves(trainer.ckpt, saves)
    state = trainer.init_or_restore()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if int(state["step"]) != 0:
        fail(f"17b a fresh directory resumed at step {int(state['step'])}")
    n_params = sum(p.numel() for p in state["params"].parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t1 = time.perf_counter()
    state = trainer.run(state, on_step=lambda s, st, m: losses.append(
        float(m["loss"])))
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    times = sorted(trainer.step_times[TRAIN_WARM:])
    step_s = times[len(times) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_params * tokens
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"[17b] SmolLM-360M bf16 ({n_params / 1e6:.1f} M params, "
          f"remat {cfg.remat}), {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step "
          f"in {TRAIN_MICRO} microbatches, {TRAIN_STEPS} steps: median "
          f"{1e3 * step_s:.2f} ms a step (steps {TRAIN_WARM}+; range "
          f"{1e3 * times[0]:.2f}-{1e3 * times[-1]:.2f}), "
          f"{tokens / step_s:,.0f} tokens/s, 6 x params x tokens = "
          f"{flops / 1e12:.1f} TFLOP a step = "
          f"{100 * flops / step_s / BF16_FLOP_PER_S:.2f}% of the "
          f"{BF16_FLOP_PER_S / 1e12:.1f} TFLOPS bf16 peak (bound "
          f"{1e3 * flops / BF16_FLOP_PER_S:.1f} ms); run {run_s:.1f} s "
          f"wall ({run_s / TRAIN_STEPS * 1e3:.0f} ms a step with data and "
          f"checkpoints); peak allocated {peak / 1e9:.2f} GB; {smi}")
    print(f"[17b] loss: first 5 steps {', '.join(f'{x:.4f}' for x in losses[:5])}"
          f"; last 5 {', '.join(f'{x:.4f}' for x in losses[-5:])}; means "
          f"{first:.4f} -> {last:.4f}")
    if not last <= 0.9 * first:
        fail(f"17b mean loss of the last 5 steps {last:.4f} above 0.9 x the "
             f"first 5's {first:.4f}")
    for kind, step, what, dt in saves:
        if kind == "save":
            print(f"[17b] checkpoint at step {step} "
                  f"({'blocking' if what else 'async'}): the loop waited "
                  f"{dt:.3f} s (host copy{', write' if what else ''})")
        else:
            print(f"[17b] checkpoint at step {step}: {what / 1e9:.3f} GB "
                  f"written and hashed in {dt:.3f} s ({what / dt / 1e9:.2f} "
                  f"GB/s)")
    want = _nbytes(dict(tr.manager.leaves(state)).values())
    if any(kind == "write" and what != want for kind, _, what, _ in saves):
        fail(f"17b a checkpoint's bytes differ from the state's {want}")
    if trainer.ckpt.all_steps() != [TRAIN_STEPS - TRAIN_CKPT_EVERY,
                                     TRAIN_STEPS]:
        fail(f"17b keep_last={TRAIN_KEEP} left {trainer.ckpt.all_steps()}")
    data_s = []

    def one(i):
        t = time.perf_counter()
        batch = data.batch_at(TRAIN_STEPS + i)
        data_s.append(time.perf_counter() - t)
        trainer.step_fn(state, batch)

    t1 = time.perf_counter()
    _busy_share(one, 3, step_s, "17b profile")
    profile_s = time.perf_counter() - t1
    print(f"[17b] the data pipeline builds a batch on the host in "
          f"{1e3 * min(data_s):.1f}-{1e3 * max(data_s):.1f} ms, outside the "
          f"timed step; phase 17b {time.perf_counter() - t0:.1f} s (init "
          f"{init_s:.1f} s, run {run_s:.1f} s, profile {profile_s:.1f} s)")
    del trainer, state
    return lcfg.ckpt_dir, step_s


def phase_restart(tr, dev, root):
    """(c) Restart against a straight run, bit for bit, under
    `torch.use_deterministic_algorithms(True)`: (b)'s model and AdamW at
    batch 2 x 2,048 in one microbatch (a step's ~20,000 launches, not
    its tokens, set the pace at this size), 30 steps straight, then 20
    steps and a new `Trainer` with total_steps=30 that resumes at step
    20 in another directory."""
    t0 = time.perf_counter()
    cfg = tr.configs.get("smollm-360m")
    tcfg = tr.tcfg(TRAIN_STEPS, microbatches=1)
    data = tr.data(cfg, batch=RESTART_BATCH)

    def trainer(sub, total):
        return tr.loop.Trainer(cfg, tcfg, tr.loop.LoopConfig(
            total_steps=total, ckpt_every=RESTART_AT,
            ckpt_dir=os.path.join(root, sub), keep_last=TRAIN_KEEP,
            log_every=TRAIN_STEPS), data, device=dev)

    runs = []

    def run(t, state):
        t1 = time.perf_counter()
        state = t.run(state)
        times = sorted(t.step_times)
        runs.append(f"{len(times)} steps in {time.perf_counter() - t1:.1f} s"
                    f" (median {1e3 * times[len(times) // 2]:.1f} ms)")
        return state

    torch.use_deterministic_algorithms(True)
    try:
        a = trainer("c_straight", TRAIN_STEPS)
        straight = run(a, a.init_or_restore())
        shutil.rmtree(a.ckpt.dir)
        b = trainer("c_restart", RESTART_AT)
        run(b, b.init_or_restore())
        b2 = trainer("c_restart", TRAIN_STEPS)
        t1 = time.perf_counter()
        resumed = b2.init_or_restore()
        restore_s = time.perf_counter() - t1
        if int(resumed["step"]) != RESTART_AT:
            fail(f"17c resumed at step {int(resumed['step'])}, not "
                 f"{RESTART_AT}")
        resumed = run(b2, resumed)
    finally:
        torch.use_deterministic_algorithms(False)
    shutil.rmtree(b2.ckpt.dir)
    ta = dict(tr.manager.leaves(straight))
    tb = dict(tr.manager.leaves(resumed))
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    if differ:
        worst = max(float((ta[k].double() - tb[k].double()).abs().max())
                    for k in differ)
        fail(f"17c {len(differ)} of {len(ta)} tensors differ after the "
             f"restart (first {differ[0]}, max |d| {worst:.3e})")
    print(f"[17c] {RESTART_AT} steps, restart, {TRAIN_STEPS - RESTART_AT} "
          f"more = {TRAIN_STEPS} straight ({RESTART_BATCH} x {TRAIN_SEQ} "
          f"tokens a step, deterministic algorithms): all {len(ta)} "
          f"tensors (params, m, v, step; {_nbytes(ta.values()) / 1e9:.3f} "
          f"GB) bit for bit equal; straight {runs[0]}, then {runs[1]}, "
          f"restore {restore_s:.1f} s, {runs[2]}; "
          f"{time.perf_counter() - t0:.1f} s")


def phase_int8_moment(tr, dev, ckpt_dir):
    """(d) 10 steps of (b)'s set-up from (b)'s step-30 checkpoint (its
    directory deleted once restored), once with the f32 second moment
    and once with it in int8 (encoded from the same f32 v): the params'
    moves held within 10% of each other."""
    t0 = time.perf_counter()
    cfg = tr.configs.get("smollm-360m")
    total = TRAIN_STEPS + INT8_STEPS
    data = tr.data(cfg)
    moves, state_bytes, step_ms = {}, {}, {}
    saved = tr.step.init_state(torch.Generator(device=dev).manual_seed(9),
                               cfg, tr.tcfg(total), dev)
    _, step = tr.CheckpointManager(ckpt_dir).restore(saved)
    shutil.rmtree(ckpt_dir)
    if step != TRAIN_STEPS:
        fail(f"17d restored step {step}, not {TRAIN_STEPS}")
    for int8 in (False, True):
        tcfg = tr.tcfg(total, int8=int8)
        state = copy.deepcopy(saved)
        if int8:
            for s in state["opt"].values():
                s["v_q"], s["v_s"] = tr.opt._q8_encode(s.pop("v"))
        before = [p.detach().to(torch.float32, copy=True)
                  for p in state["params"].parameters()]
        state_bytes[int8] = _nbytes(t for s in state["opt"].values()
                                    for t in s.values())
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(INT8_STEPS):
            state, m = tr.step.train_step(state, data.batch_at(step + i), cfg,
                                          tcfg)
        float(m["loss"])
        step_ms[int8] = (time.perf_counter() - t1) / INT8_STEPS * 1e3
        moves[int8] = torch.cat([(p.detach().float() - b).reshape(-1)
                                 for p, b in zip(
                                     state["params"].parameters(), before)])
        del state, before
    del saved
    ratio = float((moves[True] - moves[False]).norm() / moves[False].norm())
    print(f"[17d] {INT8_STEPS} steps from step {TRAIN_STEPS}: "
          f"|dp_int8 - dp_f32| / |dp_f32| = {ratio:.4f} (held below 0.1); "
          f"|dp_f32| {float(moves[False].norm()):.4f}; optimizer state "
          f"{state_bytes[False] / 1e9:.3f} GB with f32 v, "
          f"{state_bytes[True] / 1e9:.3f} GB with int8 v; "
          f"{step_ms[False]:.1f} and {step_ms[True]:.1f} ms a step; "
          f"{time.perf_counter() - t0:.1f} s")
    if not ratio < 0.1:
        fail(f"17d int8 second moment moved the params {ratio:.4f} of the "
             "f32 move away, not below 0.1")


def _mixtral_train_why(configs):
    full = configs.get("mixtral-8x7b")
    one = _expert_bytes(full) // 2                      # params a layer
    return (f"each layer's experts are {one / 1e9:.2f} G params, 10 bytes "
            f"each with their bf16 grads and m and f32 v: "
            f"{10 * one / 1e9:.1f} GB a layer, {full.n_layers * 10 * one / 1e9:.0f}"
            f" GB at {full.n_layers} layers, so {MIXTRAL_TRAIN_DEPTH} layers")


def _arctic_train_why(configs):
    full = configs.get("arctic-480b")
    one = _expert_bytes(full) // 2
    total = torch.cuda.get_device_properties(0).total_memory
    return (f"Arctic-480B is left out: one layer's {full.n_experts} experts "
            f"are {one / 1e9:.1f} G params, {2 * one / 1e9:.1f} GB in bf16 and "
            f"{10 * one / 1e9:.0f} GB with their grads, m and v, beyond the "
            f"card's {total / 1e9:.1f} GB")


def phase_train_family(tr, dev, smi, name, tag, depth, b, s, why=""):
    """(e) One step of a family whose backward SmolLM does not reach, at
    full width: loss and every gradient leaf finite, a nonzero gradient
    on every leaf, a lower loss after a plain SGD probe along -grad on
    the same batch (lr 0.5, 0.1, 0.02), then two `train_step`s, the
    second timed, with the peak memory."""
    t0 = time.perf_counter()
    over = {"n_layers": depth} if depth else {}
    cfg = tr.configs.get(name, **over)
    tcfg = tr.tcfg(TRAIN_STEPS, microbatches=1)
    torch.cuda.reset_peak_memory_stats()
    state = tr.step.init_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, tcfg, dev)
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    batch = {k: v.to(dev) for k, v in
             tr.data(cfg, batch=b, seq=s, seed=11).batch_at(0).items()}
    extra = ""
    if cfg.family == "encdec":
        batch["enc_inputs"] = torch.randn(
            (b, cfg.frontend_len, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(3))
        extra = f", seeded frames [{b}, {cfg.frontend_len}, {cfg.d_model}]"
    loss0, metrics, grads = tr.step.loss_and_grads(model, batch, tcfg)
    if not bool(torch.isfinite(loss0)):
        fail(f"{tag} {name}: loss {float(loss0)}")
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in grads.items() if not bool(g.any())]
    if bad or zero:
        fail(f"{tag} {name}: non-finite gradients {bad[:3]}, zero "
             f"gradients {zero[:3]}")
    params = dict(model.named_parameters())
    saved = {n: p.detach().clone() for n, p in params.items()}
    probe = []
    with torch.no_grad():
        for lr in (0.5, 0.1, 0.02):
            for n, p in params.items():
                p.copy_(saved[n] - lr * grads[n].to(p.dtype))
            loss1, _ = tr.lm.loss_fn(model, batch)
            probe.append((lr, float(loss1)))
            if float(loss1) < float(loss0):
                break
        for n, p in params.items():
            p.copy_(saved[n])
    del saved, grads
    if not probe[-1][1] < float(loss0):
        fail(f"{tag} {name}: SGD probe {probe} did not lower the loss "
             f"{float(loss0):.4f}")
    state, m = tr.step.train_step(state, batch, cfg, tcfg)
    float(m["loss"])
    t1 = time.perf_counter()
    state, m = tr.step.train_step(state, batch, cfg, tcfg)
    float(m["loss"])
    step_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    kinds = {}
    for k in cfg.layer_kinds():
        kinds[f"{k[0]}+{k[1]}"] = kinds.get(f"{k[0]}+{k[1]}", 0) + 1
    print(f"[{tag}] {name} bf16, {cfg.n_layers} layers ("
          + ", ".join(f"{v} {k}" for k, v in kinds.items())
          + (f"; {cfg.enc_layers} encoder layers" if cfg.enc_layers else "")
          + f"), {n_params / 1e9:.3f} G params, batch {b} x {s}{extra}"
          + (f"; depth cut to {depth} of {tr.configs.get(name).n_layers}: "
             f"{why}" if depth else "")
          + f": loss {float(loss0):.4f} (aux {float(metrics['aux']):.4f}), "
          f"{len(params)} gradient leaves finite and nonzero; SGD probe "
          f"{', '.join(f'lr {lr}: {x:.4f}' for lr, x in probe)}; "
          f"{1e3 * step_s:.1f} ms a train_step; peak allocated "
          f"{peak / 1e9:.2f} GB; {time.perf_counter() - t0:.1f} s; {smi}")
    del state, model, params


def phase_train(bpm, cs, ks, dev, smi):
    """Phase 17: training on the card (a-e), every kernel's launch count
    reset just before and read just after; no kernel lies on the
    training path (projections are dense and trained), so all stay 0."""
    import tempfile
    t0 = time.perf_counter()
    tr = _Training()
    bpm.launches = 0
    cs.launches = 0
    ks.reset()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    # the checkpoints' disk use peaks just after a save is published,
    # before the older ones are collected
    gc, disk = tr.CheckpointManager._gc, [0]

    def measured_gc(mgr):
        disk[0] = max(disk[0], _disk_bytes(root))
        gc(mgr)

    tr.CheckpointManager._gc = measured_gc
    try:
        phase_train_vs_cpu(tr, dev)
        ckpt_dir, step_s = phase_trainer(tr, dev, smi, root)
        phase_int8_moment(tr, dev, ckpt_dir)
        phase_restart(tr, dev, root)
        for name, tag, depth, b, s in FAMILY_TRAIN:
            why = _mixtral_train_why(tr.configs) if depth else ""
            phase_train_family(tr, dev, smi, name, tag, depth, b, s, why)
            torch.cuda.empty_cache()
        print(f"[17e] {_arctic_train_why(tr.configs)}")
    finally:
        tr.CheckpointManager._gc = gc
        shutil.rmtree(root, ignore_errors=True)
    print(f"[17 train] checkpoints took at most {disk[0] / 1e9:.3f} GB of "
          f"the temporary directory at once")
    launched = {"bitplane_matmul": bpm.launches, "comefa_step": cs.launches,
                **ks.counts()}
    if any(launched.values()):
        fail(f"17 kernels launched on the training path: {launched}")
    print(f"[17 train] kernel launches in phase 17: {launched} (none on "
          f"the training path); phase 17 took "
          f"{time.perf_counter() - t0:.1f} s")
    return step_s


# ---------------------------------------------------------------------------
# phase 18: the distribution layer, the quickstart and the captured step
# ---------------------------------------------------------------------------

REPLAY_STEPS = 16
PRIME_LEN = 8
SERVE_MAX_LEN = PRIME_LEN + 24 + 1   # phase 4's generate: 8 + 24 + 1
# PaliGemma's prefix forward: batch 4 x (256 patches + 8 tokens)
PREFIX_M = M_DECODE * (256 + 8)


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_quickstart(bpm, cs):
    """(a) `examples/quickstart_torch.py` on the CPU, then on the card
    with the bit-plane and step kernels' launch counts reset just before
    and read just after: its three checks hold on the card and every
    line it prints equals the CPU run's."""
    import contextlib
    import io
    qs = _load_example("quickstart_torch")
    lines = {}
    for device in ("cpu", "cuda"):
        buf = io.StringIO()
        bpm.launches = 0
        cs.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            qs.main(["--device", device])
        torch.cuda.synchronize()
        lines[device] = buf.getvalue().splitlines()
        took = time.perf_counter() - t0
    launched = {"bitplane_matmul": bpm.launches, "comefa_step": cs.launches}
    for line in lines["cuda"]:
        print(f"[18a quickstart] {line}")
    text = "\n".join(lines["cuda"])
    checks = ("paper formula n^2+3n-2 = 86" in text,
              "kernel == torch oracle: True" in text, "finite: True" in text)
    print(f"[18a quickstart] on the card in {took:.1f} s: checks {checks}, "
          f"every line equal to the CPU run's: "
          f"{lines['cuda'] == lines['cpu']}; launches {launched} (the "
          f"4-bit matmul and the reduced model's 7 projections on #1, the "
          f"multiply on #2)")
    if not all(checks) or lines["cuda"] != lines["cpu"]:
        fail(f"18a the quickstart on the card: {lines['cuda']} against the "
             f"CPU's {lines['cpu']}")
    if launched["bitplane_matmul"] != 8 or launched["comefa_step"] < 1:
        fail(f"18a the quickstart did not run on the kernels: {launched}")
    return launched


def phase_host_mesh():
    """(b) `launch.mesh.make_host_mesh()` on one card: a (1, 1) ("data",
    "model") mesh on cuda over the one-rank NCCL group it starts."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    mesh = mesh_mod.make_host_mesh()
    got = (tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh.device_type,
           dist.get_backend(), dist.get_world_size())
    print(f"[18b mesh] make_host_mesh(): shape {got[0]}, axes {got[1]}, "
          f"{got[2]}, backend {got[3]}, world {got[4]}, "
          f"{time.perf_counter() - t0:.2f} s")
    if got != ((1, 1), ("data", "model"), "cuda", "nccl", 1):
        fail(f"18b host mesh {got}")
    return mesh


def _snapshot(states):
    return [{k: v.clone() for k, v in st.items()} for st in states]


def phase_captured_serve(bpm, configs, lm, engine, mesh, dev, smi):
    """(c) `make_jitted_serve_step` on the (1, 1) mesh, full SmolLM-360M
    (32 layers, bf16, 8-bit planes, seeded params), batch 4, phase 4's
    max_len: primed with an 8-token prompt (the first call captures),
    then 16 replayed steps, counted (launches = packed projections x
    steps), then 16 eager `lm.decode_step`s from a copy of the primed
    state on the same tokens, each step's logits and every state tensor
    `torch.equal` to the replay's; ms a step of each (median, host clock
    to a synchronised end), capture time, graph pool bytes, the replay's
    busy share; a second states list captures its own graph and gives
    the first list's logits."""
    cfg = configs.get("smollm-360m", quant_bits=BITS)
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    per_call = lm.packed_projections(model)
    b = M_DECODE
    prompt = torch.randint(0, cfg.vocab, (b, PRIME_LEN), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    step = engine.make_jitted_serve_step(mesh, cfg)
    states = lm.decode_state_init(cfg, b, SERVE_MAX_LEN, dev)
    torch.cuda.synchronize()
    alloc0, reserved0 = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    logits, states = step(model, prompt[:, :1], states, 0)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    alloc, reserved = (torch.cuda.memory_allocated() - alloc0,
                       torch.cuda.memory_reserved() - reserved0)
    graph = next(iter(step.graphs.values()))
    prime = [logits]
    for t in range(1, PRIME_LEN):
        logits, states = step(model, prompt[:, t:t + 1], states, t)
        prime.append(logits)
    eager_states = _snapshot(states)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]

    # ---- the main path, counted: replays of the captured step ----
    bpm.launches = 0
    replayed, times = [], []
    for i in range(REPLAY_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, states = step(model, tok, states, PRIME_LEN + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        replayed.append((tok, logits, _snapshot(states)))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    launched = bpm.launches
    # ---- end of the counted main path ----

    eager_times = []
    for i, (tk, want, snap) in enumerate(replayed):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, eager_states = lm.decode_step(model, tk, eager_states,
                                           PRIME_LEN + i)
        torch.cuda.synchronize()
        eager_times.append(time.perf_counter() - t1)
        if not torch.equal(got, want):
            fail(f"18c step {i}: eager logits differ from the replay's by "
                 f"{float((got.float() - want.float()).abs().max()):.3e}")
        for j, (st, sn) in enumerate(zip(eager_states, snap)):
            for k in st:
                if not torch.equal(st[k], sn[k]):
                    fail(f"18c step {i}: layer {j} state {k!r} differs "
                         "from the replay's")
    rep_ms = 1e3 * sorted(times)[len(times) // 2]
    eag_ms = 1e3 * sorted(eager_times)[len(eager_times) // 2]
    print(f"[18c capture] {cfg.name}, {cfg.n_layers} layers, bf16, {BITS}-"
          f"bit planes, batch {b}, max_len {SERVE_MAX_LEN}: first call "
          f"(warm-up on copies, capture, replay) {capture_s:.3f} s; the "
          f"graph holds {graph.launches['bitplane_matmul']} bit-plane launches (packed "
          f"projections {per_call}); memory above the states after it: "
          f"{alloc / 1e6:.2f} MB allocated, {reserved / 1e6:.2f} MB "
          f"reserved (the graph's pool and the warm-up's cached blocks)")
    print(f"[18c replay] {REPLAY_STEPS} replayed steps equal to "
          f"{REPLAY_STEPS} eager lm.decode_steps from a copy of the primed "
          f"state: logits and all {sum(len(st) for st in eager_states)} "
          f"state tensors torch.equal at every step")
    print(f"[18c time] a decode step: replayed {rep_ms:.3f} ms, eager "
          f"{eag_ms:.3f} ms (medians of {REPLAY_STEPS}, same call; "
          f"replayed {min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}, eager "
          f"{min(eager_times) * 1e3:.3f}-{max(eager_times) * 1e3:.3f}); "
          f"{smi}")
    print(f"[18c launches] bit-plane kernel launches in the {REPLAY_STEPS} "
          f"replays: {launched} (expected {per_call} x {REPLAY_STEPS} = "
          f"{per_call * REPLAY_STEPS})")
    if graph.launches.get("bitplane_matmul") != per_call or launched != per_call * REPLAY_STEPS:
        fail("18c the replays did not count one launch a packed projection")
    pos = [PRIME_LEN + REPLAY_STEPS]

    def replays():
        nonlocal tok, states
        for _ in range(4):
            lg, states = step(model, tok, states, pos[0])
            pos[0] += 1
            tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
    profile_decode(replays, 4, rep_ms / 1e3, tag="18c profile")

    # a second states list: its own storages, its own graph
    other = lm.decode_state_init(cfg, b, SERVE_MAX_LEN, dev)
    for t in range(PRIME_LEN):
        logits, other = step(model, prompt[:, t:t + 1], other, t)
        if not torch.equal(logits, prime[t]):
            fail(f"18c a second states list gave other logits at step {t}")
    print(f"[18c states] a second states list: {len(step.graphs)} graphs "
          f"captured; its {PRIME_LEN} prompt steps give the first list's "
          "logits, torch.equal")
    if len(step.graphs) != 2:
        fail(f"18c {len(step.graphs)} graphs for two states lists")
    del step, states, other, eager_states, replayed, model
    torch.cuda.empty_cache()
    return launched, rep_ms, eag_ms


def phase_jitted_train(mesh, dev):
    """(d) `make_jitted_train_step` on the (1, 1) mesh against
    `train_step`, full SmolLM-360M in f32 at 1 x 128 tokens, 2 steps from
    one seeded state under deterministic algorithms (phase 17c's mode):
    params, moments, step and losses bit for bit equal."""
    tr = _Training()
    cfg = tr.configs.get("smollm-360m", dtype="float32")
    tcfg = tr.step.TrainConfig(adamw=tr.opt.AdamWConfig(lr=1e-3,
                                                        warmup_steps=0))
    data = tr.data(cfg, batch=1, seq=CHECK_SEQ)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        a = tr.step.init_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, tcfg, dev)
        b = copy.deepcopy(a)
        fn = tr.step.make_jitted_train_step(mesh, cfg, tcfg)
        losses = []
        for i in range(2):
            batch = data.batch_at(i)
            a, ma = fn(a, batch)
            b, mb = tr.step.train_step(b, batch, cfg, tcfg)
            losses.append((float(ma["loss"]), float(mb["loss"])))
    finally:
        torch.use_deterministic_algorithms(False)
    ta, tb = dict(tr.manager.leaves(a)), dict(tr.manager.leaves(b))
    differ = [k for k in ta if not torch.equal(ta[k], tb[k])]
    print(f"[18d train] make_jitted_train_step on the (1, 1) mesh against "
          f"train_step, {cfg.name} f32, 1 x {CHECK_SEQ}, 2 steps, "
          f"deterministic: losses {losses}; {len(ta) - len(differ)} of "
          f"{len(ta)} tensors bit for bit equal; "
          f"{time.perf_counter() - t0:.1f} s")
    if differ or any(x != y for x, y in losses):
        fail(f"18d {len(differ)} tensors differ (first "
             f"{differ[:1]}), losses {losses}")
    del a, b
    torch.cuda.empty_cache()


def phase_collectives(dev):
    """(e) `compress_psum` and `pipelined_apply` on the one-rank NCCL
    group: the all-reduced average equals `_dq8` of its own quantisation
    exactly (one rank sums nothing), the error is what that leaves; one
    stage equals the sequential stack."""
    import torch.distributed as dist
    from repro_torch.parallel import compression, pipeline as pp
    gen = torch.Generator(device=dev).manual_seed(18)
    g = torch.randn(960 * 2560 + 7, generator=gen, device=dev)
    avg, err = compression.compress_psum(g, torch.zeros_like(g))
    want = compression._dq8(*compression._q8(g), g.shape)
    torch.cuda.synchronize()
    ok_c = torch.equal(avg, want) and torch.equal(err, g - want)
    w = torch.randn((1, 64, 64), generator=gen, device=dev) / 8
    x = torch.randn((8, 2, 64), generator=gen, device=dev)
    y = pp.pipelined_apply(lambda wi, h: torch.tanh(h @ wi))(w, x)
    ok_p = torch.equal(y, torch.tanh(x @ w[0]))
    leaf = {"g": g}
    print(f"[18e collectives] compress_psum over {dist.get_world_size()} "
          f"NCCL rank of a {g.numel()}-value leaf equal to _dq8(_q8(g)): "
          f"{ok_c} (wire bytes {compression.wire_bytes(leaf, True)} "
          f"against {compression.wire_bytes(leaf, False)}); "
          f"pipelined_apply, 1 stage x 8 microbatches, equal to the "
          f"stack: {ok_p}")
    if not (ok_c and ok_p):
        fail("18e the collectives on one rank")


def phase_exact_product(bpm, bitplane, dev, smi):
    """(f) #1 and torch.matmul against the f64 product of their own
    operands (bf16 x; #1's integer weights and f32 scale, the matmul's
    dequantised bf16 weight), at PaliGemma's prefix projections (M =
    1,056) and Whisper's cross K/V (M = 6,144): each one's largest gap
    relative to the largest |y|, with y in f32 (the order of the f32
    sums: #1 against torch.matmul in f32 on the same bf16 values, TF32
    off, and against bf16 torch.mm with f32 y, on the tensor cores) and
    in bf16 (the main path's output: #1 against bf16 torch.matmul).  #1
    further from exact than the matmul by more than 2x is a fault of
    #1."""
    gen = torch.Generator(device=dev).manual_seed(19)
    shapes = [(PREFIX_M, k, n) for k, n in NEW_FAMILY_SHAPES["paligemma-3b"]]
    shapes.append(CROSS_KV)
    worst = []
    for m, k, n in shapes:
        w = torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)
        planes, scale = bitplane.quantize_pack(w, BITS, axis=0)
        q = bitplane.unpack(planes, BITS, axis=0)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        exact = (x.double() @ q.double()) * scale.double()
        wb = (q.float() * scale).to(torch.bfloat16)
        exact_mm = x.double() @ wb.double()
        ys = (bpm.bitplane_matmul(x, planes, scale, bits=BITS),
              x.float() @ wb.float(),
              torch.mm(x, wb, out_dtype=torch.float32),
              bpm.bitplane_matmul(x, planes, scale, bits=BITS,
                                  out_dtype=torch.bfloat16),
              x @ wb)
        row = [float((y.double() - ref).abs().max() / ref.abs().max())
               for y, ref in zip(ys, (exact, exact_mm, exact_mm, exact,
                                      exact_mm))]
        worst.append(row)
        print(f"[18f exact] M={m} K={k} N={n}: largest gap / largest |y|, "
              f"f32 y: #1 {row[0]:.3e}, torch.matmul f32 (CUDA cores) "
              f"{row[1]:.3e}, torch.mm bf16 to f32 (tensor cores) "
              f"{row[2]:.3e}; bf16 y: #1 {row[3]:.3e}, torch.matmul bf16 "
              f"{row[4]:.3e}")
    ratios = [max(r[0] / r[1] for r in worst), max(r[0] / r[2] for r in worst),
              max(r[3] / r[4] for r in worst)]
    print(f"[18f exact] #1's gap over the library call's, at most: "
          f"{ratios[0]:.2f}x f32 torch.matmul's, {ratios[1]:.2f}x bf16 "
          f"torch.mm's with f32 y, {ratios[2]:.2f}x bf16 torch.matmul's "
          f"with bf16 y (a fault of #1 above 2x); {smi}")
    return ratios


def phase_distribution(bpm, cs, dev, smi):
    """Phase 18: the quickstart, the host mesh, the captured decode step,
    the compiled train step and the collectives on one card, then #1
    against the exact product.  Returns the kernels' launches on its
    main paths (18a and 18c)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.quant import bitplane
    from repro_torch.serve import engine
    t0 = time.perf_counter()
    quick = phase_quickstart(bpm, cs)
    mesh = phase_host_mesh()
    try:
        served, rep_ms, eag_ms = phase_captured_serve(
            bpm, configs, lm, engine, mesh, dev, smi)
        phase_jitted_train(mesh, dev)
        phase_collectives(dev)
    finally:
        dist.destroy_process_group()
    phase_exact_product(bpm, bitplane, dev, smi)
    print(f"[18 distribution] phase 18 took {time.perf_counter() - t0:.1f} "
          f"s; bit-plane launches: 18a {quick['bitplane_matmul']}, 18c "
          f"{served}; step kernel launches: 18a {quick['comefa_step']}")
    return {"bitplane_matmul": quick["bitplane_matmul"] + served,
            "comefa_step": quick["comefa_step"]}



# ---------------------------------------------------------------------------
# phase 19: training across ranks, the sharded grid and the launch tools
# ---------------------------------------------------------------------------

MESH_BATCH, MESH_STEPS, MESH_CKPT_EVERY = 2, 4, 2   # 19a: 2 x 2,048 tokens
# 19a': the gradient leaves held against f64: the farthest in phase
# 17a's comparison of the card with the CPU, and two others
GAP_LEAVES = ("stack.5.n1.g", "stack.0.mix.wq.w", "embed.e")
# 19c: phase 17b's step as a cell of the launch tools (chip_smoke only)
STEP_17B = ("chip_17b", TRAIN_SEQ, TRAIN_BATCH, "train")
TOOLS_SCRIPT = r"""
import json, sys, time
from repro_torch.launch import dryrun as dr, roofline, shapes
out, res = {}, sys.argv[1]
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    t = time.time()
    d = dr.run_cell("smollm-360m", shape, "single", results=res)
    r = roofline.analyze_cell("smollm-360m", shape, results=res)
    out[shape] = {"dryrun_flops": d["flops"], "bytes": d["bytes_accessed"],
                  "coll": d["collective_bytes"],
                  "bound_s": r["step_time_lower_bound_s"],
                  "dominant": r["dominant"],
                  "roofline_frac": r["roofline_frac"],
                  "s": time.time() - t}
name, seq, batch, kind = sys.argv[2].split(",")
shapes.SHAPES[name] = shapes.ShapeCase(name, int(seq), int(batch), kind)
dr.TRAIN_SETTINGS["smollm-360m"] = dict(fsdp=False,
                                        microbatches=int(sys.argv[3]))
t = time.time()
r = roofline.analyze_cell("smollm-360m", name, mesh_shape=(1, 1),
                          save=False)
out["17b"] = {k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "step_time_lower_bound_s", "dominant",
                                 "flops_per_chip", "bytes_per_chip",
                                 "model_flops_per_chip")}
out["17b"]["s"] = time.time() - t
print("TOOLS " + json.dumps(out))
"""


def _start_tools(root):
    """19c's counting, in a process of its own (it starts a fake process
    group), begun after 19a's timed steps, saves and launcher, so that
    its CPU work overlaps 19a' and 19b, which time nothing."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-c", TOOLS_SCRIPT, os.path.join(root, "results"),
         ",".join(map(str, STEP_17B)), str(TRAIN_MICRO)],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


class _F64(torch.overrides.TorchFunctionMode):
    """Every float32 that the model's code names becomes float64: the same
    algorithm with every product, norm and softmax in f64."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = {k: torch.float64 if v is torch.float32 else v
                  for k, v in (kwargs or {}).items()}
        args = tuple(torch.float64 if a is torch.float32 else a
                     for a in args)
        return func(*args, **kwargs)


def phase_gradient_gap(tr, dev):
    """(19a') Phase 17a's step (full SmolLM-360M, f32, TF32 off, 1 x 128):
    the card's and the CPU's gradient of `GAP_LEAVES`, each against an
    f64 gradient of the same step on the CPU, as a share of the leaf's
    largest |grad|; and each side's farthest leaf over all of them."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(tr.configs.get("smollm-360m"), dtype="float32")
    tcfg = tr.tcfg(TRAIN_STEPS, microbatches=1)
    cpu = tr.step.init_state(torch.Generator().manual_seed(0), cfg, tcfg,
                             "cpu")["params"]
    gpu = copy.deepcopy(cpu).to(dev)
    # the f64 copy without remat: its backward would recompute the
    # forward outside the mode (on autograd's thread), in f32
    f64 = copy.deepcopy(cpu).double()
    f64.cfg = dataclasses.replace(cfg, remat=False)
    batch = tr.data(cfg, batch=1, seq=CHECK_SEQ, seed=7).batch_at(0)
    _, _, g_c = tr.step.loss_and_grads(cpu, batch, tcfg)
    _, _, g_g = tr.step.loss_and_grads(
        gpu, {k: v.to(dev) for k, v in batch.items()}, tcfg)
    with _F64():
        loss64, _, g_64 = tr.step.loss_and_grads(f64, batch, tcfg)
    if any(g.dtype != torch.float64 for g in g_64.values()) or \
            loss64.dtype != torch.float64:
        fail("19a' the f64 reference ran in another type")

    def gap(g, name):
        ref = g_64[name]
        return float((g[name].double().cpu() - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-300)

    rows = []
    for name in GAP_LEAVES:
        rows.append(f"{name}: card {gap(g_g, name):.3e}, CPU "
                    f"{gap(g_c, name):.3e}, card-CPU "
                    f"{float((g_g[name].cpu() - g_c[name]).abs().max()) / max(float(g_c[name].abs().max()), 1e-30):.3e}")
    far_g = max(g_64, key=lambda n: gap(g_g, n))
    far_c = max(g_64, key=lambda n: gap(g_c, n))
    print(f"[19a' gap] each leaf's largest gap from the f64 gradient of "
          f"the same step, over its largest |grad|: {'; '.join(rows)}; "
          f"farthest over all {len(g_64)} leaves: card {far_g} "
          f"{gap(g_g, far_g):.3e}, CPU {far_c} {gap(g_c, far_c):.3e}; "
          f"{time.perf_counter() - t0:.1f} s")
    del gpu, g_g
    torch.cuda.empty_cache()


def phase_trainer_mesh(tr, dev, smi, root):
    """(19a) SmolLM-360M in bf16 at full width, deterministic (phase 17c's
    mode), 2 x 2,048 tokens: `Trainer(mesh=make_host_mesh())` for 4 steps
    with a checkpoint every 2; then a second `Trainer` on a new (1, 1)
    mesh restores step 2 (`restore(shardings=...)`) and runs to step 4:
    its params and moments equal the first run's bit for bit.  Then the
    launcher with ``--mesh host --fsdp`` on the card."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    t0 = time.perf_counter()
    cfg = tr.configs.get("smollm-360m")
    tcfg = tr.tcfg(MESH_STEPS, microbatches=1)
    data = tr.data(cfg, batch=MESH_BATCH)

    def trainer(path, mesh):
        lcfg = tr.loop.LoopConfig(total_steps=MESH_STEPS,
                                  ckpt_every=MESH_CKPT_EVERY, ckpt_dir=path,
                                  log_every=MESH_STEPS)
        return tr.loop.Trainer(cfg, tcfg, lcfg, data, mesh=mesh, device=dev)

    torch.use_deterministic_algorithms(True)
    try:
        mesh = mesh_mod.make_host_mesh()
        first = trainer(os.path.join(root, "a"), mesh)
        saves = []
        _time_saves(first.ckpt, saves)
        state = first.run(first.init_or_restore())
        torch.cuda.synchronize()
        dist.destroy_process_group()
        step_ms = 1e3 * float(np.median(first.step_times[1:]))
        want = {k: v.clone() for k, v in tr.manager.leaves(state)}
        del state, first
        shutil.copytree(os.path.join(root, "a", "step_0000000002"),
                        os.path.join(root, "b", "step_0000000002"))
        shutil.rmtree(os.path.join(root, "a"))
        mesh = mesh_mod.make_host_mesh()
        second = trainer(os.path.join(root, "b"), mesh)
        t1 = time.perf_counter()
        state = second.init_or_restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        if int(state["step"]) != MESH_CKPT_EVERY:
            fail(f"19a the second trainer resumed at {int(state['step'])}")
        state = second.run(state)
        torch.cuda.synchronize()
        dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    got = dict(tr.manager.leaves(state))
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    writes = [f"step {st} {w / 1e9:.3f} GB in {dt:.3f} s"
              for kind, st, w, dt in saves if kind == "write"]
    print(f"[19a train] Trainer(mesh=make_host_mesh()), {cfg.name} bf16, "
          f"{MESH_BATCH} x {TRAIN_SEQ} tokens, {MESH_STEPS} steps, "
          f"deterministic: median {step_ms:.2f} ms a step; checkpoints "
          f"written: {', '.join(writes)}; the "
          f"second Trainer on a new (1, 1) mesh restored step "
          f"{MESH_CKPT_EVERY} with restore(shardings=...) in {restore_s:.3f}"
          f" s and ran to step {MESH_STEPS}: {len(want) - len(differ)} of "
          f"{len(want)} tensors bit for bit equal to the first run's; "
          f"{smi}")
    if differ:
        fail(f"19a {len(differ)} tensors differ after the restore "
             f"(first {differ[:1]})")
    del state, want, got
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--mesh", "host", "--fsdp", "--steps", "3", "--ckpt",
         os.path.join(root, "launcher")], cwd=ROOT, text=True,
        capture_output=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    last = (out.stdout.strip().splitlines() or [""])[-1]
    print(f"[19a launcher] python -m repro_torch.launch.train --reduced "
          f"--mesh host --fsdp --steps 3: exit {out.returncode}, "
          f"{last!r}, {time.perf_counter() - t1:.1f} s; 19a "
          f"{time.perf_counter() - t0:.1f} s")
    if out.returncode != 0 or last != "finished at step 3":
        fail(f"19a the launcher: {out.stderr[-1500:]}")


def phase_sharded_grid(cs, dev):
    """(19b) `comefa_gemv_batched` on `mesh=grid_mesh()` (the one-rank NCCL
    group's 1-D mesh) at phase 8's SmolLM-360M projection shapes, 8-bit
    weights and activations, 4 slots, against the same call without a
    mesh: results, stats, cycles and dispatches equal; the step kernel's
    launches (counted) equal the grid's dispatches, so the cuda engine
    ran.  Then one sharded dispatch of #2 held to its plain version.
    Returns the kernel's launches on the sharded path."""
    import torch.distributed as dist
    from repro_torch.core.comefa import grid as grid_mod
    from repro_torch.kernels import comefa_sim
    from repro_torch.obs import metrics
    from repro_torch.serve import comefa_exec
    t0 = time.perf_counter()
    mesh = grid_mod.grid_mesh()
    launched = 0
    try:
        rng = np.random.default_rng(19)
        rows = []
        for (k, n) in SMOLLM_SHAPES:
            w_int = rng.integers(0, 1 << BITS, (k, n))
            w = comefa_sim.stage_weights(w_int, BITS, dev)
            x = rng.integers(0, 1 << BITS, (GRID_SLOTS, k))
            acc = comefa_exec.acc_bits_for(BITS, BITS, k)
            out = []
            for m in (None, mesh):
                stats = {}
                d0, l0 = _grid_dispatches(metrics), cs.launches
                y = comefa_sim.comefa_gemv_batched(
                    w, x, w_bits=BITS, x_bits=BITS, acc_bits=acc,
                    stats=stats, mesh=m, device=dev)
                torch.cuda.synchronize()
                out.append((y, stats, _grid_dispatches(metrics) - d0,
                            cs.launches - l0))
            (y0, s0, d0, l0), (y1, s1, d1, l1) = out
            launched += l1
            rows.append(f"({k}, {n}) cycles {s1['cycles']}, {d1} "
                        f"dispatches, {l1} launches")
            if not (np.array_equal(y0, y1) and s0 == s1 and d0 == d1):
                fail(f"19b ({k}, {n}) sharded {s1} {d1} against {s0} {d0}")
            if not (l1 == d1 > 0 and l0 == d0):
                fail(f"19b ({k}, {n}) {l1} launches for {d1} dispatches: "
                     "the step kernel did not run every dispatch")
            if not np.array_equal(y1, x.astype(np.int64) @ w_int):
                fail(f"19b ({k}, {n}) not the integer product")
        # one sharded dispatch of #2 against its plain version
        plan, mat = _chunk_program(comefa_sim, comefa_exec, 960, 2560)
        from repro_torch.core.comefa import isa
        mem, carry, mask = _random_grid_state(np.random.default_rng(20),
                                              GRID_SLOTS, plan.n_blocks, isa)
        grid = grid_mod.ComefaGrid(GRID_SLOTS, n_blocks=plan.n_blocks,
                                   mesh=mesh, device=dev)
        grid.mem, grid.carry, grid.mask = mem, carry, mask
        grid._ensure_device()
        before = tuple(t.to_local().clone() for t in grid._dev)
        grid.run(mat)
        after = tuple(t.to_local() for t in grid._dev)
        cs.run_packed_plain(*before, torch.tensor(mat, device=dev),
                            chain=False, per_slot=False)
        same = [torch.equal(a, b) for a, b in zip(after, before)]
    finally:
        dist.destroy_process_group()
    print(f"[19b grid] comefa_gemv_batched on grid_mesh() (1 rank, "
          f"{GRID_SLOTS} slots) = the call without a mesh at "
          f"{'; '.join(rows)}; one sharded dispatch (T={mat.shape[0]}, "
          f"nb={plan.n_blocks}) against the plain packed scan: mem, carry, "
          f"mask equal {same}; {time.perf_counter() - t0:.1f} s")
    if not all(same):
        fail("19b the sharded dispatch differs from the plain version")
    return launched


def phase_tools(proc, train_step_s, smi):
    """(19c) The launch tools' counts of SmolLM-360M's three cells on the
    fake 16 x 16 mesh (the process started after 19a), and the roofline
    bound of phase 17b's step (8 x 2,048 tokens, 2 microbatches) counted
    on a one-rank fake mesh, beside the time 17b measured in this run."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("19c the launch tools did not finish in 600 s")
    line = [ln for ln in out.splitlines() if ln.startswith("TOOLS ")]
    if proc.returncode != 0 or not line:
        fail(f"19c the launch tools failed: {err[-2000:]}")
    r = json.loads(line[-1][len("TOOLS "):])
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        c = r[shape]
        print(f"[19c tools] smollm-360m x {shape} on the fake 16 x 16 mesh, "
              f"per rank: {c['dryrun_flops']:.4e} FLOPs, "
              f"{c['bytes']:.4e} bytes (op level), collectives "
              f"{ {k: f'{v:.3e}' for k, v in c['coll'].items()} }; roofline "
              f"bound {c['bound_s']:.4e} s ({c['dominant']}), roofline "
              f"fraction {c['roofline_frac']:.4f}; {c['s']:.1f} s")
    b = r["17b"]
    bound = b["step_time_lower_bound_s"]
    print(f"[19c roofline] phase 17b's step ({TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, {TRAIN_MICRO} microbatches, bf16) counted on a "
          f"one-rank fake mesh: {b['flops_per_chip']:.4e} FLOPs, "
          f"{b['bytes_per_chip']:.4e} bytes (op level, no fusion); compute "
          f"{1e3 * b['compute_s']:.3f} ms, memory {1e3 * b['memory_s']:.3f}"
          f" ms, bound {1e3 * bound:.3f} ms ({b['dominant']}); measured in "
          f"17b: {1e3 * train_step_s:.2f} ms a step; bound / measured = "
          f"{bound / train_step_s:.4f} (H100 SXM data-sheet peaks, this "
          f"card: {smi}); {b['s']:.1f} s")
    if not 0 < bound < train_step_s:
        fail(f"19c the bound {bound:.4f} s is not below the measured "
             f"{train_step_s:.4f} s: a counting fault")


def phase_mesh_slice(bpm, cs, ks, dev, smi, train_step_s):
    """Phase 19: training across ranks (19a, 19a'), the sharded grid on
    the step kernel (19b) and the launch tools (19c).  Returns the step
    kernel's launches on 19b's counted path."""
    import tempfile
    t0 = time.perf_counter()
    tr = _Training()
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    proc = None
    try:
        phase_trainer_mesh(tr, dev, smi, root)
        proc = _start_tools(root)
        phase_gradient_gap(tr, dev)
        launched = phase_sharded_grid(cs, dev)
        phase_tools(proc, train_step_s, smi)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(root, ignore_errors=True)
    print(f"[19 mesh] step kernel launches on 19b's sharded path "
          f"{launched}; phase 19 took {time.perf_counter() - t0:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# phase 20: latent attention (DeepSeek-V2-Lite) on the card
# ---------------------------------------------------------------------------

MLA_SLOTS, MLA_LEN = 32, 2048      # dsv2-lite-serve's slots and max_len
# 20a's positions: a 32-row chunk's first and last rows, the cache's last,
# then seeded ones (the `cuda` test's)
MLA_POSITIONS = [0, 1, 31, 32, 63, 64, 65, 127, 128, 200, 511, 512, 1000,
                 1023, 1024, 2046, 2047]
MLA_SERVE_LEN = 96                 # 20c's max_len: prompts and outputs fit


def _mla_bound(q, ckv, kpe, pos, scale, want):
    """What two f32 orders of the same sums may differ by, then one bf16
    rounding (the kernel's bf16 products are exact on the tensor cores,
    and its probabilities split exactly into three bf16 parts): each
    score by (K + 2) 2^-23 scale (|q| @ |row|), the largest over the
    slot's live rows; the softmax moves by at most twice that in relative
    terms, so the output by twice that times the slot's largest |ckv|
    (1e-6 of it more for the exponentials' own roundings); the bf16
    rounding adds 2^-8 of the value."""
    rows = torch.cat([ckv, kpe], -1).float().abs()           # [B, T, K]
    live = torch.arange(ckv.shape[1], device=q.device)[None] <= pos[:, None]
    mags = torch.einsum("bhk,btk->bht", q.float().abs(), rows)
    mags = mags.masked_fill(~live[:, None], 0).amax(-1)      # [B, H]
    ds = (q.shape[-1] + 2) * 2.0 ** -23 * scale * mags
    cmax = (ckv.float().abs() * live[..., None]).amax((1, 2))  # [B]
    return 2.0 ** -8 * want.abs() + \
        (2 * ds + 1e-6)[..., None] * cmax[:, None, None]


def _mla_operands(mk, dev):
    """Seeded q [32, 16, 576], ckv [32, 2,048, 512], kpe [32, 2,048, 64]
    in bf16, and 20a's positions [32]."""
    g = torch.Generator(device=dev).manual_seed(21)
    b, t, bf = MLA_SLOTS, MLA_LEN, torch.bfloat16
    q = torch.randn(b, mk.HEADS, mk.LATENT + mk.ROPE, device=dev,
                    generator=g).to(bf)
    ckv = torch.randn(b, t, mk.LATENT, device=dev, generator=g).to(bf)
    kpe = torch.randn(b, t, mk.ROPE, device=dev, generator=g).to(bf)
    seeded = torch.randint(0, t, (b - len(MLA_POSITIONS),),
                           generator=torch.Generator().manual_seed(3))
    pos = torch.tensor(MLA_POSITIONS + seeded.tolist(), device=dev)
    return q, ckv, kpe, pos


def phase_mla_kernel(mk, scale, q, ckv, kpe, pos):
    """20a: the kernel against the plain version in f32.  Returns the
    largest |d|."""
    worst = 0.0
    for mult in (1, 8):
        qm = q * mult                     # exact: a power of two
        got = mk.mla_decode(qm, ckv, kpe, pos, scale)
        want = mk.mla_decode_plain(qm.float(), ckv, kpe, pos, scale)
        torch.cuda.synchronize()
        if got.dtype != torch.bfloat16:
            fail(f"20a the kernel returned {got.dtype}, not bf16")
        err = (got.float() - want).abs()
        over = float((err - _mla_bound(qm, ckv, kpe, pos, scale,
                                       want)).max())
        rel = float(err.max()) / float(want.abs().max())
        print(f"[20a kernel] mla_decode vs plain (f32) at {MLA_SLOTS} slots "
              f"x {MLA_LEN} positions, positions {int(pos.min())}-"
              f"{int(pos.max())}, q x{mult}: max |d| {float(err.max()):.3e}"
              f" = {rel:.2e} of the largest |out|; most over the bound "
              f"{over:.3e} (<= 0 holds)")
        if over > 0 or rel >= 1e-2:
            fail(f"20a the kernel is outside its bound at q x{mult}")
        worst = max(worst, float(err.max()))
    return worst


def phase_mla_timing(mk, arith, mla_work, scale, q, ckv, kpe, pos, smi):
    """20b: device time of one call beside its bound, at 20a's positions
    and with every slot at the cache's last row.  Returns the record's
    numbers at 20a's positions."""
    n = _copies(2 * (ckv.numel() + kpe.numel()))
    caches = [(ckv.clone(), kpe.clone()) for _ in range(n)]
    full = torch.full_like(pos, MLA_LEN - 1)
    record = {}
    for tag, p in (("mixed", pos), ("full", full)):
        ms = _time_ms(lambda i: mk.mla_decode(q, *caches[i % n], p, scale),
                      n)
        at = p.tolist()
        heads, latent, rope = mk.HEADS, mk.LATENT, mk.ROPE
        nbytes = mla_work.call_bytes(at, heads, latent, rope)
        flops = mla_work.call_flops(at, heads, latent, rope)
        bound = 1e3 * arith.roofline_s(nbytes, flops)
        by = "bytes" if nbytes / arith.HBM_BYTES_PER_S >= \
            flops / arith.BF16_FLOP_PER_S else "operations"
        print(f"[20b time] mla_decode, {MLA_SLOTS} slots, {sum(at) + len(at)}"
              f" live rows ({tag} positions, {mk.splits(len(at), MLA_LEN, _sms())}"
              f" splits a slot): {ms * 1e3:.2f} us, bound {bound * 1e3:.2f}"
              f" us ({by}), {100 * bound / ms:.1f}% of it, "
              f"{nbytes / ms / 1e6:.0f} GB/s; {smi}")
        if tag == "mixed":
            record = {"ms": ms, "bound_ms": bound, "bound_by": by}
    del caches
    return record


def phase_mla_serve(bpm, mk, configs, lm, engine, metrics, dev, smi):
    """20c: the whole model served on the main path, its launches counted.
    Returns the MLA decode kernel's launches."""
    cfg = configs.get("deepseek-v2-lite", quant_bits=BITS)
    torch.cuda.reset_peak_memory_stats()      # the peak printed is 20c's
    t0 = time.perf_counter()
    model = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    layers = sum(1 for kinds in cfg.layer_kinds() if kinds[0] == "mla")
    per_step = lm.packed_projections(model)
    slots, max_len = MLA_SLOTS, MLA_SERVE_LEN
    # warm-up at the counted call's slots and max_len: captures the step
    engine.serve_continuous(model, [engine.Request(np.ones(2, np.int64), 2)],
                            slots=slots, max_len=max_len)
    torch.cuda.synchronize()
    rng = np.random.default_rng(20)
    reqs = [engine.Request(rng.integers(0, cfg.vocab, int(rng.integers(1, 41))),
                           int(rng.integers(1, 41))) for _ in range(48)]
    decodes = mk.DECODES
    steps = metrics.counter("serve.decode_steps")
    before = (decodes.value(path="kernel"), steps.value(mode="eager"),
              steps.value(mode="graph"))
    stats = {}
    # ---- the main path, counted ----
    mk.launches = 0
    bpm.launches = 0
    t0 = time.perf_counter()
    outs = engine.serve_continuous(model, reqs, slots=slots, max_len=max_len,
                                   stats=stats)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launched, planes = mk.launches, bpm.launches
    # ---- end of the counted main path ----
    counted = (decodes.value(path="kernel") - before[0],
               steps.value(mode="eager") - before[1],
               steps.value(mode="graph") - before[2])
    for r, o in zip(reqs, outs):
        if len(o) != r.steps or o.min() < 0 or o.max() >= cfg.vocab:
            fail("20c serve_continuous returned a wrong token stream")
    n = stats["steps"]
    emitted = sum(len(o) for o in outs)
    print(f"[20c serve] {cfg.name}: {cfg.n_layers} layers ({layers} mla), "
          f"{cfg.n_experts} experts top {cfg.top_k} + {cfg.n_shared} shared,"
          f" {cfg.dtype}, {BITS}-bit planes; init {init_s:.1f} s; "
          f"serve_continuous: {len(reqs)} requests over {slots} slots, "
          f"{emitted} tokens in {serve_s:.3f} s ({emitted / serve_s:.1f} "
          f"tokens/s), {n} batched steps ({counted[2]} replayed, "
          f"{counted[1]} eager), occupancy {stats['occupancy']:.3f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {smi}")
    print(f"[20c launches] mla_decode {launched}, attention.mla_decodes"
          f"{{path=kernel}} {counted[0]:g} (expected {layers} x {n} = "
          f"{layers * n}); bit-plane {planes} (expected {per_step} x {n} = "
          f"{per_step * n})")
    if launched != layers * n or counted[0] != layers * n or n == 0:
        fail("20c the main path did not run each MLA decode through the "
             "kernel once")
    if planes != per_step * n:
        fail("20c the main path did not run each packed projection through "
             "the bit-plane kernel once")
    if counted[1:] != (0, n):
        fail("20c the counted call did not replay every step from the graph")
    del model, outs
    torch.cuda.empty_cache()
    return launched


def phase_mla(bpm, configs, lm, engine, metrics, dev, smi):
    """Phase 20 (see the module's docstring).  Returns the kernel's record:
    launches, largest |d| and 20b's times."""
    from bench.metrics import arith, mla_work
    from repro_torch.kernels import mla_decode as mk
    from repro_torch.models import mla
    t0 = time.perf_counter()
    scale = mla.softmax_scale(configs.get("deepseek-v2-lite"))
    q, ckv, kpe, pos = _mla_operands(mk, dev)
    worst = phase_mla_kernel(mk, scale, q, ckv, kpe, pos)
    timing = phase_mla_timing(mk, arith, mla_work, scale, q, ckv, kpe, pos,
                              smi)
    del q, ckv, kpe
    launched = phase_mla_serve(bpm, mk, configs, lm, engine, metrics, dev,
                               smi)
    print(f"[20 mla] phase 20 took {time.perf_counter() - t0:.1f} s")
    return {"name": "mla_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mla_decode.cu",
            "replaces": None,    # the JAX package has no latent attention
            "launches": launched, "max_abs_err": worst, **timing}


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
    from repro_torch.kernels import mla_decode as mk
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
                       bsr.SOURCE, bsm.SOURCE, mk.SOURCE),
                ("1 build", "6 build") + ("11 build",) * 4 + ("20 build",))
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
    family_launched, family_err = phase_families(
        bpm, bitplane, configs, common, lm, engine, dev, smi)
    print(f"[15 families] bit-plane kernel launches: phase 4 {launched}, "
          f"phase 15 {family_launched}")
    new_launched, new_err = phase_new_families(
        bpm, bitplane, configs, common, lm, engine, dev, smi)
    print(f"[16 families] bit-plane kernel launches: phase 4 {launched}, "
          f"phase 15 {family_launched}, phase 16 {new_launched}")
    train_step_s = phase_train(bpm, cs, ks, dev, smi)
    dist_launched = phase_distribution(bpm, cs, dev, smi)
    mesh_launched = phase_mesh_slice(bpm, cs, ks, dev, smi, train_step_s)
    mla_record = phase_mla(bpm, configs, lm, engine, metrics, dev, smi)
    record = {"kernels": [
        {"name": "bitplane_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
         "replaces": "src/repro/kernels/bitplane_matmul.py:69",
         "launches": launched + family_launched + new_launched
         + dist_launched["bitplane_matmul"],
         "max_abs_err": max(worst, family_err, new_err), **layer},
        {"name": "comefa_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/comefa_step.cu",
         "replaces": "src/repro/kernels/comefa_step.py:80",
         "launches": step_launched + eval_launched
         + dist_launched["comefa_step"] + mesh_launched,
         "max_abs_err": step_err, **timing}]}
    for name, (source, replaces) in BITSERIAL_KERNELS.items():
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": serial_launched[name],
            "max_abs_err": ks.err[name], **serial[name]})
    record["kernels"].append(mla_record)
    print(json.dumps(record))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
