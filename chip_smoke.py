#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (`src/repro_torch`), on one card.

    python3 chip_smoke.py        # from the repository root

Drives only the port (no JAX, nothing of `repro`).  Each phase prints its
lines; any failure exits nonzero, and nothing is caught:

  1. build the bit-plane kernel from `src/repro_torch/kernels/csrc` with
     nvcc for sm_90a and print the build time;
  2. the kernel against its plain PyTorch version on the card, at the four
     SmolLM-360M projection shapes (M=4) and a ragged one, bits 4 and 8:
     exact on integer x with scale 1, else within the f32 bound for two
     orders of one sum, |d| <= (K+2) * 2^-23 * (|x| @ |w|);
  3. a reduced SmolLM (f32, 2 layers, 8-bit planes) on the card against
     the port's plain path on the CPU with the same params: equal greedy
     tokens, logits within 1e-4;
  4. the main path: full SmolLM-360M (32 layers, d_model 960, bf16, 8-bit
     planes, random params from a seeded generator) through
     `serve.engine.generate` (batch 4 x 8-token prompts) and then
     `serve_continuous` (8 requests over 4 slots), with the kernel's
     launch count reset just before and read just after; plus one decode
     step with the kernel against the plain version on the card, and a
     torch.profiler pass over a short generate (device busy share);
  5. the kernel's time beside its byte bound, its plain version's and
     `torch.matmul`'s on the dequantised f32 weight, at the four shapes;

then one JSON line of kernel records, the card's name and power limit as
nvidia-smi prints them, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BITS = 8
M_DECODE = 4
# SmolLM-360M's packed projections (K, N) and how many of each a layer runs
SMOLLM_SHAPES = {(960, 960): 2,      # wq, wo
                 (960, 320): 2,      # wk, wv
                 (960, 2560): 2,     # wi, wg
                 (2560, 960): 1}     # ffn wo
RAGGED = (3, 64, 100)


def fail(msg):
    raise SystemExit(f"FAIL: {msg}")


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_build(bpm):
    t0 = time.perf_counter()
    lib = bpm.build()
    dt = time.perf_counter() - t0
    print(f"[1 build] {lib.name} in {dt:.2f} s (nvcc {' '.join(bpm.NVCC_FLAGS)})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1 build]   {line.strip()}")


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
    shapes = [(M_DECODE, k, n) for k, n in SMOLLM_SHAPES] + [RAGGED]
    for m, k, n in shapes:
        for bits in (4, BITS):
            xi, q, ones = _operands(gen, dev, bits, m, k, n, integer=True)
            planes = bitplane.pack(q, bits)
            yk = bpm.bitplane_matmul(xi, planes, ones, bits=bits)
            yp = bpm.bitplane_matmul_plain(xi, planes, ones, bits=bits)
            torch.cuda.synchronize()
            exact = torch.equal(yk, yp)
            x, q, scale = _operands(gen, dev, bits, m, k, n, integer=False)
            planes = bitplane.pack(q, bits)
            yk = bpm.bitplane_matmul(x, planes, scale, bits=bits)
            yp = bpm.bitplane_matmul_plain(x, planes, scale, bits=bits)
            torch.cuda.synchronize()
            bound = (k + 2) * 2.0 ** -23 * (
                x.abs().double() @ (q.abs().double() * scale.double()))
            err = (yk - yp).abs().double()
            within = bool((err <= bound).all())
            worst = max(worst, float(err.max()))
            print(f"[2 kernel] M={m} K={k} N={n} bits={bits}: integer "
                  f"exact={exact}; float max|d|={float(err.max()):.3e}, "
                  f"max |d|/bound={float((err / bound).max()):.3f}")
            if not (exact and within):
                fail(f"kernel disagrees with plain at M={m} K={k} N={n} "
                     f"bits={bits}")
    return worst


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
    step_s = gen_s / (s + steps)
    profile_decode(lambda: engine.generate(model, prompt, steps=4,
                                           max_len=s + 5), s + 4, step_s)
    return launched, step_s


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
    gen = torch.Generator(device=dev).manual_seed(3)
    m, rows = M_DECODE, {}
    for (k, n), per_layer in SMOLLM_SHAPES.items():
        x, q, scale = _operands(gen, dev, BITS, m, k, n, integer=False)
        planes = bitplane.pack(q, BITS)
        w = bitplane.dequantize(q, scale)                       # f32 [K, N]
        pc = [planes.clone() for _ in range(_copies(planes.numel() * 4))]
        wc = [w.clone() for _ in range(_copies(w.numel() * 4))]
        t_kernel = _time_ms(lambda i: bpm.bitplane_matmul(
            x, pc[i % len(pc)], scale, bits=BITS), len(pc))
        t_plain = _time_ms(lambda i: bpm.bitplane_matmul_plain(
            x, pc[i % len(pc)], scale, bits=BITS), 10)
        t_lib = _time_ms(lambda i: torch.matmul(x, wc[i % len(wc)]), len(wc))
        nbytes = BITS / 8 * k * n + 4 * m * k + 4 * m * n + 4 * n
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * 2 * m * k * n / F32_FLOP_PER_S
        rows[(k, n)] = (t_kernel, t_plain, t_lib, t_bytes, t_ops)
        bound = max(t_bytes, t_ops)
        print(f"[5 time] M={m} K={k} N={n} bits={BITS}: kernel "
              f"{t_kernel * 1e3:.2f} us, bound {bound * 1e3:.2f} us ("
              f"{'bytes' if t_bytes >= t_ops else 'operations'}; "
              f"{nbytes / t_kernel / 1e6:.0f} GB/s achieved), plain "
              f"{t_plain * 1e3:.2f} us, torch.matmul on the dequantised "
              f"f32 weight {t_lib * 1e3:.2f} us; {smi}")
        del pc, wc
    kernel, plain, lib, t_bytes, t_ops = (
        sum(rows[s][i] * c for s, c in SMOLLM_SHAPES.items())
        for i in range(5))
    layer = {"ms": kernel, "plain_ms": plain, "library_ms": lib,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"[5 time] one layer's 7 projections (M={m}): kernel "
          f"{kernel * 1e3:.2f} us, bound {layer['bound_ms'] * 1e3:.2f} us "
          f"({layer['bound_by']}), plain {plain * 1e3:.2f} us, "
          f"torch.matmul {lib * 1e3:.2f} us; {smi}")
    return layer


def main():
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels import bitplane_matmul as bpm
    from repro_torch.models import common, lm
    from repro_torch.quant import bitplane
    from repro_torch.serve import engine

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    t_start = time.perf_counter()
    print(f"chip_smoke: torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}) on {torch.cuda.get_device_name(0)}; {smi}")
    phase_build(bpm)
    worst = phase_kernel_vs_plain(bpm, bitplane, dev)
    phase_reduced(bpm, configs, common, lm, engine, dev)
    launched, step_s = phase_full(bpm, configs, common, lm, engine, dev)
    layer = phase_timings(bpm, bitplane, dev, smi)
    per_step = 32 * layer["ms"]
    print(f"[5 time] 32 layers x 7 kernel launches = {per_step:.3f} ms of a "
          f"{1e3 * step_s:.2f} ms decode step ({100 * per_step / (1e3 * step_s):.1f}"
          f"% of its wall time); {smi}")
    record = {"kernels": [{
        "name": "bitplane_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitplane_matmul.cu",
        "replaces": "src/repro/kernels/bitplane_matmul.py:69",
        "launches": launched, "max_abs_err": worst, **layer}]}
    print(json.dumps(record))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
