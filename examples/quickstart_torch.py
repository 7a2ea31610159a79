"""Quickstart on the PyTorch port: CoMeFa in 60 seconds, all three layers.

  1. bit-level CoMeFa RAM simulator - run a SIMD multiply in a 20Kb block
  2. the bit-plane kernel - the same bit-serial math on the GPU
  3. a quantized model layer - the technique inside a transformer

The counterpart of `examples/quickstart.py` on `repro_torch`: the same
sections, inputs and checks.  By default everything runs on the card
(the CoMeFa step kernel for the array, the bit-plane kernel for the
matmul and the model's projections); ``--device cpu`` runs the uint8
reference engine and the kernels' plain PyTorch versions.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.comefa import ComefaArray, layout, program, timing
from repro_torch.kernels import ops, ref
from repro_torch.quant import bitplane as bp


def demo_simulator(device):
    print("=== 1. CoMeFa RAM: 160-lane bit-serial multiply ===")
    arr = ComefaArray(n_blocks=1, device=device)
    rng = np.random.default_rng(0)
    n = 8
    a = rng.integers(0, 1 << n, size=160)
    b = rng.integers(0, 1 << n, size=160)
    # assemble through the program IR: allocator-managed operands, then
    # the optimizing pass pipeline (dual-port co-issue et al.)
    bld = program.ProgramBuilder("mul8")
    ra = bld.input(n, "a")
    rb = bld.input(n, "b")
    rp = bld.mul(ra, rb)
    prog = bld.build()                               # optimized Program
    layout.place(arr, a, base_row=ra.base, n_bits=n)  # transposed layout
    layout.place(arr, b, base_row=rb.base, n_bits=n)
    cycles = arr.run(prog)
    got = layout.extract(arr, rp.base, 2 * n, block=0)
    assert np.array_equal(got, a * b)
    print(f"  160 8-bit multiplies in {cycles} cycles "
          f"(paper formula n^2+3n-2 = {timing.mul_cycles(n)}; dual-port "
          f"co-issue packs {prog.n_instrs} instrs into {prog.cycles}) - "
          f"{cycles / 588e6 * 1e9:.0f} ns at CoMeFa-D's 588 MHz")


def demo_kernel(device):
    print("=== 2. Bit-plane kernel: w4 weights x f32 activations ===")
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(8, 256)), dtype=torch.float32,
                        device=device)
    w = torch.as_tensor(rng.normal(size=(256, 128)), dtype=torch.float32,
                        device=device)
    y4 = ops.quantized_matmul(x, w, bits=4)
    dense = x @ w
    rel = float(torch.linalg.norm(y4 - dense) / torch.linalg.norm(dense))
    print(f"  4-bit bit-plane GEMM vs dense: rel err {rel:.3f}; "
          f"weight bytes 4x smaller in device memory")
    packed, scale = bp.quantize_pack(w, 4, axis=0)
    y_ref = ref.bitplane_matmul_ref(x, packed, scale, bits=4)
    print(f"  kernel == torch oracle: "
          f"{bool(torch.allclose(y4, y_ref, atol=1e-4))}")


def demo_model(device):
    print("=== 3. Quantized transformer (CoMeFa as a config flag) ===")
    from repro_torch import configs
    from repro_torch.models import common, lm
    cfg = common.reduced(configs.get("smollm-360m"), d_model=64, d_ff=128,
                         quant_bits=4)
    dev = common.device(device)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    logits, _ = lm.forward(params, tokens)
    n_packed = sum(1 for name in params.state_dict()
                   if name.endswith(".packed"))
    print(f"  smollm (reduced) with {n_packed} packed bit-plane weight "
          f"tensors -> logits {tuple(logits.shape)}, finite: "
          f"{bool(torch.isfinite(logits).all())}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    demo_simulator(args.device)
    demo_kernel(args.device)
    demo_model(args.device)


if __name__ == "__main__":
    main()
