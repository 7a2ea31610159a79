"""Run the paper's six benchmark kernels on the PyTorch port's bit-level
CoMeFa simulator and price them with the analytical FPGA model.

The counterpart of `examples/comefa_programs.py` on `repro_torch`: the
same sections, programs and printed lines.  The arrays run on the CUDA
step kernel by default; ``--device cpu`` runs them on the uint8 reference
engine.

Run:  PYTHONPATH=src python examples/comefa_programs_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.comefa import ComefaArray, layout, program, timing
from repro_torch.core.fpga_model import perf

rng = np.random.default_rng(0)
F_D = 588e6


def header(s):
    print(f"\n=== {s} ===")


def gemv_ooor(device):
    header("GEMV via OOOR dot product (weights pinned, vector streamed)")
    arr = ComefaArray(n_blocks=4, device=device)
    k, wb, accb = 8, 8, 27
    w = rng.integers(0, 1 << wb, size=(k, 160))
    x = rng.integers(0, 1 << wb, size=k)
    # IR path: allocator-managed operands, optimized schedule
    bld = program.ProgramBuilder("gemv")
    w_ops = [bld.input(wb, f"w{j}") for j in range(k)]
    acc = bld.dot(w_ops, list(x), wb, accb)
    prog = bld.build()
    raw_cycles = bld.build(optimize=False).cycles
    for j in range(k):
        layout.place(arr, np.tile(w[j], (4, 1)), w_ops[j].base, wb)
    cyc = arr.run(prog)
    got = layout.extract(arr, acc.base, accb, block=0)
    expect = (w * x[:, None]).sum(0)
    assert np.array_equal(got, expect)
    print(f"  4 blocks x 160 lanes, k={k}: {cyc} cycles after co-issue "
          f"(unoptimized {raw_cycles}; {cyc / F_D * 1e6:.1f} us @588MHz) - "
          f"{4 * 160 * k / cyc:.1f} MACs/cycle")


def search(device):
    header("Database search + replace (bulk bitwise)")
    arr = ComefaArray(device=device)
    n = 16
    recs = rng.integers(0, 1 << n, size=160)
    key = int(recs[42])
    layout.place(arr, recs, 0, n)
    prog = program.search_replace(list(range(n)), key, n,
                                  list(range(n, 2 * n))).optimize()
    cyc = arr.run(prog)
    got = layout.extract(arr, 0, n, block=0)
    assert np.array_equal(got, np.where(recs == key, 0, recs))
    print(f"  160 records matched+cleared in {cyc} cycles "
          f"(closed-form {timing.search_cycles(n)}; co-issued record "
          f"clears pack two rows/cycle)")


def raid(device):
    header("RAID rebuild (untransposed XOR fold)")
    arr = ComefaArray(device=device)
    drives = rng.integers(0, 2, size=(4, 160)).astype(np.uint8)
    parity = np.bitwise_xor.reduce(drives, 0)
    for d in range(3):                      # drive 3 lost
        arr.mem[0, d] = drives[d]
    arr.mem[0, 10] = parity
    cyc = arr.run(program.raid_rebuild([[0], [1], [2]], [10], [20]))
    assert np.array_equal(arr.mem[0, 20], drives[3])
    print(f"  one 160-bit stripe row rebuilt per {cyc} cycles")


def reduction(device):
    header("In-RAM reduction tree")
    arr = ComefaArray(device=device)
    n, steps = 8, 2
    vals = rng.integers(0, 1 << n, size=160)
    layout.place(arr, vals, 0, n)
    rows = list(range(0, n + steps + 1))
    scratch = list(range(n + steps + 1, 2 * (n + steps) + 2))
    cyc = arr.run(program.reduce_tree(rows, scratch, n, steps))
    got = layout.extract(arr, 0, n + steps, block=0)
    assert np.array_equal(got[::4], vals.reshape(-1, 4).sum(1))
    print(f"  160 -> 40 partial sums in {cyc} cycles "
          f"(= {timing.reduction_cycles(n, steps=steps)} model)")


def fp_eltwise():
    header("Elementwise HFP8 multiply (floating point in-RAM)")
    E, M = 4, 3
    cycles = timing.fp_mul_cycles(E, M)
    print(f"  HFP8 (e4m3) multiply: {cycles} cycles/lane-batch "
          f"(paper formula M^2+7M+3E+5)")
    print(f"  see tests/test_comefa_sim.py::test_fp_mul_bit_exact_vs_oracle")


def speedups():
    header("Analytical speedups (paper Fig 9) - closed-form vs achieved")
    paper_mode = perf.run_all()
    achieved = perf.run_all(achieved=True)
    for bench, targets in perf.PAPER_SPEEDUPS.items():
        got = {v: (round(paper_mode[bench][v], 2),
                   round(achieved[bench][v], 2)) for v in targets}
        print(f"  {bench:16s} (paper-formula, IR-scheduled)={got}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device the arrays run on (default cuda)")
    args = ap.parse_args()
    gemv_ooor(args.device)
    search(args.device)
    raid(args.device)
    reduction(args.device)
    fp_eltwise()
    speedups()
