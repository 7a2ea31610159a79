// CoMeFa simulator step kernel for Hopper (sm_90a).  Replaces the Pallas TPU
// kernel src/repro/kernels/comefa_step.py::run_packed (pl.pallas_call at
// :101), which carried the bit-packed CoMeFa engine: it executes T encoded
// instructions, in order, on the packed state of S independent grid slots.
//
//   mem   [S, nb, 128, 5]  32-bit words: lane c of a 160-lane row is bit
//                          c%32 of word c/32 (core/comefa/engine_packed.py)
//   carry [S, nb, 5], mask [S, nb, 5]   the PE latches, same packing
//   prog  [T, 24] (one stream for every slot) or [S, T, 24] (per_slot:
//         slot s runs its own stream): the DECODED program that
//         kernels/comefa_step.decode makes from the engine field matrix of
//         core/comefa/isa.py with engine_packed.prepare_fields' folding.
//         Words 0 and 1 hold the rows as byte offsets into a lane's column
//         (row * 128): src1 | src2 << 16, with bit 0 set when a write takes
//         a shifted value, and dst | dst2 << 16.  Every other word is
//         all-ones or all-zeros: 2 "dst2 == dst", 3-6 the TR minterms
//         tt0..tt3, 7 keep_b, 8 ext_and, 9 crst_keep, 10 c_en, 11 m_en,
//         12-15 port 1's predicate one-hots (always, mask, carry, ~carry)
//         with wp1 folded in, 16-19 port 2's, 20-23 the write muxes v1s,
//         v1r, v2c, v2l.
//
// Each instruction computes, word-parallel over 32 lanes, what
// engine_packed.datapath computes: read rows src1 and src2 (B optionally
// replaced by ext_bit), the TR truth-table mux, the X gate against the
// (optionally reset) carry, CGEN, the carry and mask latches, write
// enables predicated on the *latched* mask/carry, and the W1_RIGHT /
// W2_LEFT shift network as funnel shifts whose seam words cross into the
// neighbouring block only when `chain` is set and never cross a slot.
// Port 1 writes dst first; port 2 then reads dst2 and writes it, so
// dst2 == dst sees port 1's result.  An all-zero field row is a no-op.
//
// What bounds it on this card: the T instructions are a dependent chain on
// a tiny state (2.5 KiB a block), so the kernel is bound by latency, not
// by bytes or operations: each instruction reads rows that an earlier one
// may have written.  chip_smoke.py's dependency bound takes T times a
// shared-memory load -> ALU -> store step.  Every warp runs the whole
// stream, so a step also costs the instructions one warp issues for it;
// the design keeps both short:
//
//  * Decoded program.  Every select of the raw fields is folded on the
//    host side of the launch into all-ones/all-zeros words and row
//    offsets (a frozen matrix once, through the wrapper's cache), so a
//    step is about twenty LOP3-able and/or/xor, funnel shifts only when
//    it shifts, and no compare or select on fields.
//  * One warp-segment a block.  Block (slot, b) is 5 adjacent lanes of a
//    warp, six blocks a warp (lanes 30 and 31 idle); each lane owns one
//    word column of its block's 128 rows in shared memory ([row][32]
//    words, so a row read is conflict-free) and holds carry and mask in
//    registers.  Shift seams move with __shfl_sync inside the warp.  With
//    `chain` false a CTA is one warp of one slot, so the S * nb blocks
//    spread over S * ceil(nb / 6) CTAs (12 at the main path's 4 slots x
//    nb = 16) and the instruction loop takes no barrier at all.  With
//    `chain` true a CTA holds a whole slot of up to 78 blocks (ceil(nb / 6)
//    warps, at most 13 for shared memory); the seam between two warps goes
//    through shared memory with one barrier on each shifting instruction
//    (none when the slot fits one warp).
//  * Longer chains on a thread block cluster.  A chained slot of 79-624
//    blocks spreads over a cluster of 2, 4 or 8 CTAs (8 is the portable
//    size), each holding up to 13 warps of state in its own shared memory.
//    The seam words between neighbouring CTAs pass through distributed
//    shared memory, and the barrier of a shifting instruction becomes a
//    cluster barrier (barrier.cluster.arrive.release / wait.acquire) at the
//    same points and only there.
//  * Any number of slots.  The CTAs of a slot sit on gridDim.x and the
//    slots on (gridDim.y, gridDim.z), 65535 to a z-layer, so more than
//    65535 slots run; the spare CTAs of the last layer return at once.
//    (A one-dimensional grid that divided blockIdx.x by the CTAs a slot
//    cost the unchained kernel 4% in one H100 call, PERF.md.)
//    Above 624 blocks the state would have to leave shared memory (global
//    memory, or a cooperative grid); run_packed refuses such a launch.
//  * Rows read one instruction ahead.  While instruction t computes, the
//    four rows of t + 1 are already loaded; where one of them is a row
//    that t writes, the value t just computed is forwarded in a register
//    (dst2 before dst, since port 2 writes last), so the shared-memory
//    load leaves the chain and the store is never read back on it.  The
//    words of t + 2 are loaded at the same time, so the row addresses of
//    t + 1 are known when t starts.  Shared memory is read and written
//    through volatile asm, so the compiler neither sinks a load to its use
//    nor moves a store above a load; the loop is unrolled three times, one
//    for each place of the three instructions in flight, so they rotate
//    without register copies.
//  * Staging.  A warp's blocks come in with cp.async, every word in
//    flight at once, beside the first program tile: a copy that waited on
//    each word would cost one memory latency per 32 words.
//  * Program tiles.  The decoded program streams through shared memory
//    64 instructions (6 KiB) at a time, double-buffered with cp.async, so
//    the next tile lands while this one runs: two barriers a tile, none
//    inside it; each instruction's 24 words are six broadcast loads.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/comefa_step.py does it at first use) and called through the
// plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 128;            // wordlines per block
constexpr int kWords = 5;             // 32-lane words per 160-lane row
constexpr int kVecs = 6;              // uint4 of one decoded instruction
constexpr int kBlocksPerWarp = 6;
constexpr int kLanesUsed = kBlocksPerWarp * kWords;   // 30
constexpr int kTile = 64;             // instructions staged at once
constexpr int kMaxWarps = 13;         // warps of a chained slot's CTA (smem)
constexpr int kMaxCluster = 8;        // CTAs of a chained slot (portable)
constexpr int kSlotsPerLayer = 65535;   // slots a z-layer of the grid
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kInsnBytes = kVecs * sizeof(uint4);

// one decoded instruction (the word order of the header)
struct Insn {
  uint32_t srcs, dsts, same, t0, t1, t2, t3, keep_b, ext_and, crst, ce, me;
  uint32_t p1a, p1m, p1c, p1n, p2a, p2m, p2c, p2n, v1s, v1r, v2c, v2l;
};

// Shared-memory accesses the compiler may neither sink nor reorder: the
// loop issues loads one or two instructions ahead of their use on purpose.
__device__ __forceinline__ uint32_t lds(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds4(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts(unsigned addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// the decoded instruction at shared address `addr` (kVecs uint4)
__device__ __forceinline__ Insn load_insn(unsigned addr) {
  const uint4 q0 = lds4(addr), q1 = lds4(addr + 16), q2 = lds4(addr + 32),
              q3 = lds4(addr + 48), q4 = lds4(addr + 64),
              q5 = lds4(addr + 80);
  return Insn{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
              q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w,
              q4.x, q4.y, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w};
}

// byte offsets of an instruction's rows in a lane's column
__device__ __forceinline__ unsigned lo_off(uint32_t w) { return w & 0xFFFEu; }
__device__ __forceinline__ unsigned hi_off(uint32_t w) { return w >> 16; }

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src));
}

// start copying instructions [t0, t0 + kTile) of `prog` into `tile`
__device__ __forceinline__ void stage_tile(uint4* tile, const uint4* prog,
                                           int t0, int t_len) {
  const int n = min(kTile, t_len - t0) * kVecs;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async16(tile + i, prog + static_cast<size_t>(t0) * kVecs + i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// the four rows an instruction reads (src1, src2, dst, dst2)
struct Rows {
  uint32_t a, b, d1, d2;
};

// the barrier of a shifting instruction and at the end of a clustered run
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// kMode 0: one warp a CTA, no seam between warps; 1: a chained slot in one
// CTA of several warps; 2: a chained slot over a cluster of `ctas` CTAs
template <int kMode>
__global__ void __launch_bounds__(kMode ? 32 * kMaxWarps : 32)
comefa_step_kernel(uint32_t* __restrict__ mem,
                   uint32_t* __restrict__ carry_io,
                   uint32_t* __restrict__ mask_io,
                   const uint4* __restrict__ prog, int t_len, int nb,
                   int chain, int per_slot, int slots) {
  constexpr bool kCross = kMode > 0;
  // slots on (y, z), at most 65535 a z-layer; the CTAs of a slot on x
  const int slot = blockIdx.z * kSlotsPerLayer + blockIdx.y;
  if (slot >= slots) return;                 // the last layer's spare CTAs
  const int rank = blockIdx.x, ctas = gridDim.x;
  // shared memory: two program tiles, each warp's state [kRows][32]
  // words, then the cross-warp seam exchange [2][kMaxWarps][2]
  extern __shared__ uint4 smem[];
  const int warps = blockDim.x >> 5;
  uint4* tiles = smem;
  uint32_t* state = reinterpret_cast<uint32_t*>(smem + 2 * kTile * kVecs);
  uint32_t* xbuf = state + warps * kRows * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk0 = (rank * warps + warp) * kBlocksPerWarp;
  const int nblk = max(0, min(kBlocksPerWarp, nb - blk0));
  const int bl = lane / kWords, word = lane - bl * kWords;
  const int blk = blk0 + bl;
  const bool live = lane < kLanesUsed && blk < nb;
  uint32_t* sw = state + warp * kRows * 32;
  const uint4* p = prog + (per_slot ? static_cast<size_t>(slot) * t_len *
                                          kVecs
                                    : 0);
  const int n_tiles = (t_len + kTile - 1) / kTile;
  if (n_tiles > 0) stage_tile(tiles, p, 0, t_len);

  // this warp's blocks: contiguous [nblk, 128, 5] words in global memory,
  // copied asynchronously (all in flight at once) beside tile 0
  uint32_t* gmem = mem + (static_cast<size_t>(slot) * nb + blk0) * kRows *
                             kWords;
  const int n_state = nblk * kRows * kWords;
  for (int i = lane; i < n_state; i += 32) {
    const int b = i / (kRows * kWords);
    const int rem = i - b * kRows * kWords;
    const int r = rem / kWords;
    cp_async4(&sw[r * 32 + b * kWords + (rem - r * kWords)], gmem + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const size_t latch = (static_cast<size_t>(slot) * nb + blk) * kWords + word;
  uint32_t carry = live ? carry_io[latch] : 0u;
  uint32_t mask = live ? mask_io[latch] : 0u;

  // where this lane's shift seams come from: the next / previous lane of
  // the warp, the neighbouring warp's edge lane (chained slots), or zero
  const bool chain_hi = chain && blk + 1 < nb;
  const bool chain_lo = chain && blk > 0;
  uint32_t hi_sh =
      (word < kWords - 1 || (chain_hi && lane + 1 < kLanesUsed)) ? kFull : 0u;
  uint32_t hi_x = (word == kWords - 1 && chain_hi &&
                   lane + 1 == kLanesUsed) ? kFull : 0u;
  uint32_t lo_sh = (word > 0 || (chain_lo && lane > 0)) ? kFull : 0u;
  uint32_t lo_x = (word == 0 && chain_lo && lane == 0) ? kFull : 0u;
  // opaque to the compiler, so that it keeps them in registers instead of
  // recomputing them from the lane index inside the loop
  asm volatile("" : "+r"(hi_sh), "+r"(hi_x), "+r"(lo_sh), "+r"(lo_x));
  // where the neighbouring warps' seam words land (phase 0): the next
  // warp's low edge and the previous warp's high edge, in this CTA or,
  // across a CTA edge of a cluster, in the neighbour CTA's shared memory
  // (read only by the lanes whose hi_x / lo_x is set)
  uint32_t* x_next = xbuf + min(warp + 1, warps - 1) * 2;
  uint32_t* x_prev = xbuf + max(warp - 1, 0) * 2 + 1;
  if constexpr (kMode == 2) {
    cg::cluster_group cluster = cg::this_cluster();
    if (warp + 1 == warps && rank + 1 < ctas)
      x_next = cluster.map_shared_rank(xbuf, rank + 1);
    if (warp == 0 && rank > 0)
      x_prev = cluster.map_shared_rank(xbuf, rank - 1) + (warps - 1) * 2 + 1;
  }
  // this lane's column: row r is at col_s + 128 r (32 words a row)
  const unsigned col_s =
      static_cast<unsigned>(__cvta_generic_to_shared(sw + lane));
  int phase = 0;

  // one instruction: `f` computes on `r` (its rows, read ahead), while the
  // rows of `g` (the next one) are read and the words of the instruction
  // at `ahead` are loaded into `h`; `r` leaves holding g's rows
  auto step = [&](const Insn& f, const Insn& g, Insn& h, unsigned ahead,
                  Rows& r) {
    h = load_insn(ahead);
    const unsigned ns1 = lo_off(g.srcs), ns2 = hi_off(g.srcs);
    const unsigned nd1 = lo_off(g.dsts), nd2 = hi_off(g.dsts);
    const Rows n{lds(col_s + ns1), lds(col_s + ns2), lds(col_s + nd1),
                 lds(col_s + nd2)};

    const unsigned dst = lo_off(f.dsts), dst2 = hi_off(f.dsts);
    const uint32_t b = (r.b & f.keep_b) | f.ext_and;
    const uint32_t tr = (r.a & ((b & f.t3) | (~b & f.t2))) |
                        (~r.a & ((b & f.t1) | (~b & f.t0)));
    const uint32_t c_in = carry & f.crst;
    const uint32_t s = tr ^ c_in;                           // gate X
    const uint32_t cgen = (r.a & b) | (c_in & (r.a ^ b));   // CGEN
    const uint32_t we1 = f.p1a | (mask & f.p1m) | (carry & f.p1c) |
                         (~carry & f.p1n);
    const uint32_t we2 = f.p2a | (mask & f.p2m) | (carry & f.p2c) |
                         (~carry & f.p2n);
    uint32_t from_right = 0u, from_left = 0u;
    if (f.srcs & 1u) {                        // uniform across the CTA
      uint32_t hi = __shfl_down_sync(kFull, s, 1) & hi_sh;
      uint32_t lo = __shfl_up_sync(kFull, s, 1) & lo_sh;
      if constexpr (kCross) {
        const int off = phase * kMaxWarps * 2;
        phase ^= 1;
        if (lane == 0) xbuf[off + warp * 2] = s;
        if (lane == kLanesUsed - 1) xbuf[off + warp * 2 + 1] = s;
        if constexpr (kMode == 2) cluster_barrier(); else __syncthreads();
        if (hi_x) hi |= x_next[off];
        if (lo_x) lo |= x_prev[off];
      }
      from_right = __funnelshift_r(s, hi, 1);   // lane c + 1 -> c
      from_left = __funnelshift_l(lo, s, 1);    // lane c - 1 -> c
    }
    // W1: S / right neighbour; W2: the latched (pre-update) carry / left
    // neighbour; the other selects drive 0
    const uint32_t val1 = (s & f.v1s) | (from_right & f.v1r);
    const uint32_t val2 = (carry & f.v2c) | (from_left & f.v2l);

    // ---- write-back: port 1, then port 2 on port 1's result ----------
    const uint32_t new1 = (r.d1 & ~we1) | (val1 & we1);
    sts(col_s + dst, new1);
    const uint32_t base2 = (new1 & f.same) | (r.d2 & ~f.same);
    const uint32_t new2 = (base2 & ~we2) | (val2 & we2);
    sts(col_s + dst2, new2);
    carry = (cgen & f.ce) | (carry & ~f.ce);
    mask = (tr & f.me) | (mask & ~f.me);

    // ---- forward this instruction's rows into the next one's reads ----
    r.a = ns1 == dst2 ? new2 : (ns1 == dst ? new1 : n.a);
    r.b = ns2 == dst2 ? new2 : (ns2 == dst ? new1 : n.b);
    r.d1 = nd1 == dst2 ? new2 : (nd1 == dst ? new1 : n.d1);
    r.d2 = nd2 == dst2 ? new2 : (nd2 == dst ? new1 : n.d2);
  };

  for (int ti = 0; ti < n_tiles; ++ti) {
    const uint4* cur = tiles + (ti & 1) * kTile * kVecs;
    if (ti + 1 < n_tiles) {
      stage_tile(tiles + ((ti + 1) & 1) * kTile * kVecs, p,
                 (ti + 1) * kTile, t_len);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();                      // tile ti (and the state) landed
    const int n = min(kTile, t_len - ti * kTile);
    const unsigned cur_s =
        static_cast<unsigned>(__cvta_generic_to_shared(cur));
    const unsigned last = cur_s + (n - 1) * kInsnBytes;
    // three instructions in flight: the one computing, the next (its rows
    // being read) and the one after (its words being loaded)
    Insn f0 = load_insn(cur_s);
    Insn f1 = load_insn(min(cur_s + kInsnBytes, last));
    Insn f2;
    Rows r{lds(col_s + lo_off(f0.srcs)), lds(col_s + hi_off(f0.srcs)),
           lds(col_s + lo_off(f0.dsts)), lds(col_s + hi_off(f0.dsts))};
    unsigned ahead = cur_s + 2 * kInsnBytes;
    int i = 0;
    for (; i + 3 <= n; i += 3) {
      step(f0, f1, f2, min(ahead, last), r);
      step(f1, f2, f0, min(ahead + kInsnBytes, last), r);
      step(f2, f0, f1, min(ahead + 2 * kInsnBytes, last), r);
      ahead += 3 * kInsnBytes;
    }
    if (i < n) step(f0, f1, f2, min(ahead, last), r);
    if (i + 1 < n) step(f1, f2, f0, min(ahead + kInsnBytes, last), r);
    __syncthreads();                          // tile ti consumed
  }

  asm volatile("cp.async.wait_all;\n" ::);   // (a program of no tile)
  // no CTA of a cluster leaves while a neighbour may still read its seams
  if constexpr (kMode == 2) cluster_barrier();
  __syncwarp();
#pragma unroll 4
  for (int i = lane; i < n_state; i += 32) {
    const int b = i / (kRows * kWords);
    const int rem = i - b * kRows * kWords;
    const int r = rem / kWords;
    gmem[i] = sw[r * 32 + b * kWords + (rem - r * kWords)];
  }
  if (live) {
    carry_io[latch] = carry;
    mask_io[latch] = mask;
  }
}

size_t smem_bytes(int warps) {
  return 2 * kTile * kVecs * sizeof(uint4) +
         static_cast<size_t>(warps) * kRows * 32 * sizeof(uint32_t) +
         2 * kMaxWarps * 2 * sizeof(uint32_t);
}

// `ctas` CTAs of `warps` warps a slot on x, slots on (y, z); kMode 2 runs
// each slot's CTAs as one cluster
template <int kMode>
cudaError_t launch(int slots, int ctas, int warps, uint32_t* mem,
                   uint32_t* carry, uint32_t* mask, const uint4* prog,
                   int t_len, int nb, int chain, int per_slot,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(warps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        comefa_step_kernel<kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas, min(slots, kSlotsPerLayer),
                        (slots + kSlotsPerLayer - 1) / kSlotsPerLayer);
  config.blockDim = dim3(warps * 32, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMode == 2 ? ctas : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kMode == 2 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, comefa_step_kernel<kMode>, mem, carry, mask, prog, t_len, nb,
      chain, per_slot, slots);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the cluster of a chained slot of `groups` warps: 2, 4 or 8 CTAs
int cluster_ctas(int groups) {
  int ctas = 2;
  while (ctas * kMaxWarps < groups) ctas *= 2;
  return ctas;
}

}  // namespace

// Runs `t_len` decoded instructions on `slots` slots of `nb` blocks each,
// in place.  Returns the cudaError_t of the launch (0 on success); the
// kernel runs on `stream` and nothing here synchronises.  A chained slot
// holds at most kMaxCluster * kMaxWarps * 6 = 624 blocks (eight CTAs'
// shared memory).
extern "C" int comefa_step_launch(void* mem, void* carry, void* mask,
                                  const void* prog, int slots, int nb,
                                  int t_len, int chain, int per_slot,
                                  void* stream) {
  if (slots <= 0 || nb <= 0 || t_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (nb + kBlocksPerWarp - 1) / kBlocksPerWarp;
  if (chain && groups > kMaxCluster * kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = !chain ? groups
                   : groups <= kMaxWarps ? 1 : cluster_ctas(groups);
  auto* m = static_cast<uint32_t*>(mem);
  auto* c = static_cast<uint32_t*>(carry);
  auto* k = static_cast<uint32_t*>(mask);
  const auto* p = static_cast<const uint4*>(prog);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!chain) {         // one warp a CTA, no barrier in the loop
    err = launch<0>(slots, ctas, 1, m, c, k, p, t_len, nb, 0, per_slot, st);
  } else if (groups == 1) {
    err = launch<0>(slots, 1, 1, m, c, k, p, t_len, nb, 1, per_slot, st);
  } else if (ctas == 1) {
    err = launch<1>(slots, 1, groups, m, c, k, p, t_len, nb, 1, per_slot,
                    st);
  } else {
    err = launch<2>(slots, ctas, (groups + ctas - 1) / ctas, m, c, k, p,
                    t_len, nb, 1, per_slot, st);
  }
  return static_cast<int>(err);
}

// How many clusters of `ctas` CTAs of `warps` warps (a chained slot's
// launch) the card can hold at once, into *out; returns the cudaError_t.
extern "C" int comefa_step_max_clusters(int ctas, int warps, int* out) {
  const size_t smem = smem_bytes(warps);
  cudaError_t err = cudaFuncSetAttribute(
      comefa_step_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas, 1, 1);
  config.blockDim = dim3(warps * 32, 1, 1);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(out, comefa_step_kernel<2>, &config);
  return static_cast<int>(err);
}
