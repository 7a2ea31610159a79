// CoMeFa simulator step kernel for Hopper (sm_90a).  Replaces the Pallas TPU
// kernel src/repro/kernels/comefa_step.py::run_packed (pl.pallas_call at
// :101), which carried the bit-packed CoMeFa engine: it executes T encoded
// instructions, in order, on the packed state of S independent grid slots.
//
//   mem   [S, nb, 128, 5]  32-bit words: lane c of a 160-lane row is bit
//                          c%32 of word c/32 (core/comefa/engine_packed.py)
//   carry [S, nb, 5], mask [S, nb, 5]   the PE latches, same packing
//   prog  [T, 16] int32 (one stream for every slot) or [S, T, 16]
//         (per_slot: slot s runs its own stream), the engine field matrix
//         of core/comefa/isa.py: src1 src2 dst tt pred w1 w2 wp1 wp2 c_en
//         c_rst m_en ext_bit b_ext dst2 pred2
//
// Each instruction computes, word-parallel over 32 lanes, what
// engine_packed.datapath computes: read rows src1 and src2 (B optionally
// replaced by ext_bit), the TR truth-table mux as four minterm masks, the
// X gate against the (optionally reset) carry, CGEN, the carry and mask
// latches, write enables predicated on the *latched* mask/carry, and the
// W1_RIGHT / W2_LEFT shift network as funnel shifts whose seam words cross
// into the neighbouring block only when `chain` is set and never cross a
// slot.  Port 1 writes dst first; port 2 then reads dst2 and writes it, so
// dst2 == dst sees port 1's result.  An all-zero field row is a no-op.
//
// What bounds it on this card: the T instructions are a dependent chain on
// a tiny state (2.5 KiB a block), so the kernel is bound by latency, not
// by bytes or operations: each instruction reads rows that an earlier one
// may have written, through shared memory.  The least time is T times the
// dependent shared-memory load -> ALU -> store step (the "dependency
// bound"); the bytes (state read and written once, plus the program) take
// far less.  The design keeps that chain short and on chip: one CTA per
// slot holds the slot's whole state in shared memory, laid out [row][word]
// so a warp reads a row conflict-free; one thread owns one (block, word)
// column of every row, with carry and mask in registers, so row reads and
// writes never cross threads, and each instruction issues all four of its
// row reads (src1, src2, dst, dst2) at once.  The program is staged into
// shared memory 256 instructions (16 KiB) at a time, so each instruction's
// 16 fields are read from global memory once per CTA and never wait on L2
// inside the chain; the next instruction's fields are read from shared
// memory while the current one runs.  Only the shift network needs a neighbour's word: S is
// published to a double-buffered shared array and one barrier is taken -
// and only on instructions that shift, which the whole CTA knows from the
// same fields.  Later designs: one CTA per (slot, block) when `chain` is
// false, so 16x more CTAs fill the card, and warp-shuffle seams in place
// of the barrier.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/comefa_step.py does it at first use) and called through the
// plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;     // wordlines per block
constexpr int kWords = 5;      // 32-lane words per 160-lane row
constexpr int kFields = 16;    // engine fields per instruction

constexpr int kProgTile = 256; // instructions staged in shared memory at once
static_assert(kFields * sizeof(int) == 4 * sizeof(int4), "a row is 4 int4");

__device__ __forceinline__ uint32_t all_if(bool c) {
  return c ? 0xFFFFFFFFu : 0u;
}

// predicate select (mux P) on the latched values; 0..3, anything else 0
__device__ __forceinline__ uint32_t predicate(int sel, uint32_t mask,
                                              uint32_t carry) {
  return sel == 0 ? 0xFFFFFFFFu
       : sel == 1 ? mask
       : sel == 2 ? carry
       : sel == 3 ? ~carry
       : 0u;
}

__global__ void comefa_step_kernel(uint32_t* __restrict__ mem,
                                   uint32_t* __restrict__ carry_io,
                                   uint32_t* __restrict__ mask_io,
                                   const int4* __restrict__ prog,
                                   int t_len, int nb, int chain,
                                   int per_slot) {
  // shared memory: a tile of the program [kProgTile][4] int4, the slot's
  // state [kRows][lanes] words, then the shift exchange s[2][lanes]
  extern __shared__ int4 smem[];
  const int lanes = nb * kWords;            // words of one row of the slot
  int4* prog_s = smem;
  uint32_t* state = reinterpret_cast<uint32_t*>(smem + kProgTile * 4);
  uint32_t* sbuf = state + kRows * lanes;
  const int tid = threadIdx.x;              // = block * kWords + word
  const int blk = tid / kWords;
  const int word = tid - blk * kWords;
  const int slot = blockIdx.x;

  // stage the slot's state: coalesced over its contiguous [nb, 128, 5]
  uint32_t* gmem = mem + static_cast<size_t>(slot) * nb * kRows * kWords;
  const int n_state = nb * kRows * kWords;
  for (int i = tid; i < n_state; i += lanes) {
    const int b = i / (kRows * kWords);
    const int rem = i - b * kRows * kWords;
    const int r = rem / kWords;
    const int w = rem - r * kWords;
    state[r * lanes + b * kWords + w] = gmem[i];
  }
  uint32_t carry = carry_io[slot * lanes + tid];
  uint32_t mask = mask_io[slot * lanes + tid];

  const int4* p = prog + (per_slot ? static_cast<size_t>(slot) * t_len * 4
                                   : 0);
  const bool hi_edge = word == kWords - 1 && !(chain && blk < nb - 1);
  const bool lo_edge = word == 0 && !(chain && blk > 0);
  int phase = 0;
  for (int t0 = 0; t0 < t_len; t0 += kProgTile) {
    // the program, a tile at a time: every thread reads its fields from
    // shared memory instead of waiting on L2 once an instruction
    const int n = min(kProgTile, t_len - t0);
    __syncthreads();                        // the last tile is consumed
    for (int i = tid; i < 4 * n; i += lanes) prog_s[i] = __ldg(p + 4 * t0 + i);
    __syncthreads();
    // the next instruction's fields are loaded while this one runs
    int4 n0 = prog_s[0], n1 = prog_s[1], n2 = prog_s[2], n3 = prog_s[3];
    for (int t = 0; t < n; ++t) {
      const int4 f0 = n0, f1 = n1, f2 = n2, f3 = n3;
      if (t + 1 < n) {
        n0 = prog_s[4 * t + 4];
        n1 = prog_s[4 * t + 5];
        n2 = prog_s[4 * t + 6];
        n3 = prog_s[4 * t + 7];
      }
      const int src1 = f0.x & (kRows - 1), src2 = f0.y & (kRows - 1);
      const int dst = f0.z & (kRows - 1), tt = f0.w;
      const int pred1_sel = f1.x, w1_sel = f1.y, w2_sel = f1.z;
      const bool wp1 = f1.w == 1, wp2 = f2.x == 1;
      const bool c_en = f2.y == 1, c_rst = f2.z == 1, m_en = f2.w == 1;
      const bool ext_bit = f3.x == 1, b_ext = f3.y == 1;
      const int dst2 = f3.z & (kRows - 1), pred2_sel = f3.w;

      // ---- read: both ports and both destinations at once (this thread
      // is the only writer of its column, so nothing changes them before
      // the writes below) --------------------------------------------------
      const uint32_t a = state[src1 * lanes + tid];
      const uint32_t b_read = state[src2 * lanes + tid];
      const uint32_t old1 = state[dst * lanes + tid];
      const uint32_t old2_row = state[dst2 * lanes + tid];

      // ---- compute --------------------------------------------------------
      const uint32_t b = b_ext ? all_if(ext_bit) : b_read;
      const uint32_t na = ~a, nb_ = ~b;
      const uint32_t tr = (all_if(tt & 1) & na & nb_) |
                          (all_if(tt & 2) & na & b) |
                          (all_if(tt & 4) & a & nb_) |
                          (all_if(tt & 8) & a & b);
      const uint32_t c_in = c_rst ? 0u : carry;
      const uint32_t s = tr ^ c_in;                         // gate X
      const uint32_t cgen = (a & b) | (c_in & (a ^ b));     // CGEN
      const uint32_t we1 = wp1 ? predicate(pred1_sel, mask, carry) : 0u;
      const uint32_t we2 = wp2 ? predicate(pred2_sel, mask, carry) : 0u;

      // ---- shift network: neighbour words through shared memory --------
      uint32_t from_right = 0u, from_left = 0u;
      if ((wp1 && w1_sel == 2) || (wp2 && w2_sel == 2)) {  // uniform per CTA
        uint32_t* sb = sbuf + phase * lanes;
        phase ^= 1;
        sb[tid] = s;
        __syncthreads();
        const uint32_t hi = hi_edge ? 0u : sb[tid + 1];
        const uint32_t lo = lo_edge ? 0u : sb[tid - 1];
        from_right = (s >> 1) | (hi << 31);
        from_left = (s << 1) | (lo >> 31);
      }
      // W1: S / right neighbour; W2: the latched (pre-update) carry / left
      // neighbour; d_in and W2_ZERO drive 0
      const uint32_t val1 = w1_sel == 0 ? s
                                        : (w1_sel == 2 ? from_right : 0u);
      const uint32_t val2 = w2_sel == 0 ? carry
                                        : (w2_sel == 2 ? from_left : 0u);

      // ---- write-back: port 1, then port 2 on port 1's result ----------
      const uint32_t new1 = (old1 & ~we1) | (val1 & we1);
      state[dst * lanes + tid] = new1;
      const uint32_t old2 = dst2 == dst ? new1 : old2_row;
      state[dst2 * lanes + tid] = (old2 & ~we2) | (val2 & we2);

      if (c_en) carry = cgen;
      if (m_en) mask = tr;
    }
  }

  __syncthreads();
  for (int i = tid; i < n_state; i += lanes) {
    const int b = i / (kRows * kWords);
    const int rem = i - b * kRows * kWords;
    const int r = rem / kWords;
    const int w = rem - r * kWords;
    gmem[i] = state[r * lanes + b * kWords + w];
  }
  carry_io[slot * lanes + tid] = carry;
  mask_io[slot * lanes + tid] = mask;
}

}  // namespace

// Runs `t_len` instructions on `slots` slots of `nb` blocks each, in place.
// Returns the cudaError_t of the launch (0 on success); the kernel runs on
// `stream` and nothing here synchronises.
extern "C" int comefa_step_launch(void* mem, void* carry, void* mask,
                                  const void* prog, int slots, int nb,
                                  int t_len, int chain, int per_slot,
                                  void* stream) {
  const int lanes = nb * kWords;
  if (slots <= 0 || nb <= 0 || lanes > 1024 || t_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = kProgTile * 4 * sizeof(int4) +
                      static_cast<size_t>(kRows + 2) * lanes *
                      sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        comefa_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  comefa_step_kernel<<<slots, lanes, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(mem), static_cast<uint32_t*>(carry),
      static_cast<uint32_t*>(mask), static_cast<const int4*>(prog), t_len,
      nb, chain, per_slot);
  return static_cast<int>(cudaGetLastError());
}
