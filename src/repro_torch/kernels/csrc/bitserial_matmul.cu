// Fully bit-serial matmul for Hopper (sm_90a): both operands packed as
// bit-planes, products as AND + popcount - CoMeFa's two-operands-in-RAM
// multiply (paper Sec. III-E).  Replaces the Pallas TPU kernel
// src/repro/kernels/bitserial_matmul.py::bitserial_matmul (pl.pallas_call
// at :80).
//
//   y[m, n] = sx[m] * sw[n] * acc[m, n],
//   acc[m, n] = sum_{j<a, i<w} ca_j * cw_i * sum_k popc(xp[m, j, k] & wp[i, k, n])
//
// xp [M, a, K/32] and wp [w, K/32, N] are 32-bit words (int32 to PyTorch) in
// the layout of quant/bitplane.pack; c_b = 2^b, and -2^(bits-1) for the MSB
// plane.  sx f32 [M, 1], sw f32 [1, N], y f32 [M, N].  Any M and N, any K a
// multiple of 32, 1 <= a, w <= 8.
//
// acc is an exact integer: it is summed in unsigned 32-bit arithmetic,
// which wraps modulo 2^32 exactly as two's complement does, so the result
// is exact whenever the true sum fits in int32 - which the wrapper
// guarantees by rejecting K * 2^(a+w-2) >= 2^31 (|q_x| <= 2^(a-1),
// |q_w| <= 2^(w-1)).  It becomes a float once, then is scaled as the TPU
// kernel scales it: (float(acc) * sx[m]) * sw[n].
//
// What bounds it on this card: the function is M*K*N small integer
// products, far fewer operations than the tensor cores need time for
// while the w/8 bytes of each weight stream in, so its bound is those
// bytes: 3.00 us for one SmolLM-360M layer's 7 projections at M = 4,
// 8x8 bits, at the 3.35 TB/s of the H100 SXM data sheet (700 W).  What
// the design does about it:
//
//  * Products on the binary tensor cores.  mma.sync m16n8k256 .b1 with
//    .and.popc gives C[r, c] = sum_k popc(A[r, k] & B[k, c]) for 256 K-bits
//    a step, so the planes are stacked into the MMA's axes: A's rows are
//    (m, j) pairs, B's columns (n, i) pairs.  An m16 tile holds 16 / a
//    whole activation rows, an n8 tile 8 / w whole output columns, so no
//    output straddles two tiles (at a = w = 8, M = 4 the 32 stacked rows
//    fill two m16 tiles with no padding).  The epilogue forms
//    acc = sum_{j,i} ca_j * cw_i * C[(m, j), (n, i)] in uint32.
//  * Fragment layout (PTX ISA, m16n8k256 .b1): with g = lane / 4 and
//    t = lane % 4, A register 0 holds K-word t of row g, register 1 word t
//    of row g + 8, registers 2 and 3 word t + 4 of the same rows; B
//    register 0 holds K-word t of column g, register 1 word t + 4.  A and B
//    thus take the same K-word for the same k-range, and the bit order
//    inside a word is the same for both operands, so packed words go in as
//    they are.  A K that is not a multiple of 256 (SmolLM's 960 is 30
//    words: three steps and six) is loaded as zero words in both operands;
//    rows and columns past M*a and N*w are zero or ignored in the same way.
//  * One launch a call, no scratch.  A CTA of 4 warps owns 2 m16 tiles
//    (32 stacked rows) and 8 n8 tiles (64 stacked columns, two a warp) and
//    stages its operands through shared memory with coalesced loads
//    (words padded so that fragment reads are free of bank conflicts),
//    up to 4 k256 steps at once, every copy of a chunk in flight together
//    (cp.async, zero-filled past the edges), so a CTA waits on DRAM once.
//    K is split across the CTAs of a thread block cluster (at most 8, the
//    portable size): each CTA combines its own integer partial sums and
//    adds them with atomics into the leader CTA's shared memory through
//    distributed shared memory; after a cluster barrier the leader writes
//    y.  The barrier that lets them start adding (the leader's sum zeroed,
//    every CTA running) is arrived at before the loads and waited on only
//    after the MMAs.  The sum is an integer, so its order does not change
//    the result.
//  * Enough CTAs at decode shapes.  The split (the wrapper's
//    bitserial_matmul.geometry) is chosen so that about four CTAs land on
//    each SM: SmolLM's N = 320 at 8 bits is 2,560
//    stacked columns, 40 column tiles, and its K = 960 (4 steps) gives
//    clusters of 4, so 160 CTAs; N = 2560 gives 320 tiles in clusters of
//    2; K = 2560 (10 steps) with N = 960 gives 120 tiles in clusters of 5.
//
// Left for later: at large M the B tile is read again by every row tile,
// so wgmma .b1 (m64 tiles from shared memory) with TMA loads would keep
// the weight read once; a persistent grid would hide the fixed launch and
// cluster-barrier latency that dominates at decode shapes.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bitserial_matmul.py does it at first use) and called through the
// plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kMTiles = 2;             // m16 tiles a CTA
constexpr int kNTiles = 8;             // n8 tiles a CTA, two a warp
constexpr int kRowsCta = 16 * kMTiles; // stacked rows a CTA
constexpr int kColsCta = 8 * kNTiles;  // stacked columns a CTA
constexpr int kStepWords = 8;          // 256 K-bits an MMA step
constexpr int kChunk = 4;              // k256 steps staged at once
constexpr int kMaxCluster = 8;         // portable cluster size
constexpr int kCtasPerSm = 4;          // CTAs an SM can hold (smem, bounds)
// shared-memory strides: a fragment read of lane (g, t) hits bank
// (8 t + g) mod 32, distinct over the warp
constexpr int kAStride = kRowsCta + 8;
constexpr int kBStride = kColsCta + 8;
constexpr int kCStride = kColsCta + 1;
constexpr int kMaxOut = kRowsCta * kColsCta;   // outputs a CTA at a = w = 1

// plane weight c_b of a signed `bits`-bit value, modulo 2^32
__host__ __device__ constexpr uint32_t coef(int b, int bits) {
  return b == bits - 1 ? 0u - (1u << b) : (1u << b);
}

__device__ __forceinline__ float scaled(uint32_t acc, float sx, float sw) {
  return (__int2float_rn(static_cast<int>(acc)) * sx) * sw;
}

// one 4-byte asynchronous copy into shared memory; zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t* smem_dst,
                                          const uint32_t* gmem_src,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(valid ? 4 : 0));
}

// d += popc(A & B) over one 16 x 8 x 256-bit tile on the tensor cores
__device__ __forceinline__ void mma_and_popc(uint32_t (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bitserial_matmul_kernel(const uint32_t* __restrict__ xp,
                        const uint32_t* __restrict__ wp,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw, float* __restrict__ y,
                        int m, int words, int n, int a, int w,
                        int steps_per_cta) {
  __shared__ uint32_t as[kChunk][kStepWords][kAStride];
  __shared__ uint32_t bs[kChunk][kStepWords][kBStride];
  __shared__ uint32_t cs[kRowsCta][kCStride];
  __shared__ uint32_t sum[kMaxOut];        // the leader's: the cluster's sum

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = 16 / a, nt = 8 / w;       // whole rows / columns a tile
  const int mrows = kMTiles * mt, ncols = kNTiles * nt;
  const int m0 = blockIdx.y * mrows, n0 = blockIdx.x * ncols;
  const int steps = (words + kStepWords - 1) / kStepWords;
  const int s_end = min(steps, (rank + 1) * steps_per_cta);
  const int outs = mrows * ncols;
  if (rank == 0)
    for (int o = tid; o < outs; o += kThreads) sum[o] = 0u;
  // the leader's zeroed sum, and every CTA of the cluster running, are
  // awaited only before the partial sums go out
  asm volatile("barrier.cluster.arrive;\n" ::);

  uint32_t acc[kMTiles][2][4];
#pragma unroll
  for (int tm = 0; tm < kMTiles; ++tm)
#pragma unroll
    for (int tn = 0; tn < 2; ++tn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[tm][tn][q] = 0u;

  for (int s0 = rank * steps_per_cta; s0 < s_end; s0 += kChunk) {
    const int ns = min(kChunk, s_end - s0);
    __syncthreads();                        // the last chunk is consumed
    // every copy of the chunk is in flight at once (cp.async), so the
    // DRAM latency is paid once a chunk, not once a word
    // A: stacked row (m, j) of the CTA, 8 words a step (32 bytes a row);
    // padding rows and words past K are zero
    for (int e = tid; e < ns * kStepWords * kRowsCta; e += kThreads) {
      const int kwl = e & (kStepWords - 1);
      const int r = (e / kStepWords) % kRowsCta;
      const int st = e / (kStepWords * kRowsCta);
      const int kw = (s0 + st) * kStepWords + kwl;
      const int rr = r & 15, ml = rr / a;
      const int mm = m0 + (r >> 4) * mt + ml;
      const bool ok = ml < mt && mm < m && kw < words;
      cp_async4(&as[st][kwl][r],
                ok ? xp + (static_cast<size_t>(mm) * a + (rr - ml * a)) *
                              words + kw
                   : xp,
                ok);
    }
    // B: stacked column (n, i), coalesced along n; columns past N and
    // words past K are zero
    for (int e = tid; e < ns * kStepWords * w * ncols; e += kThreads) {
      const int nl = e % ncols;
      int rest = e / ncols;
      const int i = rest % w;
      rest /= w;
      const int kwl = rest & (kStepWords - 1);
      const int st = rest / kStepWords;
      const int kw = (s0 + st) * kStepWords + kwl;
      const int nn = n0 + nl;
      const bool ok = nn < n && kw < words;
      const int tile = nl / nt;
      cp_async4(&bs[st][kwl][tile * 8 + (nl - tile * nt) * w + i],
                ok ? wp + (static_cast<size_t>(i) * words + kw) * n + nn
                   : wp,
                ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // the 8 - nt*w unused columns of each n8 tile (w = 3, 5, 6, 7)
    const int pad = 8 - nt * w;
    for (int e = tid; e < ns * kStepWords * kNTiles * pad; e += kThreads) {
      const int c = e % pad;
      const int tile = (e / pad) % kNTiles;
      const int sk = e / (pad * kNTiles);
      bs[sk / kStepWords][sk % kStepWords][tile * 8 + nt * w + c] = 0u;
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    for (int st = 0; st < ns; ++st) {
      uint32_t bf[2][2];
#pragma unroll
      for (int tn = 0; tn < 2; ++tn) {
        const int col = (warp * 2 + tn) * 8 + g;
        bf[tn][0] = bs[st][t][col];
        bf[tn][1] = bs[st][t + 4][col];
      }
#pragma unroll
      for (int tm = 0; tm < kMTiles; ++tm) {
        const int row = tm * 16 + g;
        const uint32_t af[4] = {as[st][t][row], as[st][t][row + 8],
                                as[st][t + 4][row], as[st][t + 4][row + 8]};
#pragma unroll
        for (int tn = 0; tn < 2; ++tn) mma_and_popc(acc[tm][tn], af, bf[tn]);
      }
    }
  }

  // C fragments -> shared memory: lane (g, t) holds rows g and g + 8,
  // columns 2t and 2t + 1 of each tile
#pragma unroll
  for (int tm = 0; tm < kMTiles; ++tm)
#pragma unroll
    for (int tn = 0; tn < 2; ++tn) {
      const int row = tm * 16 + g;
      const int col = (warp * 2 + tn) * 8 + 2 * t;
      cs[row][col] = acc[tm][tn][0];
      cs[row][col + 1] = acc[tm][tn][1];
      cs[row + 8][col] = acc[tm][tn][2];
      cs[row + 8][col + 1] = acc[tm][tn][3];
    }
  __syncthreads();
  // this CTA's integer partial of each output, the planes' weighted sum,
  // added into the leader's shared memory through the cluster: a group of
  // `lanes` (a rounded up to a power of two) adjacent lanes takes one
  // output, one activation plane a lane (w weight planes, unrolled so that
  // the loads overlap), and sums the group with shuffles
  asm volatile("barrier.cluster.wait;\n" ::);
  uint32_t* lead = cluster.map_shared_rank(sum, 0);
  const int lanes = a > 4 ? 8 : a > 2 ? 4 : a;
  for (int base = warp * 32; base < outs * lanes; base += kThreads) {
    const int o = (base + lane) / lanes, j = lane & (lanes - 1);
    uint32_t v = 0u;
    if (o < outs && j < a) {
      const int ml = o / ncols, nl = o - ml * ncols;
      const int r = (ml / mt) * 16 + (ml % mt) * a + j;
      const int c0 = (nl / nt) * 8 + (nl % nt) * w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < w) v += coef(i, w) * cs[r][c0 + i];
      v *= coef(j, a);
    }
    for (int d = lanes >> 1; d > 0; d >>= 1)
      v += __shfl_xor_sync(0xFFFFFFFFu, v, d);
    if (j == 0 && o < outs) atomicAdd(lead + o, v);
  }
  cluster.sync();               // every partial has landed in the leader
  if (rank == 0) {
    for (int o = tid; o < outs; o += kThreads) {
      const int mm = m0 + o / ncols, nn = n0 + o % ncols;
      if (mm < m && nn < n)
        y[static_cast<size_t>(mm) * n + nn] = scaled(sum[o], sx[mm], sw[nn]);
    }
  }
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

}  // namespace

// Launches on `stream` and returns the first cudaError_t (0 on success).
// Pointers are device pointers to contiguous arrays: xp words [m, a_bits,
// k/32], wp words [w_bits, k/32, n], sx f32 [m, 1], sw f32 [1, n], y f32
// [m, n].  `splits` CTAs of a cluster share K (1..8; the wrapper's
// bitserial_matmul.geometry picks it so that about four CTAs land on each
// SM).  One kernel launch; nothing else is written.
extern "C" int bitserial_matmul_launch(const void* xp, const void* wp,
                                       const void* sx, const void* sw,
                                       void* y, int m, int k, int n,
                                       int a_bits, int w_bits, int splits,
                                       void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || a_bits < 1 ||
      a_bits > 8 || w_bits < 1 || w_bits > 8 || splits < 1 ||
      splits > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = k / 32;
  const int m_tiles = ceil_div(m, kMTiles * (16 / a_bits));
  const int n_tiles = ceil_div(n, kNTiles * (8 / w_bits));
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int per = ceil_div(ceil_div(words, kStepWords), splits);

  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_tiles, m_tiles, splits);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &config, bitserial_matmul_kernel, static_cast<const uint32_t*>(xp),
      static_cast<const uint32_t*>(wp), static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<float*>(y), m, words, n,
      a_bits, w_bits, per);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
