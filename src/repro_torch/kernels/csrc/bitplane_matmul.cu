// Bit-plane matmul for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// src/repro/kernels/bitplane_matmul.py::bitplane_matmul (:69, pl.pallas_call
// at :87), which every packed projection of models/common.linear reaches.
//
//   y[M, N] = (x[M, K] @ Q[K, N]) * scale[1, N],   Q = sum_i c_i * plane_i
//
// with c_i = 2^i and the MSB plane weighted -2^(bits-1).  The planes are
// [bits, K/32, N] 32-bit words in the layout of quant/bitplane.pack: lane
// k of column n is bit k%32 of word [i, k/32, n].  x is f32 or bf16 and is
// widened to f32 in registers (exact); y is f32 or bf16, rounded once in
// the epilogue with __float2bfloat16_rn (round to nearest even), as the TPU
// kernel takes x in its own dtype and has an out_dtype.  scale is f32 and
// the sum is taken in f32.  Any M and N; K a multiple of 32; bits 1-8.
//
// What bounds it on this card: at decode (M <= 8) each weight feeds at
// most 8 multiply-adds, so the function is bound by its bytes, bits/8 *
// K * N of planes: 0.10-0.75 us a call at SmolLM-360M's shapes and M = 4
// over the 3.35 TB/s of the H100 SXM data sheet.  At prefill (M = 32 in
// the smoke run) it stays bound by bytes: 0.12-0.87 us, against 0.02-0.48
// us for its products on the tensor cores (three bf16 products a weight
// for an f32 x, one for a bf16 x, at 989 TFLOP/s).  Reaching that needs
// the whole card busy and one DRAM round trip a CTA; the design:
//
//  * K split across CTAs.  A CTA owns 32 columns and a contiguous slice of
//    `per` K-words; the wrapper (kernels/bitplane_matmul.geometry) picks
//    the split, at most 8 slices, so that each SmolLM shape launches
//    80-320 CTAs on the 132 SMs.  A CTA's 4 warps share its slice word by
//    word.
//  * All of a CTA's bytes in flight at once.  Its plane slice (bits x per
//    x 32 words, 16-byte cp.async where the columns allow) and its x slice
//    (16-byte cp.async, as x lies: f32 or bf16) are in flight before any
//    compute.  On the CUDA-core path each warp copies its own words, one
//    cp.async group a word, and starts on a word as soon as it has landed,
//    with no barrier across the CTA; a bf16 x is widened once in place.
//    The MMA path stages 8 words at a time for the whole CTA.  Either way a
//    CTA waits on DRAM about once at every SmolLM shape.
//  * A cheaper rebuild.  A lane's `bits` plane words (one column, 32 k) go
//    through a bit-matrix transpose, three butterfly stages of shift/xor on
//    word pairs, after which byte g of word j holds the bits of weight
//    k = 8g + j.  One xor per word turns the two's complement into offset
//    binary, and one prmt into the mantissa of 2^23 plus one add makes each
//    byte an exact float: about 130 instructions for 32 weights where the
//    bit-by-bit rebuild took about 700.  Bytes g of words j..j+3 are four
//    consecutive k, so x comes back from shared memory, as it was copied,
//    in 16-byte broadcasts, and a lane walks k in order.
//  * A fixed order of sums.  Each lane sums its words in order, the warps'
//    partials meet in warp order, and the splits' in split order, so a
//    result never changes between runs.  The splits meet in a thread block
//    cluster of at most 8 CTAs along K: each CTA pushes its partial into
//    the leader's inbox through distributed shared memory, and the leader
//    sums the inbox in rank order.  Only the cluster barrier after the
//    push is on the path (the one that says every CTA is running is
//    arrived at when the kernel starts).  The cluster caps the split at 8
//    (80 CTAs at N = 320), yet it measured faster than partials through a
//    scratch tensor with a counter electing the last CTA, at seven of the
//    eight SmolLM shapes at M = 4 and 32 (PERF.md).
//  * M > 8 on the tensor cores.  A CTA of 32 rows rebuilds its weight tile
//    once into shared memory as bf16 (integers in [-128, 127] are exact in
//    bf16) and runs mma.sync m16n8k16 with f32 accumulation; an f32 x is
//    split, as its fragments are read, into three bf16 parts, hi + mid +
//    lo, which hold its 24 bits exactly, and each part is its own product
//    (hi, mid, lo in that order).  A bf16 x is one part.  The
//    products are exact and the tensor cores' additions round, so the
//    result stays within (K + 2) * 2^-23 * (|x| @ |q|) * scale of the exact
//    sum, and is exact on integer x.  M <= 8 takes the CUDA-core path
//    above, whose each weight is rebuilt once per CTA and used M times.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bitplane_matmul.py does it at first use) and called through
// the plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCols = 32;              // columns a CTA: one a lane
constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBits = 8;
constexpr int kWarpWords = 4;          // K-words a warp stages at once
constexpr int kMmaChunk = 8;           // K-words staged at once (M > 8)
constexpr int kMmaRows = 32;           // rows a CTA on the MMA path
// 32-bit words of one bf16 row of the MMA path's tiles in shared memory:
// 132 = 4 (mod 32), so fragment reads of lane (g, t) hit bank 4g + t
constexpr int kStride = kMmaChunk * 16 + 4;
constexpr int kMaxCluster = 8;

struct Args {
  const void* x;          // f32 or bf16 [m, k]
  const uint32_t* planes; // [bits, k/32, n]
  const float* scale;     // [1, n]
  void* y;                // f32 or bf16 [m, n]
  int m, k, n, bits, x_bf16, y_bf16, per, splits;
};

__device__ __forceinline__ void store_y(const Args& a, int row, int col,
                                        float sum) {
  const float v = sum * a.scale[col];
  const size_t i = static_cast<size_t>(row) * a.n + col;
  if (a.y_bf16)
    static_cast<__nv_bfloat16*>(a.y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(a.y)[i] = v;
}

// one 16-byte asynchronous copy into shared memory; zero when !valid
__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src,
                                           bool valid = true) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(valid ? 16 : 0));
}

// one 4-byte asynchronous copy into shared memory; zero when !valid
__device__ __forceinline__ void cp_async4(void* smem_dst,
                                          const void* gmem_src, bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(valid ? 4 : 0));
}

// Start copying plane words [kw0, kw0 + nw) of columns col0.. into
// ps[(i * nw + kw) * 32 + c], the copies spread over `threads` threads
// from `tid` (a CTA, or a warp's lanes); columns past n are zero.  (The
// caller commits the group.)
__device__ __forceinline__ void stage_planes(uint32_t* ps, const Args& a,
                                             int col0, int kw0, int nw,
                                             int tid, int threads) {
  const int words = a.k / 32;
  const bool vec = a.n % 4 == 0 && col0 + kCols <= a.n &&
                   (reinterpret_cast<uintptr_t>(a.planes) & 15) == 0;
  if (vec) {
    for (int e = tid; e < a.bits * nw * 8; e += threads) {
      const int q = e & 7, row = e >> 3;          // row = i * nw + kw
      const int i = row / nw, kw = row - i * nw;
      cp_async16(ps + row * kCols + q * 4,
                 a.planes + (static_cast<size_t>(i) * words + kw0 + kw) *
                                a.n + col0 + q * 4);
    }
  } else {
    for (int e = tid; e < a.bits * nw * kCols; e += threads) {
      const int c = e & 31, row = e >> 5;
      const int i = row / nw, kw = row - i * nw;
      const bool ok = col0 + c < a.n;
      cp_async4(ps + e,
                ok ? a.planes + (static_cast<size_t>(i) * words + kw0 + kw) *
                                    a.n + col0 + c
                   : a.planes,
                ok);
    }
  }
}

// Start copying x rows [row0, row0 + rows) of K-words [kw0, kw0 + nw) as
// they are (f32 or bf16), 16 bytes a copy, into dst + r * row_bytes; rows
// past m are zero.  The wrapper hands over a 16-byte aligned x, and a
// row's slice starts at a multiple of 64 bytes.  Threads as stage_planes.
__device__ __forceinline__ void stage_x(char* dst, int row_bytes,
                                        const Args& a, int row0, int rows,
                                        int kw0, int nw, int tid,
                                        int threads) {
  const int esz = a.x_bf16 ? 2 : 4;
  const int chunks = nw * 32 * esz / 16;          // 16-byte copies a row
  for (int e = tid; e < rows * chunks; e += threads) {
    const int r = e / chunks, q = e - r * chunks;
    const bool ok = row0 + r < a.m;
    const size_t at = (static_cast<size_t>(ok ? row0 + r : 0) * a.k +
                       static_cast<size_t>(kw0) * 32) * esz;
    cp_async16(dst + r * row_bytes + q * 16,
               static_cast<const char*>(a.x) + at + q * 16, ok);
  }
}

__device__ __forceinline__ void swap_bits(uint32_t& lo, uint32_t& hi, int s,
                                          uint32_t mask) {
  const uint32_t t = ((lo >> s) ^ hi) & mask;
  hi ^= t;
  lo ^= t << s;
}

// The bitplane words of one column, w[i] = plane i (bit 8g + j = weight
// 8g + j), become weight bytes: on return byte g of w[j] holds weight
// 8g + j's bits, bit i from plane i, in offset binary (xor `sign`).  Each
// byte of the four is an 8 x 8 bit matrix transposed by the butterfly.
__device__ __forceinline__ void rebuild(uint32_t (&w)[kMaxBits],
                                        uint32_t sign) {
#pragma unroll
  for (int i = 0; i < 4; ++i) swap_bits(w[i], w[i + 4], 4, 0x0F0F0F0Fu);
#pragma unroll
  for (int i = 0; i < 8; i += (i & 1) ? 3 : 1)      // 0, 1, 4, 5
    swap_bits(w[i], w[i + 2], 2, 0x33333333u);
#pragma unroll
  for (int i = 0; i < 8; i += 2) swap_bits(w[i], w[i + 1], 1, 0x55555555u);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] ^= sign;
}

// byte g of an offset-binary word as an exact float: into the mantissa of
// 2^23, less 2^23 + 2^(bits-1)
__device__ __forceinline__ float weight(uint32_t v, int g, float bias) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + g)) - bias;
}

// With a cluster, the CTAs of one tile push their partial sums into the
// leader's inbox: "every CTA of the cluster is running" is arrived at when
// the kernel starts (cluster_started) and awaited just before the push
// (cluster_wait), so only the barrier after the push is on the path.
__device__ __forceinline__ void cluster_started() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Where this CTA's partial sums go: the leader's inbox slot for its rank
// (cluster), or its own `tile` (one split).
template <bool kCluster>
__device__ __forceinline__ float* partial_slot(float* tile, int outs) {
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();
    return cluster.map_shared_rank(tile, 0) +
           static_cast<int>(cluster.block_rank()) * outs;
  } else {
    return tile;
  }
}

// The CTA's partial sums, written to partial_slot (rows row0.., columns
// col0..): with one split they are the result; else they meet the other
// splits' in split order, in the leader's inbox.
template <bool kCluster>
__device__ __forceinline__ void finish(const Args& a, float* tile, int rows,
                                       int row0, int col0) {
  const int outs = rows * kCols;
  if constexpr (kCluster) {
    cg::this_cluster().sync();       // every partial is in the inbox
    if (cg::this_cluster().block_rank() != 0) return;
  } else {
    __syncthreads();
  }
  for (int t = threadIdx.x; t < outs; t += kThreads) {
    const int row = row0 + t / kCols, col = col0 + t % kCols;
    float sum = tile[t];
    if constexpr (kCluster)
      for (int sp = 1; sp < a.splits; ++sp) sum += tile[sp * outs + t];
    if (row < a.m && col < a.n) store_y(a, row, col, sum);
  }
}

__device__ __forceinline__ void wait_groups_but(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// M <= ROWS <= 8: CUDA cores, each weight rebuilt once and used M times.
// Warp w takes K-words kw_begin + w, + 4, ... of the CTA's slice and stages
// each of them itself (one cp.async group a word, up to kWarpWords at
// once), so it starts on a word as soon as that word has landed.
template <int ROWS, bool kCluster>
__global__ void __launch_bounds__(kThreads)
bitplane_gemv_kernel(const Args a) {
  __shared__ __align__(16) uint32_t ps[kWarps][kWarpWords][kMaxBits * kCols];
  __shared__ __align__(16) float xs[kWarps][kWarpWords][ROWS * 32];
  __shared__ float part[kWarps][ROWS * kCols];
  // the CTA's partial sums; with a cluster, the leader's inbox of them all
  __shared__ float tile[(kCluster ? kMaxCluster : 1) * ROWS * kCols];
  if constexpr (kCluster) cluster_started();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kCols;
  const int words = a.k / 32;
  const int kw_begin = blockIdx.z * a.per;
  const int kw_end = min(words, kw_begin + a.per);
  const uint32_t sign = (1u << (a.bits - 1)) * 0x01010101u;
  const float bias = 8388608.f + static_cast<float>(1 << (a.bits - 1));
  const int esz = a.x_bf16 ? 2 : 4;

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int base = kw_begin + warp; base < kw_end;
       base += kWarps * kWarpWords) {
    const int cnt = min(kWarpWords, (kw_end - base + kWarps - 1) / kWarps);
    for (int i = 0; i < cnt; ++i) {              // word base + 4i: group i
      const int kw = base + kWarps * i;
      stage_planes(ps[warp][i], a, col0, kw, 1, lane, 32);
      stage_x(reinterpret_cast<char*>(xs[warp][i]), 32 * esz, a, 0, ROWS, kw,
              1, lane, 32);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int i = 0; i < cnt; ++i) {
      wait_groups_but(cnt - 1 - i);
      __syncwarp();
      float* xw = xs[warp][i];
      if (a.x_bf16) {                            // widen in place, exactly
        const uint16_t* raw = reinterpret_cast<const uint16_t*>(xw);
        uint32_t v[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) v[r] = raw[r * 32 + lane];
        __syncwarp();
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          xw[r * 32 + lane] = __uint_as_float(v[r] << 16);
        __syncwarp();
      }
      uint32_t w[kMaxBits];
#pragma unroll
      for (int p = 0; p < kMaxBits; ++p)
        w[p] = p < a.bits ? ps[warp][i][p * kCols + lane] : 0u;
      rebuild(w, sign);
      // xv[r * 8 + 2g + j4 / 4] = x[r][8g + j4 .. +3]; k = 8g + j in order
      const float4* xv = reinterpret_cast<const float4*>(xw);
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j4 = 0; j4 < 8; j4 += 4) {
          const float q0 = weight(w[j4], g, bias),
                      q1 = weight(w[j4 + 1], g, bias),
                      q2 = weight(w[j4 + 2], g, bias),
                      q3 = weight(w[j4 + 3], g, bias);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 x4 = xv[r * 8 + 2 * g + j4 / 4];
            acc[r] = fmaf(x4.x, q0, acc[r]);
            acc[r] = fmaf(x4.y, q1, acc[r]);
            acc[r] = fmaf(x4.z, q2, acc[r]);
            acc[r] = fmaf(x4.w, q3, acc[r]);
          }
        }
    }
    __syncwarp();                    // this round's buffers are consumed
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) part[warp][r * kCols + lane] = acc[r];
  __syncthreads();
  float* slot = partial_slot<kCluster>(tile, ROWS * kCols);
  for (int t = threadIdx.x; t < ROWS * kCols; t += kThreads) {
    float sum = part[0][t];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) sum += part[wi][t];
    slot[t] = sum;
  }
  finish<kCluster>(a, tile, ROWS, 0, col0);
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The f32 pair (v0, v1) as three bf16 pairs hi + mid + lo that hold its
// 24 bits exactly (each part rounds to nearest even what the last left).
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = bf16x2(v0, v1);
  v0 -= __uint_as_float(hi << 16);
  v1 -= __uint_as_float(hi & 0xFFFF0000u);
  mid = bf16x2(v0, v1);
  v0 -= __uint_as_float(mid << 16);
  v1 -= __uint_as_float(mid & 0xFFFF0000u);
  lo = bf16x2(v0, v1);
}

// x rows in shared memory: 32-bit words a row (bf16 pairs, 132 = 4 mod 32)
// or floats a row (f32, 264 = 8 mod 32: a float2 fragment read is two
// conflict-free wavefronts)
constexpr int kXStrideF32 = kMmaChunk * 32 + 8;

template <bool XBF16>
size_t mma_smem(bool cluster) {
  return (kMaxBits * kMmaChunk * kCols + kCols * kStride +
          kMmaRows * (XBF16 ? kStride : kXStrideF32) +
          (cluster ? kMaxCluster : 1) * kMmaRows * kCols) * sizeof(uint32_t);
}

// M > 8: a CTA of 32 rows; bf16 weights rebuilt once into shared memory,
// products on the tensor cores (mma.sync m16n8k16); an f32 x is split into
// bf16 hi, mid and lo as its fragments are read, one product each.
template <bool XBF16, bool kCluster>
__global__ void __launch_bounds__(kThreads)
bitplane_mma_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int kXRow = XBF16 ? kStride : kXStrideF32;  // words a row
  uint32_t* ps = smem;                                  // plane words
  uint32_t* ws = ps + kMaxBits * kMmaChunk * kCols;     // [col][k] bf16 pairs
  uint32_t* xs = ws + kCols * kStride;
  // the CTA's partial sums; with a cluster, the leader's inbox of them all
  float* tile = reinterpret_cast<float*>(xs + kMmaRows * kXRow);
  if constexpr (kCluster) cluster_started();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kCols, row0 = blockIdx.y * kMmaRows;
  const int words = a.k / 32;
  const int kw_begin = blockIdx.z * a.per;
  const int kw_end = min(words, kw_begin + a.per);
  const uint32_t sign = (1u << (a.bits - 1)) * 0x01010101u;
  const float bias = 8388608.f + static_cast<float>(1 << (a.bits - 1));

  float acc[2][4] = {};
  for (int c0 = kw_begin; c0 < kw_end; c0 += kMmaChunk) {
    const int nw = min(kMmaChunk, kw_end - c0);
    if (c0 != kw_begin) __syncthreads();        // the last chunk is consumed
    stage_planes(ps, a, col0, c0, nw, threadIdx.x, kThreads);
    stage_x(reinterpret_cast<char*>(xs), kXRow * 4, a, row0, kMmaRows, c0,
            nw, threadIdx.x, kThreads);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // the weight tile, once: ws[c][kw * 16 + 4g + j/2] = (k, k + 1) with
    // k = kw * 32 + 8g + j, j even
    for (int u = threadIdx.x; u < kCols * nw; u += kThreads) {
      const int c = u & 31, kw = u >> 5;
      uint32_t w[kMaxBits];
#pragma unroll
      for (int i = 0; i < kMaxBits; ++i)
        w[i] = i < a.bits ? ps[(i * nw + kw) * kCols + c] : 0u;
      rebuild(w, sign);
      uint32_t* dst = ws + c * kStride + kw * 16;
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
#pragma unroll
        for (int j = 0; j < 8; j += 2)
          dst[gg * 4 + j / 2] = bf16x2(weight(w[j], gg, bias),
                                       weight(w[j + 1], gg, bias));
    }
    __syncthreads();
    // warp w owns columns 8w..8w+7; two m16 tiles; k16 steps in order
    for (int ks = 0; ks < nw * 2; ++ks) {
      const uint32_t* wb = ws + (warp * 8 + g) * kStride + ks * 8 + t;
      const uint32_t b[2] = {wb[0], wb[4]};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if constexpr (XBF16) {
          const uint32_t* xa = xs + (mt * 16 + g) * kXRow + ks * 8 + t;
          const uint32_t af[4] = {xa[0], xa[8 * kXRow], xa[4],
                                  xa[8 * kXRow + 4]};
          mma_bf16(acc[mt], af, b);
        } else {
          const float* xf = reinterpret_cast<const float*>(xs) +
                            (mt * 16 + g) * kXRow + ks * 16 + 2 * t;
          uint32_t hi[4], mid[4], lo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {     // (g, k), (g+8, k), (g, k+8), ..
            const float2 v = *reinterpret_cast<const float2*>(
                xf + (q & 1) * 8 * kXRow + (q >> 1) * 8);
            split3(v.x, v.y, hi[q], mid[q], lo[q]);
          }
          mma_bf16(acc[mt], hi, b);
          mma_bf16(acc[mt], mid, b);
          mma_bf16(acc[mt], lo, b);
        }
      }
    }
  }
  // C fragments: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1
  float* slot = partial_slot<kCluster>(tile, kMmaRows * kCols);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float* at = slot + (mt * 16 + g) * kCols + warp * 8 + 2 * t;
    at[0] = acc[mt][0];
    at[1] = acc[mt][1];
    at[8 * kCols] = acc[mt][2];
    at[8 * kCols + 1] = acc[mt][3];
  }
  finish<kCluster>(a, tile, kMmaRows, row0, col0);
}

using Kernel = void (*)(Args);

cudaError_t run(Kernel kernel, dim3 grid, size_t smem, bool cluster,
                cudaStream_t stream, const Args& a) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  config.attrs = attr;
  config.numAttrs = cluster ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCluster>
Kernel gemv_kernel(int m) {
  if (m == 1) return bitplane_gemv_kernel<1, kCluster>;
  if (m <= 4) return bitplane_gemv_kernel<4, kCluster>;
  return bitplane_gemv_kernel<8, kCluster>;
}

}  // namespace

// Launches on `stream` and returns the first cudaError_t (0 on success).
// Pointers are device pointers to contiguous arrays: x [m, k] (bf16 if
// x_bf16, else f32), planes 32-bit words [bits, k/32, n], scale f32 [1, n],
// y [m, n] (bf16 if y_bf16, else f32).  K is split into `splits` slices of
// `per` words (splits = ceil(k/32 / per), at most 8); with more than one
// split they meet in a cluster along K.  M <= 8 runs on the CUDA cores,
// M > 8 on the tensor cores in tiles of 32 rows.  One kernel launch.
extern "C" int bitplane_matmul_launch(const void* x, const void* planes,
                                      const void* scale, void* y, int m,
                                      int k, int n, int bits, int x_bf16,
                                      int y_bf16, int per, int splits,
                                      void* stream) {
  const int words = k / 32;
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || bits < 1 ||
      bits > kMaxBits || per < 1 || splits < 1 || splits > kMaxCluster ||
      static_cast<long long>(splits) * per < words ||
      static_cast<long long>(splits - 1) * per >= words)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, static_cast<const uint32_t*>(planes),
         static_cast<const float*>(scale), y, m, k, n, bits, x_bf16, y_bf16,
         per, splits};
  const unsigned n_tiles = (n + kCols - 1) / kCols;
  auto st = static_cast<cudaStream_t>(stream);
  const bool on_cluster = splits > 1;
  if (m <= 8) {
    const Kernel kernel =
        on_cluster ? gemv_kernel<true>(m) : gemv_kernel<false>(m);
    return static_cast<int>(
        run(kernel, dim3(n_tiles, 1, splits), 0, on_cluster, st, a));
  }
  const unsigned m_tiles = (m + kMmaRows - 1) / kMmaRows;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel =
      x_bf16 ? (on_cluster ? bitplane_mma_kernel<true, true>
                           : bitplane_mma_kernel<true, false>)
             : (on_cluster ? bitplane_mma_kernel<false, true>
                           : bitplane_mma_kernel<false, false>);
  const size_t smem =
      x_bf16 ? mma_smem<true>(on_cluster) : mma_smem<false>(on_cluster);
  return static_cast<int>(run(kernel, dim3(n_tiles, m_tiles, splits), smem,
                              on_cluster, st, a));
}
