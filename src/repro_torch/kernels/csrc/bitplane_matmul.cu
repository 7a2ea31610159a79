// Bit-plane matmul for Hopper (sm_90a).  Replaces the Pallas TPU kernel
// src/repro/kernels/bitplane_matmul.py::bitplane_matmul (pl.pallas_call at
// :87), which every packed projection of models/common.linear reaches.
//
//   y[M, N] = (x[M, K] @ Q[K, N]) * scale[1, N],   Q = sum_i c_i * plane_i
//
// with c_i = 2^i and the MSB plane weighted -2^(bits-1).  The planes are
// [bits, K/32, N] 32-bit words in the layout of quant/bitplane.pack: lane
// k of column n is bit k%32 of word [i, k/32, n].  x, scale and y are f32
// and the sum is taken in f32.  Any M and N; K a multiple of 32.
//
// What bounds it on this card: at decode M is the number of live rows
// (at most 8), so each weight feeds at most 8 multiply-adds and the kernel
// is bound by the bytes it must read, bits/8 * K * N of planes, over the
// HBM rate.  The design keeps those bytes at `bits` bits a weight all the
// way to the registers: one CTA per (ROWS-row, 32-column) tile; a warp
// loads the `bits` words of its 32 columns for one K-word at a time,
// coalesced along N (128 bytes a plane), and rebuilds the 32 integer
// weights of each lane in registers, so no dequantised weight is ever
// written.  The integer becomes a float through the mantissa of 2^23 (one
// logic op and one add, exact) instead of the slower int-to-float unit.
// The CTA's 16 warps split K word by word, which keeps 16 loads in flight
// per tile; each warp stages its ROWSx32 slice of x in shared memory and
// reads it back as broadcasts.  Partial sums meet in shared memory and are
// added in a fixed warp order, so a result never changes between runs.
// ROWS is 4 when M <= 4 (a decode batch of 4), else 8.  The TPU kernel ran
// one matrix-unit pass per plane; here each weight is rebuilt once and
// multiplied once per row.  Rebuilding costs about two integer ops per
// bit, which can outweigh the byte stream when few CTAs cover N; wider
// splits of K, a cheaper bit transpose, and wgmma/TMA for large M
// (prefill) are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bitplane_matmul.py does it at first use) and called through
// the plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;             // warps per CTA; they split K
constexpr int kCols = 32;              // columns per CTA: one per lane
constexpr int kThreads = kWarps * 32;

template <int BITS, int ROWS>
__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const float* __restrict__ x,
                       const uint32_t* __restrict__ planes,
                       const float* __restrict__ scale,
                       float* __restrict__ y, int m, int k, int n) {
  static_assert(ROWS * kCols <= kThreads, "one thread per output at the end");
  __shared__ float xs[kWarps][ROWS][32];
  __shared__ float part[kWarps][ROWS][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * ROWS;
  const int words = k / 32;
  const bool col_ok = col < n;
  // q + 2^(BITS-1) lies in [0, 2^BITS); in the mantissa of 2^23 it is exact
  constexpr uint32_t kSign = 1u << (BITS - 1);
  constexpr float kBias = 8388608.f + static_cast<float>(kSign);

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  for (int kw = warp; kw < words; kw += kWarps) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      xs[warp][r][lane] =
          row < m ? x[(size_t)row * k + (size_t)kw * 32 + lane] : 0.f;
    }
    uint32_t w[BITS];
#pragma unroll
    for (int i = 0; i < BITS; ++i)
      w[i] = col_ok ? planes[((size_t)i * words + kw) * n + col] : 0u;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      uint32_t u = 0;
#pragma unroll
      for (int i = 0; i < BITS; ++i) u |= ((w[i] >> j) & 1u) << i;
      const float q = __uint_as_float(0x4B000000u | (u ^ kSign)) - kBias;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[warp][r][j], q, acc[r]);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  if (threadIdx.x < ROWS * kCols) {
    const int r = threadIdx.x / kCols;
    const int c = threadIdx.x % kCols;
    const int row = row0 + r;
    const int out_col = blockIdx.x * kCols + c;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += part[wi][r][c];
    if (row < m && out_col < n) y[(size_t)row * n + out_col] = s * scale[out_col];
  }
}

template <int BITS>
cudaError_t launch(const float* x, const uint32_t* planes, const float* scale,
                   float* y, int m, int k, int n, cudaStream_t stream) {
  const dim3 block(kThreads);
  if (m <= 4) {
    const dim3 grid((n + kCols - 1) / kCols, 1);
    bitplane_matmul_kernel<BITS, 4><<<grid, block, 0, stream>>>(
        x, planes, scale, y, m, k, n);
  } else {
    const dim3 grid((n + kCols - 1) / kCols, (m + 7) / 8);
    bitplane_matmul_kernel<BITS, 8><<<grid, block, 0, stream>>>(
        x, planes, scale, y, m, k, n);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to contiguous arrays: x f32 [m, k], planes
// 32-bit words [bits, k/32, n], scale f32 [1, n], y f32 [m, n].
extern "C" int bitplane_matmul_launch(const void* x, const void* planes,
                                      const void* scale, void* y, int m,
                                      int k, int n, int bits, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || (m + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const uint32_t*>(planes);
  const auto* s = static_cast<const float*>(scale);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return static_cast<int>(launch<1>(xf, p, s, yf, m, k, n, st));
    case 2: return static_cast<int>(launch<2>(xf, p, s, yf, m, k, n, st));
    case 3: return static_cast<int>(launch<3>(xf, p, s, yf, m, k, n, st));
    case 4: return static_cast<int>(launch<4>(xf, p, s, yf, m, k, n, st));
    case 5: return static_cast<int>(launch<5>(xf, p, s, yf, m, k, n, st));
    case 6: return static_cast<int>(launch<6>(xf, p, s, yf, m, k, n, st));
    case 7: return static_cast<int>(launch<7>(xf, p, s, yf, m, k, n, st));
    case 8: return static_cast<int>(launch<8>(xf, p, s, yf, m, k, n, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
