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
// products, which the int8 tensor cores would do in far less time than it
// takes to read the w/8 bytes a weight, so its bound is those bytes.  This
// design computes them as AND + POPC instead, and there each bit pair of
// each weight word costs one popcount per row; popcount issues at 16 per
// SM per clock on cc 9.0 (a quarter of the rate of AND and integer
// multiply-add), so its M*(K/32)*N*a*w popcounts, not the bytes, limit
// it.  The design spreads those popcounts over every SM: a CTA of four warps owns a
// (4-row, 32-column) tile and a share of K, and the shares are many enough
// that about four CTAs land on each SM whatever N is (SmolLM's N = 320
// makes only 10 column tiles).  Each warp loads the w words of its 32
// columns for one K-word at a time, coalesced along N (128 bytes a plane),
// and each row's a activation words as broadcasts (one transaction for the
// warp); the weight plane count is a template argument, so the inner sum
// t_j = sum_i cw_i * popc(x_j & w_i) is AND, POPC and a multiply-add by a
// constant, and each activation plane adds ca_j * t_j.  The CTA's warps
// meet in shared memory; when K is split, each CTA adds its partial sums
// into a 32-bit scratch with atomics (integer addition does not depend on
// order, so the result is the same on every run) and a second pass rounds
// and scales them.  Later work: the binary tensor-core MMA (mma.sync
// .b1 with .and.popc) in place of POPC.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bitserial_matmul.py does it at first use) and called through the
// plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;              // warps per CTA; they split its K share
constexpr int kCols = 32;              // columns per CTA: one per lane
constexpr int kRows = 4;               // rows per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 4;          // the K split aims at this many

// plane weight c_b of a signed `bits`-bit value, modulo 2^32
__host__ __device__ constexpr uint32_t coef(int b, int bits) {
  return b == bits - 1 ? 0u - (1u << b) : (1u << b);
}

__device__ __forceinline__ float scaled(uint32_t acc, float sx, float sw) {
  return (__int2float_rn(static_cast<int>(acc)) * sx) * sw;
}

template <int W>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
bitserial_matmul_kernel(const uint32_t* __restrict__ xp,
                        const uint32_t* __restrict__ wp,
                        const float* __restrict__ sx,
                        const float* __restrict__ sw, float* __restrict__ y,
                        uint32_t* __restrict__ partial, int m, int words,
                        int n, int a) {
  static_assert(kRows * kCols == kThreads, "one thread per output at the end");
  __shared__ uint32_t part[kWarps][kRows][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kRows;
  const bool col_ok = col < n;

  uint32_t acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0u;

  // K-words of this CTA's share, interleaved over the splits and warps
  for (int kw = blockIdx.z * kWarps + warp; kw < words;
       kw += gridDim.z * kWarps) {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = col_ok ? wp[(static_cast<size_t>(i) * words + kw) * n + col] : 0u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= m) break;                 // uniform across the CTA
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < a) {
          const uint32_t xv =
              xp[(static_cast<size_t>(row) * a + j) * words + kw];
          uint32_t t = 0u;
#pragma unroll
          for (int i = 0; i < W; ++i) t += coef(i, W) * __popc(xv & w[i]);
          const uint32_t cj = j == a - 1 ? 0u - (1u << j) : (1u << j);
          acc[r] += cj * t;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) part[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = threadIdx.x / kCols;
  const int c = threadIdx.x % kCols;
  const int row = row0 + r;
  const int out_col = blockIdx.x * kCols + c;
  if (row < m && out_col < n) {
    uint32_t s = 0u;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += part[wi][r][c];
    const size_t o = static_cast<size_t>(row) * n + out_col;
    if (gridDim.z == 1) {
      y[o] = scaled(s, sx[row], sw[out_col]);
    } else {
      atomicAdd(&partial[o], s);
    }
  }
}

__global__ void finish_kernel(const uint32_t* __restrict__ partial,
                              const float* __restrict__ sx,
                              const float* __restrict__ sw,
                              float* __restrict__ y, int m, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < static_cast<long long>(m) * n) {
    const int row = static_cast<int>(i / n);
    const int col = static_cast<int>(i % n);
    y[i] = scaled(partial[i], sx[row], sw[col]);
  }
}

int ceil_div(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

template <int W>
cudaError_t launch(const uint32_t* xp, const uint32_t* wp, const float* sx,
                   const float* sw, float* y, uint32_t* partial, int m,
                   int words, int n, int a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_n = ceil_div(n, kCols);
  const int tiles_m = ceil_div(m, kRows);
  int splits = ceil_div(static_cast<long long>(kCtasPerSm) * sms,
                        static_cast<long long>(tiles_n) * tiles_m);
  const int most = ceil_div(words, kWarps);          // a K-word a warp at least
  if (splits > most) splits = most;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  const size_t outputs = static_cast<size_t>(m) * n;
  if (splits > 1) {
    err = cudaMemsetAsync(partial, 0, outputs * sizeof(uint32_t), stream);
    if (err != cudaSuccess) return err;
  }
  bitserial_matmul_kernel<W><<<dim3(tiles_n, tiles_m, splits), kThreads, 0,
                               stream>>>(xp, wp, sx, sw, y, partial, m,
                                         words, n, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  finish_kernel<<<ceil_div(static_cast<long long>(outputs), 256), 256, 0,
                  stream>>>(partial, sx, sw, y, m, n);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the first cudaError_t (0 on success).
// Pointers are device pointers to contiguous arrays: xp words [m, a_bits,
// k/32], wp words [w_bits, k/32, n], sx f32 [m, 1], sw f32 [1, n], y f32
// [m, n], and `partial`, [m, n] 32-bit scratch that K-split CTAs add into.
extern "C" int bitserial_matmul_launch(const void* xp, const void* wp,
                                       const void* sx, const void* sw,
                                       void* y, void* partial, int m, int k,
                                       int n, int a_bits, int w_bits,
                                       void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 32 != 0 || a_bits < 1 ||
      a_bits > 8 || ceil_div(m, kRows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint32_t*>(xp);
  const auto* w = static_cast<const uint32_t*>(wp);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fw = static_cast<const float*>(sw);
  auto* out = static_cast<float*>(y);
  auto* acc = static_cast<uint32_t*>(partial);
  auto st = static_cast<cudaStream_t>(stream);
  const int words = k / 32;
  cudaError_t err;
  switch (w_bits) {
    case 1: err = launch<1>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 2: err = launch<2>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 3: err = launch<3>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 4: err = launch<4>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 5: err = launch<5>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 6: err = launch<6>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 7: err = launch<7>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    case 8: err = launch<8>(x, w, fx, fw, out, acc, m, words, n, a_bits, st); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(err);
}
