// Bit-serial reduction for Hopper (sm_90a): the sum of N signed `bits`-bit
// integers from their packed bit-planes (paper Sec. IV-C "Reduction").
// Replaces the Pallas TPU kernel
// src/repro/kernels/bitserial_reduce.py::bitserial_reduce (pl.pallas_call
// at :52).
//
//   sum = sum_b c_b * sum_w popcount(planes[b, w]),
//   c_b = 2^b, and -2^(bits-1) for the MSB plane (two's complement)
//
// planes [bits, W] are 32-bit words (int32 to PyTorch), 1 <= bits <= 32.
// The result is one f32.
//
// The sum is exact: each thread counts the set bits of each plane in a
// 32-bit counter, weights the counts into a signed 64-bit sum, and the
// CTA's sum (warp shuffles, then one warp over the CTA's partials) is added
// to a 64-bit accumulator with one atomic per CTA.  Integer sums do not
// depend on their order, so the result is the same on every run; it is
// rounded to f32 once, at the end.  The TPU kernel folded f32 partials, so
// the two agree exactly while every partial is below 2^24; beyond that this
// kernel is the correctly rounded int64 sum.
//
// What bounds it on this card: one read of the planes (bits*W words), over
// the HBM rate; a popcount and an add a word are far below the integer
// rate.  Loads are coalesced and 16 bytes wide when W % 4 == 0 (a warp
// reads 512 bytes of one plane, `bits` such loads in flight a thread), and
// a grid-stride loop keeps a bounded number of CTAs, so atomics stay few.
// Three launches on the stream: zero the accumulator, reduce, convert.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bitserial_reduce.py does it at first use) and called through
// the plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 4;   // four CTAs an SM of an H100

__device__ __forceinline__ uint32_t popc(uint32_t v) { return __popc(v); }
__device__ __forceinline__ uint32_t popc(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// V is uint4 (four words a load) or uint32_t; `cols` counts V's a plane.
template <typename V>
__global__ void __launch_bounds__(kThreads)
bitserial_reduce_kernel(const V* __restrict__ planes, long long cols,
                        int bits, unsigned long long* __restrict__ acc) {
  __shared__ long long part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t cnt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) cnt[i] = 0u;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       c < cols; c += stride) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < bits) cnt[i] += popc(planes[i * cols + c]);
  }
  long long sum = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < bits) {
      const long long term = static_cast<long long>(cnt[i]) << i;
      sum += i == bits - 1 ? -term : term;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) part[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = lane < kWarps ? part[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    // two's complement: an unsigned 64-bit add is the signed add
    if (lane == 0) atomicAdd(acc, static_cast<unsigned long long>(sum));
  }
}

__global__ void to_float_kernel(const unsigned long long* __restrict__ acc,
                                float* __restrict__ out) {
  *out = __ll2float_rn(static_cast<long long>(*acc));
}

}  // namespace

// planes: [bits, words]; acc: one 64-bit scratch word; out: one f32.
// Returns the cudaError_t of the launches (0 on success); nothing here
// synchronises.
extern "C" int bitserial_reduce_launch(const void* planes, void* acc,
                                       void* out, long long words, int bits,
                                       void* stream) {
  if (words <= 0 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<unsigned long long*>(acc);
  cudaError_t err = cudaMemsetAsync(a, 0, sizeof(*a), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = words % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  const long long cols = vec ? words / 4 : words;
  const long long want = (cols + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  if (vec) {
    bitserial_reduce_kernel<uint4><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(planes), cols, bits, a);
  } else {
    bitserial_reduce_kernel<uint32_t><<<blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(planes), cols, bits, a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  to_float_kernel<<<1, 1, 0, st>>>(a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
