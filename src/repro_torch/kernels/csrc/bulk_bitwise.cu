// Bulk bitwise kernels for Hopper (sm_90a): the paper's database
// search-replace and RAID rebuild (Sec. IV-C).  Replace the Pallas TPU
// kernels src/repro/kernels/bulk_bitwise.py::search_replace (pl.pallas_call
// at :47) and ::raid_xor (pl.pallas_call at :77).
//
//   search_replace: planes [bits, W] (records bit-transposed, 32 a word)
//       diff = OR_i (plane_i XOR keybit_i),  out_i = plane_i & diff,
//       mask = ~diff  (bit k of mask word w set iff record 32w+k == key)
//   raid_xor:       stripes [D, W] -> the XOR of the D stripes, [W]
//
// Words are 32 bits, held by PyTorch as int32.  1 <= bits <= 32; the key is
// a launch argument (the TPU kernel was compiled once per key), and only
// its low `bits` bits are read, as the TPU kernel reads them.
//
// What bounds them on this card: both are one elementwise pass with no
// reuse, so the bytes over the HBM rate - search_replace reads bits*W words
// and writes (bits+1)*W, raid_xor reads D*W and writes W.  The design
// streams each word once, coalesced: one thread owns one word column.
// search_replace keeps the column's `bits` words in registers between the
// OR-fold and the masked stores, so the planes are read once; raid_xor
// reads four words at a time (16-byte loads) when W % 4 == 0 and folds the
// D stripes with the loads of eight stripes in flight.  Grid-stride loops
// cover any W.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bulk_bitwise.py does it at first use) and called through the
// plain C functions at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads)
search_replace_kernel(const uint32_t* __restrict__ planes,
                      uint32_t* __restrict__ out, uint32_t* __restrict__ mask,
                      long long words, int bits, uint32_t key) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long w = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       w < words; w += stride) {
    uint32_t p[32];
    uint32_t diff = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < bits) {
        p[i] = planes[i * words + w];
        diff |= p[i] ^ (((key >> i) & 1u) ? 0xffffffffu : 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < bits) out[i * words + w] = p[i] & diff;
    mask[w] = ~diff;
  }
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint32_t xor4(uint32_t a, uint32_t b) {
  return a ^ b;
}

// V is uint4 (four words a thread) or uint32_t; `cols` counts V's.
template <typename V>
__global__ void __launch_bounds__(kThreads)
raid_xor_kernel(const V* __restrict__ stripes, V* __restrict__ out,
                long long cols, int d) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       c < cols; c += stride) {
    V acc = stripes[c];
#pragma unroll 8
    for (int s = 1; s < d; ++s) acc = xor4(acc, stripes[s * cols + c]);
    out[c] = acc;
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// planes, out: [bits, words]; mask: [words].  Returns the cudaError_t of
// the launch (0 on success); nothing here synchronises.
extern "C" int search_replace_launch(const void* planes, void* out,
                                     void* mask, long long words, int bits,
                                     unsigned int key, void* stream) {
  if (words <= 0 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  search_replace_kernel<<<blocks_for(words), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(mask), words, bits, key);
  return static_cast<int>(cudaGetLastError());
}

// stripes: [d, words]; out: [words].
extern "C" int raid_xor_launch(const void* stripes, void* out, long long words,
                               int d, void* stream) {
  if (words <= 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = words % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(stripes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    raid_xor_kernel<uint4><<<blocks_for(words / 4), kThreads, 0, st>>>(
        static_cast<const uint4*>(stripes), static_cast<uint4*>(out),
        words / 4, d);
  } else {
    raid_xor_kernel<uint32_t><<<blocks_for(words), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(stripes), static_cast<uint32_t*>(out),
        words, d);
  }
  return static_cast<int>(cudaGetLastError());
}
