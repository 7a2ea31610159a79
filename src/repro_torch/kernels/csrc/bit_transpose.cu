// Bit transpose and its inverse for Hopper (sm_90a): the swizzle module of
// CoMeFa (paper Sec. III-H, Fig. 7) between element-major integers and the
// packed bit-planes every other kernel of the port reads.  Replaces the
// Pallas TPU kernels src/repro/kernels/bit_transpose.py::bit_transpose
// (pl.pallas_call at :39) and ::bit_untranspose (pl.pallas_call at :69).
//
//   bit_transpose:   x int32 [N] -> planes [bits, N/32]: bit i of element
//                    32w+k is bit k of word [i, w]            (N % 32 == 0)
//   bit_untranspose: planes [bits, W] -> int32 [32W]: the inverse, the MSB
//                    plane weighted -2^(bits-1) when `signed`, else 2^(bits-1)
//
// 1 <= bits <= 32; every word is 32 bits, held by PyTorch as int32.
//
// What bounds them on this card: one pass over the data, no reuse, so the
// bytes: 4N bytes of elements and bits*N/8 bytes of planes, over the HBM
// rate - provided the bit shuffling itself stays below that, which is what
// the design is about.  Each warp owns 32 consecutive words of every plane
// (1024 elements) and moves them with coalesced 128-byte loads and stores;
// the 32x32 bit blocks are turned inside the warp by a five-stage shuffle
// butterfly (about 35 instructions for 32 elements, five of them
// shuffles), and the warp's words meet in shared memory, one row a plane,
// padded to 33 so that both the row writes and the column reads are free
// of bank conflicts.
// - bit_transpose: for each group of 32 elements (one load), lane k holds
//   element k; after the butterfly lane i holds word (i, group), which it
//   writes to row i; then each plane's 32 words leave as one store.  (One
//   `__ballot_sync` a plane makes the same words; the butterfly's cost
//   does not grow with bits, and PERF.md has the two measured.)
// - bit_untranspose: the planes' 32 words are staged row by row; for each
//   group, lane i takes plane i's word and the butterfly leaves element
//   k's bits in lane k.  The sum is in unsigned 32-bit arithmetic, which
//   wraps exactly as the int32 result; a set MSB subtracts 2^bits when
//   `signed`.  The plane count is a template argument (the power of two
//   >= bits), which sizes the staging rows.
// The TPU kernels did the transpose as multiply-and-sum over [bw, 32]
// tiles on the vector unit; warp shuffles replace that here.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/bit_transpose.py does it at first use) and called through the
// plain C functions at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr long long kMaxBlocks = 1 << 20;

// The 32x32 bit block held one row a lane is transposed across the warp:
// on return, bit i of lane k is bit k of lane i's input.
__device__ __forceinline__ uint32_t transpose32(uint32_t v, int lane) {
  uint32_t m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t p = __shfl_xor_sync(0xffffffffu, v, j);
    const bool lower = (lane & j) == 0;
    const uint32_t lo = lower ? v : p;
    const uint32_t hi = lower ? p : v;
    const uint32_t t = ((lo >> j) ^ hi) & m;
    v ^= lower ? (t << j) : t;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
bit_transpose_kernel(const uint32_t* __restrict__ x,
                     uint32_t* __restrict__ planes, long long words,
                     int bits) {
  __shared__ uint32_t tile[kWarps][32][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * 32;
  for (long long base = warp0 * 32; base < words; base += stride) {
    const long long left = words - base;
    const int groups = left < 32 ? static_cast<int>(left) : 32;
#pragma unroll 8
    for (int g = 0; g < groups; ++g) {
      // lane k holds element 32(base+g)+k; after the transpose lane i
      // holds bit i of the 32 elements: word (i, base + g)
      tile[warp][lane][g] = transpose32(x[(base + g) * 32 + lane], lane);
    }
    __syncwarp();
    if (lane < groups) {
      for (int i = 0; i < bits; ++i)
        planes[i * words + base + lane] = tile[warp][i][lane];
    }
    __syncwarp();
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
bit_untranspose_kernel(const uint32_t* __restrict__ planes,
                       uint32_t* __restrict__ out, long long words, int bits,
                       int is_signed) {
  __shared__ uint32_t tile[kWarps][NB][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp0 = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * 32;
  const uint32_t msb = 1u << (bits - 1);
  const uint32_t wrap = is_signed ? 2u * msb : 0u;   // 2^bits mod 2^32
  for (long long base = warp0 * 32; base < words; base += stride) {
    const bool ok = base + lane < words;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      tile[warp][i][lane] =
          i < bits && ok ? planes[i * words + base + lane] : 0u;
    __syncwarp();
    const long long left = words - base;
    const int groups = left < 32 ? static_cast<int>(left) : 32;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      uint32_t v = lane < NB ? tile[warp][lane % NB][g] : 0u;
      v = transpose32(v, lane);
      if (v & msb) v -= wrap;
      out[(base + g) * 32 + lane] = v;
    }
    __syncwarp();
  }
}

int blocks_for(long long words) {
  const long long b = (words + kWarps * 32 - 1) / (kWarps * 32);
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// the power of two >= bits (1 <= bits <= 32)
int planes_bound(int bits) {
  int nb = 1;
  while (nb < bits) nb <<= 1;
  return nb;
}

template <int NB>
void launch_untranspose(const uint32_t* planes, uint32_t* out,
                        long long words, int bits, int is_signed,
                        cudaStream_t st) {
  bit_untranspose_kernel<NB><<<blocks_for(words), kThreads, 0, st>>>(
      planes, out, words, bits, is_signed);
}

}  // namespace

// x: n 32-bit elements; planes: [bits, n/32] words.  Returns the
// cudaError_t of the launch (0 on success); nothing here synchronises.
extern "C" int bit_transpose_launch(const void* x, void* planes, long long n,
                                    int bits, void* stream) {
  if (n <= 0 || n % 32 != 0 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long words = n / 32;
  bit_transpose_kernel<<<blocks_for(words), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(planes), words,
      bits);
  return static_cast<int>(cudaGetLastError());
}

// planes: [bits, words] words; out: words*32 int32 elements.
extern "C" int bit_untranspose_launch(const void* planes, void* out,
                                      long long words, int bits,
                                      int is_signed, void* stream) {
  if (words <= 0 || bits < 1 || bits > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint32_t*>(planes);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (planes_bound(bits)) {
    case 1: launch_untranspose<1>(p, o, words, bits, is_signed, st); break;
    case 2: launch_untranspose<2>(p, o, words, bits, is_signed, st); break;
    case 4: launch_untranspose<4>(p, o, words, bits, is_signed, st); break;
    case 8: launch_untranspose<8>(p, o, words, bits, is_signed, st); break;
    case 16: launch_untranspose<16>(p, o, words, bits, is_signed, st); break;
    default: launch_untranspose<32>(p, o, words, bits, is_signed, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
