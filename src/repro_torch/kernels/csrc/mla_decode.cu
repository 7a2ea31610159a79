// Absorbed multi-head latent attention decode for Hopper (sm_90a): one
// query token a slot over that slot's latent cache (DeepSeek-V2's MLA,
// arXiv:2405.04434). It replaces no Pallas kernel: the JAX package has no
// latent attention. kernels/mla_decode.py is its wrapper and holds its
// plain PyTorch version.
//
//   s_h(t)    = scale * q[b, h] . row(b, t),   row = [ckv[b, t], kpe[b, t]]
//   out[b, h] = sum_{t <= pos[b]} softmax_t(s_h)(t) * ckv[b, t]
//
// q [B, 16, 576] bf16 (the absorbed query), ckv [B, T, 512] and kpe
// [B, T, 64] bf16, pos [B] int64; out [B, 16, 512] bf16. Scores, softmax
// and sums are f32.
//
// What bounds it on this card: each live row (1,152 bytes) is read once
// for all 16 heads and takes 2 * 16 * (576 + 512) = 34,816 operations, 30
// a byte: above the f32 SIMT ridge (20), where widening each bf16 operand
// to f32 costs an integer instruction beside each multiply-add, and below
// the tensor cores' (295). So both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 sums), the 16 heads being the 16 rows
// of the A operand: the scores as Q [16 x 576] times a chunk of rows
// [576 x 32], the sums as the probabilities [16 x 32] times the chunk's
// latents [32 x 512]. The probabilities are f32; each is split into three
// bf16 parts that hold its 24 bits exactly (hi + mid + lo), so the second
// product is the f32 one up to the order of its sums.
//
// Layout: kernel 1 (mla_decode_split_kernel) takes a block per (split,
// slot). A slot's live rows 0..pos, in chunks of 32, are shared out among
// its `splits` blocks in runs of whole chunks; a block past the slot's
// last chunk exits at once, so the grid, fixed by T and B, suits a step
// captured in a CUDA graph while the positions move. The wrapper sets
// `splits` so that B x splits blocks fill the card's SMs twice (two
// blocks an SM, 99 KB of shared memory each). A block copies the slot's
// 16 queries once and its chunks with cp.async, the next chunk in flight
// while it works on this one (rows padded to 584 bf16 so that ldmatrix
// reads are free of bank conflicts; rows past pos are zero-filled). Per
// chunk: 8 warps take the scores (a warp an 8-row tile and half of the
// 576 dims); 16 threads a head take the online softmax (running max and
// sum of exponentials); then each warp adds p x latents into its 64
// latent dims of the 16 heads. It writes its unnormalised sums and (max,
// sum of exponentials) a head. Kernel 2 (mla_decode_combine_kernel)
// merges a slot's splits a head and rounds to bf16.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (kernels/mla_decode.py does it at first use) and called through the
// plain C function at the bottom, with PyTorch's current stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeads = 16;
constexpr int kLatent = 512;
constexpr int kRope = 64;
constexpr int kRow = kLatent + kRope;      // 576
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // rows a chunk
constexpr int kStride = kRow + 8;          // a bf16 row in shared memory:
                                           // 584 (1,168 B = 4 mod 32 words)
constexpr int kPStride = kChunk + 8;       // a head's 32 probabilities: 40
constexpr int kVecs = kRow / 8;            // 16-byte pieces a row
constexpr int kQBytes = kHeads * kStride * 2;           // 18,688
constexpr int kBufBytes = kChunk * kStride * 2;         // 37,376
constexpr int kSBytes = 2 * kHeads * kChunk * 4;        // 4,096
constexpr int kPBytes = 3 * kHeads * kPStride * 2;      // 3,840
constexpr int kSmem = kQBytes + 2 * kBufBytes + kSBytes + kPBytes +
                      kHeads * 4;                       // 101,440
constexpr int kHalfK = kRow / 2;                        // 288 dims a warp
constexpr int kDimsWarp = kLatent / kWarps;             // 64 dims a warp
constexpr int kCombineThreads = kLatent / 4;            // 4 sums a thread

#define kNegInf (-__int_as_float(0x7f800000))

static_assert(kWarps == 8, "scores: 4 row tiles x 2 halves of the dims");
static_assert(kThreads == kHeads * 16, "softmax: 16 threads a head");
static_assert(kDimsWarp == 64, "sums: 8 column tiles of 8 a warp");
static_assert(kQBytes % 16 == 0 && kBufBytes % 16 == 0 &&
                  (kSBytes + kPBytes) % 16 == 0,
              "aligned regions");
static_assert(2 * (kSmem + 1024) <= 228 * 1024, "two blocks an SM");

// 16 bytes from device memory to shared memory, asynchronously; zero
// bytes read (the 16 zero-filled) where !valid
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving a row's
// address of matrix l / 8; .trans hands each out transposed
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += A (16 x 16 bf16) * B (16 x 8 bf16), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// a slot's live rows, and the chunks [c0, c1) that split s of `splits`
// takes (runs of `per` chunks; c0 >= c1 where it takes none)
struct Share {
  int n, chunks, per;
  __device__ Share(long long p, int t_max, int splits) {
    n = static_cast<int>(p + 1 < t_max ? p + 1 : t_max);
    chunks = (n + kChunk - 1) / kChunk;
    per = (chunks + splits - 1) / splits;
  }
  __device__ int used() const { return (chunks + per - 1) / per; }
};

// Start copying rows [lo, lo + 32) of slot row `first` on into buf, each
// 576 bf16 (the latent, then the RoPE key); rows at or past n zero-filled.
__device__ __forceinline__ void stage_rows(uint16_t* buf,
                                           const uint16_t* __restrict__ ckv,
                                           const uint16_t* __restrict__ kpe,
                                           size_t first, int lo, int n,
                                           int tid) {
  for (int i = tid; i < kChunk * kVecs; i += kThreads) {
    const int r = i / kVecs, v = i % kVecs;
    const bool live = lo + r < n;
    const size_t row = first + (live ? lo + r : 0);
    copy16(buf + r * kStride + v * 8,
           v < kLatent / 8
               ? static_cast<const void*>(ckv + row * kLatent + v * 8)
               : static_cast<const void*>(kpe + row * kRope +
                                          (v - kLatent / 8) * 8),
           live);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
mla_decode_split_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ ckv,
                        const uint16_t* __restrict__ kpe,
                        const long long* __restrict__ pos, int t_max,
                        int splits, float scale, float* __restrict__ part_o,
                        float2* __restrict__ part_ml) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* bufs = reinterpret_cast<uint16_t*>(smem + kQBytes);
  float* sp = reinterpret_cast<float*>(smem + kQBytes + 2 * kBufBytes);
  uint16_t* pm = reinterpret_cast<uint16_t*>(smem + kQBytes +
                                             2 * kBufBytes + kSBytes);
  float* alpha = reinterpret_cast<float*>(smem + kQBytes + 2 * kBufBytes +
                                          kSBytes + kPBytes);

  const int s = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Share sh(pos[b], t_max, splits);
  const int c0 = s * sh.per;
  const int c1 = c0 + sh.per < sh.chunks ? c0 + sh.per : sh.chunks;
  if (c0 >= c1) return;                      // the whole block leaves

  const uint16_t* qg = q + static_cast<size_t>(b) * kHeads * kRow;
  for (int i = tid; i < kHeads * kVecs; i += kThreads) {
    const int h = i / kVecs, v = i % kVecs;
    copy16(qs + h * kStride + v * 8, qg + h * kRow + v * 8, true);
  }
  const size_t first = static_cast<size_t>(b) * t_max;
  stage_rows(bufs, ckv, kpe, first, c0 * kChunk, sh.n, tid);
  commit();

  // the scores' tile: rows 8 nt.., dims 288 kh..; the softmax's head and
  // row pair; the fragment's rows (heads g, g + 8) and columns (2 t..)
  const int nt = warp & 3, kh = warp >> 2;
  const int sh_h = tid >> 4, sh_j = tid & 15;
  const int g = lane >> 2, t = lane & 3;
  float m_run = kNegInf, l_run = 0.f;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c = c0; c < c1; ++c) {
    const int i = c - c0;
    const uint16_t* buf = bufs + (i & 1) * (kChunk * kStride);
    const int nr = sh.n - c * kChunk < kChunk ? sh.n - c * kChunk : kChunk;
    if (c + 1 < c1) {
      stage_rows(bufs + ((i + 1) & 1) * (kChunk * kStride), ckv, kpe, first,
                 (c + 1) * kChunk, sh.n, tid);
      commit();
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    __syncthreads();

    // scores: Q [16 x 288 dims] times rows^T [288 x 8 rows], two chains
    {
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      const uint16_t* qa = qs + (lane & 15) * kStride + (lane >> 4) * 8 +
                           kh * kHalfK;
      const uint16_t* rb = buf + (nt * 8 + (lane & 7)) * kStride +
                           (lane >> 3) * 8 + kh * kHalfK;
#pragma unroll 3
      for (int k = 0; k < kHalfK; k += 32) {
        uint32_t a0[4], a1[4], bb[4];
        ldsm4(a0, qa + k);
        ldsm4(a1, qa + k + 16);
        ldsm4(bb, rb + k);
        mma_bf16(d0, a0, bb[0], bb[1]);
        mma_bf16(d1, a1, bb[2], bb[3]);
      }
      float* o = sp + kh * (kHeads * kChunk) + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(o + g * kChunk) =
          make_float2(d0[0] + d1[0], d0[1] + d1[1]);
      *reinterpret_cast<float2*>(o + (g + 8) * kChunk) =
          make_float2(d0[2] + d1[2], d0[3] + d1[3]);
    }
    __syncthreads();

    // online softmax: head sh_h, rows 2 sh_j and 2 sh_j + 1
    {
      const float* s0 = sp + sh_h * kChunk + 2 * sh_j;
      const float* s1 = s0 + kHeads * kChunk;
      const float x0 = 2 * sh_j < nr ? (s0[0] + s1[0]) * scale : kNegInf;
      const float x1 = 2 * sh_j + 1 < nr ? (s0[1] + s1[1]) * scale : kNegInf;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 8; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run, mx);  // finite: row 0 of a chunk is live
      const float al = __expf(m_run - m_new);
      const float e0 = __expf(x0 - m_new), e1 = __expf(x1 - m_new);
      float sum = e0 + e1;
#pragma unroll
      for (int o = 8; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run = l_run * al + sum;
      m_run = m_new;
      uint32_t hi, mid, lo;
      split3(e0, e1, hi, mid, lo);
      uint32_t* pw = reinterpret_cast<uint32_t*>(pm + sh_h * kPStride) + sh_j;
      pw[0] = hi;
      pw[kHeads * kPStride / 2] = mid;
      pw[kHeads * kPStride] = lo;
      if (sh_j == 0) alpha[sh_h] = al;
    }
    __syncthreads();

    // sums: P [16 x 32 rows] (three parts) times latents [32 x 64 dims]
    {
      const float a_lo = alpha[g], a_hi = alpha[g + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= a_lo;
        acc[n][1] *= a_lo;
        acc[n][2] *= a_hi;
        acc[n][3] *= a_hi;
      }
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 16) {
        uint32_t ap[3][4];
#pragma unroll
        for (int part = 0; part < 3; ++part)
          ldsm4(ap[part], pm + part * kHeads * kPStride +
                              (lane & 15) * kPStride + ks + (lane >> 4) * 8);
        const uint16_t* cb = buf + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                       kStride +
                             warp * kDimsWarp + (lane >> 4) * 8;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t bb[4];
          ldsm4_trans(bb, cb + 16 * p);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            mma_bf16(acc[2 * p], ap[part], bb[0], bb[1]);
            mma_bf16(acc[2 * p + 1], ap[part], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();                 // this chunk's buffers are consumed
  }

  const size_t at = (static_cast<size_t>(b) * splits + s) * kHeads;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = warp * kDimsWarp + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(part_o + (at + g) * kLatent + d) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(part_o + (at + g + 8) * kLatent + d) =
        make_float2(acc[n][2], acc[n][3]);
  }
  if (sh_j == 0) part_ml[at + sh_h] = make_float2(m_run, l_run);
}

__global__ void __launch_bounds__(kCombineThreads)
mla_decode_combine_kernel(const float* __restrict__ part_o,
                          const float2* __restrict__ part_ml,
                          const long long* __restrict__ pos, int t_max,
                          int splits, uint16_t* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int used = Share(pos[b], t_max, splits).used();
  const size_t first = static_cast<size_t>(b) * splits * kHeads + h;
  float mx = kNegInf;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, part_ml[first + s * kHeads].x);
  float total = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < used; ++s) {
    const size_t at = first + s * kHeads;
    const float2 ml = part_ml[at];
    const float w = __expf(ml.x - mx);
    total += ml.y * w;
    const float4 v = reinterpret_cast<const float4*>(part_o + at * kLatent)[tid];
    o.x = fmaf(w, v.x, o.x);
    o.y = fmaf(w, v.y, o.y);
    o.z = fmaf(w, v.z, o.z);
    o.w = fmaf(w, v.w, o.w);
  }
  const float inv = 1.f / total;
  uint2 packed;
  packed.x = bf16x2(o.x * inv, o.y * inv);
  packed.y = bf16x2(o.z * inv, o.w * inv);
  reinterpret_cast<uint2*>(out + (static_cast<size_t>(b) * kHeads + h) *
                                     kLatent)[tid] = packed;
}

}  // namespace

extern "C" int mla_decode_launch(const void* q, const void* ckv,
                                 const void* kpe, const void* pos,
                                 void* part_o, void* part_ml, void* out,
                                 int batch, int t_max, int splits,
                                 float scale, void* stream) {
  if (batch <= 0 || t_max <= 0 || splits <= 0 ||
      splits > (t_max + kChunk - 1) / kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized = false;        // above the 48 KB a block by default
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized = true;
  }
  auto st = static_cast<cudaStream_t>(stream);
  mla_decode_split_kernel<<<dim3(splits, batch), kThreads, kSmem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(ckv),
      static_cast<const uint16_t*>(kpe), static_cast<const long long*>(pos),
      t_max, splits, scale, static_cast<float*>(part_o),
      static_cast<float2*>(part_ml));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_combine_kernel<<<dim3(kHeads, batch), kCombineThreads, 0, st>>>(
      static_cast<const float*>(part_o), static_cast<const float2*>(part_ml),
      static_cast<const long long*>(pos), t_max, splits,
      static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
