// The Metropolis site update of the paper pipeline's colour update in one
// pass: the float-uniform form of update_rules' metropolis_lut, as
// core.checkerboard._flip runs it for a Python-number beta and no field.
// For each element
//   x    = nn * sigma                     (in the spins' dtype)
//   k    = int((f32(x) + 4) * 0.5)        (truncated; x in {-4,-2,0,2,4})
//   acc  = table[k]                       (exp(-2 beta x) in the spins' dtype)
//   flip = probs.to(spins' dtype) < acc
//   out  = flip ? -sigma : sigma
// exactly the eager chain of update_rules.metropolis_acceptance("lut") and
// _metropolis_flip_probs: the product is rounded to the spins' dtype, the
// uniform is cast to it with round-to-nearest-even as Tensor.to does, and
// the compare is made on the cast values, so the decisions are bitwise
// those of the eager form. The five table values come by value (the
// wrapper takes them from update_rules.acceptance_table once per beta and
// dtype); k is clamped to [0, 4] so no input reads outside them.
//
// Spins (sigma, nn, out) are f32 or bf16; uniforms f32, bf16 or f16. out
// may be sigma itself: each element is read before it is written, by the
// thread that writes it.
//
// It replaces no TPU kernel: the reference leaves the site update to XLA
// (src/repro/core/checkerboard.py:38 _flip, src/repro/core/update_rules.py
// :228), which fuses the chain into one loop. Eager PyTorch ran it as about
// ten kernels (the product, casts, the int64 index, the gather, the
// compare, the negation, the select and the copy into the stack), each
// intermediate written to device memory and read back: ~70 B a site.
//
// Bound, at the launcher's colour update (one quad of 20480^2: 1.05e8 bf16
// sites, bf16 uniforms): bytes. It reads the spin, its neighbour sum and
// its uniform and writes the spin, 8 B a site: 0.84 GB, 0.250 ms at
// 3.35 TB/s. Its arithmetic is about 20 instructions a site, far below the
// issue rate.
//
// The design for that bound:
// * 16-byte vector loads and stores: 8 bf16 or 4 f32 spins a thread a
//   step, the uniforms with the same count (8, 16 or 32 bytes);
// * cache-streaming loads (evict first) for the three inputs, read once;
// * a grid-stride loop over a grid of about two waves of resident blocks;
// * no shared memory, no reduction;
// * a scalar loop takes the tail past the last whole vector, and the whole
//   tensor when a pointer is not aligned for the vectors.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ising {

constexpr int kFlipThreads = 256;  // threads per block

// dtype codes: the spins' (build.DTYPE_CODE) and the uniforms'
enum FlipDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int D>
constexpr int kDtypeBytes = D == kF32 ? 4 : 2;

// The five table values, exp(-2 beta x) for x = -4, -2, 0, 2, 4, each a
// value of the spins' dtype held in f32.
struct Table {
  float t0, t1, t2, t3, t4;
};

// An element of dtype D from its raw bits (the low 16 bits for 2-byte D).
template <int D>
__device__ __forceinline__ float to_float(uint32_t raw) {
  if constexpr (D == kF32)
    return __uint_as_float(raw);
  else if constexpr (D == kBF16)
    return __uint_as_float(raw << 16);
  else
    return __half2float(__ushort_as_half((unsigned short)raw));
}

// f rounded to dtype D (round to nearest even), as an f32.
template <int D>
__device__ __forceinline__ float round_to(float f) {
  if constexpr (D == kBF16)
    return __uint_as_float((uint32_t)__bfloat16_as_ushort(
                               __float2bfloat16_rn(f))
                           << 16);
  else
    return f;
}

// The new spin's raw bits for spin s, neighbour sum n (raw, dtype S) and
// uniform p (raw, dtype P).
template <int S, int P>
__device__ __forceinline__ uint32_t flip_one(uint32_t s, uint32_t n,
                                             uint32_t p, const Table& t) {
  const float x = round_to<S>(__fmul_rn(to_float<S>(n), to_float<S>(s)));
  int k = (int)__fmul_rn(__fadd_rn(x, 4.f), 0.5f);
  k = k < 0 ? 0 : (k > 4 ? 4 : k);
  const float acc =
      k == 0 ? t.t0 : (k == 1 ? t.t1 : (k == 2 ? t.t2 : (k == 3 ? t.t3 : t.t4)));
  const float u = round_to<S>(to_float<P>(p));
  constexpr uint32_t kSign = S == kF32 ? 0x80000000u : 0x8000u;
  return u < acc ? s ^ kSign : s;
}

// Raw element e of a register array of 32-bit words holding elements of
// B bytes.
template <int B>
__device__ __forceinline__ uint32_t element(const uint32_t* w, int e) {
  if constexpr (B == 4)
    return w[e];
  else
    return (w[e >> 1] >> (16 * (e & 1))) & 0xFFFFu;
}

// The N uniforms of vector v (N * PB bytes: 8, 16 or 32) into words.
template <int N, int PB>
__device__ __forceinline__ void load_probs(const void* probs, int64_t v,
                                           uint32_t (&w)[N * PB / 4]) {
  if constexpr (N * PB == 32) {
    const uint4* q = static_cast<const uint4*>(probs) + 2 * v;
    const uint4 a = __ldcs(q), b = __ldcs(q + 1);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
  } else if constexpr (N * PB == 16) {
    const uint4 a = __ldcs(static_cast<const uint4*>(probs) + v);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  } else {
    const uint2 a = __ldcs(static_cast<const uint2*>(probs) + v);
    w[0] = a.x, w[1] = a.y;
  }
}

// Raw element e of a tensor of B-byte elements.
template <int B>
__device__ __forceinline__ uint32_t load_one(const void* p, int64_t e) {
  if constexpr (B == 4)
    return __ldcs(static_cast<const unsigned int*>(p) + e);
  else
    return __ldcs(static_cast<const unsigned short*>(p) + e);
}

// sigma and out are not __restrict__: out may be sigma.
template <int S, int P>
__global__ void __launch_bounds__(kFlipThreads)
    flip_kernel(const void* sigma, const void* __restrict__ nn,
                const void* __restrict__ probs, void* out, int64_t n,
                bool vec, Table t) {
  constexpr int SB = kDtypeBytes<S>, PB = kDtypeBytes<P>;
  constexpr int N = 16 / SB;  // elements a vector
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / N;
    const uint4* sv = static_cast<const uint4*>(sigma);
    const uint4* nnv = static_cast<const uint4*>(nn);
    uint4* ov = static_cast<uint4*>(out);
    for (int64_t v = t0; v < nv; v += stride) {
      const uint4 a = __ldcs(sv + v), b = __ldcs(nnv + v);
      uint32_t pw[N * PB / 4];
      load_probs<N, PB>(probs, v, pw);
      const uint32_t sw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t nw[4] = {b.x, b.y, b.z, b.w};
      uint32_t ow[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (SB == 4) {
          ow[i] = flip_one<S, P>(sw[i], nw[i], element<PB>(pw, i), t);
        } else {
          const uint32_t lo = flip_one<S, P>(sw[i] & 0xFFFFu, nw[i] & 0xFFFFu,
                                             element<PB>(pw, 2 * i), t);
          const uint32_t hi = flip_one<S, P>(sw[i] >> 16, nw[i] >> 16,
                                             element<PB>(pw, 2 * i + 1), t);
          ow[i] = lo | (hi << 16);
        }
      }
      ov[v] = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    }
    done = nv * N;
  }
  for (int64_t e = done + t0; e < n; e += stride) {
    const uint32_t r = flip_one<S, P>(load_one<SB>(sigma, e),
                                      load_one<SB>(nn, e),
                                      load_one<PB>(probs, e), t);
    if constexpr (SB == 4)
      static_cast<uint32_t*>(out)[e] = r;
    else
      static_cast<uint16_t*>(out)[e] = (uint16_t)r;
  }
}

template <int S, int P>
void launch_flip(unsigned grid, cudaStream_t stream, const void* sigma,
                 const void* nn, const void* probs, void* out, int64_t n,
                 bool vec, Table t) {
  flip_kernel<S, P><<<grid, kFlipThreads, 0, stream>>>(sigma, nn, probs, out,
                                                       n, vec, t);
}

inline bool aligned(const void* p, unsigned bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace ising

// out[e] = the Metropolis update of sigma[e] for e < n (every tensor
// contiguous, n elements; sigma, nn and out of spin_dtype, probs of
// prob_dtype; out may be sigma), with the table t0..t4. spin_dtype: 0 f32,
// 1 bf16; prob_dtype: 0 f32, 1 bf16, 2 f16. Returns the cudaError_t of the
// launch (0 on success; nothing is launched for n = 0).
extern "C" int ising_metropolis_flip(const void* sigma, const void* nn,
                                     const void* probs, void* out,
                                     long long n, int spin_dtype,
                                     int prob_dtype, float t0, float t1,
                                     float t2, float t3, float t4,
                                     void* stream) {
  using namespace ising;
  if (n < 0 || spin_dtype < kF32 || spin_dtype > kBF16 || prob_dtype < kF32 ||
      prob_dtype > kF16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  const int spin_bytes = spin_dtype == kF32 ? 4 : 2;
  const int prob_bytes = prob_dtype == kF32 ? 4 : 2;
  const unsigned prob_vec = (unsigned)(16 / spin_bytes * prob_bytes);
  const bool vec = aligned(sigma, 16) && aligned(nn, 16) && aligned(out, 16) &&
                   aligned(probs, prob_vec < 16 ? prob_vec : 16);
  // about two waves of resident blocks (2048 threads an SM)
  const int64_t most = (int64_t)sms * (2 * 2048 / kFlipThreads);
  const int64_t per_block =
      (int64_t)kFlipThreads * (vec ? 16 / spin_bytes : 1);
  const int64_t need = (n + per_block - 1) / per_block;
  const unsigned grid = (unsigned)(need < most ? need : most);
  const Table t{t0, t1, t2, t3, t4};
  // one instantiation a (spin, uniform) pair, by 3 * spin_dtype + prob_dtype
  constexpr decltype(&launch_flip<kF32, kF32>) kLaunch[] = {
      launch_flip<kF32, kF32>,  launch_flip<kF32, kBF16>,
      launch_flip<kF32, kF16>,  launch_flip<kBF16, kF32>,
      launch_flip<kBF16, kBF16>, launch_flip<kBF16, kF16>};
  kLaunch[3 * spin_dtype + prob_dtype](grid, static_cast<cudaStream_t>(stream),
                                       sigma, nn, probs, out, (int64_t)n, vec,
                                       t);
  return (int)cudaGetLastError();
}
