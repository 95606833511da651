// One draw of repro_torch.random on a CUDA device in one launch: the 32-bit
// words of random.bits, the uniforms of random.uniform (f32, bf16, f16),
// which random.bernoulli compares, and random.randint. Element e of row r is
// drawn from the counter c = start + e, split as (hi, lo) = (c >> 32,
// c & 0xffffffff) and hashed under row r's key: the word x0 ^ x1 of
// threefry2x32(key, (hi, lo)), exactly random._bits_lanes. The word becomes
// the draw's dtype in registers and is written once. The CPU keeps the
// eager int64 form (random._draw_eager), the oracle the kernel is held to.
//
// It replaces no TPU kernel: the reference leaves jax.random to XLA, which
// fuses the hash and its conversion into one loop. Eager PyTorch ran the
// same hash as about 165 in-place passes over 2^25 int64 lanes a chunk,
// each one read and written back to device memory.
//
// The output forms, one epilogue each (w is the 32-bit word):
//   0  bits      int32 pattern of w
//   1  uniform   f32:  float bits (w >> 9) | 0x3F800000, minus 1
//   2  uniform   bf16: bits ((w & 0xFF) >> 1) | 0x3F80, minus 1
//   3  uniform   f16:  bits ((w & 0xFFFF) >> 6) | 0x3C00, minus 1
//   4  randint   ((hi % span) * m + lo % span) % span + minval in uint32
//                that wraps, hi and lo the words of the two split keys
// Each subtraction is exact (a value in [1, 2) minus 1), so the f32 result
// of the 2-byte forms converts to bf16 / f16 without rounding.
//
// Key batches: row r of the [rows, n] output is drawn under key r, whose
// two words come from one small device buffer; a single key comes by value.
// randint takes a second key set in the same way.
//
// Bound, at the launcher's 20480^2 colour draw (2.1e8 bf16 words): integer
// issue. A hash is 20 rounds of add, funnel-shift and xor plus the key
// injections and the output xor, about 68 instructions, of which the 20
// rotations and 21 xors issue only on the integer ALU: 0.64 SM clocks a
// word at 64 a clock, 0.51 ms a draw on 132 SMs at 1.98 GHz. It writes 2 B
// a word and reads nothing: 0.42 GB, 0.13 ms at 3.35 TB/s.
//
// The design for that bound:
// * each thread carries 8 elements' hashes (16 for randint) through the 20
//   rounds together, round by round, for ILP, and stores them as one
//   16-byte vector for the 2-byte forms or two for the 4-byte forms;
// * a grid-stride loop over a row with a grid of about two waves of
//   resident blocks, blockIdx.y over rows (a key batch);
// * the 8 counters of a trip are one 32-bit lo word plus 0..7; the hi word
//   is carried only where the trip's counters cross 2^32, and no 64-bit
//   arithmetic runs in the rounds;
// * a scalar tail takes lengths that are not a multiple of 8, and a scalar
//   loop takes a row whose output is not 16-byte aligned, as in
//   threefry_fold.cu.
#include <cuda_fp16.h>

#include "checkerboard_common.cuh"

namespace ising {

constexpr int kDrawThreads = 256;  // threads per block
constexpr int kDrawVec = 8;        // elements per thread a trip

enum DrawForm {
  kBits = 0,
  kUniformF32 = 1,
  kUniformBF16 = 2,
  kUniformF16 = 3,
  kRandint = 4,
};

// randint's fold into [minval, minval + span)
struct Fold {
  uint32_t span, multiplier, minval;
};

__device__ __forceinline__ Key row_key(const Key& key,
                                       const uint32_t* __restrict__ keys,
                                       int r) {
  if (keys == nullptr) return key;
  const uint32_t a = __ldg(keys + 2 * r), b = __ldg(keys + 2 * r + 1);
  return Key{a, b, a ^ b ^ kParity};
}

// The words of counters c, c + 1, ..., c + N - 1 (x0 = hi, x1 = lo); the hi
// word steps up only for the counters past a crossing of 2^32.
template <int N>
__device__ __forceinline__ void counters(uint64_t c, uint32_t (&x0)[N],
                                         uint32_t (&x1)[N]) {
  const uint32_t hi = (uint32_t)(c >> 32), lo = (uint32_t)c;
  const bool crosses = lo > 0xFFFFFFFFu - (uint32_t)(N - 1);
#pragma unroll
  for (int v = 0; v < N; ++v) {
    x1[v] = lo + (uint32_t)v;
    x0[v] = crosses && x1[v] < lo ? hi + 1u : hi;
  }
}

// The form's result for the 32-bit word w, in the low 16 bits for the
// 2-byte forms.
template <int Form>
__device__ __forceinline__ uint32_t epilogue(uint32_t w) {
  if constexpr (Form == kUniformF32)
    return __float_as_uint(__uint_as_float((w >> 9) | 0x3F800000u) - 1.f);
  else if constexpr (Form == kUniformBF16)  // k / 128: low 16 bits are 0
    return __float_as_uint(
               __uint_as_float((((w & 0xFFu) >> 1) | 0x3F80u) << 16) - 1.f) >>
           16;
  else if constexpr (Form == kUniformF16)
    return __half_as_ushort(__float2half_rn(
        __half2float(__ushort_as_half(
            (unsigned short)(((w & 0xFFFFu) >> 6) | 0x3C00u))) -
        1.f));
  else
    return w;
}

// N elements from counter c on: their results, as epilogue gives them.
template <int Form, int N>
__device__ __forceinline__ void draw(const Key& k, const Key& k2,
                                     const Fold& f, uint64_t c,
                                     uint32_t (&w)[N]) {
  uint32_t x0[N], x1[N];
  counters(c, x0, x1);
  if constexpr (Form == kRandint) {
    uint32_t y0[N], y1[N];
#pragma unroll
    for (int v = 0; v < N; ++v) {
      y0[v] = x0[v];
      y1[v] = x1[v];
    }
    threefry_bits(k, x0, x1);
    threefry_bits(k2, y0, y1);
#pragma unroll
    for (int v = 0; v < N; ++v)
      w[v] = ((x0[v] % f.span) * f.multiplier + y0[v] % f.span) % f.span +
             f.minval;
  } else {
    threefry_bits(k, x0, x1);
#pragma unroll
    for (int v = 0; v < N; ++v) w[v] = epilogue<Form>(x0[v]);
  }
}

// keys, keys2: nullptr for one key (key, key2), else rows pairs, row r's at
// keys[2 r]. key2 and keys2 are read by randint alone.
template <int Form>
__global__ void __launch_bounds__(kDrawThreads)
    draw_kernel(void* __restrict__ out, uint64_t start, int64_t n, int rows,
                Key key, const uint32_t* __restrict__ keys, Key key2,
                const uint32_t* __restrict__ keys2, Fold f) {
  constexpr int kBytes = Form == kUniformBF16 || Form == kUniformF16 ? 2 : 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const Key k = row_key(key, keys, r);
    const Key k2 = Form == kRandint ? row_key(key2, keys2, r) : key2;
    char* dst = static_cast<char*>(out) + (int64_t)r * n * kBytes;
    int64_t done = 0;
    if (((uintptr_t)dst & 15u) == 0) {
      const int64_t nv = n / kDrawVec;
      uint4* vec = reinterpret_cast<uint4*>(dst);
      for (int64_t v = t0; v < nv; v += stride) {
        uint32_t w[kDrawVec];
        draw<Form>(k, k2, f, start + (uint64_t)(v * kDrawVec), w);
        if constexpr (kBytes == 2) {
          vec[v] = make_uint4((w[0] & 0xFFFFu) | (w[1] << 16),
                              (w[2] & 0xFFFFu) | (w[3] << 16),
                              (w[4] & 0xFFFFu) | (w[5] << 16),
                              (w[6] & 0xFFFFu) | (w[7] << 16));
        } else {
          vec[2 * v] = make_uint4(w[0], w[1], w[2], w[3]);
          vec[2 * v + 1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      done = nv * kDrawVec;
    }
    for (int64_t e = done + t0; e < n; e += stride) {
      uint32_t w[1];
      draw<Form>(k, k2, f, start + (uint64_t)e, w);
      if constexpr (kBytes == 2)
        reinterpret_cast<uint16_t*>(dst)[e] = (uint16_t)w[0];
      else
        reinterpret_cast<uint32_t*>(dst)[e] = w[0];
    }
  }
}

template <int Form>
void launch_draw(dim3 grid, cudaStream_t stream, void* out, uint64_t start,
                 int64_t n, int rows, Key key, const uint32_t* keys, Key key2,
                 const uint32_t* keys2, Fold f) {
  draw_kernel<Form><<<grid, kDrawThreads, 0, stream>>>(
      out, start, n, rows, key, keys, key2, keys2, f);
}

}  // namespace ising

// out[r][e] = form(element e of row r) for r < rows, e < n (out: rows * n
// elements of the form's dtype, contiguous), drawn from counter start + e
// under key_r = (keys[2 r], keys[2 r + 1]) when keys is not null, else
// (k0, k1); randint's second key (j0, j1) or keys2 likewise, its span (> 0),
// multiplier and minval (as uint32). Returns the cudaError_t of the launch
// (0 on success; nothing is launched for an empty output).
extern "C" int ising_threefry_draw(void* out, unsigned long long start,
                                   long long n, int rows, unsigned k0,
                                   unsigned k1, const void* keys, unsigned j0,
                                   unsigned j1, const void* keys2,
                                   unsigned span, unsigned multiplier,
                                   unsigned minval, int form, void* stream) {
  if (n < 0 || rows < 0 || form < ising::kBits || form > ising::kRandint ||
      (form == ising::kRandint && span == 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  // about two waves of resident blocks (2048 threads an SM), shared by the
  // rows in flight
  const int gy = rows < 65535 ? rows : 65535;
  const int64_t most = (int64_t)sms * (2 * 2048 / ising::kDrawThreads);
  const int64_t per_row = (most + gy - 1) / gy;
  const int64_t per_block = (int64_t)ising::kDrawThreads * ising::kDrawVec;
  const int64_t need = (n + per_block - 1) / per_block;
  const dim3 grid((unsigned)(need < per_row ? need : per_row), gy);
  // one instantiation a form, by its code
  constexpr decltype(&ising::launch_draw<0>) kLaunch[] = {
      ising::launch_draw<ising::kBits>, ising::launch_draw<ising::kUniformF32>,
      ising::launch_draw<ising::kUniformBF16>,
      ising::launch_draw<ising::kUniformF16>,
      ising::launch_draw<ising::kRandint>};
  kLaunch[form](grid, static_cast<cudaStream_t>(stream), out, start, n, rows,
                ising::make_key(k0, k1), static_cast<const uint32_t*>(keys),
                ising::make_key(j0, j1), static_cast<const uint32_t*>(keys2),
                ising::Fold{span, multiplier, minval});
  return (int)cudaGetLastError();
}
