// fold_in over a tensor of counters: for every element c, the last word of
// fold_in(key, c), which is x1 of threefry2x32(key, (0, c)), as uint32.
// repro_torch.random.fold_in_bits launches it for int32 counters on a CUDA
// device; the CPU keeps the eager int64 form beside it, which is bitwise
// the JAX package's jax.random.fold_in.
//
// It replaces no TPU kernel: the reference vmaps fold_in and leaves the
// hash to XLA, which fuses its rounds into one loop. Eager PyTorch ran the
// same hash as about 130 in-place passes over int64 lanes, each one read
// and written back to device memory.
//
// Callers: the cluster plane's bond bits (fold_in(k, 0) of 2 g + d) and
// coins (fold_in(k, 1) of the cluster label), Wolff's bonds, the Potts
// cluster states and checkerboard rules, the 3-D xla sweep's site uniforms
// and the mesh cluster paths, all with int32 counters.
//
// Key batches: row r of the [rows, n] counters is hashed under key r.
// Rows lie row_stride elements apart (0 for counters that every key
// shares, read in place), the output is [rows, n] contiguous. The rows'
// key pairs come in one small device buffer; a single key comes by value.
//
// Bound, at 5120^2 (2.62e7 counters a pass): integer issue and bytes about
// even. A hash is 20 rounds of add, funnel-shift and xor plus the key
// injections, about 71 instructions, of which the 40 rotations and xors
// issue only on the integer ALU: 0.625 SM clocks at 64 a clock, 0.063 ms a
// pass on 132 SMs at 1.98 GHz. It reads 4 B and writes 4 B a counter:
// 0.21 GB, 0.063 ms at 3.35 TB/s.
//
// The design for that bound:
// * one 16-byte load and store a thread per trip (4 counters), where both
//   rows are 16-byte aligned; the four hashes are independent and advance
//   together, round by round, for ILP;
// * a grid-stride loop over a row with a grid of about two waves of
//   resident blocks, blockIdx.y over rows; a scalar tail takes lengths
//   that are not a multiple of 4, and a scalar loop takes a row that is
//   not aligned;
// * counters are read as uint32, so negative int32 patterns hash as the
//   eager form's c & 0xffffffff does.
#include "checkerboard_common.cuh"

namespace ising {

constexpr int kFoldThreads = 256;  // threads per block
constexpr int kFoldVec = 4;        // counters per 16-byte load

// In: N counters c in x1. Out: x1 of threefry2x32(k, (0, c)) for each.
// The five inject / round steps of threefry_bits, with x0 = 0 and the
// final x0 word never formed.
template <int N>
__device__ __forceinline__ void fold_in_x1(const Key& k, uint32_t (&x1)[N]) {
  uint32_t x0[N];
#pragma unroll
  for (int v = 0; v < N; ++v) x0[v] = 0u;
  tf_inject(x0, x1, k.k0, k.k1);
  tf_rounds(x0, x1, 13, 15, 26, 6);
  tf_inject(x0, x1, k.k1, k.k2 + 1u);
  tf_rounds(x0, x1, 17, 29, 16, 24);
  tf_inject(x0, x1, k.k2, k.k0 + 2u);
  tf_rounds(x0, x1, 13, 15, 26, 6);
  tf_inject(x0, x1, k.k0, k.k1 + 3u);
  tf_rounds(x0, x1, 17, 29, 16, 24);
  tf_inject(x0, x1, k.k1, k.k2 + 4u);
  tf_rounds(x0, x1, 13, 15, 26, 6);
#pragma unroll
  for (int v = 0; v < N; ++v) x1[v] += k.k0 + 5u;
}

// keys: nullptr for one key (key), else rows pairs (k0, k1), row r's at
// keys[2 r].
__global__ void __launch_bounds__(kFoldThreads)
    fold_in_bits_kernel(const uint32_t* __restrict__ c,
                        uint32_t* __restrict__ out, int64_t n,
                        int64_t row_stride, int rows, Key key,
                        const uint32_t* __restrict__ keys) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    Key k = key;
    if (keys != nullptr) {
      const uint32_t a = __ldg(keys + 2 * r), b = __ldg(keys + 2 * r + 1);
      k = Key{a, b, a ^ b ^ kParity};
    }
    const uint32_t* src = c + (int64_t)r * row_stride;
    uint32_t* dst = out + (int64_t)r * n;
    int64_t done = 0;
    if ((((uintptr_t)src | (uintptr_t)dst) & 15u) == 0) {
      const int64_t nv = n / kFoldVec;
      for (int64_t v = t0; v < nv; v += stride) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(src) + v);
        uint32_t x[kFoldVec] = {w.x, w.y, w.z, w.w};
        fold_in_x1(k, x);
        reinterpret_cast<uint4*>(dst)[v] = make_uint4(x[0], x[1], x[2], x[3]);
      }
      done = nv * kFoldVec;
    }
    for (int64_t e = done + t0; e < n; e += stride) {
      uint32_t x[1] = {__ldg(src + e)};
      fold_in_x1(k, x);
      dst[e] = x[0];
    }
  }
}

}  // namespace ising

// out[r][e] = x1 of threefry2x32(key_r, (0, counters[r * row_stride + e]))
// for r < rows, e < n (out: rows * n uint32, contiguous). key_r is
// (keys[2 r], keys[2 r + 1]) when keys is not null, else (k0, k1). Returns
// the cudaError_t of the launch (0 on success; nothing is launched for an
// empty output).
extern "C" int ising_fold_in_bits(const void* counters, void* out,
                                  long long n, long long row_stride, int rows,
                                  unsigned k0, unsigned k1, const void* keys,
                                  void* stream) {
  if (n < 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || rows == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return (int)err;
  // about two waves of resident blocks (2048 threads an SM), shared by the
  // rows in flight
  const int gy = rows < 65535 ? rows : 65535;
  const int64_t most = (int64_t)sms * (2 * 2048 / ising::kFoldThreads);
  const int64_t per_row = (most + gy - 1) / gy;
  const int64_t need = (n + (int64_t)ising::kFoldThreads * ising::kFoldVec - 1) /
                       ((int64_t)ising::kFoldThreads * ising::kFoldVec);
  const int gx = (int)(need < per_row ? need : per_row);
  ising::fold_in_bits_kernel<<<dim3(gx, gy), ising::kFoldThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), static_cast<uint32_t*>(out), n,
      row_stride, rows, ising::make_key(k0, k1),
      static_cast<const uint32_t*>(keys));
  return (int)cudaGetLastError();
}
