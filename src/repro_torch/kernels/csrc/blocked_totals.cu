// The measurement of a measured checkerboard chain in one pass: the exact
// spin and bond sums (m_sum, e_sum) of blocked compact quads, as int64.
// core.measure.blocked_totals launches it for a CUDA tensor.
//
// It replaces no TPU kernel: src/repro/core/measure.py leaves blocked_stats
// to XLA, which fuses the white colour's K-hat products and the reductions
// into its own loops. Eager PyTorch ran the same function as a chain of
// bf16 bmm, halo adds, f32 copies, products and reductions, each
// intermediate written to device memory and read back.
//
// The function. Quads q[4][mr][mc][bs][bs] = (A, B, C, D) of spins +-1, in
// bf16 or f32, and on the torus of each unblocked quad (an index past the
// tile reads the torus-neighbour tile, as TileHalo does)
//   nn(B)[i][j] = A[i][j] + A[i][j+1] + D[i][j] + D[i-1][j]
//   nn(C)[i][j] = A[i][j] + A[i+1][j] + D[i][j] + D[i][j-1]
// (core.checkerboard.nn_white). The outputs are
//   out[0] = m_sum = the sum of every spin of the four quads,
//   out[1] = e_sum = the sum over (i, j) of B nn(B) + C nn(C).
// The kernel takes nn(C)'s A[i+1][j] and D[i][j-1] bonds from their other
// end, so a site (i, j) needs only itself, the row above and the column to
// the right:
//   (A + D)(B + C) + B A[i][j+1] + B D[i-1][j] + D C[i][j+1] + A C[i-1][j],
// the same eight bonds a site, each bond of the lattice once.
//
// Arithmetic: integers only. A spin is its sign bit s (sigma = 1 - 2s), so
// sigma_x sigma_y = 1 - 2 (s_x ^ s_y). A thread counts the negative spins
// and the unsatisfied bonds (xors) of its run of rows in the 16-bit lanes
// of 32-bit words (one bf16 site a lane, an f32 site a word), turns them
// into m = 4n - 2 neg and e = 8n - 2 unsat for its n sites, and adds those
// to its int32 sums. A block sums its threads with warp shuffles and shared
// memory, then adds its two totals to out[] with one 64-bit atomicAdd each.
// Integer sums do not depend on their order, so the result is exact at any
// size (|m_sum| <= 6.71e9, |e_sum| <= 1.34e10 at 81920^2) and the same on
// every run.
//
// Bound, at 81920^2 in bf16 ([4, 320, 320, 128, 128]): bytes. It reads
// each spin once, 2 B a lattice site: 13.42 GB, 4.01 ms at 3.35 TB/s. Its
// integer work is about 24 ALU instructions for each 16-byte word of the
// four quads (8 lattice sites): 3 a site, 1.2 ms at 64 a clock on 132 SMs
// at 1.98 GHz.
//
// The design for that bound:
// * one 16-byte load a thread per quad row (8 bf16 or 4 f32 sites); the
//   j + 1 neighbour across a vector boundary comes from the next lane
//   (__shfl_down_sync within the row's lanes), and only the last lane of a
//   row reads one element of the tile to the right, which the L2 mostly
//   holds (at worst 2 rows in bs of two quads);
// * each thread marches down a run of rows and keeps the row above of C
//   and D in registers; only a run's first row reads the row above (from
//   the tile above at the top of a tile);
// * the next row's four loads are issued before this row is counted, so a
//   thread keeps eight 16-byte loads in flight;
// * a persistent grid: as many blocks as fit on the SMs at once walk the
//   tiles, so a sweep ends in one atomicAdd pair a block;
// * bs is a template parameter for 16, 32, 64 and 128; one generic
//   instantiation (a site a thread, every neighbour from memory) takes any
//   other bs, or quads that are not 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ising {

enum TotalsDType { kTotalsFloat32 = 0, kTotalsBFloat16 = 1 };

constexpr int kTotalsThreads = 256;  // threads per block
constexpr int kWords = 4;            // 32-bit words of one 16-byte load
constexpr unsigned kAll = 0xffffffffu;

// Sign bits of packed spins, one counter lane per site.
template <typename T>
struct Signs;

template <>
struct Signs<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // The sign bits of a word's two sites, in bits 0 and 16.
  __device__ __forceinline__ static uint32_t of(uint32_t w) {
    return (w >> 15) & 0x00010001u;
  }
  // The lanes shifted one site along j: w's high site, then w1's low one.
  __device__ __forceinline__ static uint32_t next(uint32_t w, uint32_t w1) {
    return __funnelshift_r(w, w1, 16);
  }
  __device__ __forceinline__ static uint32_t total(uint32_t lanes) {
    return (lanes & 0xffffu) + (lanes >> 16);
  }
  // The sign bit of one site, in bit 0.
  __device__ __forceinline__ static uint32_t one(const __nv_bfloat16* p) {
    return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) >> 15;
  }
};

template <>
struct Signs<float> {
  static constexpr int kPerWord = 1;
  __device__ __forceinline__ static uint32_t of(uint32_t w) { return w >> 31; }
  __device__ __forceinline__ static uint32_t next(uint32_t, uint32_t w1) {
    return w1;
  }
  __device__ __forceinline__ static uint32_t total(uint32_t lanes) {
    return lanes;
  }
  __device__ __forceinline__ static uint32_t one(const float* p) {
    return __ldg(reinterpret_cast<const unsigned*>(p)) >> 31;
  }
};

// Adds a block's (m, e) to out[0], out[1]. Every thread of the block calls
// it once.
__device__ __forceinline__ void add_block_totals(int m, int e,
                                                 unsigned long long* out) {
  long long bm = m, be = e;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    bm += __shfl_xor_sync(kAll, bm, o);
    be += __shfl_xor_sync(kAll, be, o);
  }
  __shared__ long long wm[kTotalsThreads / 32], we[kTotalsThreads / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    wm[warp] = bm;
    we[warp] = be;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bm = be = 0;
#pragma unroll
    for (int w = 0; w < kTotalsThreads / 32; ++w) {
      bm += wm[w];
      be += we[w];
    }
    // two's complement: the unsigned sum is the signed one
    atomicAdd(out, (unsigned long long)bm);
    atomicAdd(out + 1, (unsigned long long)be);
  }
}

// The vector form's layout: V sites a thread along j, LANES threads a row,
// runs of ROWS rows, TILES tiles a block.
template <typename T, int BS>
struct TotalsLayout {
  static constexpr int V = kWords * Signs<T>::kPerWord;
  static constexpr int LANES = BS / V;
  static constexpr int ROWS =
      LANES * BS / kTotalsThreads > 8 ? LANES * BS / kTotalsThreads : 8;
  static constexpr int RUNS = BS / ROWS;
  static constexpr int PER_TILE = LANES * RUNS;
  static constexpr int TILES = kTotalsThreads / PER_TILE;
  static_assert(LANES >= 1 && 32 % LANES == 0 && RUNS >= 1 &&
                    kTotalsThreads % PER_TILE == 0,
                "a row's lanes lie in one warp, and tiles fill a block");
};

// One row of a thread as loaded: the four quads' 16-byte words, and the
// sign bits of A and C just right of the tile (the row's last lane only).
struct RawRow {
  uint4 a, b, c, d;
  uint32_t a_right, c_right;
};

template <typename T>
__device__ __forceinline__ void signs_of(uint32_t (&s)[kWords], uint4 v) {
  s[0] = Signs<T>::of(v.x);
  s[1] = Signs<T>::of(v.y);
  s[2] = Signs<T>::of(v.z);
  s[3] = Signs<T>::of(v.w);
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Vector form: bs = BS in {16, 32, 64, 128}. Block g of the walk covers
// tiles [g * TILES, (g + 1) * TILES) of the [mr * mc] tiles in order.
template <typename T, int BS>
__global__ void __launch_bounds__(kTotalsThreads)
    blocked_totals_vec(const T* __restrict__ q, int64_t nq, int mr, int mc,
                       int64_t groups, unsigned long long* out) {
  using Lay = TotalsLayout<T, BS>;
  using S = Signs<T>;
  constexpr int64_t kTile = (int64_t)BS * BS;
  const T* qa = q;
  const T* qb = q + nq;
  const T* qc = q + 2 * nq;
  const T* qd = q + 3 * nq;
  const int t = threadIdx.x;
  const int lane = t % Lay::LANES;
  const int i0 = (t / Lay::LANES) % Lay::RUNS * Lay::ROWS;
  const int j0 = lane * Lay::V;
  const bool edge = lane == Lay::LANES - 1;
  const int64_t ntiles = (int64_t)mr * mc;
  int m = 0, e = 0;

  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    int64_t tile = g * Lay::TILES + t / Lay::PER_TILE;
    const bool live = tile < ntiles;
    if (!live) tile = ntiles - 1;  // count a real tile (shuffles), add 0
    const int r = (int)(tile / mc);
    const int c = (int)(tile - (int64_t)r * mc);
    const int64_t at0 = tile * kTile + (int64_t)i0 * BS + j0;
    // column 0 of the tile to the right, in this thread's first row
    const int64_t right0 =
        ((int64_t)r * mc + (c == mc - 1 ? 0 : c + 1)) * kTile +
        (int64_t)i0 * BS;
    auto load_row = [&](RawRow& row, int ii) {
      const int64_t at = at0 + (int64_t)ii * BS;
      row.a = load16(qa + at);
      row.b = load16(qb + at);
      row.c = load16(qc + at);
      row.d = load16(qd + at);
      row.a_right = row.c_right = 0;
      if (edge) {
        row.a_right = S::one(qa + right0 + (int64_t)ii * BS);
        row.c_right = S::one(qc + right0 + (int64_t)ii * BS);
      }
    };

    // The row above the run: C and D of row i0 - 1.
    uint32_t cu[kWords], du[kWords];
    {
      const int64_t up =
          i0 > 0 ? at0 - BS
                 : ((int64_t)(r == 0 ? mr - 1 : r - 1) * mc + c) * kTile +
                       (int64_t)(BS - 1) * BS + j0;
      signs_of<T>(cu, load16(qc + up));
      signs_of<T>(du, load16(qd + up));
    }
    RawRow cur;
    load_row(cur, 0);
    uint32_t neg = 0, unsat = 0;  // counts in lanes
#pragma unroll
    for (int ii = 0; ii < Lay::ROWS; ++ii) {
      RawRow nxt;
      if (ii + 1 < Lay::ROWS) load_row(nxt, ii + 1);
      uint32_t a[kWords], b[kWords], c4[kWords], d[kWords];
      signs_of<T>(a, cur.a);
      signs_of<T>(b, cur.b);
      signs_of<T>(c4, cur.c);
      signs_of<T>(d, cur.d);
      // the first sites of the next lane's words, or of the next tile
      uint32_t a_next = __shfl_down_sync(kAll, a[0], 1, Lay::LANES);
      uint32_t c_next = __shfl_down_sync(kAll, c4[0], 1, Lay::LANES);
      if (edge) {
        a_next = cur.a_right;
        c_next = cur.c_right;
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const uint32_t ar = S::next(a[k], k + 1 < kWords ? a[k + 1] : a_next);
        const uint32_t cr =
            S::next(c4[k], k + 1 < kWords ? c4[k + 1] : c_next);
        neg += a[k] + b[k];
        neg += c4[k] + d[k];
        unsat += (a[k] ^ b[k]) + (a[k] ^ c4[k]);
        unsat += (d[k] ^ b[k]) + (d[k] ^ c4[k]);
        unsat += (b[k] ^ ar) + (b[k] ^ du[k]);
        unsat += (d[k] ^ cr) + (a[k] ^ cu[k]);
        cu[k] = c4[k];
        du[k] = d[k];
      }
      if (ii + 1 < Lay::ROWS) cur = nxt;
    }
    if (live) {
      constexpr int kSites = Lay::V * Lay::ROWS;
      m += 4 * kSites - 2 * (int)S::total(neg);
      e += 8 * kSites - 2 * (int)S::total(unsat);
    }
  }
  add_block_totals(m, e, out);
}

// Generic form: any bs and alignment, one site a thread at a time, every
// neighbour read from memory.
template <typename T>
__global__ void __launch_bounds__(kTotalsThreads)
    blocked_totals_any(const T* __restrict__ q, int64_t nq, int mr, int mc,
                       int bs, unsigned long long* out) {
  using S = Signs<T>;
  const T* qa = q;
  const T* qb = q + nq;
  const T* qc = q + 2 * nq;
  const T* qd = q + 3 * nq;
  const int64_t tile_n = (int64_t)bs * bs;
  int m = 0, e = 0;
  for (int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; f < nq;
       f += (int64_t)gridDim.x * blockDim.x) {
    const int j = (int)(f % bs);
    const int i = (int)(f / bs % bs);
    const int64_t tile = f / tile_n;
    const int r = (int)(tile / mc);
    const int c = (int)(tile % mc);
    const int64_t right =
        j + 1 < bs ? f + 1
                   : ((int64_t)r * mc + (c == mc - 1 ? 0 : c + 1)) * tile_n +
                         (int64_t)i * bs;
    const int64_t up =
        i > 0 ? f - bs
              : ((int64_t)(r == 0 ? mr - 1 : r - 1) * mc + c) * tile_n +
                    (int64_t)(bs - 1) * bs + j;
    const uint32_t a = S::one(qa + f), b = S::one(qb + f),
                   c1 = S::one(qc + f), d = S::one(qd + f);
    const uint32_t unsat = (a ^ b) + (a ^ c1) + (d ^ b) + (d ^ c1) +
                           (b ^ S::one(qa + right)) + (b ^ S::one(qd + up)) +
                           (d ^ S::one(qc + right)) + (a ^ S::one(qc + up));
    m += 4 - 2 * (int)(a + b + c1 + d);
    e += 8 - 2 * (int)unsat;
  }
  add_block_totals(m, e, out);
}

// Blocks of a persistent grid: as many as fit on the card's SMs at once,
// and no more than there is work for.
template <class Kernel>
int persistent_blocks(Kernel kernel, int64_t work, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kTotalsThreads, 0);
  const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(work < most ? (work > 0 ? work : 1) : most);
  return (int)err;
}

template <typename T>
int launch_blocked_totals(const T* q, unsigned long long* out, int mr, int mc,
                          int bs, bool vec_ok, cudaStream_t stream) {
  const int64_t nq = (int64_t)mr * mc * bs * bs;
  auto vec = [&](auto bs_tag) {
    constexpr int BS = decltype(bs_tag)::value;
    const auto kernel = blocked_totals_vec<T, BS>;
    constexpr int TILES = TotalsLayout<T, BS>::TILES;
    const int64_t groups = ((int64_t)mr * mc + TILES - 1) / TILES;
    int blocks = 0;
    if (int err = persistent_blocks(kernel, groups, &blocks)) return err;
    kernel<<<blocks, kTotalsThreads, 0, stream>>>(q, nq, mr, mc, groups, out);
    return (int)cudaGetLastError();
  };
  if (vec_ok) {
    switch (bs) {
      case 16: return vec(std::integral_constant<int, 16>{});
      case 32: return vec(std::integral_constant<int, 32>{});
      case 64: return vec(std::integral_constant<int, 64>{});
      case 128: return vec(std::integral_constant<int, 128>{});
      default: break;
    }
  }
  const auto kernel = blocked_totals_any<T>;
  int blocks = 0;
  if (int err = persistent_blocks(
          kernel, (nq + kTotalsThreads - 1) / kTotalsThreads, &blocks))
    return err;
  kernel<<<blocks, kTotalsThreads, 0, stream>>>(q, nq, mr, mc, bs, out);
  return (int)cudaGetLastError();
}

}  // namespace ising

// out[0] = the sum of the spins of q[4][mr][mc][bs][bs], out[1] = the sum
// of sigma nn over its white quads B and C (out: two int64, zeroed here on
// the stream first). Returns the cudaError_t of the zeroing or the launch
// (0 on success).
extern "C" int ising_blocked_totals(const void* q, void* out, int mr, int mc,
                                    int bs, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* sums = static_cast<unsigned long long*>(out);
  if (mr < 1 || mc < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  if (dtype != ising::kTotalsFloat32 && dtype != ising::kTotalsBFloat16)
    return (int)cudaErrorInvalidValue;
  if (cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(long long), s))
    return (int)err;
  const bool vec_ok = ((uintptr_t)q & 15u) == 0;
  if (dtype == ising::kTotalsBFloat16)
    return ising::launch_blocked_totals(
        static_cast<const __nv_bfloat16*>(q), sums, mr, mc, bs, vec_ok, s);
  return ising::launch_blocked_totals(static_cast<const float*>(q), sums, mr,
                                      mc, bs, vec_ok, s);
}
