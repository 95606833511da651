// Shared device code of the two checkerboard half-sweep kernels: the rule,
// threefry2x32, and the one templated body that both kernels run.
//
// Layout: blocked compact quads q[4][mr][mc][bs][bs] (A, B, C, D), one
// colour's bits[2][mr][mc][bs][bs] as uint32. Black (colour 0) updates
// s0 = A and s1 = D from the passive p0 = B and p1 = C; white (colour 1)
// updates s0 = B and s1 = C from p0 = A and p1 = D. With dx = -1 for black
// and +1 for white, the neighbour sums are
//   nn(s0)[i][j] = p0[i][j] + p0[i][j+dx] + p1[i][j] + p1[i-1][j]
//   nn(s1)[i][j] = p1[i][j] + p1[i][j-dx] + p0[i][j] + p0[i+1][j]
// where an index that leaves the tile reads the torus-neighbour tile (or,
// in the edge-lines kernel, the halo line passed in). This is the same
// function as the K-hat products of repro.core.checkerboard.nn_black /
// nn_white. The sums are integers in [-4, 4], exact in f32, so their order
// is free.
//
// Two sources of bits, one body (template flag KEYED):
// * operand form: bits[plane][r][c][i][j] read from device memory;
// * keyed form: x0 ^ x1 of threefry2x32((k0, k1), (n >> 32, n & 0xffffffff))
//   for the site's 64-bit flat index n in [2, mr, mc, bs, bs] (plane 0 is
//   s0, plane 1 is s1), which is what repro_torch.random.bits draws under
//   the colour key fold_in(fold_in(key, step), color) at that index.
//
// Design for the H100 (the stencil does about 10 flops per site; the work
// is bytes in flight and, in the keyed form, integer issue):
// * V = 8 sites per thread along j: one 16-byte load or store per quad row
//   in bf16, two in f32; a bit plane is two 16-byte loads. The j +- 1
//   neighbour across a vector boundary comes from the neighbouring lane
//   (__shfl_up/down_sync within the row's lanes); only the lane at the tile
//   edge reads one element of the neighbour tile or the halo line.
// * Each thread marches down kRows rows and keeps p1 row i-1 and p0 row i
//   in registers, so a passive row is read once per run (plus one row at
//   each end of the run); the next row's loads are issued before this row
//   is computed (software pipelined, two row buffers).
// * bs is a template parameter for 16, 32, 64 and 128, and every index is
//   a compare, a select, a shift or a product: tiles come from a 2-D grid
//   (blockIdx.y = r, blockIdx.x = a group of tiles along c), lanes and runs
//   from compile-time powers of two, and the torus wraps by compare and
//   select. One generic instantiation (V = 1, bs at run time, a (32, 8)
//   block over (j, run)) takes any other bs, or operands that are not
//   16-byte aligned.
// * Keyed form: the hashes of a row's 2V sites are independent and are
//   computed together, interleaved round by round for ILP; the key
//   schedule is three kernel parameters (uniform registers). The row loop
//   is not unrolled (one row per trip, so the code stays in the
//   instruction cache); the operand form unrolls all kRows rows.
// * Shared memory, cp.async and TMA are not used: no measurement has shown
//   that staging the rows through shared memory would help a stencil whose
//   every passive element is already read once into registers.
// * The rule stays a runtime flag. Two uniform factors in its place cut
//   the keyed row loop from 117 to 100 instructions a site, but left the
//   keyed time where it was, since that is bound by the integer ALU. They
//   also took the bs-128 operand tiles kernel past 128 registers, and it
//   ran 12% slower (PERF.md).
// Updates stay in place: an active site reads only passive quads (or halo
// lines) and its own spin, so no thread reads what another writes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ising {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 8;       // rows each thread marches down
constexpr int kVec = 8;        // sites per thread along j (vector form)
constexpr uint32_t kParity = 0x1BD11BDA;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);  // v is a bf16 value or +-1: exact
}

// The five f32 table values of the update rule, for x = -4, -2, 0, 2, 4.
struct Table {
  float t[5];
};

// The reference's select chain (thresholds x <= -3, -1, 1, 3), written as
// selects from the top so that it compiles to compares and selects, not
// branches: the chain of ternaries became branches and constant loads in
// the keyed row loop, and both forms ran slower on the card (PERF.md).
__device__ __forceinline__ float select5(float x, const Table& tab) {
  float t = x <= 3.f ? tab.t[3] : tab.t[4];
  t = x <= 1.f ? tab.t[2] : t;
  t = x <= -1.f ? tab.t[1] : t;
  return x <= -3.f ? tab.t[0] : t;
}

// New spin for one site. u = (bits >> 8) * 2^-24 is exact in f32.
// Metropolis flips sigma when u < table(sigma * nn); heat-bath sets +1 when
// u < table(nn), else -1.
__device__ __forceinline__ float new_spin(float sigma, float nn,
                                          uint32_t bits, int heat_bath,
                                          const Table& tab) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;
  const bool below = u < select5(heat_bath ? nn : nn * sigma, tab);
  return below ? (heat_bath ? 1.f : -sigma) : (heat_bath ? -1.f : sigma);
}

// ---------------------------------------------------------------------------
// threefry2x32 (20 rounds), as repro_torch.random.threefry2x32
// ---------------------------------------------------------------------------

// The key schedule (k0, k1, k0 ^ k1 ^ parity).
struct Key {
  uint32_t k0, k1, k2;
};

inline Key make_key(uint32_t k0, uint32_t k1) {
  return Key{k0, k1, k0 ^ k1 ^ kParity};
}

template <int N>
__device__ __forceinline__ void tf_rounds(uint32_t (&x0)[N], uint32_t (&x1)[N],
                                          int r0, int r1, int r2, int r3) {
  const int rot[4] = {r0, r1, r2, r3};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int v = 0; v < N; ++v) {
      x0[v] += x1[v];
      x1[v] = __funnelshift_l(x1[v], x1[v], rot[s]) ^ x0[v];
    }
  }
}

template <int N>
__device__ __forceinline__ void tf_inject(uint32_t (&x0)[N], uint32_t (&x1)[N],
                                          uint32_t a, uint32_t b) {
#pragma unroll
  for (int v = 0; v < N; ++v) {
    x0[v] += a;
    x1[v] += b;
  }
}

// In: the counter words (x0, x1) = (n >> 32, n & 0xffffffff) of N sites.
// Out: x0 = the 32-bit draw x0 ^ x1 of each. The N hashes are independent
// and advance together, round by round.
template <int N>
__device__ __forceinline__ void threefry_bits(const Key& k, uint32_t (&x0)[N],
                                              uint32_t (&x1)[N]) {
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
  tf_inject(x0, x1, k.k2, k.k0 + 5u);
#pragma unroll
  for (int v = 0; v < N; ++v) x0[v] ^= x1[v];
}

// ---------------------------------------------------------------------------
// Rows of V sites in registers
// ---------------------------------------------------------------------------

// V elements of one row, as raw 32-bit words loaded 16 bytes at a time
// (V * sizeof(T) a multiple of 16), or one scalar (V = 1).
template <typename T, int V>
struct Row {
  static constexpr int kWords = V * (int)sizeof(T) / 4;
  static_assert(kWords % 4 == 0, "a vector row is whole 16-byte chunks");
  uint32_t w[kWords];

  // Passive rows: read-only for the whole kernel, so the non-coherent path.
  __device__ __forceinline__ void load_ro(const T* p) {
#pragma unroll
    for (int n = 0; n < kWords / 4; ++n) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + n);
      w[4 * n] = v.x;
      w[4 * n + 1] = v.y;
      w[4 * n + 2] = v.z;
      w[4 * n + 3] = v.w;
    }
  }
  // Active rows: this thread reads them and then writes them.
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int n = 0; n < kWords / 4; ++n) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[n];
      w[4 * n] = v.x;
      w[4 * n + 1] = v.y;
      w[4 * n + 2] = v.z;
      w[4 * n + 3] = v.w;
    }
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int n = 0; n < kWords / 4; ++n)
      reinterpret_cast<uint4*>(p)[n] =
          make_uint4(w[4 * n], w[4 * n + 1], w[4 * n + 2], w[4 * n + 3]);
  }
  __device__ __forceinline__ uint32_t raw(int k) const { return w[k]; }
  __device__ __forceinline__ float at(int k) const {
    if constexpr (sizeof(T) == 2)  // bf16: the high half of an f32
      return __uint_as_float((k & 1) ? (w[k >> 1] & 0xffff0000u)
                                     : (w[k >> 1] << 16));
    else
      return __uint_as_float(w[k]);
  }
  // Element k := v, where v is a bf16 value widened to f32 (exact).
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (sizeof(T) == 2) {
      const uint32_t b = __float_as_uint(v);
      w[k >> 1] = (k & 1) ? ((w[k >> 1] & 0xffffu) | (b & 0xffff0000u))
                          : ((w[k >> 1] & 0xffff0000u) | (b >> 16));
    } else {
      w[k] = __float_as_uint(v);
    }
  }
};

template <typename T>
struct Row<T, 1> {
  T s;
  __device__ __forceinline__ void load_ro(const T* p) { s = __ldg(p); }
  __device__ __forceinline__ void load(const T* p) { s = *p; }
  __device__ __forceinline__ void store(T* p) const { *p = s; }
  __device__ __forceinline__ float at(int) const { return to_f32(s); }
  __device__ __forceinline__ void set(int, float v) { s = from_f32<T>(v); }
};

template <int V>
struct BitsRow : Row<uint32_t, V> {};

template <>
struct BitsRow<1> {
  uint32_t s;
  __device__ __forceinline__ void load_ro(const uint32_t* p) { s = __ldg(p); }
  __device__ __forceinline__ uint32_t raw(int) const { return s; }
};

// ---------------------------------------------------------------------------
// The half-sweep body
// ---------------------------------------------------------------------------

template <typename T>
struct Params {
  T* q;                  // [4][mr][mc][bs][bs], updated in place
  const uint32_t* bits;  // [2][mr][mc][bs][bs] (operand form)
  int64_t nq;            // elements per quad
  int mr, mc, bs;
  int heat_bath;
  Table tab;
  Key key;               // the colour key's schedule (keyed form)
};

// The quads of one colour.
template <typename T, int COLOR>
struct Roles {
  T* s0;
  T* s1;
  const T* p0;
  const T* p1;
  __device__ __forceinline__ explicit Roles(const Params<T>& p)
      : s0(p.q + (COLOR ? 1 : 0) * p.nq),
        s1(p.q + (COLOR ? 2 : 3) * p.nq),
        p0(p.q + (COLOR ? 0 : 1) * p.nq),
        p1(p.q + (COLOR ? 3 : 2) * p.nq) {}
};

// Everything one row of one thread reads besides the carried rows.
template <typename T, int V, bool KEYED>
struct RowIn {
  Row<T, V> p1;      // p1 row i
  Row<T, V> p0next;  // p0 row i + 1 (halo past the tile)
  Row<T, V> s0, s1;  // the active spins of row i
  BitsRow<V> b0, b1; // operand form only
  float e0, e1;      // p0[i][j + dx] and p1[i][j - dx] beyond the row's
                     // V sites, where this lane must read them itself
};

// One thread's run: rows [i0, i0 + nrows) of columns [j0, j0 + V) of tile
// (r, c). `lane` of `lanes` is this thread's place in the row (vector
// form); `live` is false for a padding thread that computes (it takes part
// in the shuffles) but stores nothing. Halo supplies what lies beyond the
// tile: row_above (p1 row -1, a pointer), row_below (p0 row bs, a
// pointer), side0<dx> (the element of p0 at column j + dx off the tile) and
// side1<dx> (p1 at column j - dx off the tile).
template <typename T, int V, int COLOR, bool KEYED, int UNROLL, class Halo>
__device__ __forceinline__ void march(const Params<T>& p, const Halo& h,
                                      int bs, int r, int c, int i0,
                                      int nrows, int j0, int lane, int lanes,
                                      bool live) {
  constexpr int DX = COLOR ? 1 : -1;
  const Roles<T, COLOR> q(p);
  const int64_t tile = ((int64_t)r * p.mc + c) * ((int64_t)bs * bs);
  const bool left_edge = lane == 0;
  const bool right_edge = lane == lanes - 1;

  auto load_in = [&](RowIn<T, V, KEYED>& in, int i) {
    const int64_t at = tile + (int64_t)i * bs + j0;
    in.p1.load_ro(q.p1 + at);
    if (i + 1 < bs)
      in.p0next.load_ro(q.p0 + at + bs);
    else
      in.p0next.load_ro(h.row_below(q.p0, r, c, j0));
    in.s0.load(q.s0 + at);
    in.s1.load(q.s1 + at);
    if constexpr (!KEYED) {
      in.b0.load_ro(p.bits + at);
      in.b1.load_ro(p.bits + p.nq + at);
    }
    if constexpr (V == 1) {
      // Generic form: both neighbours from memory, in the tile or beyond.
      const int ja = j0 + DX, jb = j0 - DX;
      in.e0 = (ja >= 0 && ja < bs)
                  ? to_f32(__ldg(q.p0 + at + DX))
                  : to_f32(h.template side0<DX>(q.p0, r, c, i));
      in.e1 = (jb >= 0 && jb < bs)
                  ? to_f32(__ldg(q.p1 + at - DX))
                  : to_f32(h.template side1<DX>(q.p1, r, c, i));
    } else {
      // Vector form: only the lane at the tile edge reads beyond it.
      in.e0 = 0.f;
      in.e1 = 0.f;
      if (DX < 0 ? left_edge : right_edge)
        in.e0 = to_f32(h.template side0<DX>(q.p0, r, c, i));
      if (DX < 0 ? right_edge : left_edge)
        in.e1 = to_f32(h.template side1<DX>(q.p1, r, c, i));
    }
  };

  // The carried rows: p1 row i0 - 1 and p0 row i0.
  Row<T, V> p1up, p0cur;
  {
    const int64_t at = tile + (int64_t)i0 * bs + j0;
    if (i0 > 0)
      p1up.load_ro(q.p1 + at - bs);
    else
      p1up.load_ro(h.row_above(q.p1, r, c, j0));
    p0cur.load_ro(q.p0 + at);
  }
  RowIn<T, V, KEYED> cur;
  load_in(cur, i0);

#pragma unroll UNROLL
  for (int ii = 0; ii < nrows; ++ii) {
    const int i = i0 + ii;
    RowIn<T, V, KEYED> next;
    if (ii + 1 < nrows) load_in(next, i + 1);

    // The 32-bit draws of the row's 2V sites.
    uint32_t b0[V], b1[V];
    if constexpr (KEYED) {
      uint32_t x0[2 * V], x1[2 * V];
      const uint64_t n = (uint64_t)(tile + (int64_t)i * bs + j0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const uint64_t n0 = n + k, n1 = n + (uint64_t)p.nq + k;
        x0[k] = (uint32_t)(n0 >> 32);
        x1[k] = (uint32_t)n0;
        x0[V + k] = (uint32_t)(n1 >> 32);
        x1[V + k] = (uint32_t)n1;
      }
      threefry_bits<2 * V>(p.key, x0, x1);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        b0[k] = x0[k];
        b1[k] = x0[V + k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        b0[k] = cur.b0.raw(k);
        b1[k] = cur.b1.raw(k);
      }
    }

    // Neighbours across the vector's ends: the next lane's element, or
    // this lane's own read beyond the tile.
    float a0_end, a1_end;
    if constexpr (V == 1) {
      a0_end = cur.e0;
      a1_end = cur.e1;
    } else {
      const unsigned all = 0xffffffffu;
      if constexpr (DX < 0) {
        const float up = __shfl_up_sync(all, p0cur.at(V - 1), 1, lanes);
        const float dn = __shfl_down_sync(all, cur.p1.at(0), 1, lanes);
        a0_end = left_edge ? cur.e0 : up;
        a1_end = right_edge ? cur.e1 : dn;
      } else {
        const float dn = __shfl_down_sync(all, p0cur.at(0), 1, lanes);
        const float up = __shfl_up_sync(all, cur.p1.at(V - 1), 1, lanes);
        a0_end = right_edge ? cur.e0 : dn;
        a1_end = left_edge ? cur.e1 : up;
      }
    }

#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int k0 = k + DX, k1 = k - DX;
      const float a0 = (k0 >= 0 && k0 < V) ? p0cur.at(k0 < 0 ? 0 : k0 % V)
                                           : a0_end;
      const float a1 = (k1 >= 0 && k1 < V) ? cur.p1.at(k1 < 0 ? 0 : k1 % V)
                                           : a1_end;
      const float p0c = p0cur.at(k), p1c = cur.p1.at(k);
      const float nn0 = p0c + a0 + p1c + p1up.at(k);
      const float nn1 = p1c + a1 + p0c + cur.p0next.at(k);
      cur.s0.set(k, new_spin(cur.s0.at(k), nn0, b0[k], p.heat_bath, p.tab));
      cur.s1.set(k, new_spin(cur.s1.at(k), nn1, b1[k], p.heat_bath, p.tab));
    }
    if (live) {
      const int64_t at = tile + (int64_t)i * bs + j0;
      cur.s0.store(q.s0 + at);
      cur.s1.store(q.s1 + at);
    }
    p1up = cur.p1;
    p0cur = cur.p0next;
    cur = next;
  }
}

// Vector form: bs = BS in {16, 32, 64, 128}, V = kVec sites per thread,
// kRows rows per run. A block of kThreads covers kThreads / (lanes * runs)
// tiles of one tile row r = blockIdx.y, from c = blockIdx.x * that.
template <typename T, int BS, int COLOR, bool KEYED, class Halo>
__global__ void __launch_bounds__(kThreads)
    half_sweep_vec(Params<T> p, Halo h) {
  constexpr int LANES = BS / kVec;
  constexpr int RUNS = BS / kRows;
  constexpr int PER_TILE = LANES * RUNS;
  static_assert(PER_TILE <= kThreads && kThreads % PER_TILE == 0 &&
                    32 % LANES == 0,
                "tiles must split evenly over a block and rows over a warp");
  constexpr int TILES = kThreads / PER_TILE;
  const int t = threadIdx.x;
  const int lane = t % LANES;
  const int run = (t / LANES) % RUNS;
  int c = blockIdx.x * TILES + t / PER_TILE;
  const bool live = c < p.mc;
  if (!live) c = p.mc - 1;  // compute on a real tile, store nothing
  march<T, kVec, COLOR, KEYED, KEYED ? 1 : kRows>(
      p, h, BS, blockIdx.y, c, run * kRows, kRows, lane * kVec, lane, LANES,
      live);
}

// Generic form: any bs, one site per thread and row. Block (32, 8) over
// (j, run); grid (mc, mr, runs / 8 rounded up).
template <typename T, int COLOR, bool KEYED, class Halo>
__global__ void __launch_bounds__(kThreads)
    half_sweep_any(Params<T> p, Halo h) {
  const int bs = p.bs;
  const int i0 = (blockIdx.z * blockDim.y + threadIdx.y) * kRows;
  if (i0 >= bs) return;
  const int nrows = bs - i0 < kRows ? bs - i0 : kRows;
  for (int j = threadIdx.x; j < bs; j += blockDim.x)
    march<T, 1, COLOR, KEYED, 1>(p, h, bs, blockIdx.y, blockIdx.x, i0, nrows,
                                 j, 0, 1, true);
}

__host__ inline bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
}

// Launch one colour's half-sweep: the vector form where bs has an
// instantiation and `vec_ok` (16-byte aligned operands), else the generic
// one. Returns the cudaError_t of the launch.
template <typename T, int COLOR, bool KEYED, class Halo>
int launch_half_sweep(const Params<T>& p, const Halo& h, bool vec_ok,
                      cudaStream_t stream) {
  auto vec = [&](auto bs_tag) {
    constexpr int BS = decltype(bs_tag)::value;
    constexpr int TILES = kThreads / ((BS / kVec) * (BS / kRows));
    dim3 grid((unsigned)((p.mc + TILES - 1) / TILES), (unsigned)p.mr);
    half_sweep_vec<T, BS, COLOR, KEYED, Halo>
        <<<grid, kThreads, 0, stream>>>(p, h);
    return (int)cudaGetLastError();
  };
  if (vec_ok) {
    switch (p.bs) {
      case 16: return vec(std::integral_constant<int, 16>{});
      case 32: return vec(std::integral_constant<int, 32>{});
      case 64: return vec(std::integral_constant<int, 64>{});
      case 128: return vec(std::integral_constant<int, 128>{});
      default: break;
    }
  }
  const int runs = (p.bs + kRows - 1) / kRows;
  dim3 block(32, kThreads / 32);
  dim3 grid((unsigned)p.mc, (unsigned)p.mr, (unsigned)((runs + 7) / 8));
  half_sweep_any<T, COLOR, KEYED, Halo><<<grid, block, 0, stream>>>(p, h);
  return (int)cudaGetLastError();
}

// Dispatch on colour and dtype.
template <bool KEYED, class MakeHalo>
int dispatch(void* q, const void* bits, int mr, int mc, int bs, int color,
             int heat_bath, int dtype, Table tab, Key key, bool vec_ok,
             MakeHalo make_halo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto zero) {
    using T = decltype(zero);
    Params<T> p{static_cast<T*>(q), static_cast<const uint32_t*>(bits),
                (int64_t)mr * mc * bs * bs, mr, mc, bs, heat_bath, tab, key};
    const auto h = make_halo(zero, p);
    return color ? launch_half_sweep<T, 1, KEYED>(p, h, vec_ok, s)
                 : launch_half_sweep<T, 0, KEYED>(p, h, vec_ok, s);
  };
  if (color != 0 && color != 1) return (int)cudaErrorInvalidValue;
  if (dtype == kBFloat16) return go(__nv_bfloat16{});
  if (dtype == kFloat32) return go(float{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace ising
