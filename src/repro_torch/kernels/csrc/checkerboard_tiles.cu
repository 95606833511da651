// Checkerboard half-sweep, tile-fetch halo: the Hopper port of the Pallas
// kernel update_color_pallas / _update_kernel
// (src/repro/kernels/checkerboard.py). That kernel fetched the torus
// neighbour tiles again through shifted BlockSpec index maps and summed
// neighbours with four K-hat matmuls on the MXU; here each thread sums four
// values, and what lies beyond the tile (one row above or below a run, one
// element beside the row) is read from the torus-neighbour tile itself.
//
// Bound, at L = 20480 in bf16 ([4, 80, 80, 128, 128]):
// * operand form (bits from the [2, mr, mc, bs, bs] operand): memory. It
//   reads two active and two passive quads and the two bit planes and
//   writes the two active quads, 2.10 GB per colour, 0.63 ms at 3.35 TB/s;
// * keyed form (threefry in the kernel): integer issue. It moves 1.26 GB
//   (0.38 ms), but each of its 2.1e8 sites needs 42 instructions that only
//   the integer ALU issues (threefry's 20 funnel-shift rotations and 21
//   xors, and bits >> 8) and 84 in all (with 27 adds and 15 f32 rule
//   operations): 0.656 SM clocks a site at 64 ALU or 128 issued
//   instructions per clock per SM, 0.53 ms on 132 SMs at 1.98 GHz.
//   chip_smoke.py computes this bound and prints the compiled row loop's
//   instructions per site beside it (PERF.md).
// The design (checkerboard_common.cuh): 8 sites per thread along j with
// 16-byte accesses and lane shuffles for the j +- 1 neighbours, each thread
// marching 8 rows with the row above and below in registers, bs templated
// with no runtime division, and in the keyed form the 16 hashes of a row
// interleaved.
//
// Also here: ising_threefry_bits, the same device hash over a flat counter
// range, so the card can be held against repro_torch.random._bits_lanes.
#include "checkerboard_common.cuh"

namespace ising {

// Beyond the tile: the torus-neighbour tiles of the same quads.
template <typename T>
struct TileHalo {
  int mr, mc, bs;

  __device__ __forceinline__ int64_t tile(int r, int c) const {
    return ((int64_t)r * mc + c) * ((int64_t)bs * bs);
  }
  // p1 row bs - 1 of the tile above (r - 1 on the torus).
  __device__ __forceinline__ const T* row_above(const T* p1, int r, int c,
                                                int j0) const {
    const int ru = r == 0 ? mr - 1 : r - 1;
    return p1 + tile(ru, c) + (int64_t)(bs - 1) * bs + j0;
  }
  // p0 row 0 of the tile below (r + 1 on the torus).
  __device__ __forceinline__ const T* row_below(const T* p0, int r, int c,
                                                int j0) const {
    const int rd = r == mr - 1 ? 0 : r + 1;
    return p0 + tile(rd, c) + j0;
  }
  // x at column j + D just off the tile: the first or last column of the
  // tile c + D on the torus.
  template <int D>
  __device__ __forceinline__ T side(const T* x, int r, int c, int i) const {
    const int cn = D < 0 ? (c == 0 ? mc - 1 : c - 1)
                         : (c == mc - 1 ? 0 : c + 1);
    return __ldg(x + tile(r, cn) + (int64_t)i * bs + (D < 0 ? bs - 1 : 0));
  }
  template <int DX>
  __device__ __forceinline__ T side0(const T* p0, int r, int c, int i) const {
    return side<DX>(p0, r, c, i);
  }
  template <int DX>
  __device__ __forceinline__ T side1(const T* p1, int r, int c, int i) const {
    return side<-DX>(p1, r, c, i);
  }
};

struct MakeTileHalo {
  template <typename T>
  TileHalo<T> operator()(T, const Params<T>& p) const {
    return TileHalo<T>{p.mr, p.mc, p.bs};
  }
};

__global__ void threefry_bits_kernel(uint32_t* __restrict__ out, Key key,
                                     uint64_t start, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const uint64_t counter = start + (uint64_t)e;
    uint32_t x0[1] = {(uint32_t)(counter >> 32)};
    uint32_t x1[1] = {(uint32_t)counter};
    threefry_bits<1>(key, x0, x1);
    out[e] = x0[0];
  }
}

}  // namespace ising

// One colour's half-sweep of q[4][mr][mc][bs][bs], in place, bits from the
// [2][mr][mc][bs][bs] uint32 operand. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int ising_update_tiles(void* q, const void* bits, int mr, int mc,
                                  int bs, int color, int heat_bath, int dtype,
                                  float t0, float t1, float t2, float t3,
                                  float t4, void* stream) {
  const ising::Table tab = {{t0, t1, t2, t3, t4}};
  const bool vec_ok = ising::aligned16(q) && ising::aligned16(bits);
  return ising::dispatch<false>(q, bits, mr, mc, bs, color, heat_bath, dtype,
                                tab, ising::make_key(0, 0), vec_ok,
                                ising::MakeTileHalo{}, stream);
}

// The same half-sweep with the bits drawn in the kernel: threefry2x32 under
// the colour key (k0, k1) of each site's flat index in [2][mr][mc][bs][bs].
extern "C" int ising_update_tiles_keyed(void* q, unsigned k0, unsigned k1,
                                        int mr, int mc, int bs, int color,
                                        int heat_bath, int dtype, float t0,
                                        float t1, float t2, float t3,
                                        float t4, void* stream) {
  const ising::Table tab = {{t0, t1, t2, t3, t4}};
  return ising::dispatch<true>(q, nullptr, mr, mc, bs, color, heat_bath,
                               dtype, tab, ising::make_key(k0, k1),
                               ising::aligned16(q), ising::MakeTileHalo{},
                               stream);
}

// out[e] = the 32-bit draw of counter start + e under key (k0, k1), for
// e < n: repro_torch.random._bits_lanes(key, start, start + n).
extern "C" int ising_threefry_bits(void* out, unsigned k0, unsigned k1,
                                   unsigned long long start, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  const int64_t blocks = (n + ising::kThreads - 1) / ising::kThreads;
  ising::threefry_bits_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535),
                                ising::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), ising::make_key(k0, k1), start, n);
  return (int)cudaGetLastError();
}
