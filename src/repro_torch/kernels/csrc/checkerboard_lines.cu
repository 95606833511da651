// Checkerboard half-sweep, edge-line halo: the Hopper port of the Pallas
// kernel update_color_pallas_lines / _update_kernel_lines
// (src/repro/kernels/checkerboard.py). The four halo lines [mr][mc][bs]
// come in as operands, computed outside the kernel by
// core.checkerboard.edge_lines (or by the neighbouring ranks on a grid), so
// the kernel never reads a neighbouring tile.
//
//   row0: added to row 0 of nn(s0)        col0: to the j + dx edge of nn(s0)
//   row1: added to row bs-1 of nn(s1)     col1: to the j - dx edge of nn(s1)
//
// Bound, at L = 20480 in bf16: as the tile-fetch kernel, plus the lines
// (4 * mr * mc * bs elements, 0.8% more bytes at bs = 128). The operand
// form is bound by memory (2.10 GB per colour, 0.63 ms at 3.35 TB/s), the
// keyed form by integer issue (42 ALU-only instructions of 84 per site,
// threefry's rotations and xors; 0.53 ms), with 1.26 GB to move.
// The design is the shared body of checkerboard_common.cuh: 8 sites per
// thread with 16-byte accesses, lane shuffles for the j +- 1 neighbours,
// rows marched in registers, bs templated; the run at the top of a tile
// reads its p1 row from row0, the run at the bottom its p0 row from row1
// (16-byte loads too), and the edge lanes read col0 / col1.
#include "checkerboard_common.cuh"

namespace ising {

// Beyond the tile: the halo lines, one [bs] line per tile each.
template <typename T>
struct LineHalo {
  const T* row0;
  const T* col0;
  const T* row1;
  const T* col1;
  int mc, bs;

  __device__ __forceinline__ int64_t line(int r, int c) const {
    return ((int64_t)r * mc + c) * bs;
  }
  __device__ __forceinline__ const T* row_above(const T*, int r, int c,
                                                int j0) const {
    return row0 + line(r, c) + j0;
  }
  __device__ __forceinline__ const T* row_below(const T*, int r, int c,
                                                int j0) const {
    return row1 + line(r, c) + j0;
  }
  template <int DX>
  __device__ __forceinline__ T side0(const T*, int r, int c, int i) const {
    return __ldg(col0 + line(r, c) + i);
  }
  template <int DX>
  __device__ __forceinline__ T side1(const T*, int r, int c, int i) const {
    return __ldg(col1 + line(r, c) + i);
  }
};

struct MakeLineHalo {
  const void *row0, *col0, *row1, *col1;
  template <typename T>
  LineHalo<T> operator()(T, const Params<T>& p) const {
    return LineHalo<T>{static_cast<const T*>(row0), static_cast<const T*>(col0),
                       static_cast<const T*>(row1), static_cast<const T*>(col1),
                       p.mc, p.bs};
  }
};

inline bool lines_aligned(const void* row0, const void* row1) {
  return aligned16(row0) && aligned16(row1);
}

}  // namespace ising

// One colour's half-sweep of q[4][mr][mc][bs][bs], in place, with the halo
// lines row0/col0/row1/col1 [mr][mc][bs] in the lattice dtype and bits from
// the [2][mr][mc][bs][bs] uint32 operand. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ising_update_lines(void* q, const void* bits, const void* row0,
                                  const void* col0, const void* row1,
                                  const void* col1, int mr, int mc, int bs,
                                  int color, int heat_bath, int dtype,
                                  float t0, float t1, float t2, float t3,
                                  float t4, void* stream) {
  const ising::Table tab = {{t0, t1, t2, t3, t4}};
  const bool vec_ok = ising::aligned16(q) && ising::aligned16(bits) &&
                      ising::lines_aligned(row0, row1);
  return ising::dispatch<false>(q, bits, mr, mc, bs, color, heat_bath, dtype,
                                tab, ising::make_key(0, 0), vec_ok,
                                ising::MakeLineHalo{row0, col0, row1, col1},
                                stream);
}

// The same half-sweep with the bits drawn in the kernel: threefry2x32 under
// the colour key (k0, k1) of each site's flat index in [2][mr][mc][bs][bs].
extern "C" int ising_update_lines_keyed(void* q, unsigned k0, unsigned k1,
                                        const void* row0, const void* col0,
                                        const void* row1, const void* col1,
                                        int mr, int mc, int bs, int color,
                                        int heat_bath, int dtype, float t0,
                                        float t1, float t2, float t3,
                                        float t4, void* stream) {
  const ising::Table tab = {{t0, t1, t2, t3, t4}};
  const bool vec_ok = ising::aligned16(q) && ising::lines_aligned(row0, row1);
  return ising::dispatch<true>(q, nullptr, mr, mc, bs, color, heat_bath,
                               dtype, tab, ising::make_key(k0, k1), vec_ok,
                               ising::MakeLineHalo{row0, col0, row1, col1},
                               stream);
}
