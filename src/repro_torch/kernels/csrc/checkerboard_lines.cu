// Checkerboard half-sweep, edge-line halo: the Hopper port of the Pallas
// kernel update_color_pallas_lines / _update_kernel_lines
// (src/repro/kernels/checkerboard.py). The four halo lines [mr][mc][bs]
// come in as operands, computed outside the kernel by
// core.checkerboard.edge_lines, so the kernel never reads a neighbouring
// tile and the lines can come from another device's halo.
//
//   row0: added to row 0 of nn(s0)        col0: to the j + dx edge of nn(s0)
//   row1: added to row bs-1 of nn(s1)     col1: to the j - dx edge of nn(s1)
//
// Bound: memory, as the tile-fetch kernel: 2.10 GB per colour at
// L = 20480 in bf16 (0.63 ms at 3.35 TB/s); the lines add 4 * mr * mc * bs
// elements, 0.8% of that at bs = 128.
//
// Design: one thread per site of both active quads, threads along j, in
// place (an active site reads only passive quads, lines and its own spin).
#include "checkerboard_common.cuh"

namespace ising {

template <typename T>
__global__ void update_lines_kernel(T* __restrict__ q,
                                    const uint32_t* __restrict__ bits,
                                    const T* __restrict__ row0,
                                    const T* __restrict__ col0,
                                    const T* __restrict__ row1,
                                    const T* __restrict__ col1, int mr, int mc,
                                    int bs, int color, int heat_bath,
                                    Table tab) {
  const int area = bs * bs;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= area) return;
  const int64_t tile = blockIdx.x;
  const int i = e / bs;
  const int j = e - i * bs;
  const int64_t nq = (int64_t)mr * mc * area;  // elements per quad
  const int64_t line = tile * bs;

  T* s0 = q + (color ? 1 : 0) * nq;
  T* s1 = q + (color ? 2 : 3) * nq;
  const T* p0 = q + (color ? 0 : 1) * nq;
  const T* p1 = q + (color ? 3 : 2) * nq;
  const int dx = color ? 1 : -1;
  const int64_t here = tile * area + e;

  const int j0 = j + dx;
  const int j1 = j - dx;
  const float a0 = (j0 >= 0 && j0 < bs) ? to_f32(p0[here + dx])
                                        : to_f32(col0[line + i]);
  const float a1 = (j1 >= 0 && j1 < bs) ? to_f32(p1[here - dx])
                                        : to_f32(col1[line + i]);
  const float b0 = i > 0 ? to_f32(p1[here - bs]) : to_f32(row0[line + j]);
  const float b1 = i < bs - 1 ? to_f32(p0[here + bs]) : to_f32(row1[line + j]);

  const float p0c = to_f32(p0[here]);
  const float p1c = to_f32(p1[here]);
  const float nn0 = p0c + a0 + p1c + b0;
  const float nn1 = p1c + a1 + p0c + b1;

  s0[here] = from_f32<T>(
      new_spin(to_f32(s0[here]), nn0, bits[here], heat_bath, tab));
  s1[here] = from_f32<T>(
      new_spin(to_f32(s1[here]), nn1, bits[nq + here], heat_bath, tab));
}

template <typename T>
int launch(void* q, const void* bits, const void* row0, const void* col0,
           const void* row1, const void* col1, int mr, int mc, int bs,
           int color, int heat_bath, Table tab, cudaStream_t stream) {
  const int area = bs * bs;
  dim3 grid((unsigned)((int64_t)mr * mc), (area + kThreads - 1) / kThreads);
  update_lines_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(q), static_cast<const uint32_t*>(bits),
      static_cast<const T*>(row0), static_cast<const T*>(col0),
      static_cast<const T*>(row1), static_cast<const T*>(col1), mr, mc, bs,
      color, heat_bath, tab);
  return (int)cudaGetLastError();
}

}  // namespace ising

// One colour's half-sweep of q[4][mr][mc][bs][bs], in place, with the halo
// lines row0/col0/row1/col1 [mr][mc][bs] in the lattice dtype. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ising_update_lines(void* q, const void* bits, const void* row0,
                                  const void* col0, const void* row1,
                                  const void* col1, int mr, int mc, int bs,
                                  int color, int heat_bath, int dtype,
                                  float t0, float t1, float t2, float t3,
                                  float t4, void* stream) {
  const ising::Table tab = {{t0, t1, t2, t3, t4}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ising::kBFloat16)
    return ising::launch<__nv_bfloat16>(q, bits, row0, col0, row1, col1, mr,
                                        mc, bs, color, heat_bath, tab, s);
  if (dtype == ising::kFloat32)
    return ising::launch<float>(q, bits, row0, col0, row1, col1, mr, mc, bs,
                                color, heat_bath, tab, s);
  return (int)cudaErrorInvalidValue;
}
