// Checkerboard half-sweep, tile-fetch halo: the Hopper port of the Pallas
// kernel update_color_pallas / _update_kernel
// (src/repro/kernels/checkerboard.py). That kernel fetched the torus
// neighbour tiles again through shifted BlockSpec index maps and summed
// neighbours with four K-hat matmuls on the MXU; here each thread reads the
// one neighbour element it needs, from its own tile or from the
// neighbouring one, and sums four values.
//
// Bound: memory. Per colour the kernel reads the two active and two passive
// quads and the two bit planes, and writes the two active quads: at
// L = 20480 in bf16 that is 2.10 GB, 0.63 ms at 3.35 TB/s. It does about
// 10 flops per site, far below the card's rate.
//
// Design: one thread per site (r, c, i, j) of both active quads, threads
// along j so that each warp reads and writes contiguous lines. The update
// is in place: an active site reads only passive quads and its own spin,
// so no thread reads what another writes.
#include "checkerboard_common.cuh"

namespace ising {

template <typename T>
__global__ void update_tiles_kernel(T* __restrict__ q,
                                    const uint32_t* __restrict__ bits, int mr,
                                    int mc, int bs, int color, int heat_bath,
                                    Table tab) {
  const int area = bs * bs;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= area) return;
  const int64_t tile = blockIdx.x;
  const int r = (int)(tile / mc);
  const int c = (int)(tile - (int64_t)r * mc);
  const int i = e / bs;
  const int j = e - i * bs;
  const int64_t nq = (int64_t)mr * mc * area;  // elements per quad

  T* s0 = q + (color ? 1 : 0) * nq;
  T* s1 = q + (color ? 2 : 3) * nq;
  const T* p0 = q + (color ? 0 : 1) * nq;
  const T* p1 = q + (color ? 3 : 2) * nq;
  const int dx = color ? 1 : -1;
  const int64_t here = tile * area + e;

  // Column neighbours j + dx (of p0, for s0) and j - dx (of p1, for s1).
  int64_t a0, a1;
  {
    const int j0 = j + dx;
    if (j0 >= 0 && j0 < bs) {
      a0 = here + dx;
    } else {
      const int cn = (c + dx + mc) % mc;
      a0 = ((int64_t)r * mc + cn) * area + (int64_t)i * bs + (j0 + bs) % bs;
    }
    const int j1 = j - dx;
    if (j1 >= 0 && j1 < bs) {
      a1 = here - dx;
    } else {
      const int cn = (c - dx + mc) % mc;
      a1 = ((int64_t)r * mc + cn) * area + (int64_t)i * bs + (j1 + bs) % bs;
    }
  }
  // Row neighbours i - 1 (of p1, for s0) and i + 1 (of p0, for s1).
  const int64_t b0 =
      i > 0 ? here - bs
            : ((int64_t)((r - 1 + mr) % mr) * mc + c) * area +
                  (int64_t)(bs - 1) * bs + j;
  const int64_t b1 = i < bs - 1
                         ? here + bs
                         : ((int64_t)((r + 1) % mr) * mc + c) * area + j;

  const float p0c = to_f32(p0[here]);
  const float p1c = to_f32(p1[here]);
  const float nn0 = p0c + to_f32(p0[a0]) + p1c + to_f32(p1[b0]);
  const float nn1 = p1c + to_f32(p1[a1]) + p0c + to_f32(p0[b1]);

  s0[here] = from_f32<T>(
      new_spin(to_f32(s0[here]), nn0, bits[here], heat_bath, tab));
  s1[here] = from_f32<T>(
      new_spin(to_f32(s1[here]), nn1, bits[nq + here], heat_bath, tab));
}

template <typename T>
int launch(void* q, const void* bits, int mr, int mc, int bs, int color,
           int heat_bath, Table tab, cudaStream_t stream) {
  const int area = bs * bs;
  dim3 grid((unsigned)((int64_t)mr * mc), (area + kThreads - 1) / kThreads);
  update_tiles_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(q), static_cast<const uint32_t*>(bits), mr, mc, bs,
      color, heat_bath, tab);
  return (int)cudaGetLastError();
}

}  // namespace ising

// One colour's half-sweep of q[4][mr][mc][bs][bs], in place. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ising_update_tiles(void* q, const void* bits, int mr, int mc,
                                  int bs, int color, int heat_bath, int dtype,
                                  float t0, float t1, float t2, float t3,
                                  float t4, void* stream) {
  const ising::Table tab = {{t0, t1, t2, t3, t4}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ising::kBFloat16)
    return ising::launch<__nv_bfloat16>(q, bits, mr, mc, bs, color, heat_bath,
                                        tab, s);
  if (dtype == ising::kFloat32)
    return ising::launch<float>(q, bits, mr, mc, bs, color, heat_bath, tab, s);
  return (int)cudaErrorInvalidValue;
}
