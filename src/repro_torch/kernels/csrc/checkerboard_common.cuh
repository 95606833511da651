// Shared device code of the two checkerboard half-sweep kernels.
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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ising {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

constexpr int kThreads = 256;

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
  return __float2bfloat16_rn(v);  // v is +-1: exact
}

// The five f32 table values of the update rule, for x = -4, -2, 0, 2, 4.
struct Table {
  float t[5];
};

// The reference's select chain: thresholds x <= -3, -1, 1, 3.
__device__ __forceinline__ float select5(float x, const Table& tab) {
  return x <= -3.f ? tab.t[0]
       : x <= -1.f ? tab.t[1]
       : x <= 1.f  ? tab.t[2]
       : x <= 3.f  ? tab.t[3]
                   : tab.t[4];
}

// New spin for one site. u = (bits >> 8) * 2^-24 is exact in f32.
// Metropolis flips sigma when u < table(sigma * nn); heat-bath sets +1 when
// u < table(nn), else -1.
__device__ __forceinline__ float new_spin(float sigma, float nn,
                                          uint32_t bits, int heat_bath,
                                          const Table& tab) {
  const float u = (float)(bits >> 8) * 5.9604644775390625e-08f;
  if (heat_bath) return u < select5(nn, tab) ? 1.f : -1.f;
  return u < select5(nn * sigma, tab) ? -sigma : sigma;
}

}  // namespace ising
