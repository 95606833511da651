// Connected-component labels of a periodic bond graph by union-find: every
// site gets the smallest row-major index of its cluster, the canonical
// labels of repro_torch.cluster.label. cluster.label.label_components
// launches it for bond masks on a CUDA device; the CPU keeps the iterated
// min-label propagation beside it (cluster.label.propagate), the plain
// version the tests hold it to.
//
// It replaces no TPU kernel: the reference leaves labels to XLA's
// while_loop of neighbour-min rounds and pointer jumps
// (src/repro/cluster/label.py). Eager PyTorch ran each round as about a
// dozen passes over the labels and read a changed flag on the host after
// every two rounds, so the time followed the clusters' chemical distance.
//
// The graph. right[y][x] bonds site (y, x) to (y, (x + 1) mod w),
// down[y][x] bonds it to ((y + 1) mod h, x): the torus of
// cluster.label.neighbor_min. A stack [n, h, w] is n graphs, each labelled
// in its own index space (blockIdx.y).
//
// Bound, at 5120^2: bytes. The least it must move is the two bond masks
// read once (2 x 26.2 MB) and the labels written once (104.9 MB): 157.3
// MB, 0.047 ms at 3.35 TB/s.
//
// The design (the block-based union-find of Playne and Hawick, IEEE TPDS
// 29(6), 2018, and Allegretti, Bolelli and Grana, IEEE TPDS 31(2), 2020,
// with ECL-CC's hooks and pointer jumping, Jaiganesh and Burtscher, HPDC
// 2018), three launches on the caller's stream:
// 1. label_tiles: one block a 32 x 32 tile, in shared memory. Runs of east
//    bonds come from one ballot a row; south bonds join the runs by
//    union-find; each site's tile root is written as a global index.
//    Row-major order within a tile is global row-major order, so the
//    smallest local index of a piece is its smallest global index. The
//    masks are read once and the labels written once.
// 2. merge_borders: one thread for each site on a tile's east or south
//    edge, the torus's wrap bonds included, unions across its outer bond
//    in device memory.
// 3. resolve_tiles: one block a tile again. Each site's label becomes its
//    root, found in shared memory for pointers inside the tile and in
//    device memory for those that leave it; only changed labels are
//    written.
// A union hooks the larger root under the smaller, so every parent is
// smaller than its child and the root of each tree is the smallest index
// in it. Labels are exact and do not depend on the order of the atomics:
// the result is each cluster's minimum, bit for bit the plain version's.
//
// Measured at 5120^2 on FK bonds (H100, 700 W; see PERF.md): the in-tile
// unions take most of the time, bound by the latency of their dependent
// shared-memory finds and not by bytes.
#include <cstdint>

#include <cuda_runtime.h>

namespace ising {

constexpr int kTileW = 32;  // tile columns: one warp a tile row
constexpr int kTileH = 32;  // tile rows
constexpr int kTileRowsPerPass = 8;  // block rows; each thread takes 4 sites
constexpr int kSitesPerThread = kTileH / kTileRowsPerPass;
constexpr int kTileThreads = kTileW * kTileRowsPerPass;
constexpr int kFlatThreads = 256;  // threads a block in merge_borders

// The root of x in trees that other threads are still joining, pointing
// each site on the path to its grandparent as it goes (pointer jumping,
// after Jaiganesh and Burtscher's ECL-CC). Only roots are ever hooked, so a
// parent a thread reads stays an ancestor, and a site may point to any
// ancestor: the trees and their roots are kept.
__device__ __forceinline__ int find_root(volatile int* lab, int x) {
  int p = lab[x];
  if (p != x) {
    int prev = x, next;
    while (p > (next = lab[p])) {
      lab[prev] = next;
      prev = p;
      p = next;
    }
  }
  return p;
}

// Join the trees of a and b: the larger root is hooked under the smaller,
// by a compare-and-swap that fails if another thread hooked that root
// first; the join then retries from the root's new root.
__device__ __forceinline__ void unite(int* lab, int a, int b) {
  volatile int* vlab = lab;
  a = find_root(vlab, a);
  b = find_root(vlab, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(lab + b, b, a);
    if (old == b) return;
    b = find_root(vlab, old);
  }
}

// The root of x in a forest that no thread joins any more, hooking every
// other site on the path to its grandparent (path halving). Any parent a
// thread reads is an ancestor, and atomicMin keeps the higher (smaller) of
// two, so the hooks keep every tree and its root, and a root written to a
// site by its own thread is never raised.
__device__ __forceinline__ int find_halving(int* lab, int x) {
  const volatile int* vlab = lab;
  int p = vlab[x];
  while (p != x) {
    const int gp = vlab[p];
    if (gp == p) return p;
    atomicMin(lab + x, gp);
    x = gp;
    p = vlab[x];
  }
  return x;
}

// One block a tile, one warp a tile row at a time; blockIdx.y walks the
// graphs of the stack. A row's east bonds are one ballot: each site starts
// labelled with the first site of its run of east bonds, so the runs are
// joined without atomics. A south bond then joins the run above to the run
// below, once for each pair of runs (the first site of their overlap).
// Those joins are listed first and then shared out over all the block's
// threads, so no lane idles beside a lane that joins. The runs' first
// sites are the only roots, and they are resolved before any other site
// reads them.
__global__ void __launch_bounds__(kTileThreads)
    label_tiles(const uint8_t* __restrict__ right,
                const uint8_t* __restrict__ down, int* __restrict__ labels,
                int n, int h, int w, int tiles_x) {
  __shared__ int lab[kTileH * kTileW];
  __shared__ unsigned east_rows[kTileH], south_rows[kTileH];
  __shared__ int joins[kTileH * kTileW], n_joins;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int r0 = blockIdx.x / tiles_x * kTileH;
  const int c0 = blockIdx.x % tiles_x * kTileW;
  const int c = c0 + tx;
  const unsigned upto = 0xffffffffu >> (31 - tx);  // lanes 0..tx
  const unsigned west = tx ? 1u << (tx - 1) : 0u;  // lane tx - 1
  const int64_t hw = (int64_t)h * w;
  for (int z = blockIdx.y; z < n; z += gridDim.y) {
    const int64_t base = (int64_t)z * hw;
    if (tid == 0) n_joins = 0;
    bool south[kSitesPerThread];
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      const int lr = ty + k * kTileRowsPerPass, r = r0 + lr;
      bool east = false;
      south[k] = false;
      if (r < h && c < w) {
        const int64_t g = base + (int64_t)r * w + c;
        east = tx + 1 < kTileW && c + 1 < w && right[g];
        south[k] = lr + 1 < kTileH && r + 1 < h && down[g];
      }
      const unsigned e = __ballot_sync(0xffffffffu, east);
      const unsigned so = __ballot_sync(0xffffffffu, south[k]);
      // a run starts at every lane whose west neighbour has no east bond
      lab[lr * kTileW + tx] = lr * kTileW + 31 - __clz(~(e << 1) & upto);
      if (tx == 0) {
        east_rows[lr] = e;
        south_rows[lr] = so;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      const int lr = ty + k * kTileRowsPerPass;
      // the west neighbour joins the same two runs already
      const bool join =
          south[k] &&
          !(south_rows[lr] & east_rows[lr] & east_rows[lr + 1] & west);
      const unsigned m = __ballot_sync(0xffffffffu, join);
      int at = 0;
      if (tx == 0 && m) at = atomicAdd(&n_joins, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (join) joins[at + __popc(m & (upto >> 1))] = lr * kTileW + tx;
    }
    __syncthreads();
    for (int i = tid; i < n_joins; i += kTileThreads)
      unite(lab, joins[i], joins[i] + kTileW);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      const int lr = ty + k * kTileRowsPerPass;
      const int s = lr * kTileW + tx;
      if (!(east_rows[lr] & west)) lab[s] = find_halving(lab, s);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      const int lr = ty + k * kTileRowsPerPass, r = r0 + lr;
      const int root = lab[lab[lr * kTileW + tx]];
      if (r < h && c < w)
        labels[base + (int64_t)r * w + c] =
            (r0 + root / kTileW) * w + c0 + root % kTileW;
    }
    __syncthreads();  // the next graph of the stack reuses lab
  }
}

// A crossing bond whose neighbour one step back along the edge, in the
// same tile, crosses too, with both ends joined to it by bonds inside
// their tiles (which label_tiles has joined), joins nothing new: it is
// skipped. The first crossing of such a run, at the latest at the tile's
// first row or column, is not.
__global__ void __launch_bounds__(kFlatThreads)
    merge_borders(const uint8_t* __restrict__ right,
                  const uint8_t* __restrict__ down, int* labels, int n, int h,
                  int w, int tiles_x, int tiles_y) {
  const int64_t east_edges = (int64_t)h * tiles_x;
  const int64_t edges = east_edges + (int64_t)tiles_y * w;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= edges) return;
  const int64_t hw = (int64_t)h * w;
  for (int z = blockIdx.y; z < n; z += gridDim.y) {
    const uint8_t* r = right + (int64_t)z * hw;
    const uint8_t* d = down + (int64_t)z * hw;
    int a, b;
    if (t < east_edges) {  // the last column x of tile k, in row y
      const int y = (int)(t / tiles_x), k = (int)(t % tiles_x);
      const int x = (int)min((int64_t)(k + 1) * kTileW, (int64_t)w) - 1;
      const int x1 = x + 1 == w ? 0 : x + 1;
      a = y * w + x;
      b = y * w + x1;
      if (!r[a] || (y % kTileH && r[a - w] && d[a - w] && d[b - w])) continue;
    } else {  // the last row y of tile k, in column x
      const int64_t u = t - east_edges;
      const int k = (int)(u / w), x = (int)(u % w);
      const int y = (int)min((int64_t)(k + 1) * kTileH, (int64_t)h) - 1;
      a = y * w + x;
      b = (y + 1 == h ? 0 : y + 1) * w + x;
      if (!d[a] || (x % kTileW && d[a - 1] && r[a - 1] && r[b - 1])) continue;
    }
    unite(labels + (int64_t)z * hw, a, b);
  }
}

// One block a tile, as label_tiles. Every label points to an ancestor:
// after label_tiles a site's tile root in the same tile, after
// merge_borders sometimes a site outside it. The block takes its tile's
// labels into shared memory; each site whose label leaves the tile finds
// its root in device memory; every other site follows pointers inside the
// tile in shared memory to a root or to such a found root. Only sites
// whose label changes are written.
__global__ void __launch_bounds__(kTileThreads)
    resolve_tiles(int* labels, int n, int h, int w, int tiles_x,
                  double inv_w) {
  __shared__ int lab[kTileH * kTileW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r0 = blockIdx.x / tiles_x * kTileH;
  const int c0 = blockIdx.x % tiles_x * kTileW;
  const int c = c0 + tx;
  // the tile's site that holds global index v, or -1 for one outside it;
  // v / w through the reciprocal inv_w = 1 / w, off by at most one and
  // corrected
  auto inside = [&](int v) {
    int q = (int)((double)v * inv_w);
    if (q * w > v)
      --q;
    else if ((q + 1) * w <= v)
      ++q;
    const int vr = q - r0, vc = v - q * w - c0;
    return (unsigned)vr < kTileH && (unsigned)vc < kTileW ? vr * kTileW + vc
                                                          : -1;
  };
  for (int z = blockIdx.y; z < n; z += gridDim.y) {
    int* dev = labels + (int64_t)z * h * w;
    int first[kSitesPerThread];
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      const int lr = ty + k * kTileRowsPerPass, r = r0 + lr;
      first[k] = r < h && c < w ? dev[r * w + c] : -1;
      lab[lr * kTileW + tx] = first[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      const int lr = ty + k * kTileRowsPerPass;
      if (first[k] >= 0 && first[k] != (r0 + lr) * w + c &&
          inside(first[k]) < 0)
        lab[lr * kTileW + tx] = find_halving(dev, first[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSitesPerThread; ++k) {
      if (first[k] < 0) continue;
      const int lr = ty + k * kTileRowsPerPass;
      int x = lr * kTileW + tx, v = lab[x];
      for (int y = inside(v); y >= 0 && y != x; y = inside(v)) {
        x = y;
        v = lab[x];
      }
      if (v != first[k]) dev[(r0 + lr) * w + c] = v;
    }
    __syncthreads();  // the next graph of the stack reuses lab
  }
}

}  // namespace ising

// labels[z][y][x] = the smallest index y' w + x' of the cluster of (y, x)
// in graph z < n of the bond masks right and down ([n][h][w] bytes, 0 or
// 1), as int32; h w < 2^31. Every pointer is contiguous. Returns the
// cudaError_t of the launches (0 on success; nothing is launched for an
// empty stack).
extern "C" int ising_label_components(const void* right, const void* down,
                                      void* labels, long long n, int h, int w,
                                      void* stream) {
  if (n < 0 || n >= (1LL << 31) || h < 0 || w < 0 ||
      (long long)h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0 || h == 0 || w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint8_t*>(right);
  const auto* d = static_cast<const uint8_t*>(down);
  int* lab = static_cast<int*>(labels);
  const int gy = n < 65535 ? (int)n : 65535;
  const int tiles_x = (w + ising::kTileW - 1) / ising::kTileW;
  const int tiles_y = (h + ising::kTileH - 1) / ising::kTileH;
  const dim3 tile_grid(tiles_x * tiles_y, gy);
  const dim3 tile_block(ising::kTileW, ising::kTileRowsPerPass);
  ising::label_tiles<<<tile_grid, tile_block, 0, s>>>(r, d, lab, (int)n, h, w,
                                                      tiles_x);
  cudaError_t err = cudaGetLastError();
  if (err) return (int)err;
  const int64_t edges = (int64_t)h * tiles_x + (int64_t)tiles_y * w;
  const int flat = ising::kFlatThreads;
  ising::merge_borders<<<dim3((unsigned)((edges + flat - 1) / flat), gy),
                         flat, 0, s>>>(r, d, lab, (int)n, h, w, tiles_x,
                                       tiles_y);
  if ((err = cudaGetLastError())) return (int)err;
  ising::resolve_tiles<<<tile_grid, tile_block, 0, s>>>(lab, (int)n, h, w,
                                                        tiles_x, 1.0 / w);
  return (int)cudaGetLastError();
}
