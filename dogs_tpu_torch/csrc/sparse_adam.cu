// The visibility-masked sparse Adam of the Gaussians' six leaves in one
// launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: dogs_tpu (dogs_tpu/train/optim.py:sparse_adam_step)
// writes the masked update as plain JAX and leaves it to XLA, which fuses each
// leaf's chain into one loop. PyTorch runs the same code eagerly: per leaf the
// m', v' and step temporaries, three `where`s and three copies, about 18
// launches a leaf and 108 a step, with up to five temporaries of the 45-wide
// SH leaf alive at once. At 4M Gaussians that was the largest stage of a
// training step (PERF.md). The arithmetic and the walk over a tile are in
// sparse_adam.cuh (shared with the host build the CPU tests run).
//
// Bound: memory. An element costs six flops and 28 bytes: p, g, m and v read,
// p, m and v written. A Gaussian has 59 floats (3 + 3 + 45 + 3 + 4 + 1), so
// with every Gaussian visible 4M rows move 4M x 59 x 28 B ~ 6.6 GB, ~1.97 ms
// at 3.35 TB/s; a row that is not visible needs only its mask byte. So:
//   - one CTA a tile of kRows rows: it reads the tile's mask bytes once into
//     shared memory and exits if none is set;
//   - the six leaves' spans of the tile are contiguous; the CTA's threads walk
//     them as one run of 16-byte float4s, neighbour next to neighbour, dealt
//     round-robin so that each thread has the same share;
//   - a float4 whose four rows are all invisible moves no byte;
//   - loads and stores carry the streaming hints (__ldcs / __stcs): every
//     byte is touched once;
//   - no temporaries, no `where`, no copy.
// Everything is IEEE f32 with no fast math, and this file is built with
// -fmad=false (kernels.py), so the result equals the plain PyTorch loop's bit
// for bit.
//
// Layout: Args in sparse_adam.cuh; every leaf's p, g, m and v 16-byte aligned
// (the wrapper, train/optim.py, checks).

#include <cuda_runtime.h>

#include "sparse_adam.cuh"

namespace {

using namespace dogs_adam;

__global__ void __launch_bounds__(kThreads) sparse_adam_kernel(const Args a) {
  __shared__ bool vis[kRows];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), a.n - r0));
  const int t = threadIdx.x;
  const bool mine = t < rows && a.visible[r0 + t] != 0;
  if (t < kRows) vis[t] = mine;
  if (!__syncthreads_or(mine)) return;  // no row of the tile is visible
  tile_thread(a, r0, rows, vis, t);
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int dogs_sparse_adam(const dogs_adam::Args* args, void* stream) {
  const dogs_adam::Args a = *args;
  if (a.n <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (a.n + dogs_adam::kRows - 1) / dogs_adam::kRows;
  sparse_adam_kernel<<<static_cast<unsigned>(blocks), dogs_adam::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
