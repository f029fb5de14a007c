"""A/B of two thread layouts of the segment-sum kernel (K3) on one GPU.

    python3 -m dogs_tpu_torch.tools.segment_sum_ab [--rounds 3] [--iters 50]   # from the repo root

The kept kernel (csrc/segment_sum.cu: four lanes per Gaussian, each owning
one float4 column group of the row, 8 rows of a run loaded ahead) against
the other layout, written out below: one thread per Gaussian, three float4
loads per gathered row, four float4 stores per output row, 4 or 8 rows
ahead, the same in-order adds. All run on bench camera 0 at the training
shapes (bench.py's 500k Gaussians, SH 3, 1152x864, max_tiles_per_gaussian
12), with the run lists of the real binning and per-entry rows drawn from a
seed. Each is first held bit for bit against the plain version for "f32"
and "bf16"; then they are timed in turns (kept, other, other, kept) for
`--rounds` rounds of `--iters` launches, CUDA events around each group.
Beside them, timed the same way: the kept kernel on the same rows copied
into Gaussian order (src = arange: what the random gather costs), a plain
copy of the rows (the card's streaming rate), the K->N index prep
(`reduce.gaussian_runs`) and the id sort + row gather that it replaced.
Prints the card's name and power limit, a line per round, and one JSON line
with the minima. Needs nvcc and a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from dogs_tpu_torch import kernels
from dogs_tpu_torch.data import synthetic
from dogs_tpu_torch.raster import blend, reduce
from dogs_tpu_torch.raster.binning import build_tile_bins
from dogs_tpu_torch.raster.projection import project_gaussians

THREAD_PER_GAUSSIAN = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;

template <bool kBf16>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (kBf16) { return __bfloat162float(__float2bfloat16_rn(x)); } else { return x; }
}

template <bool kBf16>
__device__ __forceinline__ void add4(float* acc, float4 v) {
  acc[0] += rounded<kBf16>(v.x); acc[1] += rounded<kBf16>(v.y);
  acc[2] += rounded<kBf16>(v.z); acc[3] += rounded<kBf16>(v.w);
}

template <int kAhead, bool kBf16>
__global__ void __launch_bounds__(kThreads)
segment_sum_thread(const float4* __restrict__ rows, const int32_t* __restrict__ src,
                   const int32_t* __restrict__ starts, float4* __restrict__ out, int n_out) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= n_out) return;
  float acc[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) acc[c] = 0.0f;
  const int lo = __ldg(starts + g), hi = __ldg(starts + g + 1);
  for (int base = lo; base < hi; base += kAhead) {
    int s[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) s[j] = base + j < hi ? __ldg(src + base + j) : 0;
    float4 v[kAhead][3];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        v[j][q] = base + j < hi ? __ldg(rows + static_cast<size_t>(s[j]) * 4 + q)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (base + j < hi) {
        add4<kBf16>(acc, v[j][0]);
        add4<kBf16>(acc + 4, v[j][1]);
        add4<kBf16>(acc + 8, v[j][2]);
      }
    }
  }
  float4* o = out + static_cast<size_t>(g) * 4;
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  o[2] = make_float4(acc[8], acc[9], 0.0f, 0.0f);
  o[3] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
}  // namespace

template <int kAhead>
int launch(const void* rows, const void* src, const void* starts, void* out, int n_out, int bf16,
           void* stream) {
  if (n_out <= 0) return 0;
  const int blocks = (n_out + kThreads - 1) / kThreads;
  const auto* r = static_cast<const float4*>(rows);
  const auto* s = static_cast<const int32_t*>(src);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<float4*>(out);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (bf16) {
    segment_sum_thread<kAhead, true><<<blocks, kThreads, 0, cs>>>(r, s, st, o, n_out);
  } else {
    segment_sum_thread<kAhead, false><<<blocks, kThreads, 0, cs>>>(r, s, st, o, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dogs_segment_sum_thread4(const void* rows, const void* src, const void* starts,
                                        void* out, int n_out, int bf16, void* stream) {
  return launch<4>(rows, src, starts, out, n_out, bf16, stream);
}

extern "C" int dogs_segment_sum_thread8(const void* rows, const void* src, const void* starts,
                                        void* out, int n_out, int bf16, void* stream) {
  return launch<8>(rows, src, starts, out, n_out, bf16, stream);
}
"""


def build_other():
    """Compile the one-thread-per-Gaussian layout with the kept kernel's
    flags, into the kernels' build directory; returns its typed C
    launchers, 4 and 8 rows ahead."""
    from torch.utils.cpp_extension import CUDA_HOME

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD_DIR / "segment_sum_thread.cu"
    so = kernels.BUILD_DIR / "segment_sum_thread.so"
    cu.write_text(THREAD_PER_GAUSSIAN)
    proc = subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the other layout:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] other layout ptxas: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    fns = {}
    for ahead in (4, 8):
        fn = getattr(lib, f"dogs_segment_sum_thread{ahead}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[ahead] = fn
    return fns


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("segment_sum_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    for line in kernels.build_all()["segment_sum"].log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] kept layout ptxas: {line.strip()}")

    with torch.no_grad():
        other = build_other()
        params = synthetic.bench_scene(device=dev)
        cam = synthetic.bench_cameras(8, device=dev)[0]
        proj = project_gaussians(params, cam, active_sh_degree=3)
        bins = build_tile_bins(proj, cam.height, cam.width, max_tiles_per_gaussian=12)
        n, k = params.capacity, bins.num_valid
        g = torch.Generator(device=dev).manual_seed(0)
        rows = torch.randn((k, blend.ENT_WIDTH), generator=g, device=dev)
        src, starts = reduce.gaussian_runs(bins.order, bins.sorted_idx, n)

        def run_other(ahead, dt):
            out = torch.empty((n, blend.ENT_WIDTH), device=dev)
            err = other[ahead](rows.data_ptr(), src.data_ptr(), starts.data_ptr(), out.data_ptr(), n,
                               int(dt == "bf16"), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"other layout launch failed: CUDA error {err}")
            return out

        for dt in reduce.REDUCE_DTYPES:
            want = reduce.sorted_segment_sum_reference(rows, src, starts, n, dt)
            runs = {"kept": lambda: reduce.sorted_segment_sum(rows, src, starts, n, dt),
                    "other4": lambda: run_other(4, dt), "other8": lambda: run_other(8, dt)}
            for label, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"{label} ({dt}) differs from the plain version by "
                                     f"{float((got - want).abs().max()):.3e}")
        # The same rows in Gaussian order: each run is read contiguously.
        rows_by_gaussian = rows[src.long()].contiguous()
        identity = torch.arange(k, dtype=torch.int32, device=dev)
        want = reduce.sorted_segment_sum_reference(rows, src, starts, n)
        if not torch.equal(reduce.sorted_segment_sum(rows_by_gaussian, identity, starts, n), want):
            raise SystemExit("the kept kernel on rows in Gaussian order differs")
        print(f"[ab] K={k} N={n}: every layout equals the plain version bit for bit (f32, bf16)")

        idx, order = bins.sorted_idx, bins.order
        timed = {
            "kept": lambda: reduce.sorted_segment_sum(rows, src, starts, n),
            "other4": lambda: run_other(4, "f32"),
            "other8": lambda: run_other(8, "f32"),
            "kept_bf16": lambda: reduce.sorted_segment_sum(rows, src, starts, n, "bf16"),
            "other4_bf16": lambda: run_other(4, "bf16"),
            "kept_rows_in_gaussian_order": lambda: reduce.sorted_segment_sum(rows_by_gaussian, identity,
                                                                             starts, n),
            "copy_rows": lambda: rows.clone(),
            "index_prep": lambda: reduce.gaussian_runs(order, idx, n),
            "id_sort_and_row_gather": lambda: rows[torch.sort(idx, stable=True).indices, :blend.N_GRADS],
        }
        turns = ("kept", "other4", "other8", "other8", "other4", "kept", "kept_bf16", "other4_bf16",
                 "other4_bf16", "kept_bf16", "kept_rows_in_gaussian_order", "copy_rows", "index_prep",
                 "id_sort_and_row_gather")
        best = {name: float("inf") for name in timed}
        for r in range(args.rounds):
            ms = {}
            for name in turns:
                t = cuda_ms(timed[name], args.iters)
                ms.setdefault(name, []).append(t)
                best[name] = min(best[name], t)
            print(f"[ab] round {r}: " + "; ".join(
                f"{name} " + "/".join(f"{t:.4f}" for t in v) for name, v in ms.items()) + " ms")
    print(json.dumps({"card": smi, "K": k, "N": n, "iters": args.iters, "rounds": args.rounds,
                      "min_ms": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
