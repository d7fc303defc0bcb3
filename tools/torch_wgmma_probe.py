"""Measure whether an NVIDIA Hopper card's tensor cores sum integer-valued
bf16 products into fp32 exactly.

Run from the root of a checkout, on a machine with an H100 and nvcc:

    python3 tools/torch_wgmma_probe.py

The base-256 digit kernel (``speech_tpu_torch/csrc/double_kernels.cu``)
runs its pair dots on the bf16 tensor cores and needs each dot's sum to be
the exact integer.  Its operands are integers that bf16 holds exactly (x
digits in [-128, 128], M digits in [-256, 256]), at K <= 512, so every
partial sum, in any order, is at most 512 * 128 * 256 = 2^24 in magnitude.
An IEEE fp32 sum of such integers is exact; the tensor cores' own fp32
accumulation is not IEEE (it aligns addends to the largest and truncates),
so whether it is exact here is a question for the card.

The probe builds one small CUDA source (below) with the port's nvcc flags
into ``build/wgmma_probe/`` and computes D (64 x 128) = A (64 x K) B (K x
128) on one warpgroup, the sum over all of K running on the tensor cores,
three ways:

- ``wgmma_ss``: ``wgmma.mma_async.m64n128k16.f32.bf16.bf16``, A and B read
  from shared memory by descriptor (K-major core matrices, no swizzle);
- ``wgmma_rs``: the same with A in registers, as the digit kernel runs it;
- ``mma_sync``: ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``.

Each output is compared bit for bit with the int64 sum on the host, for
these patterns at K = 400 and 512 (and 16 for the random one):

- ``max_same_sign``: every product +-2^15 of one sign (x = +-128, M = 256):
  the sums reach 2^24 at K = 512;
- ``cancel``: blocks of +2^15 and -2^15 products in a shuffled order, so
  large partial sums cancel back to small ones;
- ``big_then_small``: +-2^15 products to past 2^23, then +-1 products;
- ``mixed_within_step``: each 16-wide k-step holds seven +2^15, seven
  -2^15 and two small odd products, shuffled;
- ``uniform``: uniform random digits over the full ranges;
- ``speech``: the real x digit planes of frames of ``tests/audio/test.wav``
  against the real M digit planes (Hann window, dft 512), all 13 pairs of
  'double', every 128-column chunk; and the digit kernel's adversary
  (``_digit_adversary_rows``) against the Hamming window's planes at K 512.

It prints the card's name and power limit, one line per (path, pattern)
with the outputs compared, the mismatches and the largest difference, and
last a JSON line ``{"exact": bool, "results": {...}}``.  ``probe()``
returns that object; ``tests/test_torch_gpu.py`` asserts its verdict.
"""

import ctypes
import json
import os
import subprocess
import sys
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS, COLS = 64, 128
PATHS = {"wgmma_ss": 0, "wgmma_rs": 1, "mma_sync": 2}

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64, kCols = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major core matrices without swizzle: [k-step][8-row group][k half]
// [row in group][8 bf16], so 128 bytes between the two k halves of a group
// (LBO) and 256 between groups (SBO)
__device__ __forceinline__ int lay(int r, int k, int R) {
  return (k >> 4) * R * 16 + (r >> 3) * 128 + ((k >> 3) & 1) * 64 + (r & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint64_t desc(const void* p) {
  const uint32_t lo = ((smem_addr(p) & 0x3FFFF) >> 4) | ((128 >> 4) << 16);
  return ((uint64_t)(256 >> 4) << 32) | lo;
}

#define D64(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), \
  "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
  "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), \
  "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
  "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), \
  "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
  "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), \
  "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
  "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), \
  "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
  "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), \
  "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])

#define R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64(d)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pair(const uint16_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 16);
}

// D (64 x 128, row-major fp32) = A (64 x K bf16, row-major) * B, B given as
// (128 x K bf16): column c's K values contiguous
__global__ void __launch_bounds__(128) probe_kernel(const uint16_t* __restrict__ A,
                                                    const uint16_t* __restrict__ B,
                                                    float* __restrict__ D, int K, int path) {
  extern __shared__ __align__(128) uint16_t sm[];
  uint16_t* sa = sm;
  uint16_t* sb = sm + kRows * K;
  const int tid = threadIdx.x;
  for (int i = tid; i < kRows * K; i += 128) sa[lay(i / K, i % K, kRows)] = A[i];
  for (int i = tid; i < kCols * K; i += 128) sb[lay(i / K, i % K, kCols)] = B[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  float d[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
  for (int u = 0; u < K / 16; ++u) {
    const int k0 = 16 * u + 2 * t;
    // this thread's A fragment: (r0, k0..k0+1), (r0 + 8, k0..), (r0, k0 + 8..), (r0 + 8, k0 + 8..)
    const uint32_t a[4] = {pair(A + r0 * K + k0), pair(A + (r0 + 8) * K + k0),
                           pair(A + r0 * K + k0 + 8), pair(A + (r0 + 8) * K + k0 + 8)};
    if (path == 2) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const uint16_t* bc = B + (8 * nt + g) * K + k0;
        mma_bf16(d[nt], a, pair(bc), pair(bc + 8));
      }
      continue;
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint64_t db = desc(sb + u * kCols * 16);
    if (path == 0) wgmma_ss(d, desc(sa + u * kRows * 16), db, u > 0);
    else wgmma_rs(d, a, db, u > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t;
    D[r0 * kCols + c] = d[nt][0];
    D[r0 * kCols + c + 1] = d[nt][1];
    D[(r0 + 8) * kCols + c] = d[nt][2];
    D[(r0 + 8) * kCols + c + 1] = d[nt][3];
  }
}

}  // namespace

extern "C" int probe_run(const uint16_t* A, const uint16_t* B, float* D, int K, int path) {
  if (K < 16 || K % 16 || K > 512 || path < 0 || path > 2) return -1;
  const int smem = (kRows + kCols) * K * 2;
  cudaError_t e = cudaFuncSetAttribute(probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  probe_kernel<<<1, 128, smem>>>(A, B, D, K, path);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}
"""


def build():
    """The probe's library, built with the port's nvcc flags."""
    from speech_tpu_torch.ops import _build

    out = _build._build_dir().parent / "wgmma_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE)
    subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "probe.so"), str(out / "probe.cu")],
        check=True,
    )
    lib = ctypes.CDLL(str(out / "probe.so"))
    lib.probe_run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.probe_run.restype = ctypes.c_int
    return lib


def run(lib, a, b, path):
    """``a @ b`` (int arrays, (64, K) and (K, 128)) on the card's tensor
    cores through ``path``, as float32 numpy."""
    import torch

    ta = torch.tensor(a.astype(np.float32)).to(torch.bfloat16).view(torch.int16).cuda()
    tb = torch.tensor(b.T.astype(np.float32)).to(torch.bfloat16).contiguous().view(torch.int16).cuda()
    if not (ta.view(torch.bfloat16).float().cpu().numpy() == a).all():
        raise ValueError("an operand is not exact in bf16")
    d = torch.empty((ROWS, COLS), dtype=torch.float32, device="cuda")
    rc = lib.probe_run(ta.data_ptr(), tb.data_ptr(), d.data_ptr(), a.shape[1], PATHS[path])
    if rc != 0:
        raise RuntimeError(f"probe_run failed ({rc})")
    return d.cpu().numpy()


# --- the patterns: lists of (A (64, K), B (K, 128)) integer operands ---------


def _max_same_sign(rng, K):
    a = np.full((ROWS, K), 128)
    a[1::2] = -128
    return [(a, np.full((K, COLS), 256))]


def _cancel(rng, K):
    out = []
    for _ in range(4):
        sign = np.repeat(rng.permutation(np.resize([1, -1], K // 16)), 16)  # +-1 a k-step
        a = np.outer(rng.choice([1, -1], ROWS), sign) * 128
        b = np.full((K, COLS), 256) * rng.choice([1, -1], COLS)[None, :]
        b[-1, :] = rng.randint(-256, 257, COLS)  # a small rest
        out.append((a, b))
    return out


def _big_then_small(rng, K):
    out = []
    for _ in range(4):
        a = np.full((ROWS, K), 128) * rng.choice([1, -1], ROWS)[:, None]
        b = np.full((K, COLS), 256)
        a[:, -16:] = rng.choice([1, -1, 3, -3], (ROWS, 16))
        b[-16:] = rng.choice([1, -1, 5, -5], (16, COLS))
        out.append((a, b))
    return out


def _mixed_within_step(rng, K):
    out = []
    for _ in range(4):
        a = np.empty((ROWS, K), np.int64)
        for r in range(ROWS):
            for u in range(K // 16):
                step = np.array([128] * 7 + [-128] * 7 + list(rng.choice([1, -1, 3, -3], 2)))
                a[r, 16 * u : 16 * u + 16] = rng.permutation(step)
        b = np.full((K, COLS), 256)
        b[rng.rand(K, COLS) < 0.1] = 1  # small products beside the large ones
        out.append((a, b))
    return out


def _uniform(rng, K):
    return [(rng.randint(-128, 129, (ROWS, K)), rng.randint(-256, 257, (K, COLS))) for _ in range(4)]


def _digit_planes(frames, n_x):
    """The plain version's x digit planes of ``frames`` (float32)."""
    import torch

    f = torch.tensor(frames)
    m = torch.clamp_min(f.abs().amax(-1, keepdim=True), 1e-30)
    scale = (((m.view(torch.int32) >> 23) + 2) << 23).view(torch.float32)
    v = f * (1.0 / scale)
    planes = []
    for _ in range(n_x):
        d = torch.round(v * 256.0)
        v = v * 256.0 - d
        planes.append(d.numpy().astype(np.int64))
    return planes


def _speech(rng, K):
    """Real digit planes: frames of test.wav (and, at K 512, the digit
    kernel's adversary) against the M planes of 'double'."""
    from speech_tpu_torch import filters
    from speech_tpu_torch.ops import stft as S
    from speech_tpu_torch.ops.stft_kernels import _digit_adversary_rows

    with wave.open(os.path.join(ROOT, "tests", "audio", "test.wav")) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    sig = pcm.astype(np.float32) / 32768.0
    windows = {"hann": filters.HannWindow().get_impulse_response(K)}
    sources = {"hann": sig}
    if K == 512:
        windows["hamming"] = filters.HammingWindow().get_impulse_response(K)
        sources["hamming"] = _digit_adversary_rows(3, 64 * 160 + K).numpy().reshape(-1)
    out = []
    for name, window in windows.items():
        C, Sn = S.windowed_dft_matrices(window, 512)
        mats = S.digit_kernel_matrices(C, Sn, np.zeros((C.shape[1], 1)))["mats"]
        mats = mats.astype(np.int64)
        x = sources[name]
        starts = [len(x) // 3, len(x) // 2] if name == "hann" else [0, 64 * 160 + K]
        for s0 in starts:
            idx = s0 + 160 * np.arange(ROWS)[:, None] + np.arange(K)[None, :]
            planes = _digit_planes(x[idx % len(x)].astype(np.float32), 4)
            for i, j in S.digit_pair_schedule(4, 4, 4):
                for c0 in range(0, mats.shape[2], COLS):
                    out.append((planes[i], mats[j][:, c0 : c0 + COLS]))
    return out


PATTERNS = {
    "max_same_sign": _max_same_sign,
    "cancel": _cancel,
    "big_then_small": _big_then_small,
    "mixed_within_step": _mixed_within_step,
    "uniform": _uniform,
    "speech": _speech,
}


def probe(lib=None):
    """``{"exact": bool, "results": {path: {pattern@K: [outputs,
    mismatches, max abs difference, largest |sum|]}}}``."""
    lib = lib or build()
    rng = np.random.RandomState(20261017)
    cases = {}
    for name, make in PATTERNS.items():
        for K in (16, 400, 512) if name == "uniform" else (400, 512):
            cases[f"{name}@{K}"] = make(rng, K)
    results = {path: {} for path in PATHS}
    exact = True
    for key, ops in cases.items():
        for path in PATHS:
            n = bad = 0
            worst = 0.0
            peak = 0
            for a, b in ops:
                want = a.astype(np.int64) @ b.astype(np.int64)
                if np.abs(want).max() > 1 << 24 or np.abs(a).max() > 128 or np.abs(b).max() > 256:
                    raise ValueError(f"{key}: operands out of the digit kernel's range")
                got = run(lib, a, b, path)
                diff = np.abs(got.astype(np.float64) - want)
                n += want.size
                bad += int((diff != 0).sum())
                worst = max(worst, float(diff.max()))
                peak = max(peak, int(np.abs(want).max()))
            results[path][key] = [n, bad, worst, peak]
            exact = exact and bad == 0
    return {"exact": exact, "results": results}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    verdict = probe()
    for path, rows in verdict["results"].items():
        for key, (n, bad, worst, peak) in rows.items():
            print(f"{path:9s} {key:22s} outputs {n:7d} mismatches {bad:6d} "
                  f"max diff {worst:g} largest |sum| {peak} (2^{np.log2(max(peak, 1)):.2f})",
                  flush=True)
    print(json.dumps(verdict), flush=True)


if __name__ == "__main__":
    main()
