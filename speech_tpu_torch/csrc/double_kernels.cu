// Fused base-256 digit-tier STFT -> filter-bank feature kernel for Hopper
// (sm_90a), with a plain C launcher (stk_double_feats) that the Python
// wrapper stft_feats_double in speech_tpu_torch/ops/stft_kernels.py loads
// through ctypes.
//
// Replaces speech_tpu/ops/pallas_stft.py stft_feats_pallas_double
// (_double_rows_kernel): per frame a power-of-two scale from the exponent
// bits ((bits >> 23) + 2) << 23 of max(max|x|, 1e-30) (the margin bit keeps
// |x digit| <= 128), n_x base-256 digit planes (round half to even), one
// integer dot per kept digit pair (i, j) against the M digit planes
// (|M digit| <= 256, no margin), each term g * 256^-(i+j+2) added into one
// fp32 accumulator in the pair schedule's order, then the tail: rescale,
// the power spectrum with the Nyquist bin packed in the sin DC slot, the
// hi/lo-split filter weights plus the rank-1 Nyquist term, log floor and
// energy.
//
// Exactness: digit products are integers below 2^15 and a frame's sum
// stays below K * 2^15 <= 2^24 (the wrapper gates K <= 512), so fp32 FMA
// on integer-valued floats is exact in any order.  Every other step that
// the reference rounds is an explicitly rounded op (__fmul_rn, __fadd_rn,
// __fsub_rn), so nvcc contracts nothing.
//
// Bound on an H100: the pair dots, 2 * frames * K * 2nb * pairs operations;
// against the dense bf16 tensor-core rate (the digits are exact in bf16)
// that is about 1 ms at 128 x 15 s.  This kernel runs the dots on the CUDA
// cores (fp32 FMA, 67 TFLOP/s: some 15 ms for the same work) as an
// SGEMM-like tiling.  One block of 256 threads per (signal row, tile of kT
// frames) walks the bins in chunks of kBins: a chunk's kCT = 2 * kBins
// columns are the real and the mixed (imaginary, Nyquist in the DC slot)
// columns of the same bins, so the chunk ends in finished power spectra
// and its share of the filter product, and the block keeps only a chunk's
// spectrum.  For each chunk and each pair the M digit plane streams
// through shared memory in k-tiles of kKT rows (double buffered, one
// barrier per tile) beside the matching x digit tile, recomputed from the
// signal: frames and digit planes never reach device memory.  A tile's
// loads are issued before the FMAs of the tile before it and its digits
// computed after them, so the loads' latency hides behind the FMAs.  Each
// thread accumulates an 8 frame x 4 column register tile; its operands
// come as 16-byte shared-memory reads that a warp serves in one wavefront
// each (3 per 32 FMAs).  Whether the tensor cores accumulate these
// integer products exactly in fp32 is left for a later change.
//
// The launcher returns cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 64;         // frames per block
constexpr int kThreads = 256;  // 2 x 4 warps of 32 frames x 32 columns
constexpr int kBins = 64;      // bins per chunk
constexpr int kCT = 2 * kBins; // columns per chunk: real | mixed
constexpr int kKT = 16;        // k rows per tile
constexpr int kXS = kT + 4;    // x tile row stride (16-byte rows, fewer conflicts)
constexpr int kMaxPairs = 64;
constexpr int kMaxXDigits = 8;
constexpr int kMVec = kKT * kCT / 4 / kThreads;  // float4 of M per thread
constexpr int kXDig = kKT * kT / kThreads;       // x digits per thread
static_assert(kMVec * 4 * kThreads == kKT * kCT, "M tile split");
static_assert(kXDig * kThreads == kKT * kT, "x tile split");

struct Pairs {
  int n;
  int i[kMaxPairs];
  int j[kMaxPairs];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float floor_log(float v, float log_floor) {
  return logf(fmaxf(v, log_floor));
}

// the staged tile of one (pair, k-tile) step, held in registers between
// its loads and its store to shared memory: M digits, and the samples
// whose x digits the store computes
struct Tile {
  float4 m[kMVec];
  float x[kXDig];
  int di;
};

__global__ void __launch_bounds__(kThreads, 2) double_feats_kernel(
    const float* __restrict__ x, long long row_stride, long long n_valid,
    int frame_shift, int num_frames, int K, int nb, int C,
    const float* __restrict__ mats, Pairs pairs, float cos_scale,
    const float* __restrict__ mscale, const float* __restrict__ mask,
    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ w_nyq, float* __restrict__ out, int use_log,
    int use_power, int energy, float log_floor) {
  extern __shared__ __align__(16) float smem[];
  const int nb2 = 2 * nb;
  float* xt = smem;                     // [2][kKT][kXS]
  float* mt = xt + 2 * kKT * kXS;       // [2][kKT][kCT]
  float* pw = mt + 2 * kKT * kCT;       // [kT][kBins] the chunk's spectrum
  float* fhi = pw + kT * kBins;         // [kT][C] filter sums, hi weights
  float* flo = fhi + kT * C;            // [kT][C] lo weights
  float* scl = flo + kT * C;            // [kT]
  float* inv = scl + kT;                // [kT]
  float* en = inv + kT;                 // [kT]
  float* nyq = en + kT;                 // [kT]
  int* pi = reinterpret_cast<int*>(nyq + kT);  // [kMaxPairs]
  int* pj = pi + kMaxPairs;                    // [kMaxPairs]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kT;
  const float* xrow = x + (long long)b * row_stride;
  const long long start = (long long)f0 * frame_shift;

  for (int p = tid; p < pairs.n; p += kThreads) {
    pi[p] = pairs.i[p];
    pj[p] = pairs.j[p];
  }
  for (int i = tid; i < 2 * kT * C; i += kThreads) fhi[i] = 0.f;  // and flo
  // per-frame peak, power-of-two scale and energy: one warp per frame
  for (int t = warp; t < kT; t += kThreads / 32) {
    float m = 0.f, s = 0.f;
    const long long p0 = start + (long long)t * frame_shift;
    for (int k = lane; k < K; k += 32) {
      const long long p = p0 + k;
      const float v = p < n_valid ? __ldg(xrow + p) : 0.f;
      m = fmaxf(m, fabsf(v));
      s = fmaf(v, v, s);
    }
    m = warp_max(m);
    s = warp_sum(s);
    if (lane == 0) {
      const int bits = __float_as_int(fmaxf(m, 1e-30f));
      const float sc = __int_as_float(((bits >> 23) + 2) << 23);
      scl[t] = sc;
      inv[t] = 1.0f / sc;  // a power of two: exact
      en[t] = s;
    }
  }
  __syncthreads();

  // thread tile: frames fr0 + {0..3, 16..19}, columns cc0 + {0..3}; warps
  // with wc < 2 hold real columns, the others mixed ones
  const int wr = warp >> 2, wc = warp & 3;
  const int fr0 = wr * 32 + (lane >> 3) * 4;
  const int cc0 = wc * 32 + (lane & 7) * 4;
  const int nkt = (K + kKT - 1) / kKT;
  const int steps = pairs.n * nkt;
  const int nchunks = (nb + kBins - 1) / kBins;
  const bool vec_m = (nb & 3) == 0;  // 16-byte aligned M rows and halves

  // global column of local column l of the chunk at bin j0 (-1: past nb)
  auto column = [&](int j0, int l) {
    const int bin = j0 + (l & (kBins - 1));
    return bin < nb ? (l < kBins ? bin : nb + bin) : -1;
  };
  auto fetch = [&](int pr, int kt, int j0, Tile& tile) {
    const int k0 = kt * kKT;
    const float* mj = mats + (long long)pj[pr] * K * nb2;
#pragma unroll
    for (int r = 0; r < kMVec; ++r) {
      const int q = tid + r * kThreads;
      const int kk = q / (kCT / 4);
      const int l = (q % (kCT / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + kk < K) {
        const float* row = mj + (long long)(k0 + kk) * nb2;
        const int col = column(j0, l);
        if (vec_m && col >= 0) {
          v = __ldg(reinterpret_cast<const float4*>(row + col));
        } else {
          float e[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cu = column(j0, l + u);
            e[u] = cu >= 0 ? __ldg(row + cu) : 0.f;
          }
          v = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
      tile.m[r] = v;
    }
    tile.di = pi[pr];
#pragma unroll
    for (int r = 0; r < kXDig; ++r) {
      const int e = tid + r * kThreads;
      const int kk = e % kKT;
      const long long p = start + (long long)(e / kKT) * frame_shift + k0 + kk;
      tile.x[r] = (k0 + kk < K && p < n_valid) ? __ldg(xrow + p) : 0.f;
    }
  };
  auto store = [&](int buf, const Tile& tile) {
    float* mb = mt + buf * kKT * kCT;
#pragma unroll
    for (int r = 0; r < kMVec; ++r) {
      const int q = tid + r * kThreads;
      *reinterpret_cast<float4*>(mb + (q / (kCT / 4)) * kCT + (q % (kCT / 4)) * 4) =
          tile.m[r];
    }
    float* xb = xt + buf * kKT * kXS;
#pragma unroll
    for (int r = 0; r < kXDig; ++r) {
      const int e = tid + r * kThreads;
      float v = __fmul_rn(tile.x[r], inv[e / kKT]), d = 0.f;
      for (int step = 0; step <= tile.di; ++step) {
        const float vb = __fmul_rn(v, 256.f);
        // round half to even, as jnp.round: adding 1.5 * 2^23 leaves no
        // fraction bits (|vb| <= 128), a full-rate add where rintf is not
        d = __fsub_rn(__fadd_rn(vb, 12582912.f), 12582912.f);
        v = __fsub_rn(vb, d);
      }
      xb[(e % kKT) * kXS + e / kKT] = d;
    }
  };

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int j0 = chunk * kBins;
    float acc[8][4], g[8][4];
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[f][c] = 0.f;
        g[f][c] = 0.f;
      }
    Tile tile;
    fetch(0, 0, j0, tile);
    store(0, tile);
    __syncthreads();
    int pr = 0, kt = 0;  // the step being computed
    for (int s = 0; s < steps; ++s) {
      const int buf = s & 1;
      const int kt_n = kt + 1 == nkt ? 0 : kt + 1;
      const int pr_n = kt + 1 == nkt ? pr + 1 : pr;
      if (s + 1 < steps) fetch(pr_n, kt_n, j0, tile);
      const float* xb = xt + buf * kKT * kXS + fr0;
      const float* mb = mt + buf * kKT * kCT + cc0;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(xb + kk * kXS);
        const float4 a1 = *reinterpret_cast<const float4*>(xb + kk * kXS + 16);
        const float4 b0 = *reinterpret_cast<const float4*>(mb + kk * kCT);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bw[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int f = 0; f < 8; ++f)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[f][c] = fmaf(a[f], bw[c], g[f][c]);
      }
      if (kt + 1 == nkt) {  // the pair's dot is complete: exact integers
        const float w = ldexpf(1.0f, -8 * (pi[pr] + pj[pr] + 2));
#pragma unroll
        for (int f = 0; f < 8; ++f)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[f][c] = __fadd_rn(acc[f][c], __fmul_rn(g[f][c], w));
            g[f][c] = 0.f;
          }
      }
      if (s + 1 < steps) store(buf ^ 1, tile);
      pr = pr_n;
      kt = kt_n;
      __syncthreads();
    }

    // real parts (warps with wc < 2) into pw, then the mixed columns
    // finish each bin's power; local column cc0 + c is bin (cc0 + c) % kBins
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      if ((wc >> 1) == pass) {
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          const int t = fr0 + (f & 3) + (f >> 2) * 16;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int l = (cc0 + c) & (kBins - 1);
            const int j = j0 + l;
            if (j >= nb) continue;
            if (pass == 0) {
              pw[t * kBins + l] = __fmul_rn(acc[f][c], __fmul_rn(scl[t], cos_scale));
              continue;
            }
            const float mixed = __fmul_rn(acc[f][c], __fmul_rn(scl[t], mscale[j]));
            const float im = __fmul_rn(mixed, mask[j]);
            const float re = pw[t * kBins + l];
            const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            pw[t * kBins + l] = use_power ? p : sqrtf(p);
            if (j == 0) {
              const float nq = __fsub_rn(mixed, im);
              nyq[t] = use_power ? __fmul_rn(nq, nq) : fabsf(nq);
            }
          }
        }
      }
      __syncthreads();
    }
    // this chunk's share of the filter product
    const int nbins = nb - j0 < kBins ? nb - j0 : kBins;
    for (int idx = tid; idx < kT * C; idx += kThreads) {
      const int t = idx / C;
      const int c = idx - t * C;
      const float* sp = pw + t * kBins;
      float hi = fhi[idx], lo = flo[idx];
      for (int l = 0; l < nbins; ++l) {
        const float v = sp[l];
        hi = fmaf(v, __ldg(w_hi + (long long)(j0 + l) * C + c), hi);
        lo = fmaf(v, __ldg(w_lo + (long long)(j0 + l) * C + c), lo);
      }
      fhi[idx] = hi;
      flo[idx] = lo;
    }
    __syncthreads();
  }

  const int nc = C + energy;
  for (int idx = tid; idx < kT * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx - t * C;
    const int f = f0 + t;
    if (f >= num_frames) continue;
    float a = __fadd_rn(__fadd_rn(fhi[idx], flo[idx]), __fmul_rn(nyq[t], __ldg(w_nyq + c)));
    if (use_log) a = floor_log(a, log_floor);
    out[((long long)b * num_frames + f) * nc + energy + c] = a;
  }
  if (energy) {
    for (int t = tid; t < kT; t += kThreads) {
      const int f = f0 + t;
      if (f >= num_frames) continue;
      float e = en[t] / (float)K;
      if (!use_power) e = sqrtf(e);
      if (use_log) e = floor_log(e, log_floor);
      out[((long long)b * num_frames + f) * nc] = e;
    }
  }
}

size_t double_smem_bytes(int C) {
  return sizeof(float) * ((size_t)2 * kKT * kXS + 2 * kKT * kCT + kT * kBins +
                          2 * (size_t)kT * C + 4 * kT) +
         sizeof(int) * 2 * kMaxPairs;
}

}  // namespace

extern "C" {

// Digit-tier features of `batch` rows of fp32 samples.  Frame f of row b is
// samples [f*frame_shift, f*frame_shift + K) of x + b*row_stride; samples at
// or past n_valid read as zero.  mats is (n_m, K, 2*nb) fp32 integer digits,
// 16-byte aligned; pair_i/pair_j list the n_pairs kept digit pairs in the
// order their terms are added.  out is (batch, num_frames, C + energy) fp32.
// Returns a cudaError_t; -1 when the tile does not fit in shared memory, -2
// for a bad pair table or layout.
int stk_double_feats(const float* x, long long batch, long long row_stride,
                     long long n_valid, int frame_shift, int num_frames, int K,
                     int nb, int C, const float* mats, int n_m, int n_pairs,
                     const int* pair_i, const int* pair_j, float cos_scale,
                     const float* mscale, const float* mask, const float* w_hi,
                     const float* w_lo, const float* w_nyq, float* out,
                     int use_log, int use_power, int energy, float log_floor,
                     void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || reinterpret_cast<size_t>(mats) % 16)
    return -2;
  Pairs pairs;
  pairs.n = n_pairs;
  for (int p = 0; p < n_pairs; ++p) {
    if (pair_i[p] < 0 || pair_i[p] >= kMaxXDigits || pair_j[p] < 0 ||
        pair_j[p] >= n_m)
      return -2;
    pairs.i[p] = pair_i[p];
    pairs.j[p] = pair_j[p];
  }
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = double_smem_bytes(C);
  if (smem > (size_t)optin) return -1;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(double_feats_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((num_frames + kT - 1) / kT, (unsigned)batch);
  double_feats_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, row_stride, n_valid, frame_shift, num_frames, K, nb, C, mats, pairs,
      cos_scale, mscale, mask, w_hi, w_lo, w_nyq, out, use_log, use_power, energy,
      log_floor);
  return (int)cudaGetLastError();
}

const char* stk_error_string(int code) {
  if (code == -1) return "the frame tile does not fit in shared memory";
  if (code == -2) return "bad digit pair table or layout";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
