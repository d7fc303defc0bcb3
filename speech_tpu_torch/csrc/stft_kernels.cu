// Fused STFT -> filter-bank feature kernels for Hopper (sm_90a).
//
// Two kernels, each with a plain C launcher that the Python wrappers in
// speech_tpu_torch/ops/stft_kernels.py load through ctypes:
//
// float_feats_kernel (stk_float_feats): the fused float pipeline.  One block
//   per (signal row, tile of T frames).  The block stages the tile's samples
//   in shared memory (frame t is samples [t*stride, t*stride + K) of the
//   tile), so frames never reach device memory; stride is the frame shift
//   for padded signal rows and K for materialised frames.  Each thread owns
//   DFT bins and accumulates re/im for the whole tile in IEEE fp32 FMA
//   against the window-folded cos/sin matrices (read through L1/L2), writes
//   |X|^2 (or |X|) to shared memory, and the block then contracts the tile's
//   spectrum with the folded filter weights, applies the log floor and
//   writes the energy column.
//
// int8_feats_kernel (stk_int8_feats): the exact digit tiers.  Per frame:
//   max|x| and energy, a power-of-two scale from the exponent bits
//   ((bits >> 23) + 2) << 23 of max(max|x|, 1e-30), and five base-128 int8
//   digit planes (round half to even) in shared memory.  One exact int32 dot
//   per equal-weight pair group (__dp4a over 4 packed digits), the low 12
//   bits split off so both halves convert to fp32 exactly, then the weighted
//   fp32 add in ascending-weight group order.  The tail rescales, forms the
//   power spectrum with the Nyquist bin packed in the sin DC slot, and
//   contracts with the hi/lo-split filter weights plus the rank-1 Nyquist
//   term, then log floor and energy.
//
// Both launchers return cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 9;   // s = i + j in 0..8 for 5 x 5 digit planes
constexpr int kMaxMembers = 5;  // x planes per group

struct I8Groups {
  int n;
  int members[kMaxGroups];
  int xs[kMaxGroups][kMaxMembers];
  int row4[kMaxGroups];  // first packed row of the group in g4
  float w[kMaxGroups];   // 128^-(s+2), exact
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

// ---------------------------------------------------------------------------
// fused float pipeline
// ---------------------------------------------------------------------------

template <int T>
__global__ void float_feats_kernel(
    const float* __restrict__ x, long long row_stride, long long n_valid,
    int frame_stride, int num_frames, int K, int half, int C,
    const float* __restrict__ cosm, const float* __restrict__ sinm,
    const float* __restrict__ w, float* __restrict__ out, int use_log,
    int use_power, int energy, float log_floor) {
  extern __shared__ float smem[];
  const int nsamp = (T - 1) * frame_stride + K;
  float* xs = smem;
  float* spec = xs + nsamp;  // T * half
  float* en = spec + T * half;  // T
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * T;
  const float* xrow = x + (long long)b * row_stride;
  const long long start = (long long)f0 * frame_stride;
  for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
    const long long p = start + i;
    xs[i] = p < n_valid ? xrow[p] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (energy) {
    for (int t = warp; t < T; t += nwarps) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = xs[t * frame_stride + k];
        s = fmaf(v, v, s);
      }
      s = warp_sum(s);
      if (lane == 0) en[t] = s;
    }
  }

  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    float re[T], im[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      re[t] = 0.f;
      im[t] = 0.f;
    }
    const float* cj = cosm + j;
    const float* sj = sinm + j;
    for (int k = 0; k < K; ++k) {
      const float c = __ldg(cj + (long long)k * half);
      const float s = __ldg(sj + (long long)k * half);
      const float* xk = xs + k;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float v = xk[t * frame_stride];
        re[t] = fmaf(v, c, re[t]);
        im[t] = fmaf(v, s, im[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float p = re[t] * re[t] + im[t] * im[t];
      spec[t * half + j] = use_power ? p : sqrtf(p);
    }
  }
  __syncthreads();

  const int nc = C + energy;
  for (int idx = threadIdx.x; idx < T * C; idx += blockDim.x) {
    const int t = idx / C;
    const int c = idx - t * C;
    const int f = f0 + t;
    if (f >= num_frames) continue;
    const float* sp = spec + t * half;
    float a = 0.f;
    for (int j = 0; j < half; ++j) a = fmaf(sp[j], __ldg(w + (long long)j * C + c), a);
    if (use_log) a = floor_log(a, log_floor);
    out[((long long)b * num_frames + f) * nc + energy + c] = a;
  }
  if (energy) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int f = f0 + t;
      if (f >= num_frames) continue;
      float e = en[t] / (float)K;
      if (!use_power) e = sqrtf(e);
      if (use_log) e = floor_log(e, log_floor);
      out[((long long)b * num_frames + f) * nc] = e;
    }
  }
}

size_t float_smem_bytes(int T, int frame_stride, int K, int half) {
  return sizeof(float) * ((size_t)(T - 1) * frame_stride + K + (size_t)T * half + T);
}

template <int T>
cudaError_t launch_float(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                         const float* x, long long row_stride, long long n_valid,
                         int frame_stride, int num_frames, int K, int half, int C,
                         const float* cosm, const float* sinm, const float* w,
                         float* out, int use_log, int use_power, int energy,
                         float log_floor) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(float_feats_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  float_feats_kernel<T><<<grid, threads, smem, stream>>>(
      x, row_stride, n_valid, frame_stride, num_frames, K, half, C, cosm, sinm, w,
      out, use_log, use_power, energy, log_floor);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 digit tiers
// ---------------------------------------------------------------------------

template <int T>
__global__ void int8_feats_kernel(
    const float* __restrict__ x, long long row_stride, long long n_valid,
    int frame_shift, int num_frames, int K, int K16, int nb, int C,
    const int* __restrict__ g4, I8Groups groups, float cos_scale,
    const float* __restrict__ mscale, const float* __restrict__ mask,
    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ w_nyq, float* __restrict__ out, int use_log,
    int use_power, int energy, float log_floor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb2 = 2 * nb;
  const int nk4 = K16 / 4;  // packed int32 words per digit-plane row
  const int nsamp = (T - 1) * frame_shift + K;
  int8_t* planes = reinterpret_cast<int8_t*>(smem_raw);  // [5][T][K16]
  float* xs = reinterpret_cast<float*>(smem_raw + 5 * T * K16);  // [nsamp]
  float* buf = xs + ((nsamp + 3) & ~3);  // [T][2nb]
  float* scl = buf + T * nb2;  // [T]
  float* en = scl + T;  // [T]
  float* nyq = en + T;  // [T]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * T;
  const float* xrow = x + (long long)b * row_stride;
  const long long start = (long long)f0 * frame_shift;
  for (int i = threadIdx.x; i < nsamp; i += blockDim.x) {
    const long long p = start + i;
    xs[i] = p < n_valid ? xrow[p] : 0.f;
  }
  __syncthreads();

  // per-frame peak, power-of-two scale and energy: one warp per frame
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < T; t += nwarps) {
    float m = 0.f, s = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = xs[t * frame_shift + k];
      m = fmaxf(m, fabsf(v));
      s = fmaf(v, v, s);
    }
    m = warp_max(m);
    s = warp_sum(s);
    if (lane == 0) {
      const int bits = __float_as_int(fmaxf(m, 1e-30f));
      scl[t] = __int_as_float(((bits >> 23) + 2) << 23);
      en[t] = s;
    }
  }
  __syncthreads();

  // five base-128 digit planes; every step is exact in fp32
  for (int idx = threadIdx.x; idx < T * K16; idx += blockDim.x) {
    const int t = idx / K16;
    const int k = idx - t * K16;
    float v = 0.f;
    if (k < K) v = __fmul_rn(xs[t * frame_shift + k], 1.0f / scl[t]);
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float vb = __fmul_rn(v, 128.f);
      const float d = rintf(vb);  // half to even, as jnp.round
      v = __fsub_rn(vb, d);
      planes[(i * T + t) * K16 + k] = (int8_t)__float2int_rn(d);
    }
  }
  __syncthreads();

  // one exact int32 dot per weight group, fp32 adds in ascending weight
  for (int col = threadIdx.x; col < nb2; col += blockDim.x) {
    float acc[T];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = 0.f;
    for (int g = 0; g < groups.n; ++g) {
      int sum[T];
#pragma unroll
      for (int t = 0; t < T; ++t) sum[t] = 0;
      for (int mi = 0; mi < groups.members[g]; ++mi) {
        const int* xp =
            reinterpret_cast<const int*>(planes) + groups.xs[g][mi] * T * nk4;
        const int* gp = g4 + (long long)(groups.row4[g] + mi * nk4) * nb2 + col;
        for (int q = 0; q < nk4; q += 4) {
          const int b0 = __ldg(gp + (long long)(q + 0) * nb2);
          const int b1 = __ldg(gp + (long long)(q + 1) * nb2);
          const int b2 = __ldg(gp + (long long)(q + 2) * nb2);
          const int b3 = __ldg(gp + (long long)(q + 3) * nb2);
#pragma unroll
          for (int t = 0; t < T; ++t) {
            const int4 a = *reinterpret_cast<const int4*>(xp + t * nk4 + q);
            int s = sum[t];
            s = __dp4a(a.x, b0, s);
            s = __dp4a(a.y, b1, s);
            s = __dp4a(a.z, b2, s);
            s = __dp4a(a.w, b3, s);
            sum[t] = s;
          }
        }
      }
      const float wg = groups.w[g];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int lo = sum[t] & 4095;
        const int hi = sum[t] - lo;
        const float term = __fadd_rn(__fmul_rn(__int2float_rn(hi), wg),
                                     __fmul_rn(__int2float_rn(lo), wg));
        acc[t] = __fadd_rn(acc[t], term);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float s = col < nb ? __fmul_rn(scl[t], cos_scale)
                               : __fmul_rn(scl[t], mscale[col - nb]);
      buf[t * nb2 + col] = __fmul_rn(acc[t], s);
    }
  }
  __syncthreads();

  // spectrum; the DC slot of the sin block carries the Nyquist value
  for (int idx = threadIdx.x; idx < T * nb; idx += blockDim.x) {
    const int t = idx / nb;
    const int j = idx - t * nb;
    const float re = buf[t * nb2 + j];
    const float mixed = buf[t * nb2 + nb + j];
    const float im = __fmul_rn(mixed, mask[j]);
    const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    if (j == 0) {
      const float nq = __fsub_rn(mixed, im);
      nyq[t] = use_power ? __fmul_rn(nq, nq) : fabsf(nq);
    }
    buf[t * nb2 + j] = use_power ? p : sqrtf(p);
  }
  __syncthreads();

  const int nc = C + energy;
  for (int idx = threadIdx.x; idx < T * C; idx += blockDim.x) {
    const int t = idx / C;
    const int c = idx - t * C;
    const int f = f0 + t;
    if (f >= num_frames) continue;
    const float* sp = buf + t * nb2;
    float hi = 0.f, lo = 0.f;
    for (int j = 0; j < nb; ++j) {
      const float v = sp[j];
      hi = fmaf(v, __ldg(w_hi + (long long)j * C + c), hi);
      lo = fmaf(v, __ldg(w_lo + (long long)j * C + c), lo);
    }
    float a = __fadd_rn(__fadd_rn(hi, lo), __fmul_rn(nyq[t], __ldg(w_nyq + c)));
    if (use_log) a = floor_log(a, log_floor);
    out[((long long)b * num_frames + f) * nc + energy + c] = a;
  }
  if (energy) {
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const int f = f0 + t;
      if (f >= num_frames) continue;
      float e = en[t] / (float)K;
      if (!use_power) e = sqrtf(e);
      if (use_log) e = floor_log(e, log_floor);
      out[((long long)b * num_frames + f) * nc] = e;
    }
  }
}

size_t int8_smem_bytes(int T, int frame_shift, int K, int K16, int nb) {
  const size_t nsamp = (size_t)(T - 1) * frame_shift + K;
  return (size_t)5 * T * K16 + sizeof(float) * (((nsamp + 3) & ~(size_t)3) +
                                                (size_t)T * 2 * nb + 3 * T);
}

template <int T>
cudaError_t launch_int8(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                        const float* x, long long row_stride, long long n_valid,
                        int frame_shift, int num_frames, int K, int K16, int nb,
                        int C, const int* g4, const I8Groups& groups,
                        float cos_scale, const float* mscale, const float* mask,
                        const float* w_hi, const float* w_lo, const float* w_nyq,
                        float* out, int use_log, int use_power, int energy,
                        float log_floor) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(int8_feats_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  int8_feats_kernel<T><<<grid, threads, smem, stream>>>(
      x, row_stride, n_valid, frame_shift, num_frames, K, K16, nb, C, g4, groups,
      cos_scale, mscale, mask, w_hi, w_lo, w_nyq, out, use_log, use_power, energy,
      log_floor);
  return cudaGetLastError();
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

extern "C" {

// Features of `batch` rows of fp32 samples.  Frame f of row b is samples
// [f*frame_stride, f*frame_stride + K) of x + b*row_stride; samples at or
// past n_valid read as zero.  out is (batch, num_frames, C + energy) fp32.
// Returns a cudaError_t; -1 when no tile fits in shared memory.
int stk_float_feats(const float* x, long long batch, long long row_stride,
                    long long n_valid, int frame_stride, int num_frames, int K,
                    int half, int C, const float* cosm, const float* sinm,
                    const float* w, float* out, int use_log, int use_power,
                    int energy, float log_floor, void* stream) {
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  const int threads = round_up(half < 512 ? half : 512, 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles[] = {32, 16, 8, 4, 2, 1};
  for (int T : tiles) {
    const size_t smem = float_smem_bytes(T, frame_stride, K, half);
    if (smem > (size_t)optin) continue;
    dim3 grid((num_frames + T - 1) / T, (unsigned)batch);
#define STK_FLOAT(TT)                                                            \
  case TT:                                                                       \
    return (int)launch_float<TT>(grid, threads, smem, s, x, row_stride, n_valid, \
                                 frame_stride, num_frames, K, half, C, cosm, sinm, \
                                 w, out, use_log, use_power, energy, log_floor);
    switch (T) {
      STK_FLOAT(32)
      STK_FLOAT(16)
      STK_FLOAT(8)
      STK_FLOAT(4)
      STK_FLOAT(2)
      STK_FLOAT(1)
    }
#undef STK_FLOAT
  }
  return -1;
}

// The int8 digit tiers on padded rows (frame f of row b is samples
// [f*frame_shift, f*frame_shift + K)).  g4 holds the grouped digit matrices
// packed four k-rows to an int32, (rows4, 2*nb), each group member's block
// K16 = round_up(K, 16) rows long and zero past K.  members/xs/row4/s
// describe the n_groups groups in ascending weight order (xs is
// n_groups x 5).  Returns a cudaError_t; -1 when no tile fits, -2 for a bad
// group table.
int stk_int8_feats(const float* x, long long batch, long long row_stride,
                   long long n_valid, int frame_shift, int num_frames, int K,
                   int nb, int C, const int* g4, int n_groups, const int* members,
                   const int* xs, const int* row4, const int* s_of_group,
                   float cos_scale, const float* mscale, const float* mask,
                   const float* w_hi, const float* w_lo, const float* w_nyq,
                   float* out, int use_log, int use_power, int energy,
                   float log_floor, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return -2;
  I8Groups groups;
  groups.n = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    if (members[g] < 1 || members[g] > kMaxMembers) return -2;
    groups.members[g] = members[g];
    for (int m = 0; m < kMaxMembers; ++m) {
      const int xi = xs[g * kMaxMembers + m];
      if (m < members[g] && (xi < 0 || xi >= 5)) return -2;
      groups.xs[g][m] = xi;
    }
    groups.row4[g] = row4[g];
    groups.w[g] = ldexpf(1.0f, -7 * (s_of_group[g] + 2));
  }
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  const int K16 = round_up(K, 16);
  const int threads = round_up(2 * nb < 512 ? 2 * nb : 512, 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles[] = {16, 8, 4, 2, 1};
  for (int T : tiles) {
    const size_t smem = int8_smem_bytes(T, frame_shift, K, K16, nb);
    if (smem > (size_t)optin) continue;
    dim3 grid((num_frames + T - 1) / T, (unsigned)batch);
#define STK_INT8(TT)                                                            \
  case TT:                                                                      \
    return (int)launch_int8<TT>(grid, threads, smem, st, x, row_stride, n_valid, \
                                frame_shift, num_frames, K, K16, nb, C, g4,     \
                                groups, cos_scale, mscale, mask, w_hi, w_lo,    \
                                w_nyq, out, use_log, use_power, energy,         \
                                log_floor);
    switch (T) {
      STK_INT8(16)
      STK_INT8(8)
      STK_INT8(4)
      STK_INT8(2)
      STK_INT8(1)
    }
#undef STK_INT8
  }
  return -1;
}

const char* stk_error_string(int code) {
  if (code == -1) return "no frame tile fits in shared memory";
  if (code == -2) return "bad digit group table";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
