// Fused float STFT -> filter-bank feature kernel for Hopper (sm_90a), with
// a plain C launcher (stk_float_feats) that the Python wrappers
// stft_feats_rows and stft_feats_frames in
// speech_tpu_torch/ops/stft_kernels.py load through ctypes.
//
// float_feats_kernel replaces speech_tpu/ops/pallas_stft.py
// stft_feats_pallas (_rows_kernel) and stft_feats_pallas_from_frames
// (_frames_kernel).  One block per (signal row, tile of T frames).  The
// block stages the tile's samples in shared memory (frame t is samples
// [t*stride, t*stride + K) of the tile), so frames never reach device
// memory; stride is the frame shift for padded signal rows and K for
// materialised frames.  Each thread owns DFT bins and accumulates re/im for
// the whole tile in IEEE fp32 FMA against the window-folded cos/sin matrices
// (read through L1/L2), writes |X|^2 (or |X|) to shared memory, and the
// block then contracts the tile's spectrum with the folded filter weights,
// applies the log floor and writes the energy column.  The int8 digit tiers
// have a source of their own, int8_kernels.cu.
//
// The launcher returns cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

const char* stk_error_string(int code) {
  if (code == -1) return "no frame tile fits in shared memory";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
