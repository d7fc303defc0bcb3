// Fused base-256 digit-tier STFT -> filter-bank feature kernel for Hopper
// (sm_90a) on the bf16 tensor cores, with a plain C launcher
// (stk_double_feats) that the Python wrapper stft_feats_double in
// speech_tpu_torch/ops/stft_kernels.py loads through ctypes.
//
// Replaces speech_tpu/ops/pallas_stft.py stft_feats_pallas_double
// (_double_rows_kernel): per frame a power-of-two scale from the exponent
// bits ((bits >> 23) + 2) << 23 of max(max|x|, 1e-30) (the margin bit keeps
// |x digit| <= 128), base-256 x digit planes (round half to even), one
// integer dot per kept digit pair (i, j) against the M digit planes
// (|M digit| <= 256, no margin), each term g * 256^-(i+j+2) added into one
// fp32 accumulator in the pair schedule's order, then the tail: rescale,
// the power spectrum with the Nyquist bin packed in the sin DC slot, the
// hi/lo-split filter weights plus the rank-1 Nyquist term, log floor and
// energy.
//
// Exactness: every digit is an integer that bf16 holds exactly, so each pair
// dot runs as bf16 tensor-core products (wgmma .f32.bf16.bf16) summed in
// fp32 by the tensor cores over all of K.  Products are below 2^15 and a
// frame's partial sums stay at or below K * 2^15 <= 2^24 (the wrapper gates
// K <= 512, and so does the launcher).  That the tensor cores' own fp32
// accumulation (not IEEE: it aligns addends and truncates) sums such
// integers exactly in any order was measured, not assumed:
// tools/torch_wgmma_probe.py compares wgmma (A from shared memory or from
// registers) and mma.sync bit for bit with int64 sums, with sums up to 2^24.
// Pairs are never merged into one longer dot (two pairs could pass 2^24).
// Every other step the reference rounds is an explicitly rounded fp32 op
// (__fmul_rn, __fadd_rn, __fsub_rn, __fmaf_rn), so each frame's accumulator
// has the plain version's fp32 bits; the filter sums skip only exact zeros.
//
// Bound on an H100: the pair dots, 2 * frames * K * 2nb operations a pair
// against the 989 TFLOP/s dense bf16 rate (about 1 ms for 'double' at 128 x
// 15 s), plus the fp32 filter tail over each filter's span.  The block
//   1. takes 128 frames of one signal row (64 a consumer warpgroup) and one
//      group of filters (grid axis z), so each M plane it streams from L2
//      (13 pairs x K x 2nb x 2 bytes, 5.3 MB at K 400 and dft 512) serves
//      128 frames; stages the span of samples
//      [f0 * shift, f0 * shift + 127 * shift + 16 * steps) in shared memory
//      by cp.async (where the span does not fit, every read goes to device
//      memory instead: kSpan = false);
//   2. walks the bins in chunks of 64: chunk c's 128 columns are the real
//      and mixed columns of bins [64c, 64c + 64) side by side, so that one
//      thread's accumulator pair is one bin's.  It walks only the chunks
//      its group's filter spans touch (led by chunk 0, which carries the
//      Nyquist value, where a filter of the group weights it): the filter
//      sums of 128 frames take 1,056 bytes a filter of shared memory, so
//      the launcher splits a bank into the fewest groups whose sums fit
//      beside a ring of at least 3 stages (and the staged samples where
//      they fit too: at K 400 and a 10 ms shift one group holds at most 83
//      filters with them, 161 without), and a group remakes only the
//      chunks it shares with its neighbours;
//   3. has one thread of a producer warpgroup (which gives most of its
//      registers to the consumers by setmaxnreg) stream, for each chunk and
//      pair in order, the pair's M plane (bf16, packed by _pack_double in
//      k-steps of 16 rows x 128 columns as K-major core matrices) through a
//      ring of 3 to 8 stages of 8 KB by bulk (TMA) copies, signalled by full
//      / empty mbarriers;
//   4. runs each k-step on the tensor cores: each warpgroup issues wgmma
//      m64n128k16 with its x digits in registers, computed from the staged
//      samples (i + 1 rounds for plane i, each an fma, an fma and an add;
//      the bf16 bits are the upper half of the exact fp32 digit); a chunk is
//      one flat sequence of stages over all pairs, three register sets in
//      turn, so two stages of products stay queued while the next stage's
//      digits are made (its samples loaded a stage ahead); each pair's
//      first product starts its sum afresh.  The digits are most of the
//      time: about 7 ALU operations for each A element against 256
//      tensor-core operations (tools/torch_double_variants.py times the
//      kernel without them);
//   5. folds each pair's exact sum into the fp32 accumulator (weight, one
//      __fadd_rn) when its last product is done;
//   6. ends each chunk with its spectrum in shared memory; warp w adds the
//      chunk's w_hi and w_lo products for filters w, w + 8, ..., lane l for
//      frames 4l .. 4l + 3, over the filter's span of nonzero rows only;
//      the last chunk adds the Nyquist term and the log floor, and the block
//      writes its features, energy first, by coalesced stores.  No atomics
//      and a fixed order: the result is deterministic.
//
// The launcher returns cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;                  // 2 warpgroups of products
constexpr int kThreads = kConsumers + 128;       // and a producer warpgroup (one thread works)
constexpr int kConsumerRegs = 232;               // registers a consumer thread: setmaxnreg
constexpr int kProducerRegs = 40;                // ... and a producer thread
constexpr int kM = 128;                          // frames per block: 64 a warpgroup
constexpr int kBins = 64;                        // bins per chunk
constexpr int kCols = 2 * kBins;                 // chunk columns: (real, mixed) per bin
constexpr int kStepK = 16;                       // k of one bf16 product
constexpr int kCore = 128;                       // core matrix: 8 columns x 16 bytes
constexpr int kStepBytes = kCols * kStepK * 2;   // one k-step of a chunk: 4096
constexpr int kStageSteps = 2;                   // k-steps a ring stage
constexpr int kSlotBytes = kStageSteps * kStepBytes;
constexpr int kMaxStages = 8;
constexpr int kMinStages = 3;                    // two stages in flight and one landing
constexpr int kBarBytes = 128;                   // full and empty barriers
constexpr int kSS = kM + 8;                      // spectrum row stride: conflict-free stores
constexpr int kFT = 4;                           // frames of a lane's filter sums
constexpr int kFS = kM + 4;                      // filter-sum row stride
constexpr int kMaxPairs = 64;
constexpr int kMaxXDigits = 8;
constexpr int kMaxK = 512;                       // exact sums: K * 2^15 <= 2^24
constexpr float kRound = 12582912.f;             // 1.5 * 2^23
static_assert(kM == 32 * kFT, "a warp's lanes take a filter's frames");
static_assert(kBarBytes >= 2 * kMaxStages * 8, "barriers");

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// `bytes` more bytes are to land on `bar`, and this thread arrives on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one bulk (TMA) copy of `bytes` contiguous bytes, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4 bytes from global to shared memory, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// barrier among the consumer warps only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// shared-memory matrix descriptor, K-major without swizzle: the low word
// holds the start address in 16-byte units and the 128 bytes between the two
// core matrices along k; the high word the 256 bytes between 8-column groups.
// Adding n to the low word moves the start by 16 n bytes.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | ((kCore >> 4) << 16);
}

__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return ((uint64_t)((2 * kCore) >> 4) << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warp are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128 f32, the warpgroup's fragment layout) = a * b (+ d when
// `accumulate`): a (64 x 16 bf16) in registers, this thread's (row g, k 2t
// and 2t + 1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..), the lower k
// in the low half; b (16 x 128 bf16) K-major in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// shared memory of a block: the fixed part (barriers, ring, spectrum,
// filter sums of a group of Cg filters, per-frame values, pair table, the
// chunk walk) before the sample buffer
size_t double_fixed_bytes(int stages, int Cg) {
  return kBarBytes + (size_t)stages * kSlotBytes +
         sizeof(float) * ((size_t)kBins * kSS + 2 * (size_t)Cg * kFS + 3 * (size_t)kM) +
         3 * sizeof(int) * kMaxPairs + 4 * sizeof(int);
}

// the launch's shape: `groups` filter groups of `cg` filters (the last may
// hold fewer), a ring of `stages`, staged samples where `span`
struct DoublePlan {
  int groups, cg, stages, span;
};

// the fewest filter groups whose sums fit: for each count of groups, the
// span of samples with the deepest ring that fits, else samples from device
// memory with the deepest ring that fits.  The ring needs at least
// kMinStages: a consumer frees stage s - 2 only in step s, after stage s
// has landed, so the producer must be able to fill stage s while stages
// s - 2 and s - 1 still hold their slots.  -1 where not even one filter fits.
int double_plan(size_t optin, int frame_shift, int K, int C, DoublePlan* plan) {
  const int steps = ((K + kStepK - 1) / kStepK + kStageSteps - 1) / kStageSteps * kStageSteps;
  const long long span_n = (long long)(kM - 1) * frame_shift + (long long)steps * kStepK;
  const size_t span_bytes = sizeof(float) * (size_t)span_n;
  for (int ng = 1; ng <= C; ++ng) {
    const int cg = (C + ng - 1) / ng;
    if ((C + cg - 1) / cg != ng) continue;  // the same groups as a smaller count
    for (int s = kMaxStages; s >= kMinStages; --s)
      if (span_n < (1LL << 30) && double_fixed_bytes(s, cg) + span_bytes <= optin) {
        *plan = {ng, cg, s, 1};
        return 0;
      }
    for (int s = kMaxStages; s >= kMinStages; --s)
      if (double_fixed_bytes(s, cg) <= optin) {
        *plan = {ng, cg, s, 0};
        return 0;
      }
  }
  return -1;
}

// Warpgroup 2 is the producer (its first thread works).  Warps 0-7 consume:
// warpgroup wg takes frames [64 wg, 64 wg + 64) of the block.  kSpan: the
// block's samples are staged in shared memory; else read from device
// memory.  kPairs (with kSpan, for an even frame shift): the digit fragments
// load their sample pairs 8 bytes at a time.
template <bool kSpan, bool kPairs>
__global__ void __launch_bounds__(kThreads, 1) double_feats_kernel(
    const float* __restrict__ x, long long row_stride, long long n_valid,
    int frame_shift, int num_frames, int K, int nb, int C, int Cg,
    const uint16_t* __restrict__ packed, int steps, const __grid_constant__ Pairs pairs,
    float cos_scale, const float* __restrict__ mscale, const float* __restrict__ mask,
    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
    const float* __restrict__ w_nyq, const int* __restrict__ spans, float* __restrict__ out,
    int use_log, int use_power, int energy, float log_floor, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [stages]: a stage landed
  uint64_t* empty = full + kMaxStages;                 // [stages]: a slot is free
  // [stages][kStageSteps][16][2][8][8]: the packed layout, copied as it is
  unsigned char* ring = smem + kBarBytes;
  float* spec = reinterpret_cast<float*>(ring + (size_t)stages * kSlotBytes);  // [kBins][kSS]
  float* fhi = spec + kBins * kSS;  // [Cg][kFS]: w_hi sums of the group
  float* flo = fhi + Cg * kFS;      // [Cg][kFS]: w_lo sums
  float* scl = flo + Cg * kFS;      // [kM]
  float* en = scl + kM;             // [kM]
  float* nyq = en + kM;             // [kM]
  // the pair table, read once from the parameters: a dynamically indexed
  // kernel parameter is a slow load
  int* pi = reinterpret_cast<int*>(nyq + kM);  // [kMaxPairs]
  int* pj = pi + kMaxPairs;                    // [kMaxPairs]
  float* pw = reinterpret_cast<float*>(pj + kMaxPairs);  // [kMaxPairs] 256^-(i+j+2)
  // the chunk walk: [0] 1 where chunk 0 leads, [1] the first chunk of the
  // group's spans, [2] the chunks walked
  int* walk = reinterpret_cast<int*>(pw + kMaxPairs);
  float* xs = reinterpret_cast<float*>(walk + 4);  // the sample buffer (kSpan)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kM;
  const float* xrow = x + (long long)b * row_stride;
  const long long start = (long long)f0 * frame_shift;
  const int nchunks = (nb + kBins - 1) / kBins;
  const int c0 = blockIdx.z * Cg;  // the group's filters: [c0, c0 + cg)
  const int cg = min(Cg, C - c0);
  const int npairs = pairs.n;

  if (tid < npairs) {
    pi[tid] = pairs.i[tid];
    pj[tid] = pairs.j[tid];
    pw[tid] = ldexpf(1.0f, -8 * (pairs.i[tid] + pairs.j[tid] + 2));
  }
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    // the chunks the group's spans touch, led by chunk 0 where a filter of
    // the group weights the Nyquist value and the spans start above it; a
    // group without weights walks chunk 0 alone
    int lo = nb, hi = 0, nq = 0;
    for (int c = c0 + lane; c < c0 + cg; c += 32) {
      lo = min(lo, __ldg(spans + 2 * c));
      hi = max(hi, __ldg(spans + 2 * c + 1));
      nq |= __ldg(w_nyq + c) != 0.f;
    }
    for (int o = 16; o; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      nq |= __shfl_xor_sync(0xffffffffu, nq, o);
    }
    if (lane == 0) {
      // a span may end past nb (the Nyquist row, which chunk 0 carries)
      int clo = lo / kBins, chi = (min(hi, nb) + kBins - 1) / kBins;
      if (chi <= clo) clo = 0, chi = 1;
      const int lead = nq && clo > 0;
      walk[0] = lead;
      walk[1] = clo;
      walk[2] = chi - clo + lead;
    }
  }
  __syncthreads();
  const int nwalk = walk[2];
  auto chunk_of = [walk](int w) { return walk[0] && w == 0 ? 0 : walk[1] + w - walk[0]; };

  if (tid >= kConsumers) {
    // the launch bound leaves 168 registers a thread; the producer
    // warpgroup hands most of its share to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // the producer: for each chunk, each pair's plane, its k-steps in order,
    // a stage at a time; stage q goes into slot q mod stages once the slot's
    // previous stage has been consumed
    if (tid == kConsumers) {
      int slot = 0, use = 0;
      for (int w = 0; w < nwalk; ++w) {
        const int chunk = chunk_of(w);
        for (int p = 0; p < npairs; ++p) {
          const uint16_t* src =
              packed + ((long long)pj[p] * nchunks + chunk) * steps * (kStepBytes / 2);
          for (int q = 0; q < steps; q += kStageSteps) {
            if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
            mbar_expect(full + slot, kSlotBytes);
            bulk_copy(ring + slot * kSlotBytes, src + (long long)q * (kStepBytes / 2), kSlotBytes,
                      full + slot);
            if (++slot == stages) {
              slot = 0;
              ++use;
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // the samples, staged while the producer's first copies are in flight; a
  // sample past n_valid reads as zero
  if constexpr (kSpan) {
    const int n = (kM - 1) * frame_shift + steps * kStepK;
    for (int i = tid; i < n; i += kConsumers) {
      const long long p = start + i;
      cp_async4(xs + i, p < n_valid ? xrow + p : xrow, p < n_valid);
    }
    cp_async_wait_all();
    consumer_sync();
  }
  // sample i of the block's span, i = t * frame_shift + k for frame t
  auto sample_at = [&](int i) -> float {
    if constexpr (kSpan) return xs[i];
    const long long p = start + i;
    return p < n_valid ? __ldg(xrow + p) : 0.f;
  };
  auto sample = [&](int t, int k) { return sample_at(t * frame_shift + k); };

  // per-frame peak, power-of-two scale and energy: one warp a frame
  for (int t = warp; t < kM; t += kConsumers / 32) {
    float m = 0.f, s = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = sample(t, k);
      m = fmaxf(m, fabsf(v));
      s = fmaf(v, v, s);
    }
    m = warp_max(m);
    s = warp_sum(s);
    if (lane == 0) {
      const int bits = __float_as_int(fmaxf(m, 1e-30f));
      scl[t] = __int_as_float(((bits >> 23) + 2) << 23);
      en[t] = s;
      nyq[t] = 0.f;  // where chunk 0 is not walked, no filter weights it
    }
  }
  consumer_sync();

  // this thread's fragments: frames r0 = 64 wg + 16 (warp % 4) + g and r0 +
  // 8; accumulator columns 8 nt + 2 t (+1), that is bin 4 nt + t's (real,
  // mixed)
  const int g8 = lane >> 2;
  const int tig = lane & 3;
  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + g8;
  // 256 / scale of the two frames: powers of two, so x * sc is exact
  const float sc0 = 256.f / scl[r0];
  const float sc1 = 256.f / scl[r0 + 8];
  const int base0 = r0 * frame_shift + 2 * tig;  // sample (r0, 2t) of the frame tile
  const int base1 = base0 + 8 * frame_shift;     // (r0 + 8, 2t)
  const uint32_t b_base = desc_lo(smem_addr(ring));

  // The A fragments of the kStageSteps k-steps from k-step u0 of x digit
  // plane di: k-step u takes samples (r0, k), (r0, k + 1), (r0 + 8, k), (r0 +
  // 8, k + 1), then the same at k + 8, with k = 16 u + 2 t.  Digits past K
  // are zero (their M rows are zero too).  d = round(x * sc): 1.5 * 2^23
  // added to |x * sc| <= 128 leaves no fraction bits (round half to even, as
  // jnp.round); each further plane keeps x * sc - d (exact) and scales it by
  // 256.  All 8 kStageSteps elements go through each round together.
  constexpr int kE = 8 * kStageSteps;
  auto load = [&](int u0, float (&x)[kE]) {
#pragma unroll
    for (int u = 0; u < kStageSteps; ++u)
#pragma unroll
      for (int h = 0; h < 4; ++h) {  // (r0, k), (r0 + 8, k), (r0, k + 8), (r0 + 8, k + 8)
        const int i = (h & 1 ? base1 : base0) + (u0 + u) * kStepK + (h >> 1) * 8;
        float* xe = x + 8 * u + 2 * h;
        if constexpr (kPairs) {
          // i is even: one 8-byte load
          const float2 v = *reinterpret_cast<const float2*>(xs + i);
          xe[0] = v.x;
          xe[1] = v.y;
        } else {
          xe[0] = sample_at(i);
          xe[1] = sample_at(i + 1);
        }
      }
  };
  // the samples of the next stage's k-steps, loaded a stage ahead so that
  // their latency hides behind the digits before them
  float xq[kE];
  load(0, xq);
  auto digits = [&](int u0, int di, uint32_t (&a)[kStageSteps][4], int u0_next) {
    float x[kE], d[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) x[e] = xq[e];
    load(u0_next, xq);
#pragma unroll
    for (int e = 0; e < kE; ++e)
      d[e] = __fsub_rn(__fmaf_rn(x[e], e & 2 ? sc1 : sc0, kRound), kRound);
    if (di > 0) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        x[e] = __fmaf_rn(x[e], e & 2 ? sc1 : sc0, -d[e]);
        d[e] = __fsub_rn(__fmaf_rn(x[e], 256.f, kRound), kRound);
      }
#pragma unroll 1
      for (int r = 1; r < di; ++r) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          x[e] = __fmaf_rn(x[e], 256.f, -d[e]);
          d[e] = __fsub_rn(__fmaf_rn(x[e], 256.f, kRound), kRound);
        }
      }
    }
    uint32_t bits[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) bits[e] = __float_as_uint(d[e]);
    if ((u0 + kStageSteps) * kStepK > K) {
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if ((u0 + e / 8) * kStepK + 2 * tig + (e & 1) + ((e >> 2) & 1) * 8 >= K) bits[e] = 0u;
    }
    // an integer of at most 8 bits: its bf16 is the upper half of its fp32
#pragma unroll
    for (int u = 0; u < kStageSteps; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[u][q] = __byte_perm(bits[8 * u + 2 * q], bits[8 * u + 2 * q + 1], 0x7632);
  };

  // g: the tensor cores' exact sum of the current pair; acc: the fp32 sum
  // of the weighted pair terms, in pair order
  float g[16][4], acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[nt][e] = 0.f;
      acc[nt][e] = 0.f;
    }
  auto fold = [&](float w) {  // the pair's dot is complete: exact integers, weighted exactly
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = __fadd_rn(acc[nt][e], __fmul_rn(g[nt][e], w));
  };

  // A chunk is one flat sequence of ring stages, pair after pair (nst
  // stages a pair).  Stage s issues its products from register set s mod 3
  // and, once stage s - 2 is done, puts the digits of stage s + 1 into that
  // stage's set: two stages of products stay queued on the tensor cores
  // while the digits are made, and every stage's digits are ready when it
  // issues.  A pair's first stage first drains its predecessor and folds it.
  const int nst = steps / kStageSteps;
  const int nstages = npairs * nst;
  int slot = 0, use = 0;             // ring slot and its use of the next stage
  int prev1 = -1, prev2 = -1;        // the slots of the last two stages
  int ip = 0, iq = 0;                // the pair and stage of the next issue
  int pp = 0, pq = 0;                // ... and of the next digits
  auto prep = [&](uint32_t (&a)[kStageSteps][4]) {
    const int di = pi[pp];
    const int u0 = pq * kStageSteps;
    if (++pq == nst) {
      pq = 0;
      ++pp;
    }
    digits(u0, di, a, pq * kStageSteps);
  };
  auto step = [&](bool more, uint32_t (&cur)[kStageSteps][4], uint32_t (&nxt)[kStageSteps][4]) {
    if (iq == 0 && ip > 0) {
      wgmma_wait<0>();
      fold(pw[ip - 1]);
    }
    mbar_wait(full + slot, use & 1);
    const uint32_t b_slot = b_base + ((slot * kSlotBytes) >> 4);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kStageSteps; ++u)
      wgmma_bf16(g, cur[u], desc(b_slot + ((u * kStepBytes) >> 4)), iq + u > 0);
    // the stage before the previous one is done (the last two may still
    // run): its slot and its register set are free
    wgmma_commit();
    wgmma_wait<2>();
    if (prev2 >= 0 && lane == 0) mbar_arrive(empty + prev2);
    prev2 = prev1;
    prev1 = slot;
    if (++slot == stages) {
      slot = 0;
      ++use;
    }
    if (++iq == nst) {
      iq = 0;
      ++ip;
    }
    if (more) prep(nxt);
  };

  uint32_t a0[kStageSteps][4], a1[kStageSteps][4], a2[kStageSteps][4];
  for (int w = 0; w < nwalk; ++w) {
    const int chunk = chunk_of(w);
    ip = iq = pp = pq = 0;
    prep(a0);
    int s = 0;
    for (; s + 3 <= nstages; s += 3) {
      step(true, a0, a1);
      step(true, a1, a2);
      step(s + 3 < nstages, a2, a0);
    }
    if (s < nstages) step(s + 1 < nstages, a0, a1);
    if (s + 1 < nstages) step(false, a1, a2);
    wgmma_wait<0>();
    fold(pw[npairs - 1]);

    // chunk done: its spectrum, once every consumer is done with the
    // previous chunk's; the mixed column of bin 0 carries the Nyquist value
    consumer_sync();
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = r0 + 8 * h;
        const int jl = 4 * nt + tig;
        const int j = chunk * kBins + jl;
        if (j < nb) {
          const float re = __fmul_rn(acc[nt][2 * h], __fmul_rn(scl[t], cos_scale));
          const float mixed = __fmul_rn(acc[nt][2 * h + 1], __fmul_rn(scl[t], __ldg(mscale + j)));
          const float im = __fmul_rn(mixed, __ldg(mask + j));
          const float pwr = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
          if (j == 0) {
            const float nq = __fsub_rn(mixed, im);
            nyq[t] = use_power ? __fmul_rn(nq, nq) : fabsf(nq);
          }
          spec[jl * kSS + t] = use_power ? pwr : sqrtf(pwr);
        }
        acc[nt][2 * h] = 0.f;
        acc[nt][2 * h + 1] = 0.f;
      }
    consumer_sync();

    // the chunk's share of the filter sums, bins ascending over the filter's
    // nonzero span within the chunk: warp w takes filters w, w + 8, ... and
    // lane l frames 4l .. 4l + 3, so a warp walks one span in step, loads
    // each weight once for all its lanes and reads the spectrum without
    // bank conflicts; the sums wait in fhi / flo between chunks
    const int j0 = chunk * kBins;
    const bool last = w + 1 == nwalk;
    for (int c = warp; c < cg; c += kConsumers / 32) {
      const int cc = c0 + c;  // the filter's column in the bank
      float4* fh = reinterpret_cast<float4*>(fhi + c * kFS) + lane;
      float4* fl = reinterpret_cast<float4*>(flo + c * kFS) + lane;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 h = w ? *fh : zero, l = w ? *fl : zero;
      const int ja = max(j0, __ldg(spans + 2 * cc));
      const int jb = min(min(j0 + kBins, nb), __ldg(spans + 2 * cc + 1));
      const float* sp = spec + lane * kFT;
      for (int j = ja; j < jb; ++j) {
        const float vh = __ldg(w_hi + (long long)j * C + cc);
        const float vl = __ldg(w_lo + (long long)j * C + cc);
        const float4 v = *reinterpret_cast<const float4*>(sp + (j - j0) * kSS);
        h = make_float4(fmaf(v.x, vh, h.x), fmaf(v.y, vh, h.y), fmaf(v.z, vh, h.z),
                        fmaf(v.w, vh, h.w));
        l = make_float4(fmaf(v.x, vl, l.x), fmaf(v.y, vl, l.y), fmaf(v.z, vl, l.z),
                        fmaf(v.w, vl, l.w));
      }
      if (last) {
        // hi + lo, then the rank-1 Nyquist term (row 0 of w_nyq), then the
        // log floor
        const float wn = __ldg(w_nyq + cc);
        const float4 q = reinterpret_cast<const float4*>(nyq)[lane];
        h = make_float4(__fadd_rn(__fadd_rn(h.x, l.x), __fmul_rn(q.x, wn)),
                        __fadd_rn(__fadd_rn(h.y, l.y), __fmul_rn(q.y, wn)),
                        __fadd_rn(__fadd_rn(h.z, l.z), __fmul_rn(q.z, wn)),
                        __fadd_rn(__fadd_rn(h.w, l.w), __fmul_rn(q.w, wn)));
        if (use_log)
          h = make_float4(floor_log(h.x, log_floor), floor_log(h.y, log_floor),
                          floor_log(h.z, log_floor), floor_log(h.w, log_floor));
      } else {
        *fl = l;
      }
      *fh = h;
    }
  }

  // the block's features, frame by frame, by coalesced stores: the energy
  // column (group 0 only), then the group's filters from fhi
  consumer_sync();
  const int nc = C + energy;
  const int e0 = energy && blockIdx.z == 0;
  const int nw = cg + e0;  // columns this block writes
  const int nf = min(kM, num_frames - f0);
  float* ob = out + ((long long)b * num_frames + f0) * nc + (e0 ? 0 : energy + c0);
  for (int i = tid; i < nf * nw; i += kConsumers) {
    const int t = i / nw;
    const int col = i - t * nw;
    const int c = col - e0;
    float v;
    if (c >= 0) {
      v = fhi[c * kFS + t];
    } else {
      v = en[t] / (float)K;
      if (!use_power) v = sqrtf(v);
      if (use_log) v = floor_log(v, log_floor);
    }
    ob[(long long)t * nc + col] = v;
  }
}

template <bool kSpan, bool kPairs>
cudaError_t launch_double(dim3 grid, size_t smem, cudaStream_t stream, const float* x,
                          long long row_stride, long long n_valid, int frame_shift,
                          int num_frames, int K, int nb, int C, int Cg, const uint16_t* packed,
                          int steps, const Pairs& pairs, float cos_scale, const float* mscale,
                          const float* mask, const float* w_hi, const float* w_lo,
                          const float* w_nyq, const int* spans, float* out, int use_log,
                          int use_power, int energy, float log_floor, int stages) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(double_feats_kernel<kSpan, kPairs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  double_feats_kernel<kSpan, kPairs><<<grid, kThreads, smem, stream>>>(
      x, row_stride, n_valid, frame_shift, num_frames, K, nb, C, Cg, packed, steps, pairs,
      cos_scale, mscale, mask, w_hi, w_lo, w_nyq, spans, out, use_log, use_power, energy,
      log_floor, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Digit-tier features of `batch` rows of fp32 samples.  Frame f of row b is
// samples [f*frame_shift, f*frame_shift + K) of x + b*row_stride; samples at
// or past n_valid read as zero.  packed holds the n_m M digit planes as bf16
// (n_m, chunks, steps, 16, 2, 8, 8), 16-byte aligned: [plane][chunk c][k-step
// u][column group][k half][column in group][k in half], chunk c's column 2i
// the real and 2i + 1 the mixed column of bin 64c + i (zero past nb), k-step
// u rows [16u, 16u + 16) (zero past K), steps = ceil(K / 16) rounded up to
// even.  pair_i/pair_j list the n_pairs kept digit pairs in the order their
// terms are added.  spans (C x 2 int32) bound each filter's nonzero w_hi /
// w_lo rows as [first, last + 1).  out is (batch, num_frames, C + energy)
// fp32.  The bank is split into the fewest filter groups whose sums fit in
// shared memory (stk_double_plan), one grid slice each.  Returns a
// cudaError_t; -1 when not even one filter's sums fit beside a ring of 3
// stages, -2 for a bad pair table, K above 512 or a bad layout.
int stk_double_feats(const float* x, long long batch, long long row_stride,
                     long long n_valid, int frame_shift, int num_frames, int K, int nb,
                     int C, const uint16_t* packed, int n_m, int n_pairs, const int* pair_i,
                     const int* pair_j, float cos_scale, const float* mscale,
                     const float* mask, const float* w_hi, const float* w_lo,
                     const float* w_nyq, const int* spans, float* out, int use_log,
                     int use_power, int energy, float log_floor, void* stream) {
  if (n_pairs < 1 || n_pairs > kMaxPairs || K < 1 || K > kMaxK || nb < 1 || C < 1 ||
      frame_shift < 1 || reinterpret_cast<size_t>(packed) % 16)
    return -2;
  Pairs pairs = {};
  pairs.n = n_pairs;
  for (int p = 0; p < n_pairs; ++p) {
    if (pair_i[p] < 0 || pair_i[p] >= kMaxXDigits || pair_j[p] < 0 || pair_j[p] >= n_m)
      return -2;
    pairs.i[p] = pair_i[p];
    pairs.j[p] = pair_j[p];
  }
  const int steps = ((K + kStepK - 1) / kStepK + kStageSteps - 1) / kStageSteps * kStageSteps;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  DoublePlan plan;
  if (double_plan((size_t)optin, frame_shift, K, C, &plan)) return -1;
  const size_t smem = double_fixed_bytes(plan.stages, plan.cg) +
                      (plan.span ? sizeof(float) * ((size_t)(kM - 1) * frame_shift +
                                                    (size_t)steps * kStepK)
                                 : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((num_frames + kM - 1) / kM, (unsigned)batch, plan.groups);
#define STK_DOUBLE(SPAN, PAIRS)                                                               \
  launch_double<SPAN, PAIRS>(grid, smem, st, x, row_stride, n_valid, frame_shift, num_frames, K, \
                             nb, C, plan.cg, packed, steps, pairs, cos_scale, mscale, mask,     \
                             w_hi, w_lo, w_nyq, spans, out, use_log, use_power, energy,         \
                             log_floor, plan.stages)
  // an even shift puts every fragment's sample pairs at even offsets
  cudaError_t rc = !plan.span ? STK_DOUBLE(false, false)
                   : frame_shift % 2 ? STK_DOUBLE(true, false) : STK_DOUBLE(true, true);
#undef STK_DOUBLE
  return (int)rc;
}

// The launch stft_feats_double would make for a frame shift, K and C on the
// current device: plan[0..3] = filter groups, filters a group, ring stages,
// staged samples (1) or not (0).  Returns 0, -1 where nothing fits, or a
// cudaError_t.
int stk_double_plan(int frame_shift, int K, int C, int* plan) {
  if (K < 1 || K > kMaxK || C < 1 || frame_shift < 1) return -2;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  DoublePlan p;
  if (double_plan((size_t)optin, frame_shift, K, C, &p)) return -1;
  plan[0] = p.groups;
  plan[1] = p.cg;
  plan[2] = p.stages;
  plan[3] = p.span;
  return 0;
}

const char* stk_error_string(int code) {
  if (code == -1) return "not even one filter's sums fit in shared memory";
  if (code == -2) return "bad digit pair table, K above 512 or a bad layout";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
