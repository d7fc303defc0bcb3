// Fused float STFT -> filter-bank feature kernel for Hopper (sm_90a) on the
// TF32 tensor cores, with a plain C launcher (stk_float_feats) that the
// Python wrappers stft_feats_rows and stft_feats_frames in
// speech_tpu_torch/ops/stft_kernels.py load through ctypes.
//
// Replaces speech_tpu/ops/pallas_stft.py stft_feats_pallas (_rows_kernel +
// _feats_from_pieces) and stft_feats_pallas_from_frames (_frames_kernel):
// re/im of each frame against the window-folded DFT matrices, |X|^2 (its
// root for magnitude), the folded filter weights, log floor and energy.  One
// kernel serves both routes: frame t of a block is samples [t*stride, t*stride
// + K) of its row, stride the frame shift for padded signal rows and K for
// materialised frames.
//
// Precision: the DFT products run as TF32 tensor-core products with fp32
// accumulation (wgmma .f32.tf32.tf32).  kPasses = 3 ('highest', 'high') splits
// both operands, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and adds
// lo*hi + hi*lo + hi*hi per k-step, small terms first: about fp32 accuracy (the
// dropped lo*lo term is 2^-22 of a product).  kPasses = 1 ('default') adds
// hi*hi only: TF32, about 2^-11 of a product.  The filter product, log and
// energy are IEEE fp32 in every tier.
//
// Bound on an H100: the DFT products, kPasses * 2 * frames * K * 2nb
// operations against the 495 TFLOP/s dense TF32 rate, plus the fp32 filter
// product; the signal is read once and the features written once.  Every
// block reads the whole packed DFT operand (hi and lo: 1.6 MB at K 400, dft
// 512) from L2, so a block takes 128 frames of one row, and L2 traffic is
// 1.6 MB per 128 frames.  The block
//   1. stages its samples in shared memory by cp.async while the producer's
//      first copies are in flight: the span [f0 * stride, f0 * stride + 127
//      * stride + K) where it fits (frames overlap, so this is all of them),
//      else slabs of K of each frame, staged again as the walk reaches them
//      (back and forth, so a chunk starts on the slab the last one ended
//      on); a skew of 4 floats every 2^sh (the launcher picks sh for the
//      stride) keeps the fragment loads free of most bank conflicts;
//   2. walks the bins in chunks of 64: chunk c's 128 columns are the real and
//      mixed columns of bins [64c, 64c + 64) side by side (the mixed column
//      of bin 0 holds the Nyquist cosine, for even DFT sizes), so one
//      thread's accumulator pair is one bin's (re, im).  A block takes one
//      group of filters (grid axis z) and walks only the chunks its
//      filters' spans touch (led by chunk 0 where a filter of the group
//      weights the Nyquist bin): the filter sums of 128 frames take 528
//      bytes a filter, so the launcher splits a bank into the fewest groups
//      whose sums fit beside the ring and the samples (one group holds
//      some 290 filters at K 400);
//   3. has one thread of a producer warpgroup (which gives most of its
//      registers to the consumers by setmaxnreg) stream each chunk's hi /
//      lo k-steps (8 k x 128 columns, K-major core matrices, packed by
//      _pack_float) into a ring of 2-6 stages of 2 k-steps by bulk (TMA)
//      copies, signalled by full / empty mbarriers;
//   4. runs each k-step on the tensor cores: two warpgroups, 64 frames each,
//      issue wgmma m64n128k8 with the frame operand in registers (loaded from
//      the staged samples and split hi / lo there) and the DFT operand read
//      from shared memory by descriptor; one stage of products stays in
//      flight while the next is issued, the two register sets alternating
//      by stage so that ptxas need not serialise the products; the split
//      passes hand their sum to fp32 registers after every stage (kFold),
//      since the tensor cores' own fp32 adds truncate: summed over all of
//      K 400 they put 'highest' up to 3e-4 from float64 on log features of
//      narrow filters, and folding every 2 k-steps brings that to 3.6e-5,
//      where fewer folds leave up to 2.6e-4 (tools/torch_float_fold.py
//      times and checks the fold intervals);
//   5. ends each chunk with its spectrum in shared memory; warp w adds the
//      chunk's weight products for filters w, w + 8, ..., lane l for frames
//      4l .. 4l + 3, over the filter's span of nonzero weight rows only, and
//      keeps the sums in shared memory; the last chunk adds the Nyquist
//      term and the log floor, and the block writes its features, energy
//      first, by coalesced stores.  No atomics and a fixed order: the
//      result is deterministic.
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
constexpr int kCols = 2 * kBins;                 // chunk columns: (re, mixed) per bin
constexpr int kStepK = 8;                        // k of one tf32 product
constexpr int kCore = 128;                       // core matrix: 8 columns x 16 bytes
constexpr int kPartBytes = kCols * kStepK * 4;   // hi (or lo) of one k-step: 4096
constexpr int kStepBytes = 2 * kPartBytes;       // hi and lo
constexpr int kStageSteps = 2;                   // k-steps a ring stage
constexpr int kSlotBytes = kStageSteps * kStepBytes;
constexpr int kMaxStages = 6;
constexpr int kBarBytes = 128;                   // full and empty barriers
constexpr int kSS = kM + 8;                      // spectrum row stride: conflict-free stores
constexpr int kFT = 4;                           // frames of a lane's filter sums
constexpr int kFS = kM + 4;                      // filter-sum row stride
constexpr int kFoldSteps = 2;                    // k-steps a split-pass tensor-core sum
                                                 // runs at most (kFold)
static_assert(kFoldSteps % kStageSteps == 0, "folds fall between stages");
static_assert(kM == 32 * kFT, "a warp's lanes take a filter's frames");

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// fp32 -> tf32, round to nearest (ties away), as the host packing rounds
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
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

// d (64 x 128 f32, the warpgroup's fragment layout) += a * b: a (64 x 8 tf32)
// in registers, this thread's (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); b (8 x 128 tf32) K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// What the launcher settles for a launch.  Samples: with `span`, the block's
// samples [f0 * stride, f0 * stride + (kM - 1) * stride + steps * 8), staged
// once, frame t at rs * t (rs = stride); else slabs of each frame, frame t
// at rs * t (rs / 8 k-steps), staged anew as the walk reaches them.  Sample i of the buffer lies at float i + 4 * (i >> sh).
struct FloatPlan {
  int stages;  // ring stages, 2..kMaxStages
  int span;    // 1: the span of samples; 0: slabs
  int slab;    // k-steps a slab, a stretch of the walk: with span, steps;
               // else at most rs / 8
  int rs;      // buffer floats between frames
  int sh;      // skew shift (31: none)
};

// shared memory of a block: the fixed part (barriers, ring, spectrum,
// filter sums of a group of Cg filters, energy, Nyquist, the chunk walk)
// before the sample buffer
size_t float_fixed_bytes(int stages, int Cg) {
  return kBarBytes + (size_t)stages * kSlotBytes +
         sizeof(float) * ((size_t)kBins * kSS + (size_t)Cg * kFS + 2 * (size_t)kM) +
         4 * sizeof(int);
}

template <int kPasses, bool kFold>
__global__ void __launch_bounds__(kThreads, 1) float_feats_kernel(
    const float* __restrict__ x, long long row_stride, long long n_valid,
    int frame_stride, int num_frames, int K, int half, int nb, int C, int Cg,
    const float* __restrict__ packed, int steps, const float* __restrict__ w,
    const int* __restrict__ spans, float* __restrict__ out, int use_log,
    int use_power, int energy, float log_floor, const __grid_constant__ FloatPlan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [stages]: a stage landed
  uint64_t* empty = full + kMaxStages;                 // [stages]: a slot is free
  // [stages][kStageSteps][hi, lo][16][2][8][4]: the packed layout, copied as it is
  unsigned char* ring = smem + kBarBytes;
  float* spec = reinterpret_cast<float*>(ring + (size_t)plan.stages * kSlotBytes);  // [kBins][kSS]
  float* fsum = spec + kBins * kSS;  // [Cg][kFS]: the group's sums
  float* en = fsum + Cg * kFS;       // [kM]
  float* nyq = en + kM;              // [kM]
  // the chunk walk: [0] 1 where chunk 0 leads, [1] the first chunk of the
  // group's spans, [2] the chunks walked
  int* walk = reinterpret_cast<int*>(nyq + kM);
  float* xs = reinterpret_cast<float*>(walk + 4);  // the sample buffer

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kM;
  const float* xrow = x + (long long)b * row_stride;
  const long long start = (long long)f0 * frame_stride;
  const int c0 = blockIdx.z * Cg;  // the group's filters: [c0, c0 + cg)
  const int cg = min(Cg, C - c0);
  const int sh = plan.sh;
  const int rs = plan.rs;
  auto at = [sh](int i) { return i + ((i >> sh) << 2); };
  // the slabs of K (one with span) walk back and forth, so that a chunk
  // starts on the slab the last one ended on (w: the chunk's place in the
  // walk)
  const int nslabs = (steps + plan.slab - 1) / plan.slab;
  auto slab_of = [nslabs](int w, int i) { return w & 1 ? nslabs - 1 - i : i; };

  if (tid == 0) {
    for (int i = 0; i < plan.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    // the chunks the group's spans touch, led by chunk 0 where a filter of
    // the group weights the Nyquist row and the spans start above it; a
    // group without weights walks chunk 0 alone
    int lo = nb, hi = 0, nq = 0;
    for (int c = c0 + lane; c < c0 + cg; c += 32) {
      lo = min(lo, __ldg(spans + 2 * c));
      hi = max(hi, __ldg(spans + 2 * c + 1));
      nq |= nb < half && __ldg(w + (long long)nb * C + c) != 0.f;
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
  auto chunk_of = [walk](int i) { return walk[0] && i == 0 ? 0 : walk[1] + i - walk[0]; };

  if (tid >= kConsumers) {
    // the producer: each chunk's k-steps in order, a stage at a time; stage
    // q goes into slot q mod stages once the slot's previous stage has been
    // consumed.  The launch bound leaves 168 registers a thread; the
    // producer warpgroup hands most of its share to the consumers, whose
    // fold of the split passes would spill in 168
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      constexpr int kBytes = kPasses == 3 ? kStepBytes : kPartBytes;
      int slot = 0, use = 0;
      for (int wi = 0; wi < nwalk; ++wi) {
        const float* pc = packed + (long long)chunk_of(wi) * steps * (kStepBytes / 4);
        for (int i = 0; i < nslabs; ++i) {
          const int kb = slab_of(wi, i) * plan.slab;
          for (int q = kb; q < min(steps, kb + plan.slab); q += kStageSteps) {
            if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
            mbar_expect(full + slot, kStageSteps * kBytes);
#pragma unroll
            for (int u = 0; u < kStageSteps; ++u)
              bulk_copy(ring + slot * kSlotBytes + u * kStepBytes,
                        pc + (long long)(q + u) * (kStepBytes / 4), kBytes, full + slot);
            if (++slot == plan.stages) {
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

  // no Nyquist value where chunk 0 is not walked (no filter weights it)
  for (int t = tid; t < kM; t += kConsumers) nyq[t] = 0.f;

  // the samples, staged while the producer's first copies are in flight; a
  // sample past n_valid reads as zero (its copy comes from xrow)
  auto stage = [&](float* dst, long long p) {
    cp_async4(dst, p < n_valid ? xrow + p : xrow, p < n_valid);
  };
  if (plan.span) {
    const int n = (kM - 1) * rs + steps * kStepK;
    for (int i = tid; i < n; i += kConsumers) stage(xs + at(i), start + i);
    cp_async_wait_all();
    consumer_sync();
  }

  // energy of each frame: one consumer warp a frame, read when the block
  // writes its features, after the consumer barriers between (slabs: as
  // they are staged)
  if (energy && plan.span) {
    for (int t = warp; t < kM; t += kConsumers / 32) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float v = xs[at(t * rs + k)];
        s = fmaf(v, v, s);
      }
      s = warp_sum(s);
      if (lane == 0) en[t] = s;
    }
  }

  // this thread's fragments: frames r0 = 64 wg + 16 (warp % 4) + g and r0 +
  // 8; accumulator columns 8 nt + 2 t (+1), that is bin 4 nt + t's (re, mixed)
  const int g8 = lane >> 2;
  const int tig = lane & 3;
  const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + g8;
  const int base0 = r0 * rs + tig;
  const int base1 = base0 + 8 * rs;
  const uint32_t b_base = desc_lo(smem_addr(ring));

  // slab mode: the slab from k-step kb, once every consumer has read the
  // last; the first walk over the slabs also sums the energy
  int loaded = -1;
  auto stage_slab = [&](int kb, bool first) {
    if (kb == loaded) return;
    loaded = kb;
    consumer_sync();
    for (int t = warp; t < kM; t += kConsumers / 32) {
      const long long p = start + (long long)t * frame_stride + kb * kStepK;
      for (int k = lane; k < rs; k += 32) stage(xs + at(t * rs + k), p + k);
    }
    cp_async_wait_all();
    consumer_sync();
    if (energy && first) {
      const int kn = min(plan.slab * kStepK, K - kb * kStepK);
      for (int t = warp; t < kM; t += kConsumers / 32) {
        float s = 0.f;
        for (int k = lane; k < kn; k += 32) {
          const float v = xs[at(t * rs + k)];
          s = fmaf(v, v, s);
        }
        s = warp_sum(s);
        if (lane == 0) en[t] = kb ? en[t] + s : s;
      }
    }
  };

  // acc: the tensor cores' sum; with kFold, `part` takes it over by IEEE fp32
  // adds every kFoldSteps k-steps and at each slab's end, so that no sum
  // runs over more than kFoldSteps k-steps on the tensor cores (their fp32
  // adds truncate)
  float acc[16][4], part[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[nt][e] = 0.f;
      part[nt][e] = 0.f;
    }

  // the tensor cores' sum so far goes to `part` (IEEE fp32 adds) and
  // starts again from zero
  auto fold = [&] {
    wgmma_wait<0>();
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[nt][e] = __fadd_rn(part[nt][e], acc[nt][e]);
        acc[nt][e] = 0.f;
      }
  };

  // one ring stage: the frame fragments of its k-steps from the samples
  // (split hi / lo), then (with `fold_first`, once the last stage's
  // products are done: the fragment loads overlap them) a fold, then its
  // products; `hi` / `lo` are this stage's own registers, which the
  // products read until they are done
  int slot = 0, use = 0, prev = -1;  // ring slot and its use of this stage; the last one's
  auto run_stage = [&](int q, int kb, uint32_t (&hi)[kStageSteps][4],
                       uint32_t (&lo)[kStageSteps][4], bool fold_first) {
#pragma unroll
    for (int u = 0; u < kStageSteps; ++u) {
      const int k0 = (q + u - kb) * kStepK;
      const float v[4] = {xs[at(base0 + k0)], xs[at(base1 + k0)], xs[at(base0 + k0 + 4)],
                          xs[at(base1 + k0 + 4)]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[u][e] = to_tf32(v[e]);
        if constexpr (kPasses == 3) lo[u][e] = to_tf32(__fsub_rn(v[e], __uint_as_float(hi[u][e])));
      }
    }
    mbar_wait(full + slot, use & 1);
    if constexpr (kFold)
      if (fold_first) fold();
    const uint32_t b_slot = b_base + ((slot * kSlotBytes) >> 4);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < kStageSteps; ++u) {
      const uint32_t b_hi = b_slot + ((u * kStepBytes) >> 4);
      if constexpr (kPasses == 3) {
        const uint32_t b_lo = b_hi + (kPartBytes >> 4);
        wgmma_tf32(acc, lo[u], desc(b_hi));
        wgmma_tf32(acc, hi[u], desc(b_lo));
      }
      wgmma_tf32(acc, hi[u], desc(b_hi));
    }
    // the previous stage's products are done (this one's may still run):
    // its slot is free
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
    prev = slot;
    if (++slot == plan.stages) {
      slot = 0;
      ++use;
    }
  };

  uint32_t hi0[kStageSteps][4], lo0[kStageSteps][4], hi1[kStageSteps][4], lo1[kStageSteps][4];
  for (int wi = 0; wi < nwalk; ++wi) {
    const int chunk = chunk_of(wi);
    for (int i = 0; i < nslabs; ++i) {
      const int kb = slab_of(wi, i) * plan.slab;
      const int ke = min(steps, kb + plan.slab);
      if (!plan.span) stage_slab(kb, wi == 0);
      // the register sets alternate, and an odd last stage takes the first
      // set after the second: no path reuses a set whose products may run
      const int koff = plan.span ? 0 : kb;
      int q = kb;
      // a fold before the stage that ends kFoldSteps k-steps of the slab
      auto due = [&](int qs) { return kFold && qs > kb && (qs - kb) % kFoldSteps == 0; };
      for (; q + 2 * kStageSteps <= ke; q += 2 * kStageSteps) {
        run_stage(q, koff, hi0, lo0, due(q));
        run_stage(q + kStageSteps, koff, hi1, lo1, due(q + kStageSteps));
      }
      if (q < ke) run_stage(q, koff, hi0, lo0, due(q));
      if constexpr (kFold) {
        fold();
      } else {
        wgmma_wait<0>();
      }
    }

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
        const float re = kFold ? part[nt][2 * h] : acc[nt][2 * h];
        const float mixed = kFold ? part[nt][2 * h + 1] : acc[nt][2 * h + 1];
        if (j < nb) {
          float p = re * re;
          if (j == 0) {
            nyq[t] = use_power ? mixed * mixed : fabsf(mixed);
          } else {
            p += mixed * mixed;
          }
          spec[jl * kSS + t] = use_power ? p : sqrtf(p);
        }
        acc[nt][2 * h] = part[nt][2 * h] = 0.f;
        acc[nt][2 * h + 1] = part[nt][2 * h + 1] = 0.f;
      }
    consumer_sync();

    // the chunk's share of the filter sums, bins ascending over the filter's
    // nonzero span within the chunk: warp w takes filters w, w + 8, ... and
    // lane l frames 4l .. 4l + 3, so a warp walks one span in step, loads
    // each weight once for all its lanes and reads the spectrum without
    // bank conflicts; the sums wait in fsum between chunks
    const int j0 = chunk * kBins;
    const bool last = wi + 1 == nwalk;
    for (int c = warp; c < cg; c += kConsumers / 32) {
      const int cc = c0 + c;  // the filter's column in the bank
      float4* fs = reinterpret_cast<float4*>(fsum + c * kFS) + lane;
      float4 a = wi ? *fs : make_float4(0.f, 0.f, 0.f, 0.f);
      const int ja = max(j0, __ldg(spans + 2 * cc));
      const int jb = min(min(j0 + kBins, nb), __ldg(spans + 2 * cc + 1));
      const float* sp = spec + lane * kFT;
      for (int j = ja; j < jb; ++j) {
        const float wj = __ldg(w + (long long)j * C + cc);
        const float4 v = *reinterpret_cast<const float4*>(sp + (j - j0) * kSS);
        a.x = fmaf(v.x, wj, a.x);
        a.y = fmaf(v.y, wj, a.y);
        a.z = fmaf(v.z, wj, a.z);
        a.w = fmaf(v.w, wj, a.w);
      }
      if (last) {
        // the Nyquist row of the weights (even DFT sizes: nb = half - 1; an
        // odd size has none, and its DC slot is empty), then the log floor
        const float wn = nb < half ? __ldg(w + (long long)nb * C + cc) : 0.f;
        const float4 q = reinterpret_cast<const float4*>(nyq)[lane];
        a = make_float4(fmaf(q.x, wn, a.x), fmaf(q.y, wn, a.y), fmaf(q.z, wn, a.z),
                        fmaf(q.w, wn, a.w));
        if (use_log)
          a = make_float4(floor_log(a.x, log_floor), floor_log(a.y, log_floor),
                          floor_log(a.z, log_floor), floor_log(a.w, log_floor));
      }
      *fs = a;
    }
  }

  // the block's features, frame by frame, by coalesced stores: the energy
  // column (group 0 only), then the group's filters from fsum
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
      v = fsum[c * kFS + t];
    } else {
      v = en[t] / (float)K;
      if (!use_power) v = sqrtf(v);
      if (use_log) v = floor_log(v, log_floor);
    }
    ob[(long long)t * nc + col] = v;
  }
}

// the most shared-memory wavefronts a warp's fragment load takes with frames
// `rs` floats apart and skew shift `sh`, over the first k-steps
int skew_cost(int rs, int sh) {
  int worst = 0;
  for (int k0 = 0; k0 < 256; k0 += kStepK)
    for (int kh = 0; kh < 8; kh += 4) {
      int count[32] = {};
      for (int g = 0; g < 8; ++g)
        for (int t = 0; t < 4; ++t) {
          const long long i = (long long)g * rs + k0 + kh + t;
          ++count[(i + ((i >> sh) << 2)) & 31];
        }
      for (int c : count) worst = worst > c ? worst : c;
    }
  return worst;
}

// the skew shift with the fewest conflicts (31: none), searched anew for
// each launch (some 25,000 integer operations).  At stride 160 (a 10 ms
// shift) it takes the fragment loads from 8-way bank conflicts to none;
// tools/torch_float_variants.py times the kernel against no skew
int pick_skew(int rs) {
  int best = 31, cost = skew_cost(rs, 31);
  for (int sh = 5; sh <= 9; ++sh) {
    const int c = skew_cost(rs, sh);
    if (c < cost) {
      cost = c;
      best = sh;
    }
  }
  return best;
}

// floats of a buffer holding logical samples [0, n) with skew shift sh
int buf_floats(long long n, int sh) {
  return (int)(n + ((n >> sh) << 2) + 8);
}

// the plan of one filter group of Cg filters: the span of samples with the
// deepest ring that fits; else slabs of K with a ring of three stages (two
// where three leave no slab).  False where nothing fits.
bool group_plan(size_t optin, int frame_stride, int steps, int Cg, FloatPlan* plan,
                size_t* smem) {
  *smem = 0;
  const int span_sh = pick_skew(frame_stride);
  const long long span_n = (long long)(kM - 1) * frame_stride + (long long)steps * kStepK;
  for (int stages = kMaxStages; stages >= 2 && !*smem; --stages) {
    const size_t need = float_fixed_bytes(stages, Cg) + sizeof(float) * (size_t)buf_floats(span_n, span_sh);
    if (span_n < (1LL << 30) && need <= optin) {
      *plan = {stages, 1, steps, frame_stride, span_sh};
      *smem = need;
    }
  }
  for (int stages = 3; stages >= 2 && !*smem; --stages) {
    const size_t fixed = float_fixed_bytes(stages, Cg);
    if (fixed >= optin) continue;
    const size_t room = (optin - fixed) / sizeof(float);
    // slabs of whole stages; the skew adds at most an eighth
    for (int slab = (int)(room * 8 / 9 / ((size_t)kM * kStepK)) / kStageSteps * kStageSteps;
         slab >= kStageSteps; slab -= kStageSteps) {
      const int s = slab < steps ? slab : steps;
      const int rs = s * kStepK;
      const int sh = pick_skew(rs);
      const int n = buf_floats((long long)kM * rs, sh);
      if ((size_t)n <= room) {
        *plan = {stages, 0, s, rs, sh};
        *smem = fixed + sizeof(float) * (size_t)n;
        break;
      }
    }
  }
  return *smem != 0;
}

// the fewest filter groups whose plan fits: `groups` of `cg` filters (the
// last may hold fewer).  -1 where not even one filter fits.
int float_plan(size_t optin, int frame_stride, int steps, int C, FloatPlan* plan,
               size_t* smem, int* groups, int* cg) {
  for (int ng = 1; ng <= C; ++ng) {
    const int g = (C + ng - 1) / ng;
    if ((C + g - 1) / g != ng) continue;  // the same groups as a smaller count
    if (group_plan(optin, frame_stride, steps, g, plan, smem)) {
      *groups = ng;
      *cg = g;
      return 0;
    }
  }
  return -1;
}

template <int kPasses, bool kFold>
cudaError_t launch_float(dim3 grid, size_t smem, cudaStream_t stream, const float* x,
                         long long row_stride, long long n_valid, int frame_stride,
                         int num_frames, int K, int half, int nb, int C, int Cg,
                         const float* packed, int steps,
                         const float* w, const int* spans, float* out, int use_log,
                         int use_power, int energy, float log_floor, const FloatPlan& plan) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(float_feats_kernel<kPasses, kFold>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  float_feats_kernel<kPasses, kFold><<<grid, kThreads, smem, stream>>>(
      x, row_stride, n_valid, frame_stride, num_frames, K, half, nb, C, Cg, packed, steps, w, spans,
      out, use_log, use_power, energy, log_floor, plan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Features of `batch` rows of fp32 samples.  Frame f of row b is samples
// [f*frame_stride, f*frame_stride + K) of x + b*row_stride; samples at or
// past n_valid read as zero.  packed holds the DFT operand as fp32 (chunks,
// steps, 2, 16, 2, 8, 4), 16-byte aligned: [chunk c][k-step u][hi, lo][column
// group][k half][column in group][k in half], chunk c's column 2i the real
// and 2i + 1 the mixed column of bin 64c + i (bins past nb zero), k-step u
// rows [8u, 8u + 8), zero past K; steps is even.  w is (half, C) fp32.  nb
// is half - 1 where the mixed column of bin 0 holds the Nyquist cosine (even
// DFT sizes; w's last row is the Nyquist row) and half where it is zero (odd
// sizes).  spans (C x 2 int32) bound each filter's nonzero
// weight rows as [first, last + 1).  passes is 3 (split operands) or 1
// (TF32).  out is (batch, num_frames, C + energy) fp32.  The bank is split
// into the fewest filter groups whose sums fit in shared memory
// (stk_float_plan), one grid slice each.  Returns a cudaError_t; -1 when not
// even one filter fits beside a slab of one stage, -2 for bad arguments.
int stk_float_feats(const float* x, long long batch, long long row_stride,
                    long long n_valid, int frame_stride, int num_frames, int K,
                    int half, int nb, int C, const float* packed, int steps, const float* w,
                    const int* spans, float* out, int use_log, int use_power,
                    int energy, float log_floor, int passes, void* stream) {
  if ((passes != 1 && passes != 3) || K < 1 || nb < 1 || C < 1 || frame_stride < 1 ||
      (nb != half && nb != half - 1) ||
      steps < (K + kStepK - 1) / kStepK || steps % kStageSteps ||
      reinterpret_cast<size_t>(packed) % 16)
    return -2;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  FloatPlan plan;
  size_t smem;
  int groups, cg;
  if (float_plan((size_t)optin, frame_stride, steps, C, &plan, &smem, &groups, &cg))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((num_frames + kM - 1) / kM, (unsigned)batch, groups);
#define STK_FLOAT(P, F)                                                                        \
  launch_float<P, F>(grid, smem, st, x, row_stride, n_valid, frame_stride, num_frames, K, half, \
                     nb, C, cg, packed, steps, w, spans, out, use_log, use_power, energy,       \
                     log_floor, plan)
  // the split passes fold their tensor-core sums (kFold); one TF32 pass
  // keeps its sum, whose error is TF32's
  cudaError_t rc = passes == 1 ? STK_FLOAT(1, false) : STK_FLOAT(3, true);
#undef STK_FLOAT
  return (int)rc;
}

// The launch stk_float_feats would make for a frame stride, K (steps as the
// packing gives them: ceil(K / 8) rounded up to even) and C on the current
// device: plan[0..3] = filter groups, filters a group, ring stages, staged
// span of samples (1) or slabs (0).  Returns 0, -1 where
// nothing fits, or a cudaError_t.
int stk_float_plan(int frame_stride, int K, int C, int* plan) {
  if (K < 1 || C < 1 || frame_stride < 1) return -2;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int steps = ((K + kStepK - 1) / kStepK + kStageSteps - 1) / kStageSteps * kStageSteps;
  FloatPlan p;
  size_t smem;
  int groups, cg;
  if (float_plan((size_t)optin, frame_stride, steps, C, &p, &smem, &groups, &cg)) return -1;
  plan[0] = groups;
  plan[1] = cg;
  plan[2] = p.stages;
  plan[3] = p.span;
  return 0;
}

const char* stk_error_string(int code) {
  if (code == -1) return "not even one filter fits in shared memory";
  if (code == -2) return "bad arguments or packed layout";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
