// Fused int8 digit-tier STFT -> filter-bank feature kernel for Hopper
// (sm_90a) on the int8 tensor cores, with a plain C launcher
// (stk_int8_feats) that the Python wrapper stft_feats_int8 in
// speech_tpu_torch/ops/stft_kernels.py loads through ctypes.
//
// Replaces speech_tpu/ops/pallas_stft.py stft_feats_pallas_int8
// (_int8_rows_kernel): per frame a power-of-two scale from the exponent bits
// ((bits >> 23) + 2) << 23 of max(max|x|, 1e-30), five base-128 digit planes
// (round half to even, |digit| <= 64), one exact int32 sum per equal-weight
// digit-pair group against the grouped M digit matrices, the low 12 bits
// split off so both halves convert to fp32 exactly, the weighted fp32 adds in
// ascending-weight group order, then the tail: rescale, the power spectrum
// with the Nyquist bin packed in the sin DC slot, the hi/lo-split filter
// weights plus the rank-1 Nyquist term, log floor and energy.
//
// Exactness: the group sums are int8 x int8 -> int32 tensor-core products
// (wgmma .s32.s8.s8, or mma.sync m16n8k32 .s32.s8.s8.s32; no .satfinite),
// exact in any order: no sum reaches 5 * K * 64 * 64, below 2^31 for any K
// under 104,857 (6.5 s frames at 16 kHz).  Every step the
// reference rounds is an explicitly rounded fp32 op (__fmul_rn, __fadd_rn,
// __fsub_rn), so each frame's accumulator has the plain version's fp32 bits;
// the filter sums add bins in ascending order and skip only exact zeros.
//
// Bound on an H100: the group products, 2 * frames * K * 2nb * pairs int8
// operations against the 1,979 TOP/s dense int8 rate (about 0.75 ms for
// 'double' at 128 x 15 s), plus the fp32 filter tail.  Every block reads the
// whole grouped matrices (3.9 MB for 'double') from L2, so a block takes as
// many frames as its shared memory holds: M = 64 frames of one signal row
// (32 or 16 where long frames do not fit).  The block
//   1. stages its samples in shared memory by coalesced loads and digitises
//      its frames once: five planes of M x K bytes in the K-major core-matrix
//      layout of the tensor cores (8 rows x 16 bytes contiguous), rounding
//      by adding 1.5 * 2^23 (full-rate adds, not rintf);
//   2. walks the bins in chunks of 64: chunk c's 128 columns are the real
//      and mixed columns of bins [64c, 64c + 64), interleaved, so that one
//      thread's accumulator pair is one bin's (real, mixed) and the chunk
//      ends in finished power spectra;
//   3. has one producer warp stream the chunks' grouped matrices, packed in
//      k-steps of 32 rows in the same core-matrix layout, into a ring of 2-4
//      stages of 4 k-steps by bulk (TMA) copies, signalled by full / empty
//      mbarriers, so no block-wide barrier runs in the main loop;
//   4. runs each k-step on the tensor cores: at M = 64 two warpgroups each
//      issue wgmma m64n64k32 (64 frames x 64 columns) on operands read from
//      shared memory by descriptor, starting each group's sum afresh, and
//      keep one stage of products in flight while the next is issued; at M
//      = 32 and 16 eight warps run mma.sync on ldmatrix fragments;
//   5. folds each group's int32 tile into the fp32 tile (12-bit split,
//      weight, __fadd_rn) when the group's last k-step is done;
//   6. ends each chunk with its spectrum in shared memory, and each thread
//      adds the chunk's w_hi / w_lo products into its own (4 frames, 1
//      filter) sums, over the filter's span of nonzero weights only; the last
//      chunk adds the Nyquist term, log floor and energy.  No atomics: the
//      result is deterministic.
// The fp32 filter sums (two of M frames a filter) grow with the bank, so a
// bank whose sums leave no room for one k-step of planes is split into the
// fewest filter groups that fit (int8_plan), one grid slice (axis z) each.
// A group walks only the chunks its filters' spans touch, led by chunk 0
// (which carries the Nyquist value) where one of its filters weights it;
// only group 0 writes the energy column.  Every filter still sums its bins
// in ascending order over the same chunks, and the integer group sums and
// their fp32 adds do not depend on the group, so each column has the bits
// of a one-group launch.  The main path's 40 filters are one group.
// Frames too long for 16 frames of full planes (K above about 2300 at 40
// filters) take M = 64 with the planes cut along K into slabs of whole
// k-steps (a separate instantiation, so the other loops stay as they are): each group walks the slabs in turn, its int32 sum running on
// across them, and a slab is digitised again (from device memory) whenever
// the walk reaches it, so shared memory no longer grows with K.
//
// The launcher returns cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 256;              // 8 warps (2 warpgroups) of products
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kBins = 64;                    // bins per chunk
constexpr int kCols = 2 * kBins;             // chunk columns: (real, mixed) per bin
constexpr int kStepK = 32;                   // k bytes of one product
constexpr int kCore = 128;                   // core matrix: 8 rows x 16 bytes
constexpr int kStepBytes = kCols * kStepK;   // one k-step of a chunk: 4096
constexpr int kStageSteps = 4;               // k-steps a ring stage
constexpr int kStageBytes = kStageSteps * kStepBytes;
constexpr int kStepAlign = kStageSteps;      // the packing pads k-steps to a multiple
constexpr int kPlanes = 5;                   // x digit planes
constexpr int kMaxGroups = 9;                // s = i + j in 0..8
constexpr int kGroupMembers = 5;             // x planes per group at most
constexpr int kMaxMembers = 25;              // over all groups
constexpr int kFT = 4;                       // frames per filter-sum task
constexpr float kRound = 12582912.f;         // 1.5 * 2^23

struct I8Groups {
  int n;                    // groups, ascending weight
  int nk;                   // k-steps per member: ceil(K / 32)
  int members;              // members over all groups
  int steps;                // k-steps per chunk, a multiple of kStepAlign
  int plane[kMaxMembers];   // x plane of each member, in group order
  int end[kMaxGroups];      // one past the group's last k-step (the last: steps)
  int mend[kMaxGroups];     // one past the group's last member
  float w[kMaxGroups];      // 128^-(s+2), exact
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

// barrier among the consumer warps only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d += a (16 x 32 s8, row) * b (32 x 8 s8, col), exact int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared-memory matrix descriptor, K-major without swizzle: the low word
// holds the start address in 16-byte units and the 128 bytes between the two
// core matrices along k; the high word the bytes between 8-row groups, in
// 16-byte units.  Adding n to the low word moves the start by 16 n bytes.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | ((kCore >> 4) << 16);
}

__device__ __forceinline__ uint64_t desc(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
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

// d (64 x 64 s32, the warpgroup's fragment layout) = a * b (+ d when
// `accumulate`), a (64 x 32 s8) and b (32 x 64 s8) K-major in shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

constexpr int kMaxStages = 4;  // ring stages: full and empty barriers in 64 bytes

// shared memory of a block: M frames, a ring of `stages`, planes `slab`
// k-steps long
size_t int8_smem_bytes(int M, int stages, int slab, int C) {
  return 2 * kMaxStages * sizeof(uint64_t) + (size_t)kPlanes * M * slab * kStepK +
         (size_t)stages * kStageBytes +
         sizeof(float) * ((size_t)kBins * (M + 8) + 2 * (size_t)M * C + 3 * (size_t)M +
                          kMaxMembers + 3 * kMaxGroups + 4);
}

// the launch's shape: `groups` filter groups of `cg` filters (the last may
// hold fewer), M-frame tiles, a ring of `stages`, planes `slab` k-steps long
// (all of them where `whole`), samples staged in the ring where `staged`
struct I8Plan {
  int groups, cg, M, stages, slab, whole, staged;
};

// the fewest filter groups that fit; for each count of groups, the first
// tile and ring that hold whole planes, else the first that hold a slab of
// them.  -1 where not even one filter fits beside one k-step of planes.
int int8_plan(size_t optin, int frame_shift, int K, int C, I8Plan* plan) {
  const int nk = (K + kStepK - 1) / kStepK;
  const int tiles[] = {64, 32, 16};
  for (int ng = 1; ng <= C; ++ng) {
    const int cg = (C + ng - 1) / ng;
    if ((C + cg - 1) / cg != ng) continue;  // the same groups as a smaller count
    for (int whole = 1; whole >= 0; --whole)
      for (int M : tiles)
        for (int stages = kMaxStages; stages >= 2; --stages) {
          const size_t fixed = int8_smem_bytes(M, stages, 0, cg);
          if (fixed > optin) continue;
          const size_t fit = (optin - fixed) / ((size_t)kPlanes * M * kStepK);
          const int slab = fit < (size_t)nk ? (int)fit : nk;
          if (slab < (whole ? nk : 1)) continue;
          const long long nsamp = (long long)(M - 1) * frame_shift + K;
          const int staged = whole && nsamp * (long long)sizeof(float) <=
                                          (long long)stages * kStageBytes;
          *plan = {ng, cg, M, stages, slab, whole, staged};
          return 0;
        }
  }
  return -1;
}

// Warp 8 is the producer: it streams the walked chunks' k-steps into the
// ring by bulk copies.  Warps 0-7 consume them.  Grid axis z picks the
// filter group: filters [z Cg, z Cg + Cg) of the C in the bank.  M = 64:
// two warpgroups, each 64 frames x 64 columns by wgmma.  M = 32, 16: eight warps, each M frames x 16
// columns by mma.sync.  The planes hold `slab` k-steps of K: all of K, or
// with kSlabs (very long frames) fewer, digitised again as the walk needs.
template <int M, bool kSlabs>
__global__ void __launch_bounds__(kThreads, 1) int8_feats_kernel(
    const float* __restrict__ x, long long row_stride, long long n_valid,
    int frame_shift, int num_frames, int K, int nb, int C, int Cg,
    const int8_t* __restrict__ packed, const __grid_constant__ I8Groups groups,
    int stages, int slab, float cos_scale, const float* __restrict__ mscale,
    const float* __restrict__ mask, const float* __restrict__ w_hi,
    const float* __restrict__ w_lo, const float* __restrict__ w_nyq,
    const int* __restrict__ spans, float* __restrict__ out, int use_log,
    int use_power, int energy, float log_floor) {
  constexpr bool kWgmma = M == 64;
  constexpr int kMT = kWgmma ? 1 : M / 16;  // 16-row tiles per warp
  constexpr int kNT = kWgmma ? 8 : 2;       // 8-column tiles per warp
  constexpr int kSS = M + 8;                // spectrum row stride: conflict-free stores
  static_assert(M % 16 == 0 && M <= 64 && M % kFT == 0, "frame tile");

  extern __shared__ __align__(128) unsigned char smem[];
  const int nk = groups.nk;
  const int kp = slab * kStepK;  // plane bytes a frame
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [stages]: a stage landed
  uint64_t* empty = full + kMaxStages;                 // [stages]: a slot is free
  // [kPlanes][M / 8][kp / 16][8][16]: plane p, frame t, sample k (from the
  // slab's first) at p*M*kp + (t/8)*8kp + (k/16)*128 + (t%8)*16 + k%16
  int8_t* planes = reinterpret_cast<int8_t*>(smem + 2 * kMaxStages * sizeof(uint64_t));
  // [stages][kStageSteps][16][2][8][16]: the packed layout, copied as it is
  unsigned char* ring = reinterpret_cast<unsigned char*>(planes) + (size_t)kPlanes * M * kp;
  float* spec = reinterpret_cast<float*>(ring + (size_t)stages * kStageBytes);  // [kBins][kSS]
  float* fsum = spec + kBins * kSS;  // [2][M][Cg]: the group's w_hi and w_lo sums
  float* scl = fsum + 2 * M * Cg;    // [M]
  float* en = scl + M;               // [M]
  float* nyq = en + M;               // [M]
  // the group table, read once from the parameters: a dynamically indexed
  // kernel parameter is a slow load, and the k-step loop must not wait on one
  int* a_offs = reinterpret_cast<int*>(nyq + M);  // [kMaxMembers] plane offsets
  int* ends = a_offs + kMaxMembers;                // [kMaxGroups]
  int* mends = ends + kMaxGroups;                  // [kMaxGroups]
  float* wts = reinterpret_cast<float*>(mends + kMaxGroups);  // [kMaxGroups]
  // the chunk walk: [0] 1 where chunk 0 leads, [1] the first chunk of the
  // group's spans, [2] the chunks walked
  int* walk = reinterpret_cast<int*>(wts + kMaxGroups);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * M;
  const float* xrow = x + (long long)b * row_stride;
  const int c0 = blockIdx.z * Cg;  // the group's filters: [c0, c0 + cg)
  const int cg = min(Cg, C - c0);
  if (tid < kMaxMembers) a_offs[tid] = groups.plane[tid] * M * kp;
  if (tid < kMaxGroups) {
    ends[tid] = groups.end[tid];
    mends[tid] = groups.mend[tid];
    wts[tid] = groups.w[tid];
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
      // clamped to nb: a span that ended past the last row would walk a
      // chunk past the packed matrices
      int clo = lo / kBins, chi = (min(hi, nb) + kBins - 1) / kBins;
      if (chi <= clo) clo = 0, chi = 1;
      const int lead = nq && clo > 0;
      walk[0] = lead;
      walk[1] = clo;
      walk[2] = chi - clo + lead;
    }
  }
  // The block's samples, [f0 * shift, f0 * shift + nsamp), staged in the
  // ring (which the producer fills only after the digits exist) by coalesced
  // loads where they fit and the planes are digitised once; else each read
  // goes to device memory.
  const int nsamp = (M - 1) * frame_shift + K;
  const bool staged =
      !kSlabs && (long long)nsamp * sizeof(float) <= (long long)stages * kStageBytes;
  float* xs = reinterpret_cast<float*>(ring);
  const long long start = (long long)f0 * frame_shift;
  if (staged) {
    for (int i = tid; i < nsamp; i += kThreads)
      xs[i] = start + i < n_valid ? __ldg(xrow + start + i) : 0.f;
  }
  __syncthreads();
  auto sample = [&](int t, int k) -> float {
    const int i = t * frame_shift + k;
    if (staged) return xs[i];
    return start + i < n_valid ? __ldg(xrow + start + i) : 0.f;
  };

  // per-frame peak, power-of-two scale and energy: one warp per frame
  for (int t = warp; t < M; t += kThreads / 32) {
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
  __syncthreads();
  const int nwalk = walk[2];
  auto chunk_of = [walk](int w) { return walk[0] && w == 0 ? 0 : walk[1] + w - walk[0]; };

  // five base-128 digit planes of the slab from k-step kb, by `nthreads`
  // threads, four samples to a thread (a warp fills one core matrix: 8
  // frames x 16 samples); every step is exact in fp32; zero past K
  auto digitise = [&](int kb, int nthreads) {
    for (int idx = tid; idx < M * kp / 4; idx += nthreads) {
      const int e = idx & 31;
      const int blk = idx >> 5;        // (row group, 16-sample chunk)
      const int kc = blk / (M / 8);
      const int t = (blk - kc * (M / 8)) * 8 + (e >> 2);
      const int k0 = kb * kStepK + kc * 16 + (e & 3) * 4;
      const float inv = 1.0f / scl[t];
      uint32_t word[kPlanes] = {};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v = 0.f;
        if (k0 + c < K) v = __fmul_rn(sample(t, k0 + c), inv);
#pragma unroll
        for (int i = 0; i < kPlanes; ++i) {
          // vb + 1.5 * 2^23 rounds vb (|vb| <= 64) to an integer, half to
          // even as jnp.round, and the low byte of its bits is that integer
          // as an int8: full-rate adds in place of the quarter-rate rintf
          // and float2int
          const float vb = __fmul_rn(v, 128.f);
          const float r = __fadd_rn(vb, kRound);
          v = __fsub_rn(vb, __fsub_rn(r, kRound));
          word[i] |= (__float_as_uint(r) & 0xFFu) << (8 * c);
        }
      }
      const int off = (t >> 3) * 8 * kp + kc * kCore + e * 4;
#pragma unroll
      for (int i = 0; i < kPlanes; ++i)
        *reinterpret_cast<uint32_t*>(planes + (size_t)i * M * kp + off) = word[i];
    }
    // the planes, written by threads, are read by the tensor cores' proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  digitise(0, kThreads);
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: each walked chunk's k-steps in the order the consumers take
    // them (group by group, each group's slabs in turn, each slab member by
    // member), then the padding k-steps; stage q goes into slot q mod stages
    // once the slot's previous stage has been consumed
    if (lane == 0) {
      int slot = 0, use = 0, u = 0;
      auto copy = [&](const int8_t* src, int n) {
        if (u == 0) {
          if (use > 0) mbar_wait(empty + slot, (use - 1) & 1);
          mbar_expect(full + slot, kStageBytes);
        }
        bulk_copy(ring + slot * kStageBytes + u * kStepBytes, src, n * kStepBytes, full + slot);
        u += n;
        if (u == kStageSteps) {
          u = 0;
          if (++slot == stages) {
            slot = 0;
            ++use;
          }
        }
      };
      for (int w = 0; w < nwalk; ++w) {
        const int8_t* pc = packed + (long long)chunk_of(w) * groups.steps * kStepBytes;
        if constexpr (!kSlabs) {
          // whole planes: the k-steps lie in order, a stage at a time
          for (int q = 0; q < groups.steps; q += kStageSteps)
            copy(pc + (long long)q * kStepBytes, kStageSteps);
        } else {
          for (int g = 0, m0 = 0; g < groups.n; m0 = mends[g++])
            for (int kb = 0; kb < nk; kb += slab)
              for (int m = m0; m < mends[g]; ++m)
                for (int kk = kb; kk < min(nk, kb + slab); ++kk)
                  copy(pc + ((long long)m * nk + kk) * kStepBytes, 1);
          for (int q = groups.members * nk; q < groups.steps; ++q)
            copy(pc + (long long)q * kStepBytes, 1);
        }
      }
    }
    return;
  }

  // this thread's accumulators: rows rb + 16 mt + g8 (+8), columns cb + 8 nt
  // + 2 tig (+1), as mma.sync and wgmma lay out their fragments
  const int g8 = lane >> 2;
  const int tig = lane & 3;
  const int rb = kWgmma ? 16 * (warp & 3) : 0;
  const int cb = kWgmma ? 64 * (warp >> 2) : 16 * warp;
  // Operand addresses advance by constants: a k-step's A rows start at
  // planes + a_offs[member] + 256 (kk - kb), its B columns at ring + slot *
  // kStageBytes + 4096 u.  wgmma takes both as the low word of a descriptor,
  // in 16-byte units (kShift 4); mma.sync as this lane's ldmatrix address:
  // lanes 8i..8i+7 give the rows of matrix i, A (rows +0/+8, k +0/+16) =
  // a0..a3 and B (k +0/+16, columns +0/+8) = b0, b1 of two 8-column tiles
  constexpr int kShift = kWgmma ? 4 : 0;
  const uint32_t a_base =
      kWgmma ? desc_lo(smem_addr(planes))
             : smem_addr(planes) + ((lane >> 3) & 1) * 8 * kp + (lane >> 4) * kCore +
                   (lane & 7) * 16;
  const uint32_t b_base =
      kWgmma ? desc_lo(smem_addr(ring) + (cb / 8) * 2 * kCore)
             : smem_addr(ring) + (cb / 8 + (lane >> 4)) * 2 * kCore +
                   ((lane >> 3) & 1) * kCore + (lane & 7) * 16;
  const uint32_t a_hi = (8 * kp) >> 4;  // A: 8-row groups 8 kp bytes apart
  const uint32_t b_hi = (2 * kCore) >> 4;  // B: 8-column groups 256 bytes apart
  constexpr uint32_t kStepA = (2 * kCore) >> kShift;  // A: one k-step on
  if (tid < kMaxMembers) a_offs[tid] >>= kShift;

  float acc[kMT][kNT][4];
  int sum[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0.f;
        sum[mt][nt][e] = 0;
      }
  consumer_sync();  // a_offs in its units

  // the slab in the planes is [loaded, loaded + slab); load(kb) digitises
  // the one from kb once every product on the planes is done
  int loaded = 0;
  auto load = [&](int kb) {
    if (!kSlabs || kb == loaded) return;
    if constexpr (kWgmma) {
      wgmma_commit();
      wgmma_wait<0>();
    }
    consumer_sync();
    digitise(kb, kConsumers);
    consumer_sync();
    if constexpr (kWgmma) wgmma_fence();
    loaded = kb;
  };

  const int per_chunk = groups.steps / kStageSteps;
  int slot = 0, use = 0, prev = -1;  // ring slot and its use of this stage; the last one's
  for (int w = 0; w < nwalk; ++w) {
    const int chunk = chunk_of(w);
    // k-step position: `member` and `kk` pick the A rows (a_cur) in the
    // slab [kb, kend); `next_end` is the k-step that ends group `group`;
    // `fresh`: its sum starts anew
    int step = 0, group = 0, member = 0, kk = 0, kb = 0, kend = slab, fresh = 1;
    int next_end = ends[0];
    uint32_t a_cur = a_offs[0];
    load(0);
    for (int s = 0; s < per_chunk; ++s) {
      mbar_wait(full + slot, use & 1);
      const uint32_t b_slot = b_base + slot * (kStageBytes >> kShift);
      if constexpr (kWgmma) wgmma_fence();
#pragma unroll
      for (int u = 0; u < kStageSteps; ++u) {
        const uint32_t a_addr = a_base + a_cur;
        const uint32_t b_addr = b_slot + u * (kStepBytes >> kShift);
        if constexpr (kWgmma) {
          wgmma_s8(sum[0], desc(a_addr, a_hi), desc(b_addr, b_hi), !fresh);
        } else {
          uint32_t a[kMT][4];
          uint32_t bf[kNT][2];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            ldmatrix_x4(a_addr + mt * 16 * kp, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np)
            ldmatrix_x4(b_addr + np * 4 * kCore, bf[2 * np][0], bf[2 * np][1],
                        bf[2 * np + 1][0], bf[2 * np + 1][1]);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
              mma_s8(sum[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
        }
        fresh = 0;
        if (++kk < kend) {
          a_cur += kStepA;
        } else if (member + 1 < mends[group]) {
          ++member;
          kk = kb;
          a_cur = a_offs[member];
        } else if (kSlabs && kend < nk) {
          // the group's next slab, from its first member
          kb = kend;
          kend = min(nk, kb + slab);
          kk = kb;
          member = group ? mends[group - 1] : 0;
          a_cur = a_offs[member];
          load(kb);
        } else {
          kk = kend - 1;  // the padding k-steps (zero columns) reuse these rows
        }
        if (++step == next_end) {
          // one group done: the 12-bit split and the weighted fp32 add
          if constexpr (kWgmma) {
            wgmma_commit();
            wgmma_wait<0>();
          }
          const float wg = wts[group];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int lo = sum[mt][nt][e] & 4095;
                const int hi = sum[mt][nt][e] - lo;
                const float term = __fadd_rn(__fmul_rn(__int2float_rn(hi), wg),
                                             __fmul_rn(__int2float_rn(lo), wg));
                acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], term);
                if constexpr (!kWgmma) sum[mt][nt][e] = 0;
              }
          if constexpr (kWgmma) wgmma_fence();
          fresh = 1;
          if (++group < groups.n) {
            next_end = ends[group];
            member = mends[group - 1];
            kb = kk = 0;
            kend = slab;
            a_cur = a_offs[member];
            load(0);
          } else {
            next_end = -1;
          }
        }
      }
      // the previous stage's products are done (this one's may still run):
      // its slot is free
      if constexpr (kWgmma) {
        wgmma_commit();
        wgmma_wait<1>();
      }
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = slot;
      if (++slot == stages) {
        slot = 0;
        ++use;
      }
    }
    // The last group's fold waited for every product already; saying so
    // here keeps ptxas from waiting at the end of every stage instead.
    if constexpr (kWgmma) wgmma_wait<0>();

    // chunk done: its spectrum, once every consumer is done with the
    // previous chunk's
    consumer_sync();
    // the DC slot of the mixed column carries the Nyquist value
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = rb + mt * 16 + g8 + h * 8;
          const int jl = cb / 2 + nt * 4 + tig;
          const int j = chunk * kBins + jl;
          if (j < nb) {
            const float re = __fmul_rn(acc[mt][nt][2 * h], __fmul_rn(scl[t], cos_scale));
            const float mixed =
                __fmul_rn(acc[mt][nt][2 * h + 1], __fmul_rn(scl[t], __ldg(mscale + j)));
            const float im = __fmul_rn(mixed, __ldg(mask + j));
            const float p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
            if (j == 0) {
              const float nq = __fsub_rn(mixed, im);
              nyq[t] = use_power ? __fmul_rn(nq, nq) : fabsf(nq);
            }
            spec[jl * kSS + t] = use_power ? p : sqrtf(p);
          }
          acc[mt][nt][2 * h] = 0.f;
          acc[mt][nt][2 * h + 1] = 0.f;
        }
    consumer_sync();

    // the chunk's share of the filter sums, bins ascending over the filter's
    // nonzero span; each thread owns the same (4 frames, filter) tasks in
    // every chunk
    const int j0 = chunk * kBins;
    const bool last = w + 1 == nwalk;
    const int nc = C + energy;
    for (int task = tid; task < (M / kFT) * cg; task += kConsumers) {
      const int tg = task / cg;
      const int c = task - tg * cg;
      const int cc = c0 + c;  // the filter's column in the bank
      float* fh = fsum + tg * kFT * Cg + c;
      float* fl = fh + M * Cg;
      float hi[kFT], lo[kFT];
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        hi[f] = w ? fh[f * Cg] : 0.f;
        lo[f] = w ? fl[f * Cg] : 0.f;
      }
      const int ja = max(j0, __ldg(spans + 2 * cc));
      const int jb = min(min(j0 + kBins, nb), __ldg(spans + 2 * cc + 1));
      const float* sp = spec + tg * kFT;
      for (int j = ja; j < jb; ++j) {
        const float vh = __ldg(w_hi + (long long)j * C + cc);
        const float vl = __ldg(w_lo + (long long)j * C + cc);
        const float4 v = *reinterpret_cast<const float4*>(sp + (j - j0) * kSS);
        hi[0] = fmaf(v.x, vh, hi[0]);
        lo[0] = fmaf(v.x, vl, lo[0]);
        hi[1] = fmaf(v.y, vh, hi[1]);
        lo[1] = fmaf(v.y, vl, lo[1]);
        hi[2] = fmaf(v.z, vh, hi[2]);
        lo[2] = fmaf(v.z, vl, lo[2]);
        hi[3] = fmaf(v.w, vh, hi[3]);
        lo[3] = fmaf(v.w, vl, lo[3]);
      }
      if (!last) {
#pragma unroll
        for (int f = 0; f < kFT; ++f) {
          fh[f * Cg] = hi[f];
          fl[f * Cg] = lo[f];
        }
        continue;
      }
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        const int t = tg * kFT + f;
        if (f0 + t >= num_frames) continue;
        float a = __fadd_rn(__fadd_rn(hi[f], lo[f]), __fmul_rn(nyq[t], __ldg(w_nyq + cc)));
        if (use_log) a = floor_log(a, log_floor);
        out[((long long)b * num_frames + f0 + t) * nc + energy + cc] = a;
      }
    }
    if (last && energy && blockIdx.z == 0) {
      for (int t = tid; t < M; t += kConsumers) {
        if (f0 + t >= num_frames) continue;
        float e = en[t] / (float)K;
        if (!use_power) e = sqrtf(e);
        if (use_log) e = floor_log(e, log_floor);
        out[((long long)b * num_frames + f0 + t) * nc] = e;
      }
    }
  }
}

template <int M, bool kSlabs>
cudaError_t launch_int8(dim3 grid, size_t smem, cudaStream_t stream, const float* x,
                        long long row_stride, long long n_valid, int frame_shift,
                        int num_frames, int K, int nb, int C, int Cg, const int8_t* packed,
                        const I8Groups& groups, int stages, int slab,
                        float cos_scale, const float* mscale, const float* mask,
                        const float* w_hi, const float* w_lo, const float* w_nyq,
                        const int* spans, float* out, int use_log, int use_power,
                        int energy, float log_floor) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(int8_feats_kernel<M, kSlabs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  int8_feats_kernel<M, kSlabs><<<grid, kThreads, smem, stream>>>(
      x, row_stride, n_valid, frame_shift, num_frames, K, nb, C, Cg, packed, groups,
      stages, slab, cos_scale, mscale, mask, w_hi, w_lo, w_nyq, spans, out,
      use_log, use_power, energy, log_floor);
  return cudaGetLastError();
}

// the shared memory a block of the current device may opt in to
cudaError_t optin_bytes(int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

extern "C" {

// The int8 digit tiers on padded rows: frame f of row b is samples
// [f*frame_shift, f*frame_shift + K) of x + b*row_stride; samples at or past
// n_valid read as zero.  packed holds the grouped digit matrices as int8
// (chunks, steps, 16, 2, 8, 16), 16-byte aligned: [chunk c][k-step u][column
// group][k half][column in group][k in half], chunk c's column 2i the real
// and 2i + 1 the mixed column of bin 64c + i; k-step u holds rows [32 kk,
// 32 kk + 32) of member u / ceil(K / 32) (kk = u mod ceil(K / 32)), members
// in group order, zero past K, past nb and in the padding k-steps that make
// `steps` a multiple of 4.  members/xs/s describe the n_groups groups in
// ascending weight order (xs is n_groups x 5).  spans (C x 2 int32) bound
// each filter's nonzero w_hi / w_lo rows as [first, last + 1).  out is
// (batch, num_frames, C + energy) fp32.  Any K: where no frame tile holds
// whole planes, 64-frame tiles hold slabs of them.  Any C: the bank is split
// into the fewest filter groups whose sums fit beside the planes
// (stk_int8_plan), one grid slice each.  Returns a cudaError_t; -1 when not
// even one filter's sums fit beside one k-step of planes, -2 for a bad group
// table or layout.
int stk_int8_feats(const float* x, long long batch, long long row_stride,
                   long long n_valid, int frame_shift, int num_frames, int K,
                   int nb, int C, const int8_t* packed, int steps, int n_groups,
                   const int* members, const int* xs, const int* s_of_group,
                   float cos_scale, const float* mscale, const float* mask,
                   const float* w_hi, const float* w_lo, const float* w_nyq,
                   const int* spans, float* out, int use_log, int use_power,
                   int energy, float log_floor, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups || K < 1 || nb < 1 || C < 1 ||
      reinterpret_cast<size_t>(packed) % 16)
    return -2;
  I8Groups groups = {};
  groups.n = n_groups;
  groups.nk = (K + kStepK - 1) / kStepK;
  int total = 0;
  for (int g = 0; g < n_groups; ++g) {
    if (members[g] < 1 || members[g] > kGroupMembers || total + members[g] > kMaxMembers)
      return -2;
    for (int m = 0; m < members[g]; ++m) {
      const int xi = xs[g * kGroupMembers + m];
      if (xi < 0 || xi >= kPlanes) return -2;
      groups.plane[total++] = xi;
    }
    groups.end[g] = total * groups.nk;
    groups.mend[g] = total;
    groups.w[g] = ldexpf(1.0f, -7 * (s_of_group[g] + 2));
  }
  groups.members = total;
  groups.steps = (total * groups.nk + kStepAlign - 1) / kStepAlign * kStepAlign;
  if (steps != groups.steps) return -2;
  groups.end[n_groups - 1] = groups.steps;

  int optin = 0;
  cudaError_t e = optin_bytes(&optin);
  if (e != cudaSuccess) return (int)e;
  I8Plan plan;
  if (int8_plan((size_t)optin, frame_shift, K, C, &plan)) return -1;
  const size_t smem = int8_smem_bytes(plan.M, plan.stages, plan.slab, plan.cg);
  dim3 grid((num_frames + plan.M - 1) / plan.M, (unsigned)batch, plan.groups);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define STK_INT8(MM, SLABS)                                                           \
  launch_int8<MM, SLABS>(grid, smem, st, x, row_stride, n_valid, frame_shift,         \
                         num_frames, K, nb, C, plan.cg, packed, groups, plan.stages,  \
                         plan.slab, cos_scale, mscale, mask, w_hi, w_lo, w_nyq,       \
                         spans, out, use_log, use_power, energy, log_floor)
  cudaError_t rc;
  if (plan.M == 64) rc = plan.whole ? STK_INT8(64, false) : STK_INT8(64, true);
  else if (plan.M == 32) rc = plan.whole ? STK_INT8(32, false) : STK_INT8(32, true);
  else rc = plan.whole ? STK_INT8(16, false) : STK_INT8(16, true);
#undef STK_INT8
  return (int)rc;
}

// The launch stft_feats_int8 would make for a frame shift, K and C on the
// current device: plan[0..5] = filter groups, filters a group, ring stages,
// samples staged in shared memory (1) or not (0), frames a tile, k-steps of
// planes a slab (all of K's where the planes are whole).  Returns 0, -1
// where nothing fits, or a cudaError_t.
int stk_int8_plan(int frame_shift, int K, int C, int* plan) {
  if (K < 1 || C < 1 || frame_shift < 1) return -2;
  int optin = 0;
  cudaError_t e = optin_bytes(&optin);
  if (e != cudaSuccess) return (int)e;
  I8Plan p;
  if (int8_plan((size_t)optin, frame_shift, K, C, &p)) return -1;
  plan[0] = p.groups;
  plan[1] = p.cg;
  plan[2] = p.stages;
  plan[3] = p.staged;
  plan[4] = p.M;
  plan[5] = p.slab;
  return 0;
}

const char* stk_error_string(int code) {
  if (code == -1) return "not even one filter's sums fit beside one k-step of digit planes";
  if (code == -2) return "bad digit group table or layout";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
