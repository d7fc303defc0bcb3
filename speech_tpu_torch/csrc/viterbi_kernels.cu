// The pitch tracker's Viterbi for Hopper (sm_90a) in one launch, with plain C
// launchers (stk_viterbi, stk_viterbi_plan) that the Python wrapper
// viterbi_path in speech_tpu_torch/ops/stft_kernels.py loads through ctypes.
//
// Replaces no TPU kernel: the JAX package runs the Viterbi as two lax.scan
// passes (speech_tpu/ops/pitch.py), and speech_tpu_torch/ops/pitch.py:_viterbi
// as two Python loops of about nine launches a frame, which stay the path of
// the CPU, of float64 and of more lags than kMaxLags.  This kernel is the whole
// of it: the forward min-plus recursion with int16 back-pointers, then the
// walk back over them.
//
// What it computes, for rows b and lags j < L, with the loop's float32
// operations in the loop's order (an add, a min, a subtraction, each rounded
// once as __fadd_rn / __fsub_rn: there is no product, so nothing contracts):
//   cost = -nc[0][b];  cost -= min(cost)
//   each step t = 1 .. steps - 1:
//     m[j] = min_i (cost[i] + tmat[i][j]),  bp[t][b][j] = the first such i
//     while t < counts[b]:  s = m - nc[t][b];  cost = s - min(s)
//     (past counts[b] the costs stay as they were; bp is written all the same)
//   path[steps - 1][b] = the first argmin of cost;  path[t - 1][b] = bp[t][b][path[t][b]]
//   path[t][b] = path[steps - 1][b] for t >= steps
// A min of floats is exact whatever its order, and every tie goes to the
// first index, so the path is the loop's bit for bit: the loop's backward
// step re-derives bp at the chosen lag from the same sums (tmat is
// symmetric).  Scores must be finite: a NaN would not spread as in the loop.
//
// Bound on an H100: an add and a min for each of L^2 lag pairs a row a step
// (bench_port/roofline_pitch.py's Viterbi term) against 67 TFLOP/s of
// float32, and a step's L float32 scores read and L int16 back-pointers
// written a row, with the table read once, against 3.35 TB/s: 0.66 ms for 64
// rows x 1,965 steps x 418 lags, bound by the operations.
//
// Design.  The L x L table (699 KB at 418 lags) is more than one SM holds, so
// a thread-block cluster of C blocks splits its columns, each block holding
// its slice in shared memory for the whole launch, and a cluster takes R rows
// of the batch.  In a block, a warp's lanes take two neighbouring columns
// each (64 a warp: a column group, one float2 of the table a lane a row) and
// the warps split i into chunks, so that all lanes of a warp read the same
// cost row (a broadcast) and neighbouring table words.  A lane walks its
// chunk four rows i at a time: the minimum of the four sums first, and only
// where that beats the best so far, the best and the block's first row (an
// add, about a min and a compare a pair); the chunks' minima meet in shared
// memory, in chunk order, and the first row of the winning block that
// reaches the minimum is the back-pointer.  Each step a block keeps its
// columns' new costs and its row minima in its own shared memory; after one
// cluster barrier every block reads all of them from the cluster's blocks
// (distributed shared memory, a vector a lag, the reads in flight while one
// warp takes the row minima) as it shifts the whole cost vector by the row
// minimum into its own copy.  The new costs and minima are double-buffered by
// the step's parity, so one barrier a step orders every write against every
// read, and each step's scores are loaded a step ahead.  No (rows, L, L)
// block touches device memory: a step reads its scores and writes its
// back-pointers, nothing more.  stk_viterbi_plan picks C, the blocks a
// cluster (1 to 8), and R, the rows a cluster (1 to 3), that with the
// clusters resident at once give the least time a step by a count of the
// column groups' work and a step's fixed latency: batches of up to 64 rows
// (the extractor's and the CLIs' default) take R 1 to 3; a larger batch runs
// in more waves.  Past about 650 lags no slice fits and the blocks read the
// table from L2 (R then 1).
//
// The walk: block k of a cluster walks its rows k, k + C, ...: the last
// costs' argmin, then the back-pointers, staged from device memory into
// shared memory a chunk of steps at a time, so that each of the walk's
// dependent reads is a shared-memory read.
//
// The launcher returns cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLags = 2048;  // int16 back-pointers, and the buffers below
constexpr int kLaneCols = 2;    // columns a lane: a float2 of the table
constexpr int kGroupCols = 32 * kLaneCols;  // columns a warp
constexpr int kBlock = 4;       // rows i a lane takes at once
constexpr int kMaxWarps = 16;
constexpr int kMaxRowIters = 4;  // (row, column) pairs a thread
constexpr int kMatIters = 4;     // lags a thread shifts: L <= 4 threads
constexpr int kMaxCluster = 8;
constexpr int kMaxRows = 3;     // rows a cluster
constexpr int kSmemLimit = 232448;  // 227 KB a block
constexpr int kWalkMinBytes = 32768;
constexpr int kWalkUnroll = 8;  // back-pointers a thread loads at once in the walk
constexpr float kInf = __builtin_huge_valf();

// a cost row's floats in shared memory: R rounded up to a vector
__host__ __device__ constexpr int padded_rows(int R) {
  return R <= 1 ? 1 : R <= 2 ? 2 : 4;
}

struct Params {
  const float* nc;    // nc[t * st + b * sb + j]
  long long st, sb;
  const float* tmat;  // (L, L), row-major
  const long long* counts;  // (rows,) or null: every row tracked to steps
  short* bp;          // (steps, rows, L); bp[0] is not written
  long long* path;    // (frames, rows)
  int rows, L, frames, steps;
  int W;       // columns a block (the last blocks may have fewer, or none)
  int Ws;      // the table slice's row stride (even)
  int NG;      // column groups a block
  int S;       // chunks of i: warps = NG * S
  int nb;      // blocks of kBlock rows a chunk
  int Wq;      // a row's (row, column) pairs: W rounded up to a warp
  int walk_k;  // steps of back-pointers a walk chunk stages
  int rs;      // the chunk minima's row stride, in pairs: the block's padded columns
  int off_cost, off_xbuf, off_red2, off_wl, off_cmin, off_gs;  // float offsets
};

// n floats from or to shared memory, n a vector's width
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&c)[N]) {
  if constexpr (N == 1) {
    c[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    c[0] = v.x;
    c[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&c)[N]) {
  if constexpr (N == 1) {
    p[0] = c[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(c[0], c[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(c[0], c[1], c[2], c[3]);
  }
}

template <int R, typename T>
__device__ __forceinline__ T pick(const T (&a)[R], int k) {
  T v = a[0];
#pragma unroll
  for (int q = 1; q < R; ++q)
    if (k == q) v = a[q];
  return v;
}

// (v, i) becomes (ov, oi) where that is the smaller value, or the same value
// at a smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// the table's column jj (of this block) at row i: from shared memory, or
// from device memory (0 past the table)
template <bool kSmemTable>
__device__ __forceinline__ float table_at(const Params& p, const float* table, int j0, int i,
                                          int jj) {
  if (kSmemTable) return table[i * p.Ws + jj];
  return i < p.L && j0 + jj < p.L ? __ldg(p.tmat + (size_t)i * p.L + j0 + jj) : 0.0f;
}

// R rows a cluster; the table slice in shared memory (kSmemTable) or read
// from device memory
template <int R, bool kSmemTable>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    viterbi_kernel(const Params p) {
  constexpr int Rp = padded_rows(R);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / C;
  const int L = p.L;
  const int j0 = rank * p.W;
  const int nW = max(0, min(p.W, L - j0));  // this block's columns
  const int threads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NB = (L + kBlock - 1) / kBlock;
  const int Lp = NB * kBlock;  // rows of the padded cost and table
  const int jl = (warp % p.NG) * kGroupCols + lane * kLaneCols;  // the lane's first column
  const int chunk = warp / p.NG;
  const int b_lo = min(NB, chunk * p.nb), b_hi = min(NB, b_lo + p.nb);
  const int row_warps = p.Wq / 32;  // warps of pairs a row

  extern __shared__ __align__(16) float smem[];
  float* table = smem;  // [Lp][Ws] (+ a group's columns), then the walk's back-pointers
  short* walkbuf = reinterpret_cast<short*>(smem);
  float* cost = smem + p.off_cost;  // [Lp][Rp]: this block's copy of the costs
  float* xbuf = smem + p.off_xbuf;  // [2][W][Rp]: this block's columns' new costs, unshifted
  float2* red2 = reinterpret_cast<float2*>(smem + p.off_red2);  // [S][R][rs]: (min, first row)
  float* wl = smem + p.off_wl;      // a warp of pairs' row minimum, a slot each
  float* cmin = smem + p.off_cmin;  // [2][Rp]: this block's row minima
  float* gs = smem + p.off_gs;      // the shift of each row, then the walk's argmin
  int* gs_i = reinterpret_cast<int*>(gs + kMaxWarps);

  long long cnt[R];  // each row's tracked frames (0 past the batch)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = group * R + r;
    cnt[r] = b < p.rows ? (p.counts ? p.counts[b] : (long long)p.steps) : 0;
  }

  if (kSmemTable) {
    for (int e = threadIdx.x; e < Lp * p.Ws + p.NG * kGroupCols; e += threads) {
      const int i = e / p.Ws, jj = e - i * p.Ws;
      table[e] = i < L && jj < nW ? __ldg(p.tmat + (size_t)i * L + j0 + jj) : 0.0f;
    }
  }
  for (int e = L * Rp + threadIdx.x; e < Lp * Rp; e += threads) cost[e] = kInf;

  // this thread's (row, column) pairs: e = tid + k * threads, r = e / Wq,
  // jj = e % Wq: a warp's pairs are one row's 32 neighbouring columns
  const int npairs = R * p.Wq;
  float ncv[kMaxRowIters];      // the scores of the step to come
  long long pc[kMaxRowIters];  // the tracked frames of each pair's row
#pragma unroll
  for (int k = 0; k < kMaxRowIters; ++k) pc[k] = pick<R>(cnt, (threadIdx.x + k * threads) / p.Wq);

  // the block's row minima of a step's new costs (each warp of pairs its
  // own slot first), then the cluster's barrier: the other blocks read both
  auto publish = [&](int par) {
    __syncthreads();
    if (warp == 0 && lane < R) {
      float m = kInf;
      for (int w = 0; w < row_warps; ++w) m = fminf(m, wl[lane * row_warps + w]);
      cmin[par * Rp + lane] = m;
    }
    cluster.sync();
  };

  // the start: -nc[0]
#pragma unroll
  for (int k = 0; k < kMaxRowIters; ++k) {
    const int e = threadIdx.x + k * threads;
    ncv[k] = 0.0f;
    if (e < npairs) {
      const int r = e / p.Wq, jj = e - r * p.Wq, b = group * R + r;
      float v = kInf;
      if (jj < nW) {
        const int j = j0 + jj;
        const float* src = p.nc + (size_t)b * p.sb + j;
        v = b < p.rows ? -__ldg(src) : 0.0f;
        if (b < p.rows && p.steps > 1) ncv[k] = __ldg(src + p.st);
        xbuf[jj * Rp + r] = v;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) wl[e >> 5] = v;
    }
  }
  publish(0);

  for (int t = 1;; ++t) {
    const int par = (t - 1) & 1;  // the buffers step t - 1 (or the start) wrote
    // each row's shift: the minimum of what it wrote, or 0 for a row it left
    // frozen (its costs stay as they were)
    {
      // this thread's lags' new costs from the blocks that hold them, in
      // flight while warp 0 reads the minima
      float x[kMatIters][Rp];
#pragma unroll
      for (int k = 0; k < kMatIters; ++k) {
        const int i = threadIdx.x + k * threads;
        if (i < L) {
          const int q = i / p.W;  // the block that holds lag i
          load_vec<Rp>(cluster.map_shared_rank(xbuf, q) + (par * p.W + i - q * p.W) * Rp, x[k]);
        }
      }
      if (warp == 0 && lane < R) {
        float m[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          m[q] = q < C ? cluster.map_shared_rank(cmin, q)[par * Rp + lane] : kInf;
#pragma unroll
        for (int q = 1; q < kMaxCluster; ++q) m[0] = fminf(m[0], m[q]);
        gs[lane] = (t == 1 || t - 1 < pick<R>(cnt, lane)) ? m[0] : 0.0f;
      }
      __syncthreads();
      float g[Rp];
#pragma unroll
      for (int r = 0; r < Rp; ++r) g[r] = r < R ? gs[r] : 0.0f;
#pragma unroll
      for (int k = 0; k < kMatIters; ++k) {
        const int i = threadIdx.x + k * threads;
        if (i < L) {
#pragma unroll
          for (int r = 0; r < R; ++r) x[k][r] = __fsub_rn(x[k][r], g[r]);
          store_vec<Rp>(cost + i * Rp, x[k]);
        }
      }
    }
    __syncthreads();
    if (t >= p.steps) break;
    const int nxt = t & 1;

    // each chunk's minimum and the first row of its first block that holds it
    {
      float best[R][kLaneCols];
      int blk[R][kLaneCols];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < kLaneCols; ++c) {
          best[r][c] = kInf;
          blk[r][c] = 0x7fffffff;
        }
      for (int bk = b_lo; bk < b_hi; ++bk) {
        const int i0 = bk * kBlock;
        float cv[kBlock][Rp];
        float tv[kBlock][kLaneCols];
#pragma unroll
        for (int k = 0; k < kBlock; ++k) {
          load_vec<Rp>(cost + (i0 + k) * Rp, cv[k]);
          if (kSmemTable) {
            const float2 t2 = *reinterpret_cast<const float2*>(table + (i0 + k) * p.Ws + jl);
            tv[k][0] = t2.x;
            tv[k][1] = t2.y;
          } else {
#pragma unroll
            for (int c = 0; c < kLaneCols; ++c)
              tv[k][c] = table_at<false>(p, table, j0, i0 + k, jl + c);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < kLaneCols; ++c) {
            const float m01 = fminf(__fadd_rn(cv[0][r], tv[0][c]), __fadd_rn(cv[1][r], tv[1][c]));
            const float m23 = fminf(__fadd_rn(cv[2][r], tv[2][c]), __fadd_rn(cv[3][r], tv[3][c]));
            const float m = fminf(m01, m23);
            if (m < best[r][c]) {
              best[r][c] = m;
              blk[r][c] = i0;
            }
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        *reinterpret_cast<float4*>(red2 + (chunk * R + r) * p.rs + jl) = make_float4(
            best[r][0], __int_as_float(blk[r][0]), best[r][1], __int_as_float(blk[r][1]));
    }
    __syncthreads();

    // each (row, column) pair: the chunks in order, the first row of the
    // winning block that reaches the minimum, the new cost for the cluster
#pragma unroll
    for (int k = 0; k < kMaxRowIters; ++k) {
      const int e = threadIdx.x + k * threads;
      if (e < npairs) {
        const int r = e / p.Wq, jj = e - r * p.Wq, b = group * R + r;
        float out = kInf;
        if (jj < nW) {
          const int j = j0 + jj;
          float v = kInf;
          int i0 = 0;
          const float2* src = red2 + r * p.rs + jj;
#pragma unroll 4
          for (int s = 0; s < p.S; ++s) {
            const float2 o = src[s * R * p.rs];
            if (o.x < v) {
              v = o.x;
              i0 = __float_as_int(o.y);
            }
          }
          int a = i0 + kBlock - 1;
#pragma unroll
          for (int q = kBlock - 2; q >= 0; --q) {
            const float tq = table_at<kSmemTable>(p, table, j0, i0 + q, jj);
            if (__fadd_rn(cost[(i0 + q) * Rp + r], tq) == v) a = i0 + q;
          }
          out = cost[j * Rp + r];  // a frozen row's, or a row past the batch
          if (b < p.rows) {
            p.bp[((size_t)t * p.rows + b) * L + j] = (short)a;
            if (t < pc[k]) out = __fsub_rn(v, ncv[k]);
            if (t + 1 < p.steps)
              ncv[k] = __ldg(p.nc + (size_t)(t + 1) * p.st + (size_t)b * p.sb + j);
          }
          xbuf[(nxt * p.W + jj) * Rp + r] = out;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          out = fminf(out, __shfl_xor_sync(0xffffffffu, out, off));
        if (lane == 0) wl[e >> 5] = out;
      }
    }
    publish(nxt);
  }

  // every block's back-pointers are in device memory before any block walks
  __threadfence();
  cluster.sync();

  for (int r = rank; r < R; r += C) {
    const int b = group * R + r;
    if (b >= p.rows) break;
    float v = kInf;
    int a = 0x7fffffff;
    for (int i = threadIdx.x; i < L; i += threads) {
      const float c = cost[i * Rp + r];
      if (c < v) {
        v = c;
        a = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, a, off);
      take_better(v, a, ov, oi);
    }
    if (lane == 0) {
      gs[warp] = v;
      gs_i[warp] = a;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < (threads >> 5); ++w) take_better(v, a, gs[w], gs_i[w]);
      gs_i[kMaxWarps] = a;
    }
    __syncthreads();
    int j = gs_i[kMaxWarps];
    for (int t = p.steps - 1 + threadIdx.x; t < p.frames; t += threads)
      p.path[(size_t)t * p.rows + b] = j;
    for (int hi = p.steps - 1; hi >= 1; hi -= p.walk_k) {
      const int lo = max(1, hi - p.walk_k + 1);
      const int n = (hi - lo + 1) * L;  // walkbuf[(t - lo) * L + i] = bp[t][b][i]
      for (int e0 = threadIdx.x; e0 < n; e0 += kWalkUnroll * threads) {
        short w[kWalkUnroll];  // all loaded before any is stored: reads in flight
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u) {
          const int e = e0 + u * threads;
          if (e < n) {
            const int dt = e / L;
            w[u] = __ldcg(p.bp + ((size_t)(lo + dt) * p.rows + b) * L + (e - dt * L));
          }
        }
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u) {
          const int e = e0 + u * threads;
          if (e < n) walkbuf[e] = w[u];
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int t = hi; t >= lo; --t) {
          j = walkbuf[(t - lo) * L + j];
          p.path[(size_t)(t - 1) * p.rows + b] = j;
        }
      }
      __syncthreads();
    }
    __syncthreads();  // gs is read again for the block's next row
  }
}

struct Plan {
  int C, R, threads, in_smem;
  long long smem;
  Params geo;  // the geometry fields of Params
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

// the shared-memory layout and threads of C blocks a cluster and R rows
Plan make_plan(int L, int C, int R) {
  Plan pl = {};
  pl.C = C;
  pl.R = R;
  Params& g = pl.geo;
  g.L = L;
  g.W = (L + C - 1) / C;
  g.Ws = g.W + (g.W & 1);
  g.NG = (g.W + kGroupCols - 1) / kGroupCols;
  g.S = g.NG < kMaxWarps ? kMaxWarps / g.NG : 1;  // more groups than warps: no launch
  const int warps = g.NG * g.S;
  pl.threads = warps * 32;
  const int NB = (L + kBlock - 1) / kBlock, Lp = NB * kBlock;
  const int Rp = padded_rows(R);
  g.nb = (NB + g.S - 1) / g.S;
  g.Wq = (g.W + 31) / 32 * 32;
  g.rs = g.NG * kGroupCols;
  const long long table = 4LL * ((long long)Lp * g.Ws + g.NG * kGroupCols);
  const long long cost = round4((long long)Lp * Rp), xbuf = round4(2LL * g.W * Rp);
  const long long red2 = 2 * round4((long long)g.S * R * g.rs);
  const long long wl = round4((long long)R * g.Wq / 32), cmin = round4(2LL * Rp);
  const long long gs = round4(2 * kMaxWarps + 2);
  const long long rest = 4 * (cost + xbuf + red2 + wl + cmin + gs);
  pl.in_smem = table + rest <= kSmemLimit;
  long long walk = pl.in_smem && table > kWalkMinBytes ? table : kWalkMinBytes;
  walk = (walk + 15) / 16 * 16;
  g.off_cost = (int)(walk / 4);
  g.off_xbuf = (int)(g.off_cost + cost);
  g.off_red2 = (int)(g.off_xbuf + xbuf);
  g.off_wl = (int)(g.off_red2 + red2);
  g.off_cmin = (int)(g.off_wl + wl);
  g.off_gs = (int)(g.off_cmin + cmin);
  pl.smem = walk + rest;
  g.walk_k = (int)(walk / (2LL * L));
  return pl;
}

// the launch of C-block clusters over `clusters` clusters: attr and cfg are
// the caller's, filled here
void fill_config(const Plan& pl, int clusters, cudaStream_t stream, cudaLaunchAttribute* attr,
                 cudaLaunchConfig_t* cfg) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(clusters * pl.C));
  cfg->blockDim = dim3((unsigned)pl.threads);
  cfg->dynamicSmemBytes = (size_t)pl.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// launches the kernel of the plan's R rows and table place with p, or (p
// null) puts the clusters resident at once into *active
template <int R, bool S>
cudaError_t launch(const Plan& pl, const Params* p, int clusters, cudaStream_t stream,
                   int* active) {
  auto kernel = viterbi_kernel<R, S>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  fill_config(pl, clusters, stream, &attr, &cfg);
  if (!p) return cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  cudaLaunchKernelEx(&cfg, kernel, *p);
  return cudaGetLastError();
}

// the table in device memory takes 1 row a cluster (one kernel to build for
// the lags past what shared memory holds, which no caller's grid reaches)
cudaError_t run(const Plan& pl, const Params* p, int clusters, cudaStream_t stream,
                int* active) {
  if (!pl.in_smem) return launch<1, false>(pl, p, clusters, stream, active);
  switch (pl.R) {
    case 1:
      return launch<1, true>(pl, p, clusters, stream, active);
    case 2:
      return launch<2, true>(pl, p, clusters, stream, active);
    default:
      return launch<3, true>(pl, p, clusters, stream, active);
  }
}

bool valid_shape(int L, int C, int R) {
  if (C < 1 || C > kMaxCluster || R < 1 || R > kMaxRows) return false;
  const Plan pl = make_plan(L, C, R);
  if (!pl.in_smem && R != 1) return false;
  return pl.threads <= kMaxWarps * 32 && R * pl.geo.Wq <= kMaxRowIters * pl.threads &&
         L <= kMatIters * pl.threads && pl.smem <= kSmemLimit;
}

// a step's time in units of one row of one column group's work: R x the
// groups, and C + kStepLatency for the exchange, the barrier, the shift and
// the chunks' minima (on an H100 at 418 lags and 1,965 steps a unit costs
// about 0.8 ms; the fit puts C = 4 or 5 and 3 rows a cluster first for 64
// rows, within 4% of each other, and 2 blocks of 1 row at 210 lags)
constexpr int kStepLatency = 2;

}  // namespace

extern "C" {

// The launch the kernel takes for `rows` rows of `lags` lags on the current
// device, into plan[0..6]: cluster blocks C, rows a cluster R, threads a
// block, shared-memory bytes a block, the table in shared memory (1) or read
// from device memory (0), the clusters resident at once, and kMaxLags.  Of
// every C in 1 .. 8 and R in 1 .. 3 (1 with the table in device memory),
// with the table in shared memory where any slice fits, it takes the least
// waves x (R x column groups a block + C + kStepLatency), the fewer blocks
// on a tie.  Returns a cudaError_t; -1 for lags outside 1 .. kMaxLags or rows
// below 1, -2 where no launch fits.
int stk_viterbi_plan(int rows, int lags, int* plan) {
  if (lags < 1 || lags > kMaxLags || rows < 1) return -1;
  bool any_smem = false;
  for (int c = 1; c <= kMaxCluster; ++c)
    any_smem = any_smem || (valid_shape(lags, c, 1) && make_plan(lags, c, 1).in_smem);
  long long best = -1;
  for (int c = 1; c <= kMaxCluster; ++c) {
    for (int r = 1; r <= kMaxRows; ++r) {
      if (!valid_shape(lags, c, r)) continue;
      const Plan pl = make_plan(lags, c, r);
      if (any_smem && !pl.in_smem) continue;
      int active = 0;
      const int clusters = (rows + r - 1) / r;
      const cudaError_t e = run(pl, nullptr, clusters, nullptr, &active);
      if (e != cudaSuccess) return (int)e;
      if (active < 1) continue;
      const long long waves = (clusters + active - 1) / active;
      const long long score = waves * ((long long)r * pl.geo.NG + c + kStepLatency);
      if (best < 0 || score < best) {
        best = score;
        plan[0] = c;
        plan[1] = r;
        plan[2] = pl.threads;
        plan[3] = (int)pl.smem;
        plan[4] = pl.in_smem;
        plan[5] = active;
        plan[6] = kMaxLags;
      }
    }
  }
  return best < 0 ? -2 : 0;
}

// The lag path of `rows` rows of `lags` lags over `frames` frames: nc[t * st
// + b * sb + j] float32 scores (lags contiguous), tmat the (lags, lags)
// float32 transition costs, counts `rows` int64 tracked frames or null, the
// recursion run to `steps` (1 .. frames), bp an int16 (steps, rows, lags)
// scratch, path the int64 (frames, rows) output.  C blocks a cluster and R
// rows a cluster as stk_viterbi_plan gave them.  Returns a cudaError_t; -1
// for sizes outside the kernel's, -2 for a C or R it does not take.
int stk_viterbi(const float* nc, long long st, long long sb, const float* tmat,
                const long long* counts, int rows, int lags, int frames, int steps, short* bp,
                long long* path, int cluster, int rows_per_cluster, void* stream) {
  if (lags < 1 || lags > kMaxLags || rows < 1 || frames < 1 || steps < 1 || steps > frames)
    return -1;
  if (!valid_shape(lags, cluster, rows_per_cluster)) return -2;
  const Plan pl = make_plan(lags, cluster, rows_per_cluster);
  Params p = pl.geo;
  p.nc = nc;
  p.st = st;
  p.sb = sb;
  p.tmat = tmat;
  p.counts = counts;
  p.bp = bp;
  p.path = path;
  p.rows = rows;
  p.frames = frames;
  p.steps = steps;
  const int clusters = (rows + rows_per_cluster - 1) / rows_per_cluster;
  return (int)run(pl, &p, clusters, static_cast<cudaStream_t>(stream), nullptr);
}

const char* stk_error_string(int code) {
  if (code == -1) return "lags must be 1 .. 2048, rows and frames at least 1, steps 1 .. frames";
  if (code == -2) return "no launch of 1 .. 8 blocks a cluster and 1 .. 3 rows a cluster fits";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
