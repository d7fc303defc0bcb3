// Zero-padded row layout of a packed batch for Hopper (sm_90a), with a plain
// C launcher (stk_layout_rows) that the Python wrapper layout_rows in
// speech_tpu_torch/ops/stft_kernels.py loads through ctypes.
//
// Replaces no TPU kernel: the JAX package pads its batches on the host and
// hands XLA the whole block.  Here the host packs only each row's real
// samples, back to back (ShardedExtractor._pack_rows), the packed bytes
// cross PCIe, and this kernel writes the (rows, max_len) block the computers
// take: row r holds counts[r] samples from packed + offsets[r], then zeros to
// max_len.  The block is bit for bit the host-padded one: elements are copied
// as 2-, 4- or 8-byte words, never converted.
//
// Bound on an H100: one read of the packed samples and one write of the
// block against 3.35 TB/s (about 27 us for the corpus batches' 22.5 MB read
// and 67 MB written).  Each thread moves 16 bytes at a time, eight vectors
// a step (all eight loaded before any is stored, so that a thread keeps
// eight reads in flight and reads its row's offset and count once for 128
// bytes; on an H100 38 us for a batch of 64 x 524288 int16 samples, against
// 82 us for one vector a step):
// a row whose offset is a multiple of 16 bytes (the host aligns every
// offset) loads its samples as 16-byte vectors, masks the tail of its last
// vector and stores 16-byte vectors of samples or zeros; a row whose offset
// is not aligned loads its samples one element at a time and still stores
// 16-byte vectors.
// A block of max_len not a multiple of 16 bytes, or an unaligned pointer,
// takes one-element stores.  blockIdx.y walks the rows, blockIdx.x the
// columns, grid-striding past the grid's limits.  Counts are clamped to
// max_len and to the packed buffer, so a bad table cannot read out of
// bounds.
//
// The launcher returns cudaGetLastError() after the launch; nothing here
// allocates or synchronises.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // vectors a thread moves a step
constexpr long long kMaxGridY = 65535;
constexpr long long kMaxGridX = 1 << 16;

// V elements of T: 16 bytes, or one element (V = 1)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    layout_rows_kernel(const T* __restrict__ packed, long long packed_len,
                       const long long* __restrict__ offsets,
                       const long long* __restrict__ counts, long long rows,
                       long long max_len, T* __restrict__ out) {
  constexpr long long kSpan = (long long)kThreads * V;  // a block's vectors, one each
  const long long first = (long long)blockIdx.x * kSpan * kUnroll + threadIdx.x * V;
  const long long step = (long long)gridDim.x * kSpan * kUnroll;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    long long off = offsets[r];
    off = off < 0 ? 0 : (off > packed_len ? packed_len : off);
    long long k = counts[r];
    k = k < 0 ? 0 : k;
    k = k < max_len ? k : max_len;
    k = k < packed_len - off ? k : packed_len - off;
    const T* src = packed + off;
    T* dst = out + r * max_len;
    const bool whole = off % V == 0;  // the row's vectors are aligned
    for (long long c0 = first; c0 < max_len; c0 += step) {
      Vec<T, V> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + u * kSpan;
        if (whole && c + V <= k) {
          x[u] = *reinterpret_cast<const Vec<T, V>*>(src + c);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) x[u].v[j] = c + j < k ? src[c + j] : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long c = c0 + u * kSpan;
        if (c < max_len) *reinterpret_cast<Vec<T, V>*>(dst + c) = x[u];
      }
    }
  }
}

template <typename T>
cudaError_t launch_layout(const void* packed, long long packed_len,
                          const long long* offsets, const long long* counts,
                          long long rows, long long max_len, void* out,
                          cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = max_len % kVec == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long per = (vec ? (long long)kThreads * kVec : kThreads) * kUnroll;
  long long gx = (max_len + per - 1) / per;
  gx = gx < kMaxGridX ? gx : kMaxGridX;
  const dim3 grid((unsigned)gx, (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  const T* p = static_cast<const T*>(packed);
  T* o = static_cast<T*>(out);
  if (vec)
    layout_rows_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(p, packed_len, offsets, counts,
                                                              rows, max_len, o);
  else
    layout_rows_kernel<T, 1><<<grid, kThreads, 0, stream>>>(p, packed_len, offsets, counts,
                                                           rows, max_len, o);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The (rows, max_len) block of elem_bytes-byte elements (2, 4 or 8) at out:
// row r is counts[r] elements of packed (packed_len elements) from element
// offsets[r], then zeros.  offsets and counts are rows int64 values in
// device memory.  Returns a cudaError_t; -1 for an element size other than
// 2, 4 or 8, or a negative size.
int stk_layout_rows(const void* packed, long long packed_len, const long long* offsets,
                    const long long* counts, long long rows, long long max_len,
                    int elem_bytes, void* out, void* stream) {
  if (rows < 0 || max_len < 0 || packed_len < 0) return -1;
  if (rows == 0 || max_len == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2:
      return (int)launch_layout<uint16_t>(packed, packed_len, offsets, counts, rows, max_len,
                                          out, st);
    case 4:
      return (int)launch_layout<uint32_t>(packed, packed_len, offsets, counts, rows, max_len,
                                          out, st);
    case 8:
      return (int)launch_layout<unsigned long long>(packed, packed_len, offsets, counts, rows,
                                                    max_len, out, st);
    default:
      return -1;
  }
}

const char* stk_error_string(int code) {
  if (code == -1) return "element size must be 2, 4 or 8 bytes, and sizes not negative";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
