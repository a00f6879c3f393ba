// Tile kernels of the tiled DBSCAN backend.
//
// Replace the Pallas kernels `count_kernel` and `minlabel_kernel`
// (src/repro/kernels/pairwise.py, launched by `pairwise_count` and
// `pairwise_minlabel` through `pallas_call`):
//   * count:    per query, the number of references within eps, saturated
//               at `cap`;
//   * minlabel: per query, the min of labels_r over references with
//               mask_r != 0 within eps (INT_MAX if none), and that count.
// Both take points of any width d >= 1.
//
// The squared distance is the reference's MXU form,
//   d2 = (|q|^2 + |r|^2) - 2 <q, r>,
// rounded as the reference's compiled float32 code rounds it on the host
// (kernels/ref.py: tile_dist2, tile_sum_sq):
//   * the dot product: the first axis's product, then one fused
//     multiply-add per further axis, in axis order;
//   * each norm: the same chain for d <= 4 and 9 <= d <= 32; squares and
//     sums rounded on their own, in axis order, for 5 <= d <= 8; for
//     d >= 33, windows of 32 axes over d padded to a multiple of 32 (half
//     the padding, rounded down, before axis 0), each window summed
//     unfused, the window sums added in order.
// Every operation is written out (__fmul_rn, __fadd_rn, __fmaf_rn), and
// the build passes --fmad=false, so nothing else is fused. No tensor cores,
// no TF32.
//
// What bounds them on an H100: operations. Each query meets every
// reference, about 2d + 4 float32 operations a pair, on a few bytes a
// point, so the float rate is the limit, far above the point where memory
// would be. At the tiled path's sizes (n <= 1024) the work is a few
// microseconds of the card, so what matters first is spreading it over the
// SMs. The design:
//   * a block of 8 warps serves 8 / split queries; the split * 32 threads
//     of a query take every (split * 32)-th reference of a tile, so a few
//     queries against many references still fill the card (the wrapper
//     picks split);
//   * the references are staged in shared memory a tile at a time, and
//     their norms computed there once a block, one thread a reference; a
//     row's stride in shared memory is odd, so the 32 threads of a warp,
//     reading 32 neighbouring rows, hit 32 banks;
//   * d <= 4 (the 2-D and 3-D point clouds the system is for) is compiled
//     for each d: the query's coordinates and norm live in registers, each
//     thread stages whole rows of a 1,024-reference tile, and every pair's
//     distance is tested as soon as it is computed;
//   * any larger d is staged in chunks of at most 32 axes (the norm's
//     windows when d > 32), so reads from device memory are coalesced at
//     any d; the dot products of a thread's references (at most 8 of a
//     256-reference tile) are carried across chunks in registers, so the
//     fused chain keeps its axis order. The axes of one pair are never
//     split between threads;
//   * counts are exact integers and labels exact minima, combined by warp
//     reductions (__reduce_add_sync, __reduce_min_sync) and then across a
//     query's split warps in shared memory: add and min are exact in any
//     order. A label and its mask are read from device memory only for a
//     pair within eps. The count is saturated at `cap` once, at the end,
//     which equals the reference's per-tile min(out + hits, cap) because
//     counts are non-negative. The ragged edge is masked by index (the
//     reference pads with +-1e30 coordinates instead, which never land
//     within eps, so the results are the same).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;     // threads a block = references a
                                          // tile of the chunked body
constexpr int kPerThread = kThreads / 32; // references of such a tile a
                                          // thread takes at split 1
constexpr int kSmallTile = 4 * kThreads;  // references a tile at d <= 4
constexpr int kMaxSmallD = 4;
constexpr int kWindow = 32;               // axes a chunk (a norm window)
constexpr int kIntMax = 0x7fffffff;
constexpr unsigned kFullWarp = 0xffffffffu;

// Where a thread stands: its query and its place among the query's
// split * 32 threads.
struct Place {
  int per_block;  // queries a block
  int slot;       // the thread's query within the block
  int i;          // the query
  bool active;    // i < nq
  int g;          // the thread among its query's threads
  int stride;     // split * 32
};

__device__ __forceinline__ Place place(int nq, int split) {
  Place p;
  const int warp = threadIdx.x / 32;
  p.per_block = kWarps / split;
  p.slot = warp / split;
  p.i = blockIdx.x * p.per_block + p.slot;
  p.active = p.i < nq;
  p.g = (warp % split) * 32 + threadIdx.x % 32;
  p.stride = split * 32;
  return p;
}

// One pair's outcome, given its squared distance; j is the reference.
template <bool kMinLabel>
__device__ __forceinline__ void take_pair(float d2, float eps2, int j,
                                          const int* __restrict__ labels_r,
                                          const uint8_t* __restrict__ mask_r,
                                          int& cnt, int& best) {
  if (d2 <= eps2) {
    if (!kMinLabel) {
      ++cnt;
    } else if (mask_r[j] != 0) {
      ++cnt;
      best = min(best, labels_r[j]);
    }
  }
}

// Combine the threads' counts and minima of each query (warp reductions,
// then the query's split warps in shared memory) and write the outputs.
template <bool kMinLabel>
__device__ __forceinline__ void finish(int cnt, int best, const Place& p,
                                       int split, int cap,
                                       int* __restrict__ out,
                                       int* __restrict__ out_cnt) {
  __shared__ int part_cnt[kWarps];
  __shared__ int part_min[kWarps];
  const int warp = threadIdx.x / 32;
  cnt = __reduce_add_sync(kFullWarp, cnt);
  if (kMinLabel) best = __reduce_min_sync(kFullWarp, best);
  if (threadIdx.x % 32 == 0) {
    part_cnt[warp] = cnt;
    part_min[warp] = best;
  }
  __syncthreads();
  if (p.active && threadIdx.x % 32 == 0 && warp % split == 0) {
    int total = 0;
    int low_label = kIntMax;
    for (int s = 0; s < split; ++s) {
      total += part_cnt[warp + s];
      low_label = min(low_label, part_min[warp + s]);
    }
    if (kMinLabel) {
      out[p.i] = low_label;
      out_cnt[p.i] = total;
    } else {
      out[p.i] = total < cap ? total : cap;
    }
  }
}

// d = kD <= 4, known at compile time: the fused chain for both norms and
// the dot product, the query in registers, whole rows staged per thread.
template <bool kMinLabel, int kD>
__device__ __forceinline__ void small_body(
    const float* __restrict__ q, const float* __restrict__ r,
    const int* __restrict__ labels_r, const uint8_t* __restrict__ mask_r,
    int nq, int nr, float eps2, int cap, int split, int* __restrict__ out,
    int* __restrict__ out_cnt) {
  constexpr int kStride = kD | 1;
  __shared__ float r_s[kSmallTile * kStride];
  __shared__ float rn_s[kSmallTile];

  const Place p = place(nq, split);
  float qv[kD];
  float qn = 0.0f;
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    qv[k] = p.active ? q[static_cast<size_t>(p.i) * kD + k] : 0.0f;
    qn = k == 0 ? __fmul_rn(qv[0], qv[0]) : __fmaf_rn(qv[k], qv[k], qn);
  }
  int cnt = 0;
  int best = kIntMax;
  for (int base = 0; base < nr; base += kSmallTile) {
    const int width = min(kSmallTile, nr - base);
    __syncthreads();  // the previous tile is consumed
    for (int row = threadIdx.x; row < width; row += kThreads) {
      const float* src = r + static_cast<size_t>(base + row) * kD;
      float rn = 0.0f;
#pragma unroll
      for (int k = 0; k < kD; ++k) {
        const float v = src[k];
        r_s[row * kStride + k] = v;
        rn = k == 0 ? __fmul_rn(v, v) : __fmaf_rn(v, v, rn);
      }
      rn_s[row] = rn;
    }
    __syncthreads();
    if (p.active) {
      for (int j = p.g; j < width; j += p.stride) {
        const float* rv = r_s + j * kStride;
        float cross = __fmul_rn(qv[0], rv[0]);
#pragma unroll
        for (int k = 1; k < kD; ++k) cross = __fmaf_rn(qv[k], rv[k], cross);
        const float d2 = __fsub_rn(__fadd_rn(qn, rn_s[j]),
                                   __fmul_rn(2.0f, cross));
        take_pair<kMinLabel>(d2, eps2, base + j, labels_r, mask_r, cnt, best);
      }
    }
  }
  finish<kMinLabel>(cnt, best, p, split, cap, out, out_cnt);
}

// Sum of squares of x[0..c), the part of a norm that one chunk holds:
// the fused chain, or every product and sum rounded on its own.
__device__ __forceinline__ float chunk_sq(const float* x, int c, bool fused) {
  float s = __fmul_rn(x[0], x[0]);
  for (int k = 1; k < c; ++k)
    s = fused ? __fmaf_rn(x[k], x[k], s) : __fadd_rn(s, __fmul_rn(x[k], x[k]));
  return s;
}

// Any d: the references staged in chunks of at most 32 axes.
template <bool kMinLabel>
__device__ __forceinline__ void chunked_body(
    const float* __restrict__ q, const float* __restrict__ r,
    const int* __restrict__ labels_r, const uint8_t* __restrict__ mask_r,
    int nq, int nr, int d, float eps2, int cap, int split,
    int* __restrict__ out, int* __restrict__ out_cnt) {
  extern __shared__ float r_s[];          // kThreads rows of a chunk
  __shared__ float q_s[kWarps * kWindow];  // the block's queries, a chunk
  __shared__ float rn_s[kThreads];
  __shared__ float qn_s[kWarps];

  const Place p = place(nq, split);
  const int per_thread = kPerThread / split;
  const bool fused = d <= 4 || (d >= 9 && d <= kWindow);
  const int low = d <= kWindow ? 0 : ((kWindow - d % kWindow) % kWindow) / 2;
  const int n_chunks = (d + low + kWindow - 1) / kWindow;

  int cnt = 0;
  int best = kIntMax;
  float qn = 0.0f;
  for (int base = 0; base < nr; base += kThreads) {
    const int width = min(kThreads, nr - base);
    float cross[kPerThread];
    float rn = 0.0f;    // the norm of reference base + threadIdx.x
    float qn_t = 0.0f;  // first tile: the norm of the block's query t
    for (int m = 0; m < n_chunks; ++m) {
      const int lo = m == 0 ? 0 : m * kWindow - low;
      const int hi = min(d, (m + 1) * kWindow - low);
      const int c = hi - lo;
      const int cs = c | 1;
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < width * c; e += kThreads) {
        const int row = e / c;
        const int col = e - row * c;
        r_s[row * cs + col] =
            r[static_cast<size_t>(base + row) * d + lo + col];
      }
      for (int e = threadIdx.x; e < p.per_block * c; e += kThreads) {
        const int row = e / c;
        const int col = e - row * c;
        const int qi = blockIdx.x * p.per_block + row;
        q_s[row * kWindow + col] =
            qi < nq ? q[static_cast<size_t>(qi) * d + lo + col] : 0.0f;
      }
      __syncthreads();
      if (threadIdx.x < width) {
        const float part = chunk_sq(r_s + threadIdx.x * cs, c, fused);
        rn = m == 0 ? part : __fadd_rn(rn, part);
      }
      if (base == 0 && threadIdx.x < p.per_block) {
        const float part = chunk_sq(q_s + threadIdx.x * kWindow, c, fused);
        qn_t = m == 0 ? part : __fadd_rn(qn_t, part);
      }
      if (p.active) {
        const float* qv = q_s + p.slot * kWindow;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          const int j = p.g + u * p.stride;
          if (u < per_thread && j < width) {
            const float* rv = r_s + j * cs;
            float acc = m == 0 ? __fmul_rn(qv[0], rv[0])
                               : __fmaf_rn(qv[0], rv[0], cross[u]);
            for (int k = 1; k < c; ++k) acc = __fmaf_rn(qv[k], rv[k], acc);
            cross[u] = acc;
          }
        }
      }
    }
    if (threadIdx.x < width) rn_s[threadIdx.x] = rn;
    if (base == 0 && threadIdx.x < p.per_block) qn_s[threadIdx.x] = qn_t;
    __syncthreads();
    if (base == 0) qn = qn_s[p.slot];
    if (p.active) {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        const int j = p.g + u * p.stride;
        if (u < per_thread && j < width) {
          const float d2 = __fsub_rn(__fadd_rn(qn, rn_s[j]),
                                     __fmul_rn(2.0f, cross[u]));
          take_pair<kMinLabel>(d2, eps2, base + j, labels_r, mask_r, cnt,
                               best);
        }
      }
    }
  }
  finish<kMinLabel>(cnt, best, p, split, cap, out, out_cnt);
}

// kD = d for d <= 4, else 0 (any d, in chunks).
template <bool kMinLabel, int kD>
__device__ __forceinline__ void tile_body(
    const float* __restrict__ q, const float* __restrict__ r,
    const int* __restrict__ labels_r, const uint8_t* __restrict__ mask_r,
    int nq, int nr, int d, float eps2, int cap, int split,
    int* __restrict__ out, int* __restrict__ out_cnt) {
  if constexpr (kD == 0) {
    chunked_body<kMinLabel>(q, r, labels_r, mask_r, nq, nr, d, eps2, cap,
                            split, out, out_cnt);
  } else {
    small_body<kMinLabel, kD>(q, r, labels_r, mask_r, nq, nr, eps2, cap,
                              split, out, out_cnt);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads) count_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int nq, int nr,
    int d, float eps2, int cap, int split, int* __restrict__ out) {
  tile_body<false, kD>(q, r, nullptr, nullptr, nq, nr, d, eps2, cap, split,
                       out, nullptr);
}

template <int kD>
__global__ void __launch_bounds__(kThreads) minlabel_kernel(
    const float* __restrict__ q, const float* __restrict__ r,
    const int* __restrict__ labels_r, const uint8_t* __restrict__ mask_r,
    int nq, int nr, int d, float eps2, int split, int* __restrict__ out,
    int* __restrict__ out_cnt) {
  tile_body<true, kD>(q, r, labels_r, mask_r, nq, nr, d, eps2, 0, split, out,
                      out_cnt);
}

bool bad_args(int nq, int d, int split) {
  return nq < 0 || d < 1 || split < 1 || split > kWarps ||
         kWarps % split != 0;
}

dim3 grid_of(int nq, int split) {
  const int per_block = kWarps / split;
  return dim3((nq + per_block - 1) / per_block);
}

// Dynamic shared memory of the chunked body: kThreads rows of at most 32
// axes, odd stride. The bodies for d <= 4 take none.
size_t smem_bytes(int d) {
  if (d <= kMaxSmallD) return 0;
  const int c = d < kWindow ? d : kWindow;
  return sizeof(float) * kThreads * (c | 1);
}

// The kernel for d: compiled for d <= 4, chunked above.
template <typename Kernel>
Kernel pick(int d, Kernel k1, Kernel k2, Kernel k3, Kernel k4, Kernel any) {
  switch (d) {
    case 1: return k1;
    case 2: return k2;
    case 3: return k3;
    case 4: return k4;
    default: return any;
  }
}

}  // namespace

// Counts of references within eps per query, saturated at cap. q (nq, d),
// r (nr, d) float32, d >= 1; split (1, 2, 4 or 8) warps a query; out (nq,)
// int32. Returns cudaGetLastError() (0 on success).
extern "C" int pairwise_count_launch(const float* q, const float* r, int nq,
                                     int nr, int d, float eps2, int cap,
                                     int split, int* out, void* stream) {
  if (bad_args(nq, d, split)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const auto kernel = pick(d, count_kernel<1>, count_kernel<2>,
                           count_kernel<3>, count_kernel<4>, count_kernel<0>);
  kernel<<<grid_of(nq, split), kThreads, smem_bytes(d),
           static_cast<cudaStream_t>(stream)>>>(q, r, nq, nr, d, eps2, cap,
                                                split, out);
  return static_cast<int>(cudaGetLastError());
}

// (min masked label within eps, matched count) per query. labels_r (nr,)
// int32, mask_r (nr,) uint8; out_lab, out_cnt (nq,) int32.
extern "C" int pairwise_minlabel_launch(const float* q, const float* r,
                                        const int* labels_r,
                                        const uint8_t* mask_r, int nq, int nr,
                                        int d, float eps2, int split,
                                        int* out_lab, int* out_cnt,
                                        void* stream) {
  if (bad_args(nq, d, split)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const auto kernel =
      pick(d, minlabel_kernel<1>, minlabel_kernel<2>, minlabel_kernel<3>,
           minlabel_kernel<4>, minlabel_kernel<0>);
  kernel<<<grid_of(nq, split), kThreads, smem_bytes(d),
           static_cast<cudaStream_t>(stream)>>>(
      q, r, labels_r, mask_r, nq, nr, d, eps2, split, out_lab, out_cnt);
  return static_cast<int>(cudaGetLastError());
}
