// Tile kernels of the tiled DBSCAN backend.
//
// Replace the Pallas kernels `count_kernel` and `minlabel_kernel`
// (src/repro/kernels/pairwise.py, launched by `pairwise_count` and
// `pairwise_minlabel` through `pallas_call`):
//   * count:    per query, the number of references within eps, saturated
//               at `cap`;
//   * minlabel: per query, the min of labels_r over references with
//               mask_r != 0 within eps (INT_MAX if none), and that count.
// The squared distance is the reference's MXU form,
//   d2 = (|q|^2 + |r|^2) - 2 <q, r>,
// where each norm and the dot product are rounded as the reference's
// compiled float32 code rounds them on the host: the first axis's product,
// then one fused multiply-add per further axis, in axis order, written out
// as __fmaf_rn. No tensor cores, no TF32; compiled with --fmad=false so
// nothing else is fused.
//
// What bounds them on an H100: operations. Each query meets every
// reference, about 2d + 4 float32 operations a pair, on data of a few
// bytes a point, so the float rate is the limit, far above the point where
// memory would be. At the tiled path's sizes (n <= 1024) the work is a few
// microseconds of the card, so what matters first is spreading it over the
// SMs.
//   * count: one warp per query. Its 32 threads take every 32nd reference
//     (neighbouring threads read neighbouring references), count their
//     hits exactly in integers, and add the counts with a warp reduction;
//     the sum is saturated at `cap` once, at the end, which equals the
//     reference's per-tile min(out + hits, cap) because counts are
//     non-negative. 1,000 queries make 125 blocks of 8 warps.
//   * minlabel: one thread per query; a block of 128 queries stages 128
//     references at a time (coordinates, norms, labels and masks) in shared
//     memory, so each reference is read from device memory once per block
//     and broadcast to all 128 threads; a loop over the reference tiles
//     inside the block takes the place of the TPU grid's sequential
//     reference dimension, and the ragged edge is masked by index (the
//     reference pads with +-1e30 coordinates instead, which never land
//     within eps, so the results are the same).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;  // minlabel: queries a block = references a tile
constexpr int kCountWarps = 8;  // count: queries (warps) per block
constexpr int kMaxD = 16;
constexpr int kIntMax = 0x7fffffff;

__global__ void __launch_bounds__(kCountWarps * 32) count_kernel(
    const float* __restrict__ q, const float* __restrict__ r, int nq, int nr,
    int d, float eps2, int cap, int* __restrict__ out) {
  const int i = blockIdx.x * kCountWarps + threadIdx.x / 32;
  const int t = threadIdx.x % 32;
  if (i >= nq) return;  // whole warps leave together
  float qv[kMaxD];
  float qn = 0.0f;
  for (int k = 0; k < d; ++k) {
    qv[k] = q[i * d + k];
    qn = k == 0 ? qv[k] * qv[k] : __fmaf_rn(qv[k], qv[k], qn);
  }
  int cnt = 0;
  for (int j = t; j < nr; j += 32) {
    const float* rv = r + j * d;
    float rn = rv[0] * rv[0];
    float cross = qv[0] * rv[0];
    for (int k = 1; k < d; ++k) {
      rn = __fmaf_rn(rv[k], rv[k], rn);
      cross = __fmaf_rn(qv[k], rv[k], cross);
    }
    const float d2 = (qn + rn) - 2.0f * cross;
    cnt += d2 <= eps2 ? 1 : 0;
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (t == 0) out[i] = cnt < cap ? cnt : cap;
}

__global__ void __launch_bounds__(kTile) minlabel_kernel(
    const float* __restrict__ q, const float* __restrict__ r,
    const int* __restrict__ labels_r, const uint8_t* __restrict__ mask_r,
    int nq, int nr, int d, float eps2, int* __restrict__ out,
    int* __restrict__ out_cnt) {
  extern __shared__ float smem[];
  float* r_tile = smem;                      // kTile * d
  float* rn_tile = smem + kTile * d;         // kTile
  int* lab_tile = reinterpret_cast<int*>(rn_tile + kTile);      // kTile
  uint8_t* ok_tile = reinterpret_cast<uint8_t*>(lab_tile + kTile);  // kTile

  const int t = threadIdx.x;
  const int i = blockIdx.x * kTile + t;
  const bool active = i < nq;
  float qv[kMaxD];
  float qn = 0.0f;
  for (int k = 0; k < d; ++k) {
    qv[k] = active ? q[i * d + k] : 0.0f;
    qn = k == 0 ? qv[k] * qv[k] : __fmaf_rn(qv[k], qv[k], qn);
  }
  int cnt = 0;
  int best = kIntMax;

  for (int base = 0; base < nr; base += kTile) {
    __syncthreads();  // the previous tile is consumed
    const int jr = base + t;
    if (jr < nr) {
      float rn = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float v = r[jr * d + k];
        r_tile[t * d + k] = v;
        rn = k == 0 ? v * v : __fmaf_rn(v, v, rn);
      }
      rn_tile[t] = rn;
      lab_tile[t] = labels_r[jr];
      ok_tile[t] = mask_r[jr];
    }
    __syncthreads();
    const int width = min(kTile, nr - base);
    if (active) {
      for (int jj = 0; jj < width; ++jj) {
        const float* rv = r_tile + jj * d;
        float cross = qv[0] * rv[0];
        for (int k = 1; k < d; ++k) cross = __fmaf_rn(qv[k], rv[k], cross);
        const float d2 = (qn + rn_tile[jj]) - 2.0f * cross;
        if (d2 <= eps2 && ok_tile[jj] != 0) {
          ++cnt;
          const int lab = lab_tile[jj];
          best = lab < best ? lab : best;
        }
      }
    }
  }
  if (active) {
    out[i] = best;
    out_cnt[i] = cnt;
  }
}

size_t smem_bytes(int d) {
  return sizeof(float) * kTile * (d + 1) + sizeof(int) * kTile + kTile;
}

}  // namespace

// Counts of references within eps per query, saturated at cap. q (nq, d),
// r (nr, d) float32; out (nq,) int32. 1 <= d <= 16. Returns
// cudaGetLastError() (0 on success).
extern "C" int pairwise_count_launch(const float* q, const float* r, int nq,
                                     int nr, int d, float eps2, int cap,
                                     int* out, void* stream) {
  if (nq <= 0) return 0;
  const dim3 grid((nq + kCountWarps - 1) / kCountWarps);
  count_kernel<<<grid, kCountWarps * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(q, r, nq, nr, d, eps2,
                                                      cap, out);
  return static_cast<int>(cudaGetLastError());
}

// (min masked label within eps, matched count) per query. labels_r (nr,)
// int32, mask_r (nr,) uint8; out_lab, out_cnt (nq,) int32.
extern "C" int pairwise_minlabel_launch(const float* q, const float* r,
                                        const int* labels_r,
                                        const uint8_t* mask_r, int nq, int nr,
                                        int d, float eps2, int* out_lab,
                                        int* out_cnt, void* stream) {
  if (nq <= 0) return 0;
  const dim3 grid((nq + kTile - 1) / kTile);
  minlabel_kernel<<<grid, kTile, smem_bytes(d),
                    static_cast<cudaStream_t>(stream)>>>(
      q, r, labels_r, mask_r, nq, nr, d, eps2, out_lab, out_cnt);
  return static_cast<int>(cudaGetLastError());
}
