// The rope walk of the LBVH, one CUDA thread per query lane.
//
// Replaces the Pallas kernel `_walk_kernel` (src/repro/kernels/traverse.py,
// launched by `_run` through `pallas_call`). Each lane walks the tree
// without a stack, following the ropes (`miss`), until it has nothing left
// to visit, for an `intersects(sphere(eps))` batch:
//   * node test: box_dist2(q, box) <= r2, optionally with range_r >= rank,
//     and a node mask chosen per lane between node_mask and node_mask_wide;
//   * leaf members: sum over axes of (q - p)^2 <= r2;
//   * visitor, inlined: count, minlabel or countminlabel, with the
//     dense-segment short-circuit;
//   * each loop trip runs `unroll` work units; a finished lane does nothing.
// The step is `make_step` of src/repro_torch/core/traversal.py, step for
// step, so acc, hits and evals equal the plain engine's, and iters equals
// its count at the same unroll.
//
// What bounds it on an H100: neither the card's memory rate nor its float
// rate. Every work unit is a dependent chain of gathers (node -> box ->
// rope -> next node, or member -> point), so a lane waits on memory latency
// (L2 when the index fits its 50 MB, device memory beyond), and lanes of
// one warp diverge as their walks differ in length. The design answers the
// latency with occupancy: one thread per lane, small per-thread state
// (node, member pointer, carry, counters: a few registers), 128 threads a
// block, so many warps are resident to hide each other's gathers. The
// index is read through the read-only data path (const __restrict__).
// Lanes of a block are neighbours in Morton order, so they walk nearby
// subtrees and share cache lines. Reordering lanes by walk depth to cut
// divergence is later work.
//
// Float discipline (compiled with --fmad=false, so the compiler fuses
// nothing on its own): every squared distance is the first axis's square
// followed by one explicit fused multiply-add per further axis, in axis
// order. That is how the reference's compiled float32 code rounds its
// sum(diff * diff) (measured against the JAX walk on the host), and how
// the plain engine rounds it (core/lbvh.py: sum_sq).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCount = 0;
constexpr int kMinLabel = 1;
constexpr int kCountMinLabel = 2;
constexpr int kBlock = 128;

struct WalkArgs {
  int n_lanes;
  int m;  // segments (leaves); internal nodes are 0 .. m-2
  int unroll;
  int use_range_mask, has_node_mask, dual_nodes, dual_gather;
  float r2;
  int cap;
  // lane inputs
  const float* __restrict__ q;
  const int* __restrict__ qid;
  const int* __restrict__ self_id;
  const uint8_t* __restrict__ dense;
  const int* __restrict__ rank;
  const uint8_t* __restrict__ wide;
  const void* __restrict__ acc0;
  const int* __restrict__ hits0;
  // index
  const float* __restrict__ pts;
  const int* __restrict__ seg_start;
  const int* __restrict__ seg_end;
  const uint8_t* __restrict__ dense_seg;
  const int* __restrict__ left;
  const int* __restrict__ miss;
  const int* __restrict__ range_r;
  const float* __restrict__ box_lo;
  const float* __restrict__ box_hi;
  const uint8_t* __restrict__ node_mask;
  const uint8_t* __restrict__ node_mask_wide;
  const void* __restrict__ vals;
  const uint8_t* __restrict__ mask;
  const uint8_t* __restrict__ mask_wide;
  // outputs
  void* acc;
  int* hits;
  int* evals;
  int* iters;
};

template <int KIND, typename V, int D>
__global__ void __launch_bounds__(kBlock) walk_kernel(const WalkArgs a) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int leaf_off = a.m - 1;
  const V* __restrict__ vals = static_cast<const V*>(a.vals);

  float q[D];
#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = a.q[lane * D + k];
  const int self_id = a.self_id[lane];
  const bool dense = a.dense[lane] != 0;
  const int rank = a.rank[lane];
  const bool wide = a.wide[lane] != 0;
  // per-lane choice of node mask and gather mask (the split first sweep)
  const uint8_t* __restrict__ nmask =
      (a.dual_nodes && wide) ? a.node_mask_wide : a.node_mask;
  const uint8_t* __restrict__ gmask =
      (KIND == kMinLabel && a.dual_gather && wide) ? a.mask_wide : a.mask;

  V acc = static_cast<const V*>(a.acc0)[lane];
  int hits = a.hits0[lane];
  int node = a.qid[lane] >= 0 ? 0 : -1;  // root = 0; -1: inert lane
  int ptr = -1;
  int evals = 0;
  int iters = 0;

  // CountVisitor.done: the lane dies once its count reaches cap
  auto live = [&]() {
    return node >= 0 && !(KIND == kCount && acc >= static_cast<V>(a.cap));
  };

  while (live()) {
    for (int u = 0; u < a.unroll && live(); ++u) {
      if (ptr >= 0) {
        // ---- member step: one distance test against sorted point ptr
        const int j = ptr;
        float diff = q[0] - a.pts[j * D];
        float d2 = diff * diff;
#pragma unroll
        for (int k = 1; k < D; ++k) {
          diff = q[k] - a.pts[j * D + k];
          d2 = __fmaf_rn(diff, diff, d2);
        }
        const bool hit = d2 <= a.r2;
        const int seg = node - leaf_off;
        bool stop_seg = false;
        if (KIND == kCount) {
          const V inc = hit ? 1 : 0;
          acc = acc + inc < static_cast<V>(a.cap) ? acc + inc
                                                  : static_cast<V>(a.cap);
          hits += (hit && j != self_id) ? 1 : 0;
        } else {
          const bool ok = hit && gmask[j] != 0;
          if (ok) {
            const V v = vals[j];
            acc = v < acc ? v : acc;
          }
          if (KIND == kMinLabel) {
            hits += (ok && j != self_id) ? 1 : 0;
            stop_seg = ok && a.dense_seg[seg] != 0;
          } else {
            const int h = hits + ((ok && j != self_id) ? 1 : 0);
            hits = h < a.cap ? h : a.cap;
            stop_seg = ok && a.dense_seg[seg] != 0 && (dense || hits >= a.cap);
          }
        }
        if (ptr + 1 >= a.seg_end[seg] || stop_seg) {
          node = a.miss[node];
          ptr = -1;
        } else {
          ptr = ptr + 1;
        }
        ++evals;
      } else {
        // ---- node step: descend / skip
        float bd2 = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float lo = a.box_lo[node * D + k];
          const float hi = a.box_hi[node * D + k];
          const float g = fmaxf(fmaxf(lo - q[k], q[k] - hi), 0.0f);
          bd2 = k == 0 ? g * g : __fmaf_rn(g, g, bd2);
        }
        bool overlap = bd2 <= a.r2;
        if (a.use_range_mask) overlap = overlap && a.range_r[node] >= rank;
        if (a.has_node_mask) overlap = overlap && nmask[node] != 0;
        if (node < leaf_off) {
          node = overlap ? a.left[node] : a.miss[node];
        } else {
          const int seg = node - leaf_off;
          const int s0 = a.seg_start[seg];
          if (overlap && s0 < a.seg_end[seg]) {
            ptr = s0;  // enter the segment's members
          } else {
            node = a.miss[node];  // empty segments go straight to the rope
          }
        }
      }
    }
    ++iters;
  }
  static_cast<V*>(a.acc)[lane] = acc;
  a.hits[lane] = hits;
  a.evals[lane] = evals;
  a.iters[lane] = iters;
}

template <int KIND, typename V>
void launch_d(const WalkArgs& a, int d, cudaStream_t stream) {
  const dim3 grid((a.n_lanes + kBlock - 1) / kBlock);
  if (d == 2) {
    walk_kernel<KIND, V, 2><<<grid, kBlock, 0, stream>>>(a);
  } else {
    walk_kernel<KIND, V, 3><<<grid, kBlock, 0, stream>>>(a);
  }
}

}  // namespace

// Launch the walk on `stream`; returns cudaGetLastError() (0 on success).
// kind: 0 count, 1 minlabel, 2 countminlabel; vals_f32: vals/acc are
// float32 (else int32; count is always int32); d in {2, 3}.
extern "C" int walk_launch(
    int kind, int vals_f32, int d, int unroll, int use_range_mask,
    int has_node_mask, int dual_nodes, int dual_gather, int n_lanes, int m,
    float r2, int cap,
    const float* q, const int* qid, const int* self_id, const uint8_t* dense,
    const int* rank, const uint8_t* wide, const void* acc0, const int* hits0,
    const float* pts, const int* seg_start, const int* seg_end,
    const uint8_t* dense_seg, const int* left, const int* miss,
    const int* range_r, const float* box_lo, const float* box_hi,
    const uint8_t* node_mask, const uint8_t* node_mask_wide,
    const void* vals, const uint8_t* mask, const uint8_t* mask_wide,
    void* acc, int* hits, int* evals, int* iters, void* stream) {
  WalkArgs a;
  a.n_lanes = n_lanes;
  a.m = m;
  a.unroll = unroll;
  a.use_range_mask = use_range_mask;
  a.has_node_mask = has_node_mask;
  a.dual_nodes = dual_nodes;
  a.dual_gather = dual_gather;
  a.r2 = r2;
  a.cap = cap;
  a.q = q;
  a.qid = qid;
  a.self_id = self_id;
  a.dense = dense;
  a.rank = rank;
  a.wide = wide;
  a.acc0 = acc0;
  a.hits0 = hits0;
  a.pts = pts;
  a.seg_start = seg_start;
  a.seg_end = seg_end;
  a.dense_seg = dense_seg;
  a.left = left;
  a.miss = miss;
  a.range_r = range_r;
  a.box_lo = box_lo;
  a.box_hi = box_hi;
  a.node_mask = node_mask;
  a.node_mask_wide = node_mask_wide;
  a.vals = vals;
  a.mask = mask;
  a.mask_wide = mask_wide;
  a.acc = acc;
  a.hits = hits;
  a.evals = evals;
  a.iters = iters;
  if (n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kCount) {
    launch_d<kCount, int>(a, d, s);
  } else if (kind == kMinLabel) {
    if (vals_f32) launch_d<kMinLabel, float>(a, d, s);
    else launch_d<kMinLabel, int>(a, d, s);
  } else {
    if (vals_f32) launch_d<kCountMinLabel, float>(a, d, s);
    else launch_d<kCountMinLabel, int>(a, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
