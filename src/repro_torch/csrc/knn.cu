// The k-nearest-neighbour rope walk of the LBVH on Hopper: one thread per
// query lane, its k-best list in its own rows of the outputs.
//
// Replaces no Pallas kernel: the reference runs k-NN on its XLA engine
// (src/repro/core/traversal.py: traverse_impl with the nearest(k) predicate
// and KNNVisitor; src/repro/core/neighbors.py: knn). It computes exactly
// what the port's plain engine computes for
//   traverse(tree, segs, nearest(k, r, ids, pts), KNNVisitor(k, id_map=order))
// (`make_step` in src/repro_torch/core/traversal.py), step for step:
//   * at every work unit the lane's bound is min(r2, worst), worst being
//     the k-th best squared distance so far (+inf while the list is short);
//   * node step: box_dist2(q, box) <= bound descends (internal node) or
//     enters the leaf's members; else the rope (`miss`);
//   * member step: d2 = sum over axes of (q - p)^2; d2 <= bound offers the
//     member to the list, which takes it unless k slots are strictly better
//     under (d2, original id); the candidate is inserted by shifting;
//   * `evals` counts member steps; `iters` is the plain engine's loop trips
//     at `unroll` work units a trip, ceil(units / unroll), since a k-NN
//     lane never ends early.
// Ties at the k-th distance go to the smaller *original* id: the list
// compares and stores order[j], not the sorted index j.
//
// It reads the index in the walk kernel's packed layout
// (src/repro_torch/kernels/walkpack.py): a node is one 32-byte record (box
// corners, rope, left child or first member); a one-member leaf whose box
// is its member's point holds ~seg_start, and its member test's squared
// distance is the box distance bit for bit, so it needs no point load.
//
// What bounds it on an H100: as for the walk kernel (csrc/walk.cu), the
// dependent chain of scattered gathers per work unit, one cache line per
// thread of a warp, and here also the k-best list, which lives in device
// memory (a row of k floats and k ints per lane, strided across a warp's
// threads). This is the simple kernel: no lane refill, no batched member
// tests, no register-resident list; those are later work.
//
// Float discipline (compiled with --fmad=false): every squared distance is
// the first axis's square followed by one explicit fused multiply-add per
// further axis, in axis order, as the reference's compiled float32 code
// rounds its sum(diff * diff) (core/lbvh.py: sum_sq in the plain engine).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlock = 128;  // threads per block
constexpr int kDenseBit = static_cast<int>(0x80000000u);

struct KnnArgs {
  int n_lanes;
  int m;  // segments (leaves); internal nodes are 0 .. m-2, root 0
  int k;
  int unroll;
  float r2;
  const float* __restrict__ q;        // (L, D)
  const int* __restrict__ qid;        // (L,) -1: inert lane
  const int4* __restrict__ nodes;     // (2m-1) records of two int4
  const int* __restrict__ leaf_end;   // (m,) seg_end | dense << 31
  const void* __restrict__ pts;       // (n,) float4 (d = 3) or float2
  const int* __restrict__ order;      // (n,) original id of sorted point
  int* __restrict__ ids;              // (L, k)
  float* __restrict__ d2;             // (L, k)
  int* __restrict__ evals;            // (L,)
  int* __restrict__ iters;            // (L,)
};

template <int D>
__global__ void __launch_bounds__(kBlock) knn_kernel(const KnnArgs a) {
  using P = typename std::conditional<D == 3, float4, float2>::type;
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const P* __restrict__ pts = static_cast<const P*>(a.pts);
  const int k = a.k;
  const int last = k - 1;
  float* __restrict__ bd = a.d2 + static_cast<size_t>(lane) * k;
  int* __restrict__ bi = a.ids + static_cast<size_t>(lane) * k;
  const float inf = __int_as_float(0x7f800000);
  for (int s = 0; s < k; ++s) {
    bd[s] = inf;
    bi[s] = -1;
  }
  int evals = 0, units = 0;

  if (a.qid[lane] >= 0) {
    float q[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = a.q[lane * D + c];
    const int leaf_off = a.m - 1;
    float worst = inf;  // bd[last], kept in a register
    int node = 0;       // root; -1 once the walk is done
    int ptr = -1;       // next member to test; -1: at a node
    int end = 0, leaf_miss = -1;

    // A member within the bound: insert (dd, order[j]) unless all k slots
    // are strictly better. The list is sorted under (d2, id), so the slots
    // better than the candidate are a prefix, and shifting the others one
    // slot down from the end puts the candidate where the plain engine's
    // count of better slots puts it.
    auto offer = [&](int j, float dd) {
      const int id = __ldg(a.order + j);
      const float ld = bd[last];
      if (ld < dd || (ld == dd && bi[last] < id)) return;
      int i = last;
      float w = dd;  // the last slot's distance after the insertion
      while (i > 0) {
        const float pd = bd[i - 1];
        const int pi = bi[i - 1];
        if (pd < dd || (pd == dd && pi < id)) break;
        if (i == last) w = pd;
        bd[i] = pd;
        bi[i] = pi;
        --i;
      }
      bd[i] = dd;
      bi[i] = id;
      worst = w;
    };

    while (node >= 0) {
      const float bound = fminf(a.r2, worst);
      ++units;
      if (ptr >= 0) {
        // ---- member step: one distance test against sorted point ptr
        const P p = __ldg(pts + ptr);
        float diff = q[0] - p.x;
        float dd = diff * diff;
        diff = q[1] - p.y;
        dd = __fmaf_rn(diff, diff, dd);
        if constexpr (D == 3) {
          diff = q[2] - p.z;
          dd = __fmaf_rn(diff, diff, dd);
        }
        ++evals;
        if (dd <= bound) offer(ptr, dd);
        if (++ptr >= end) {
          node = leaf_miss;
          ptr = -1;
        }
        continue;
      }
      // ---- node step: descend / skip
      const int4 w0 = __ldg(a.nodes + 2 * node);
      const int4 w1 = __ldg(a.nodes + 2 * node + 1);
      float lo[D], hi[D];
      lo[0] = __int_as_float(w0.x);
      lo[1] = __int_as_float(w0.y);
      if constexpr (D == 3) {
        lo[2] = __int_as_float(w0.z);
        hi[0] = __int_as_float(w0.w);
        hi[1] = __int_as_float(w1.x);
        hi[2] = __int_as_float(w1.y);
      } else {
        hi[0] = __int_as_float(w0.z);
        hi[1] = __int_as_float(w0.w);
      }
      float bd2 = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const float g = fmaxf(fmaxf(lo[c] - q[c], q[c] - hi[c]), 0.0f);
        bd2 = c == 0 ? g * g : __fmaf_rn(g, g, bd2);
      }
      const bool overlap = bd2 <= bound;
      const int miss = w1.z;
      const int link = w1.w;  // left child, or a leaf's first member
      if (node < leaf_off) {
        node = overlap ? link : miss;
      } else if (link < 0) {
        // a one-member leaf whose box is its member's point: the plain
        // engine enters it and tests the member at the same bound (no
        // insertion in between), with d2 == bd2 bit for bit
        node = miss;
        if (overlap) {
          ++units;
          ++evals;
          offer(~link, bd2);
        }
      } else {
        const int lend = D == 2 ? w1.x : __ldg(a.leaf_end + (node - leaf_off));
        const int e = lend & ~kDenseBit;
        if (overlap && link < e) {
          ptr = link;  // enter the segment's members
          end = e;
          leaf_miss = miss;
        } else {
          node = miss;  // empty segments go straight to the rope
        }
      }
    }
  }
  a.evals[lane] = evals;
  a.iters[lane] = units / a.unroll + (units % a.unroll != 0 ? 1 : 0);
}

}  // namespace

// Launch the k-NN walk on `stream`: d in {2, 3}, k >= 1, m >= 2 segments;
// r2 the squared radius cap (+inf for none). Returns the first CUDA error
// (0 on success).
extern "C" int knn_launch(int d, int n_lanes, int m, int k, int unroll,
                          float r2, const float* q, const int* qid,
                          const void* nodes, const int* leaf_end,
                          const void* pts, const int* order, int* ids,
                          float* d2, int* evals, int* iters, void* stream) {
  KnnArgs a;
  a.n_lanes = n_lanes;
  a.m = m;
  a.k = k;
  a.unroll = unroll;
  a.r2 = r2;
  a.q = q;
  a.qid = qid;
  a.nodes = static_cast<const int4*>(nodes);
  a.leaf_end = leaf_end;
  a.pts = pts;
  a.order = order;
  a.ids = ids;
  a.d2 = d2;
  a.evals = evals;
  a.iters = iters;
  if (n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n_lanes + kBlock - 1) / kBlock;
  if (d == 2) {
    knn_kernel<2><<<grid, kBlock, 0, s>>>(a);
  } else {
    knn_kernel<3><<<grid, kBlock, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
