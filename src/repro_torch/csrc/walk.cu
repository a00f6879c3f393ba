// The rope walk of the LBVH on Hopper: persistent threads, each walking
// one query lane at a time and taking the next lane when its own is done.
//
// Replaces the Pallas kernel `_walk_kernel` (src/repro/kernels/traverse.py,
// launched by `_run` through `pallas_call`). Each lane walks the tree
// without a stack, following the ropes (`miss`), until it has nothing left
// to visit, for an `intersects(sphere(eps))` batch:
//   * node test: box_dist2(q, box) <= r2, optionally with range_r >= rank,
//     and a node mask chosen per lane between node_mask and node_mask_wide;
//   * leaf members: sum over axes of (q - p)^2 <= r2;
//   * visitor, inlined: count, minlabel or countminlabel, with the
//     dense-segment short-circuit.
// The steps are those of `make_step` in src/repro_torch/core/traversal.py,
// in the same order, so acc, hits and evals equal the plain engine's. The
// plain engine runs `unroll` work units (node steps and member tests) per
// loop trip and stops a lane at the first unit after which it is done, so
// a lane that does U units takes ceil(U / unroll) trips: the kernel counts
// units and writes that as `iters`, and `unroll` does not shape its loop.
//
// What bounds it on an H100: neither the memory rate nor the float rate.
// Every work unit is a dependent chain of gathers (node -> record -> next
// node, or segment -> points), and each thread of a warp gathers from its
// own place in the index, so a warp-wide load touches up to 32 cache lines
// and the L1 serves it one line at a time: measured, the time follows the
// number of such lines (about one per member test and two per node step
// on the hacc first pass), not the bytes. What the design does about it:
//   * packed index (built once per index, kernels/walkpack.py): a node is
//     one 32-byte record read with two 16-byte loads (box corners, rope,
//     left child or first member); a leaf's member end and dense flag sit in
//     the record for d = 2 and in a side array for d = 3; points are float4
//     (d = 3) or float2 (d = 2), one load each;
//   * batched member tests: entering a segment keeps its end, dense flag
//     and rope in registers; each trip loads up to kBatch members' points
//     at once, so kBatch loads are in flight where the one-member step had
//     one, loads value and gather mask only for the members within eps
//     (most tests miss), then applies them in order and stops exactly where
//     the one-member walk stops;
//   * one-member leaves whose box is the member's point (marked in the
//     packed record) take their member test from the node step itself;
//   * lane refill: about as many blocks as stay resident; once kRefill
//     threads of a warp have finished their lanes, one atomic on a global
//     counter hands them that many new lanes, so a warp is no longer as
//     slow as its slowest first lane. Lane state never crosses lanes, so
//     the schedule changes no output;
//   * per trip a thread takes up to kNodeSteps node steps, then one batch
//     of members if it is inside a segment.
// The block size is a launch argument (the reference's lane tile: 64,
// 128, 256 or 512 threads; the kernel uses no shared memory, and every
// block size gives the same outputs). Each body is compiled once for each
// bound of 64, 128, 256 and 512 threads (`__launch_bounds__`), and a
// launch takes the smallest bound that holds its block: under one bound
// of 512 the compiler gave the block of 128 up to 4 more registers a
// thread (60 against 56), so each block size keeps the registers it gets
// alone. kBatch, kRefill and kNodeSteps are fixed at compile time.
//
// Float discipline (compiled with --fmad=false, so the compiler fuses
// nothing on its own): every squared distance is the first axis's square
// followed by one explicit fused multiply-add per further axis, in axis
// order, over exactly d axes. That is how the reference's compiled float32
// code rounds its sum(diff * diff) (measured against the JAX walk on the
// host), and how the plain engine rounds it (core/lbvh.py: sum_sq).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCount = 0;
constexpr int kMinLabel = 1;
constexpr int kCountMinLabel = 2;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxBlock = 512;  // the largest block a launch may ask for
constexpr int kBatch = 4;       // member tests loaded together
constexpr int kRefill = 8;      // idle threads of a warp that take new lanes
constexpr int kNodeSteps = 2;   // node steps a thread takes per trip
constexpr int kDenseBit = static_cast<int>(0x80000000u);

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
  const int* __restrict__ root;  // per-lane start node; null: the root, 0
  const int* __restrict__ self_id;
  const uint8_t* __restrict__ dense;
  const int* __restrict__ rank;
  const uint8_t* __restrict__ wide;
  const void* __restrict__ acc0;
  const int* __restrict__ hits0;
  // packed index
  const int4* __restrict__ nodes;    // (2m-1) records of two int4
  const int* __restrict__ leaf_end;  // (m,) seg_end | dense << 31
  const void* __restrict__ pts;      // (n,) float4 (d = 3) or float2
  // minlabel kinds: per member value and gather masks
  const void* __restrict__ vals;
  const uint8_t* __restrict__ mask;
  const uint8_t* __restrict__ mask_wide;
  const int* __restrict__ range_r;
  const uint8_t* __restrict__ node_mask;
  const uint8_t* __restrict__ node_mask_wide;
  // scratch: the next lane to hand out (zero at launch)
  int* next;
  // outputs
  void* acc;
  int* hits;
  int* evals;
  int* iters;
};

template <int KIND, typename V, int D, int MAXB>
__global__ void __launch_bounds__(MAXB) walk_kernel(const WalkArgs a) {
  using P = typename std::conditional<D == 3, float4, float2>::type;
  const P* __restrict__ pts = static_cast<const P*>(a.pts);
  const V* __restrict__ vals = static_cast<const V*>(a.vals);
  const int leaf_off = a.m - 1;
  const V cap_v = static_cast<V>(a.cap);
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;

  int lane = -1;  // the lane this thread walks; -1: none
  float q[D];
  int self_id = -1, rank = 0;
  bool dense = false;
  const uint8_t* __restrict__ nmask = a.node_mask;
  const uint8_t* __restrict__ gmask = a.mask;  // the lane's gather mask
  V acc = 0;
  int hits = 0;
  int node = -1;      // current node; the leaf while inside a segment
  int ptr = -1;       // next member to test; -1: at a node
  int end = 0;        // inside a segment: its member end, dense flag, rope
  bool dseg = false;
  int leaf_miss = -1;
  int evals = 0, units = 0;
  bool more = true;   // the counter may still hand out lanes (warp-uniform)

#pragma unroll
  for (int k = 0; k < D; ++k) q[k] = 0.0f;

  while (true) {
    // ---- refill: one atomic hands the warp's idle threads new lanes
    const unsigned idle = __ballot_sync(kFullWarp, lane < 0);
    if (idle == kFullWarp && !more) break;
    const int n_idle = __popc(idle);
    if (more && (n_idle >= kRefill || idle == kFullWarp)) {
      const int leader = __ffs(idle) - 1;
      int base = 0;
      if ((threadIdx.x & 31) == leader) base = atomicAdd(a.next, n_idle);
      base = __shfl_sync(kFullWarp, base, leader);
      more = base + n_idle < a.n_lanes;
      if (lane < 0) {
        const int l = base + __popc(idle & below);
        if (l < a.n_lanes) {
          lane = l;
#pragma unroll
          for (int k = 0; k < D; ++k) q[k] = a.q[l * D + k];
          self_id = a.self_id[l];
          dense = a.dense[l] != 0;
          rank = a.rank[l];
          const bool wide = a.wide[l] != 0;
          nmask = (a.dual_nodes && wide) ? a.node_mask_wide : a.node_mask;
          gmask = (KIND == kMinLabel && a.dual_gather && wide) ? a.mask_wide
                                                                : a.mask;
          acc = static_cast<const V*>(a.acc0)[l];
          hits = a.hits0[l];
          // the root (0, or the lane's own tree's root in a forest of
          // trees packed into one index); -1: inert lane
          node = a.qid[l] >= 0 ? (a.root != nullptr ? a.root[l] : 0) : -1;
          ptr = -1;
          evals = 0;
          units = 0;
        }
      }
    }
    if (lane < 0) continue;

    // The visitor's hook for one member test: the count saturates at cap,
    // the minlabel kinds take the min value over gathered members. Returns
    // whether the walk leaves the segment (dense short-circuit) or, for
    // count, ends (cap reached).
    auto visit = [&](int j, bool hit, bool gathered, V val) -> bool {
      if constexpr (KIND == kCount) {
        const V inc = hit ? 1 : 0;
        acc = acc + inc < cap_v ? acc + inc : cap_v;
        hits += (hit && j != self_id) ? 1 : 0;
        return acc >= cap_v;  // CountVisitor.done: the lane ends here
      } else {
        const bool ok = hit && gathered;
        if (ok) acc = val < acc ? val : acc;
        if constexpr (KIND == kMinLabel) {
          hits += (ok && j != self_id) ? 1 : 0;
          return ok && dseg;
        } else {
          const int h = hits + ((ok && j != self_id) ? 1 : 0);
          hits = h < a.cap ? h : a.cap;
          return ok && dseg && (dense || hits >= a.cap);
        }
      }
    };

    // ---- node steps: descend / skip until a segment is entered
    if (node >= 0 && ptr < 0 && !(KIND == kCount && acc >= cap_v)) {
      // kept rolled: unrolled, the walks of both main-path runs take 4% to
      // 10% longer on an H100 (PERF.md, section 6)
#pragma unroll 1
      for (int s = 0; s < kNodeSteps; ++s) {
        const bool leaf = node >= leaf_off;
        const int4 w0 = __ldg(a.nodes + 2 * node);
        const int4 w1 = __ldg(a.nodes + 2 * node + 1);
        const bool mask_ok = !a.has_node_mask || __ldg(nmask + node) != 0;
        const bool range_ok =
            !a.use_range_mask || __ldg(a.range_r + node) >= rank;
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
        for (int k = 0; k < D; ++k) {
          const float g = fmaxf(fmaxf(lo[k] - q[k], q[k] - hi[k]), 0.0f);
          bd2 = k == 0 ? g * g : __fmaf_rn(g, g, bd2);
        }
        const bool overlap = bd2 <= a.r2 && mask_ok && range_ok;
        const int miss = w1.z;
        const int link = w1.w;  // left child, or a leaf's first member
        ++units;
        if (!leaf) {
          node = overlap ? link : miss;
        } else if (link < 0) {
          // a one-member leaf whose box is its member's point: the member
          // test's squared distance is bd2 bit for bit (|x|^2 == x^2), so
          // an overlap is a hit and the test needs no point load
          node = miss;
          if (overlap) {
            const int j = ~link;
            bool gathered = false;
            V val = 0;
            if constexpr (KIND != kCount) {
              gathered = __ldg(gmask + j) != 0;
              val = __ldg(vals + j);
            }
            ++units;
            ++evals;
            if (visit(j, true, gathered, val) && KIND == kCount) break;
          }
        } else {
          // d = 2 keeps a leaf's member end in the record, d = 3 beside it
          const int lend =
              D == 2 ? w1.x : __ldg(a.leaf_end + (node - leaf_off));
          const int e = lend & ~kDenseBit;
          if (overlap && link < e) {
            ptr = link;  // enter the segment's members
            end = e;
            dseg = (lend & kDenseBit) != 0;
            leaf_miss = miss;
            break;
          }
          node = miss;  // empty segments go straight to the rope
        }
        if (node < 0) break;
      }
    }

    // ---- one batch of up to kBatch member tests, applied in order. The
    // points load together; a minlabel kind then loads value and gather
    // mask only for the members within eps (the others do not reach the
    // visitor).
    if (ptr >= 0) {
      const int nb = min(kBatch, end - ptr);
      P p[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < nb) p[i] = __ldg(pts + ptr + i);
      }
      bool hit[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        float diff = q[0] - p[i].x;
        float d2 = diff * diff;
        diff = q[1] - p[i].y;
        d2 = __fmaf_rn(diff, diff, d2);
        if constexpr (D == 3) {
          diff = q[2] - p[i].z;
          d2 = __fmaf_rn(diff, diff, d2);
        }
        hit[i] = i < nb && d2 <= a.r2;
      }
      bool gathered[kBatch];
      V val[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        gathered[i] = false;
        val[i] = 0;
        if constexpr (KIND != kCount) {
          if (hit[i]) {
            gathered[i] = __ldg(gmask + ptr + i) != 0;
            val[i] = __ldg(vals + ptr + i);
          }
        }
      }
      int applied = 0;
      bool stop = false;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i >= nb) break;
        ++applied;
        if (visit(ptr + i, hit[i], gathered[i], val[i])) {
          stop = true;
          break;
        }
      }
      evals += applied;
      units += applied;
      ptr += applied;
      if (stop || ptr >= end) {
        node = leaf_miss;
        ptr = -1;
      }
    }

    // ---- a finished lane writes its outputs and frees the thread
    if (node < 0 || (KIND == kCount && acc >= cap_v)) {
      static_cast<V*>(a.acc)[lane] = acc;
      a.hits[lane] = hits;
      a.evals[lane] = evals;
      a.iters[lane] = units / a.unroll + (units % a.unroll != 0 ? 1 : 0);
      lane = -1;
    }
  }
}

// Resident blocks on the whole card for this kernel at `block` threads a
// block, cached per kernel (statics per template instance), block size and
// device.
template <int KIND, typename V, int D, int MAXB>
int resident_blocks(int block) {
  static int device[MAXB / 32 + 1] = {};  // device + 1; 0: not known
  static int blocks[MAXB / 32 + 1] = {};
  const int slot = block / 32;
  int dev = 0;
  cudaGetDevice(&dev);
  if (device[slot] != dev + 1) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, walk_kernel<KIND, V, D, MAXB>, block, 0);
    blocks[slot] = (per_sm > 0 ? per_sm : 1) * sms;
    device[slot] = dev + 1;
  }
  return blocks[slot];
}

// Launches one block per resident slot, or fewer for few lanes; returns
// the grid size.
template <int KIND, typename V, int D, int MAXB>
int launch_bound(const WalkArgs& a, int block, cudaStream_t stream) {
  const int resident = resident_blocks<KIND, V, D, MAXB>(block);
  const int wanted = (a.n_lanes + block - 1) / block;
  const int grid = wanted < resident ? wanted : resident;
  walk_kernel<KIND, V, D, MAXB><<<grid, block, 0, stream>>>(a);
  return grid;
}

// The body compiled for the smallest bound that holds `block`.
template <int KIND, typename V, int D>
int launch(const WalkArgs& a, int block, cudaStream_t s) {
  if (block <= 64) return launch_bound<KIND, V, D, 64>(a, block, s);
  if (block <= 128) return launch_bound<KIND, V, D, 128>(a, block, s);
  if (block <= 256) return launch_bound<KIND, V, D, 256>(a, block, s);
  return launch_bound<KIND, V, D, kMaxBlock>(a, block, s);
}

template <int KIND, typename V>
int launch_d(const WalkArgs& a, int d, int block, cudaStream_t s) {
  return d == 2 ? launch<KIND, V, 2>(a, block, s)
                : launch<KIND, V, 3>(a, block, s);
}

int launch_any(int kind, int vals_f32, int d, int block, const WalkArgs& a,
               cudaStream_t s) {
  if (kind == kCount) return launch_d<kCount, int>(a, d, block, s);
  if (kind == kMinLabel) {
    return vals_f32 ? launch_d<kMinLabel, float>(a, d, block, s)
                    : launch_d<kMinLabel, int>(a, d, block, s);
  }
  return vals_f32 ? launch_d<kCountMinLabel, float>(a, d, block, s)
                  : launch_d<kCountMinLabel, int>(a, d, block, s);
}

}  // namespace

// Launch the walk on `stream`. kind: 0 count, 1 minlabel, 2 countminlabel;
// vals_f32: vals/acc are float32 (else int32; count is always int32);
// d in {2, 3}; block: threads a block, a multiple of 32 up to 512 (else
// cudaErrorInvalidValue); `next` points to one int32 of scratch, zeroed
// here on the stream before the launch. Writes the grid size used
// (resident blocks, capped by the lanes) to *grid_out when it is not null.
// `root` (may be null: every lane starts at node 0) gives each lane its
// start node. Returns the first CUDA error (0 on success).
extern "C" int walk_launch(
    int kind, int vals_f32, int d, int block, int unroll, int use_range_mask,
    int has_node_mask, int dual_nodes, int dual_gather, int n_lanes, int m,
    float r2, int cap, const float* q, const int* qid, const int* root,
    const int* self_id,
    const uint8_t* dense, const int* rank, const uint8_t* wide,
    const void* acc0, const int* hits0, const void* nodes,
    const int* leaf_end, const void* pts, const void* vals,
    const uint8_t* mask, const uint8_t* mask_wide, const int* range_r,
    const uint8_t* node_mask, const uint8_t* node_mask_wide, int* next,
    void* acc, int* hits, int* evals, int* iters, void* stream,
    int* grid_out) {
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
  a.root = root;
  a.self_id = self_id;
  a.dense = dense;
  a.rank = rank;
  a.wide = wide;
  a.acc0 = acc0;
  a.hits0 = hits0;
  a.nodes = static_cast<const int4*>(nodes);
  a.leaf_end = leaf_end;
  a.pts = pts;
  a.vals = vals;
  a.mask = mask;
  a.mask_wide = mask_wide;
  a.range_r = range_r;
  a.node_mask = node_mask;
  a.node_mask_wide = node_mask_wide;
  a.next = next;
  a.acc = acc;
  a.hits = hits;
  a.evals = evals;
  a.iters = iters;
  if (n_lanes <= 0) return 0;
  if (block < 32 || block > kMaxBlock || block % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = launch_any(kind, vals_f32, d, block, a, s);
  if (grid_out != nullptr) *grid_out = grid;
  return static_cast<int>(cudaGetLastError());
}
