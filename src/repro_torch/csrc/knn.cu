// The k-nearest-neighbour rope walk of the LBVH on Hopper: persistent
// threads, each walking one query lane at a time with its k-best list in
// registers, and taking the next lane when its own is done.
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
//     enters the leaf's members; else the rope (`miss`). The rope order is
//     the reference's (left child first, no nearest-child-first descent),
//     which fixes `evals`;
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
// distance is the box distance bit for bit, so the node step takes the
// test (two work units, one eval) and loads no point. The neighbor queries'
// index has one point a segment, so on that path every member test is
// such a leaf's and the walk is node steps alone.
//
// What bounds it on an H100: as for the walk kernel (csrc/walk.cu), the
// dependent chain of scattered gathers per work unit, one cache line per
// thread of a warp, not the memory rate or the float rate. In the rope
// order a lane's list starts with far points and improves all walk long,
// so most member tests insert (about 2,900 insertions in 15,000 work units
// a lane, hacc at full size, k = 16). What the design does about it:
//   * the k-best list in registers for k <= 16: bodies compiled for list
//     capacities 4, 8 and 16 (the runtime k at most the capacity; slots at
//     k and beyond are never read), insertion by an unrolled
//     compare-and-shift over compile-time slots, the k-th best distance and
//     id kept in registers for the gate and the bound. Above 16 the list is
//     the lane's rows of the outputs in device memory (the same steps);
//   * persistent blocks with lane refill a warp at a time: about as many
//     blocks as stay resident; once all threads of a warp are idle, one
//     atomic on a counter hands it its next lanes. Lane state never
//     crosses lanes, so the schedule changes no output. A lane's row, evals
//     and iters are written when its walk ends. csrc/walk.cu refills as
//     soon as 8 threads are idle; here a warp's 32 lanes are neighbours in
//     Morton order and start down the same left-first path from the root,
//     so their loads share cache lines, and refilling a few threads at a
//     time with far lanes loses that (measured on the H100, full hacc
//     k = 16, 2 node steps a trip: refill at 8 idle threads 333 ms, at 16
//     328 ms, a warp at a time 310 ms);
//   * per trip a thread takes up to kNodeSteps node steps, then, inside a
//     segment of several members, one batch of up to kBatch member points
//     loaded together and applied in order, each at the bound left by the
//     insertion before it (a k-NN lane tests every member of a segment).
//     Longer trips mean fewer refill ballots (2 steps 310 ms, 8 297 ms, 16
//     292 ms, 64 291 ms);
//   * fewer lanes than resident threads: each warp takes only
//     ceil(lanes / resident warps) lanes, so the lanes spread over every
//     SM instead of filling the first blocks (4,096 lanes in 32 full
//     blocks left 100 of 132 SMs idle).
// The schedule (kBlock, kBatch, kNodeSteps) is fixed at compile
// time; the launch picks the grid and the lanes a warp takes.
//
// Float discipline (compiled with --fmad=false): every squared distance is
// the first axis's square followed by one explicit fused multiply-add per
// further axis, in axis order, as the reference's compiled float32 code
// rounds its sum(diff * diff) (core/lbvh.py: sum_sq in the plain engine).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kBlock = 128;     // threads per block
constexpr int kBatch = 4;       // member points loaded together
constexpr int kNodeSteps = 16;  // node steps a thread takes per trip
constexpr int kDenseBit = static_cast<int>(0x80000000u);

struct KnnArgs {
  int n_lanes;
  int m;  // segments (leaves); internal nodes are 0 .. m-2, root 0
  int k;
  int unroll;
  int warp_lanes;  // lanes a warp walks at once (threads 0 .. warp_lanes-1)
  float r2;
  const float* __restrict__ q;        // (L, D)
  const int* __restrict__ qid;        // (L,) -1: inert lane
  const int4* __restrict__ nodes;     // (2m-1) records of two int4
  const int* __restrict__ leaf_end;   // (m,) seg_end | dense << 31
  const void* __restrict__ pts;       // (n,) float4 (d = 3) or float2
  const int* __restrict__ order;      // (n,) original id of sorted point
  int* next;                          // the next lane to hand out (0 at launch)
  int* __restrict__ ids;              // (L, k)
  float* __restrict__ d2;             // (L, k)
  int* __restrict__ evals;            // (L,)
  int* __restrict__ iters;            // (L,)
};

__device__ __forceinline__ bool better(float dd, int id, float sd, int si) {
  return dd < sd || (dd == sd && id < si);
}

// The k-best list in registers, CAP slots sorted by (d2, id); only slots
// 0 .. k-1 are the list. Every slot index is a compile-time constant after
// unrolling, so the arrays stay in registers.
template <int CAP>
struct RegList {
  float d[CAP];
  int i[CAP];

  __device__ __forceinline__ void reset(const KnnArgs&, int) {
#pragma unroll
    for (int s = 0; s < CAP; ++s) {
      d[s] = __int_as_float(0x7f800000);
      i[s] = -1;
    }
  }

  // Insert (dd, id), which is better than slot km1: the slots better than
  // it are a prefix, the others shift one slot down. Slots above km1 take
  // what is shifted out and never feed back into slots 0 .. km1. Leaves
  // slot km1 in (worst, wid).
  __device__ __forceinline__ void insert(float dd, int id, int km1,
                                         float& worst, int& wid) {
#pragma unroll
    for (int s = CAP - 1; s >= 0; --s) {
      const int t = s > 0 ? s - 1 : 0;
      const bool shift = s > 0 && better(dd, id, d[t], i[t]);
      const bool place = better(dd, id, d[s], i[s]);
      const float nd = shift ? d[t] : (place ? dd : d[s]);
      const int ni = shift ? i[t] : (place ? id : i[s]);
      d[s] = nd;
      i[s] = ni;
      if (s == km1) {
        worst = nd;
        wid = ni;
      }
    }
  }

  __device__ __forceinline__ void store(const KnnArgs& a, int lane) const {
    const size_t row = static_cast<size_t>(lane) * a.k;
#pragma unroll
    for (int s = 0; s < CAP; ++s) {
      if (s < a.k) {
        a.ids[row + s] = i[s];
        a.d2[row + s] = d[s];
      }
    }
  }
};

// The k-best list in the lane's rows of the outputs (any k).
struct MemList {
  float* d;
  int* i;

  __device__ __forceinline__ void reset(const KnnArgs& a, int lane) {
    const size_t row = static_cast<size_t>(lane) * a.k;
    d = a.d2 + row;
    i = a.ids + row;
    for (int s = 0; s < a.k; ++s) {
      d[s] = __int_as_float(0x7f800000);
      i[s] = -1;
    }
  }

  __device__ __forceinline__ void insert(float dd, int id, int km1,
                                         float& worst, int& wid) {
    int s = km1;
    float w = dd;  // slot km1 after the insertion
    int wi = id;
    while (s > 0) {
      const float pd = d[s - 1];
      const int pi = i[s - 1];
      if (!better(dd, id, pd, pi)) break;
      if (s == km1) {
        w = pd;
        wi = pi;
      }
      d[s] = pd;
      i[s] = pi;
      --s;
    }
    d[s] = dd;
    i[s] = id;
    worst = w;
    wid = wi;
  }

  __device__ __forceinline__ void store(const KnnArgs&, int) const {}
};

// CAP: the register list's capacity, or 0 for the list in device memory.
template <int D, int CAP>
__global__ void __launch_bounds__(kBlock) knn_kernel(const KnnArgs a) {
  using P = typename std::conditional<D == 3, float4, float2>::type;
  using List = typename std::conditional<(CAP > 0),
                                         RegList<(CAP > 0 ? CAP : 1)>,
                                         MemList>::type;
  const P* __restrict__ pts = static_cast<const P*>(a.pts);
  const int leaf_off = a.m - 1;
  const int km1 = a.k - 1;
  const float inf = __int_as_float(0x7f800000);
  const int tid = threadIdx.x & 31;  // threads 0 .. warp_lanes-1 take lanes

  List list;
  int lane = -1;  // the lane this thread walks; -1: none
  float q[D];
  int node = -1;      // current node; -1 once the walk is done
  int ptr = -1;       // next member to test; -1: at a node
  int end = 0;        // inside a segment: its member end and rope
  int leaf_miss = -1;
  int evals = 0, units = 0;
  float worst = inf;  // list slot k-1: the k-th best distance and its id
  int wid = -1;
  bool more = true;   // the counter may still hand out lanes (warp-uniform)

#pragma unroll
  for (int c = 0; c < D; ++c) q[c] = 0.0f;

  // A member within the bound: insert (dd, id) unless slot k-1 is strictly
  // better (dd <= bound <= worst, so only a tie at worst can refuse it).
  auto offer = [&](float dd, int id) {
    if (better(dd, id, worst, wid)) list.insert(dd, id, km1, worst, wid);
  };

  while (true) {
    // ---- refill: once the warp is idle, one atomic hands it new lanes
    if (__all_sync(kFullWarp, lane < 0)) {
      if (!more) break;
      int base = 0;
      if (tid == 0) base = atomicAdd(a.next, a.warp_lanes);
      base = __shfl_sync(kFullWarp, base, 0);
      more = base + a.warp_lanes < a.n_lanes;
      if (tid < a.warp_lanes) {
        const int l = base + tid;
        if (l < a.n_lanes) {
          lane = l;
#pragma unroll
          for (int c = 0; c < D; ++c) q[c] = a.q[l * D + c];
          node = a.qid[l] >= 0 ? 0 : -1;  // root = 0; -1: inert lane
          ptr = -1;
          evals = 0;
          units = 0;
          worst = inf;
          wid = -1;
          list.reset(a, l);
        }
      }
    }
    if (lane < 0) continue;

    // ---- node steps: descend / skip until a segment is entered
    if (node >= 0 && ptr < 0) {
#pragma unroll 1
      for (int s = 0; s < kNodeSteps; ++s) {
        const float bound = fminf(a.r2, worst);
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
        ++units;
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
            offer(bd2, __ldg(a.order + ~link));
          }
        } else {
          // d = 2 keeps a leaf's member end in the record, d = 3 beside it
          const int lend =
              D == 2 ? w1.x : __ldg(a.leaf_end + (node - leaf_off));
          const int e = lend & ~kDenseBit;
          if (overlap && link < e) {
            ptr = link;  // enter the segment's members
            end = e;
            leaf_miss = miss;
            break;
          }
          node = miss;  // empty segments go straight to the rope
        }
        if (node < 0) break;
      }
    }

    // ---- one batch of up to kBatch member tests, applied in order. The
    // points load together, and the original ids of the members within the
    // bound at the batch's start (a superset of those the list takes: the
    // bound only shrinks) load together after them.
    if (ptr >= 0) {
      const int nb = min(kBatch, end - ptr);
      P p[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < nb) {
          p[b] = __ldg(pts + ptr + b);
        } else {
          p[b] = P{};
        }
      }
      float dd[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        float diff = q[0] - p[b].x;
        float acc = diff * diff;
        diff = q[1] - p[b].y;
        acc = __fmaf_rn(diff, diff, acc);
        if constexpr (D == 3) {
          diff = q[2] - p[b].z;
          acc = __fmaf_rn(diff, diff, acc);
        }
        dd[b] = acc;
      }
      const float bound0 = fminf(a.r2, worst);
      int oid[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        oid[b] = (b < nb && dd[b] <= bound0) ? __ldg(a.order + ptr + b) : -1;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < nb && dd[b] <= fminf(a.r2, worst)) offer(dd[b], oid[b]);
      }
      evals += nb;
      units += nb;
      ptr += nb;
      if (ptr >= end) {
        node = leaf_miss;
        ptr = -1;
      }
    }

    // ---- a finished lane writes its outputs and frees the thread
    if (node < 0) {
      list.store(a, lane);
      a.evals[lane] = evals;
      a.iters[lane] = units / a.unroll + (units % a.unroll != 0 ? 1 : 0);
      lane = -1;
    }
  }
}

// Resident blocks on the whole card for this kernel, cached per kernel
// (one static per template instance) and device.
template <int D, int CAP>
int resident_blocks() {
  static int device = -1, blocks = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (device != dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, knn_kernel<D, CAP>,
                                                  kBlock, 0);
    device = dev;
    blocks = (per_sm > 0 ? per_sm : 1) * sms;
  }
  return blocks;
}

// Launches one block per resident slot with full warps, or, for fewer
// lanes than resident threads, as many lanes a warp as spread the lanes
// over all resident warps. Writes (grid, block, lanes a warp) to sched.
template <int D, int CAP>
void launch(KnnArgs a, cudaStream_t stream, int* sched) {
  constexpr int kWarps = kBlock / 32;
  const int resident = resident_blocks<D, CAP>();
  const long long resident_warps = static_cast<long long>(resident) * kWarps;
  int per_warp = 32;
  if (a.n_lanes < resident_warps * 32) {
    per_warp = static_cast<int>((a.n_lanes + resident_warps - 1) /
                                resident_warps);
  }
  a.warp_lanes = per_warp;
  const long long warps = (a.n_lanes + per_warp - 1) / per_warp;
  const long long wanted = (warps + kWarps - 1) / kWarps;
  const int grid = wanted < resident ? static_cast<int>(wanted) : resident;
  knn_kernel<D, CAP><<<grid, kBlock, 0, stream>>>(a);
  sched[0] = grid;
  sched[1] = kBlock;
  sched[2] = per_warp;
}

template <int D>
void launch_cap(const KnnArgs& a, int cap, cudaStream_t s, int* sched) {
  switch (cap) {
    case 4: launch<D, 4>(a, s, sched); break;
    case 8: launch<D, 8>(a, s, sched); break;
    case 16: launch<D, 16>(a, s, sched); break;
    default: launch<D, 0>(a, s, sched); break;
  }
}

}  // namespace

// Launch the k-NN walk on `stream`: d in {2, 3}, k >= 1, m >= 2 segments;
// cap the list body, 4, 8 or 16 (the register list, k <= cap) or 0 (the
// list in device memory, any k); r2 the squared radius cap (+inf for
// none); `next` one int32 of scratch, zeroed here on the stream before the
// launch. Writes (grid, block, lanes a warp) to sched[0..2]. Returns the
// first CUDA error (0 on success; cudaErrorInvalidValue for a cap that
// does not hold k).
extern "C" int knn_launch(int d, int cap, int n_lanes, int m, int k,
                          int unroll, float r2, const float* q,
                          const int* qid, const void* nodes,
                          const int* leaf_end, const void* pts,
                          const int* order, int* next, int* ids, float* d2,
                          int* evals, int* iters, void* stream, int* sched) {
  if (!(cap == 0 || cap == 4 || cap == 8 || cap == 16) ||
      (cap > 0 && k > cap) || k < 1 || unroll < 1 || (d != 2 && d != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KnnArgs a;
  a.n_lanes = n_lanes;
  a.m = m;
  a.k = k;
  a.unroll = unroll;
  a.warp_lanes = 32;
  a.r2 = r2;
  a.q = q;
  a.qid = qid;
  a.nodes = static_cast<const int4*>(nodes);
  a.leaf_end = leaf_end;
  a.pts = pts;
  a.order = order;
  a.next = next;
  a.ids = ids;
  a.d2 = d2;
  a.evals = evals;
  a.iters = iters;
  sched[0] = sched[1] = sched[2] = 0;
  if (n_lanes <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(next, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d == 2) {
    launch_cap<2>(a, cap, s, sched);
  } else {
    launch_cap<3>(a, cap, s, sched);
  }
  return static_cast<int>(cudaGetLastError());
}
