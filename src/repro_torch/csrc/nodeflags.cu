// Per-node "subtree holds a flagged leaf" flags of an LBVH, in one launch.
//
// Replaces no Pallas kernel. The reference computes this mask with the
// level-synchronous loop `propagate_leaf_flags` (src/repro/core/lbvh.py):
// each round ORs every internal node's two children, and the host reads
// whether anything changed. The port keeps that loop for CPU tensors; on
// the card it cost about eight launches and one host read a tree level, at
// every frontier sweep, the core and border masks and every level walk of
// the stream.
//
// Design: the output (2m - 1 bytes) is zeroed by one memset, then one
// thread takes one item. A flagged item climbs from its leaf (`n_int +
// leaf`) through `parent`, setting each node's flag, and stops at the first
// node already set or past the root. Items are leaves (`item_leaf` null)
// or points folded onto their leaves through `item_leaf` (the segment of
// each point), which takes the place of the segment maximum the loop's
// caller ran first.
//   * Exact with no atomics: a node's flag is only ever set by a thread that
//     then climbs on from it, so by the end of the launch every ancestor of
//     a set node is set, and only ancestors of flagged leaves are. An OR is
//     idempotent, so two threads racing up one path at most both climb it;
//     the output is the per-subtree OR, byte-equal to the loop's, whatever
//     the order.
//   * The stop test reads through L2 (`__ldcg`), where the other threads'
//     flags land, so a climb stops at a node another block already set
//     instead of at a stale L1 line.
//   * The work is bounded by the flagged items plus the nodes they flag:
//     a small frontier touches a few paths, not the tree.
// What bounds it on an H100: a climb is a chain of dependent loads (the
// flag, then `parent`), one tree level each, so the time is the memset of
// the output plus the latency of the longest climbs; bytes are the flags,
// the leaf of each flagged item, the parent of each flagged node and the
// output: 6 to 22 MB at 4M nodes, some microseconds at 3.35 TB/s, against
// 15 to 50 us measured.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    node_flags_kernel(int n_items, int n_int, const int* __restrict__ parent,
                      const uint8_t* __restrict__ flags,
                      const int* __restrict__ item_leaf, uint8_t* out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_items || flags[i] == 0) return;
  int node = n_int + (item_leaf != nullptr ? item_leaf[i] : i);
  while (node >= 0 && __ldcg(out + node) == 0) {
    out[node] = 1;
    node = __ldg(parent + node);
  }
}

}  // namespace

// Zero `out` (n_nodes bytes) and set each node's flag to the OR of the
// flags of the items under it, on `stream`. n_nodes = 2m - 1 for a tree of
// m leaves (internal nodes 0 .. m - 2, leaf k is node m - 1 + k); `parent`
// (n_nodes int32, -1 at the root); `flags` (n_items bytes, 0 or 1);
// `item_leaf` (n_items int32, each item's leaf) or null, then n_items = m
// and item k is leaf k. Returns the first CUDA error (0 on success).
extern "C" int nodeflags_launch(int n_nodes, int n_items, const int* parent,
                                const uint8_t* flags, const int* item_leaf,
                                uint8_t* out, void* stream) {
  if (n_nodes <= 0 || n_items < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(out, 0, n_nodes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items > 0) {
    const int grid = (n_items + kBlock - 1) / kBlock;
    node_flags_kernel<<<grid, kBlock, 0, s>>>(n_items, (n_nodes - 1) / 2,
                                              parent, flags, item_leaf, out);
  }
  return static_cast<int>(cudaGetLastError());
}
