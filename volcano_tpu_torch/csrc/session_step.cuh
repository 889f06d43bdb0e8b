// The control logic of one allocate step over a class-compacted node
// list: which list a task sweeps, one thread's share of a full or a fast
// (repeated-row) step, and the state update at the pick.
//
// Shared by the CUDA session kernel (session_kernel.cu) and the host test
// shim, which drives these functions in a loop that plays the block's
// threads one after another (tests/test_torch_session_step.py).
//
// A class list holds the node ids of one feasibility class in ascending
// order (cls_nodes[cls_off[c] : cls_off[c+1]]), so a thread's first max
// over its list positions is also its lowest-node max, and the block
// argmax over (value, key) keeps the reference's lowest-index tie-break:
// a key packs (list position << 16) | node id, and within one list both
// halves rise together.  Node ids and positions stay below 2^15 (the
// shared-memory gate holds NK under 19,456 nodes).
//
// R = kWide selects the wide kernel's step: the lane count is read at
// run time (NodeState::R), the used lanes are read by node id at stride
// NK beside the planes in list order, and a key is the list position
// alone (any node count), its node read back from the list.
#pragma once

#include <string.h>

#include "session_math.cuh"

namespace vt {

// Key of "no feasible node" (the argmax's identity).
constexpr int kNoPick = 0x7fffffff;

VT_HD int pick_key(int pos, int node) { return (pos << 16) | node; }
VT_HD int key_pos(int key) { return key >> 16; }
VT_HD int key_node(int key) { return key & 0xffff; }

// The template lane count of the wide kernel's step.
constexpr int kWide = 0;

// Keys of the step with R lanes; ``list`` is the list the key indexes.
template <int R>
VT_HD int pick_key_of(int pos, int node) {
  return R == kWide ? pos : pick_key(pos, node);
}
template <int R>
VT_HD int key_pos_of(int key) {
  return R == kWide ? key : key_pos(key);
}
template <int R>
VT_HD int key_node_of(int key, const int* list) {
  if constexpr (R == kWide) {
    return list[key];
  } else {
    return key_node(key);
  }
}

VT_HD unsigned float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  unsigned u;
  memcpy(&u, &x, sizeof u);
  return u;
#endif
}

// Rows a and b equal bit for bit over their RC columns (resource lanes,
// class, active): the repeated-row test.
VT_HD bool same_row(const float* a, const float* b, int RC) {
  bool same = true;  // no short cut: the loads issue together
  for (int r = 0; r < RC; ++r) same = same & (float_bits(a[r]) == float_bits(b[r]));
  return same;
}

// The list a task with class column ``cls`` sweeps: [start, start + len)
// of cls_nodes.  A class outside [0, C) (truncated toward zero, as the
// reference's int() does) gets the empty list and places nothing.
VT_HD void task_list(float cls, int C, const int* cls_off, int& start, int& len) {
  start = 0;
  len = 0;
  if (cls > -1.0f && cls < static_cast<float>(C)) {
    const int c = static_cast<int>(cls);
    start = cls_off[c];
    len = cls_off[c + 1] - start;
  }
}

// What a sweep reads.  The read-only node planes come in list order: lnd
// is nd[:, cls_nodes] ([3R+2, LT]: base | alloc | used0 | count0, maxt at
// each list slot), so one list position's planes load beside its node id
// and neighbouring threads read neighbouring words.  The mutable state is
// by node id.
struct NodeState {
  const int* cls_nodes;  // [LT] node id of each list slot
  const float* lnd;      // [3R+2, LT] node planes in list order
  int LT;
  const float* used;     // [R, NK] used lanes, updated at each pick
  const float* cnt;      // [NK] pod count, updated at each pick
  int NK;
  int R;                 // lanes (read by the wide step only)
};

// Masked score of the node n at list slot q for a task of the list's
// class; least-requested in int32 where LrInt.
template <int R, bool LrInt>
VT_HD float list_score(const NodeState& s, const float* rr, const float* tol, float act, int q,
                       int n, const Weights& w) {
  if constexpr (R == kWide) {
    const float* lq = s.lnd + q;
    return masked_score<LrInt>(s.R, rr, tol, act, true, lq, lq + s.R * s.LT, s.LT,
                               s.used + n, s.NK, s.cnt[n], lq[(3 * s.R + 1) * s.LT], w);
  } else {
    float base[R], alloc[R], used[R];
    for (int r = 0; r < R; ++r) {
      base[r] = s.lnd[r * s.LT + q];
      alloc[r] = s.lnd[(R + r) * s.LT + q];
      used[r] = s.used[r * s.NK + n];
    }
    return masked_score<LrInt>(R, rr, tol, act, true, base, alloc, used, 1, s.cnt[n],
                               s.lnd[(3 * R + 1) * s.LT + q], w);
  }
}

// One thread's share of a step over the list at slots [start, start + L)
// of cls_nodes: list positions first, first + stride, ... .  A full step
// (redo < 0) scores every position and, when ``plane`` is given, stores
// each value there.  A fast step rescores position ``redo`` (node
// ``redo_node``, the previous pick, one of the calling thread's positions)
// into the plane and reads the thread's other positions from it: those
// first, so that the node id of their best loads while ``redo`` is
// rescored.  Out: the thread's first max as (value, key); (-inf, kNoPick)
// when none of its positions is feasible.
template <int R, bool LrInt>
VT_HD void sweep_list(const NodeState& s, int start, int L, int first, int stride, int redo,
                      int redo_node, float* plane, const float* rr, const float* tol, float act,
                      const Weights& w, float& bv, int& bk) {
  const int* nodes = s.cls_nodes + start;
  bv = -INFINITY;
  int bp = -1;
  int bn = -1;
  if (redo < 0) {
    for (int p = first; p < L; p += stride) {
      const int n = nodes[p];
      const float v = list_score<R, LrInt>(s, rr, tol, act, start + p, n, w);
      if (plane != nullptr) plane[p] = v;
      if (v > bv) {  // ascending positions: the first max
        bv = v;
        bp = p;
        bn = n;
      }
    }
  } else {
    for (int p = first; p < L; p += stride) {
      const float v = p == redo ? -INFINITY : plane[p];
      if (v > bv) {
        bv = v;
        bp = p;
      }
    }
    if (R != kWide && bp >= 0) bn = nodes[bp];
    const float v = list_score<R, LrInt>(s, rr, tol, act, start + redo, redo_node, w);
    plane[redo] = v;
    if (v > bv || (v == bv && redo < bp)) {  // the first max over all positions
      bv = v;
      bp = redo;
      bn = redo_node;
    }
  }
  bk = bp >= 0 ? pick_key_of<R>(bp, bn) : kNoPick;
}

// Place a task with resource row rr on node n; nR is the lane count of
// the wide step (R = kWide).
template <int R>
VT_HD void apply_pick(float* used, float* cnt, int NK, const float* rr, int n, int nR = R) {
  for (int r = 0; r < (R == kWide ? nR : R); ++r) used[r * NK + n] = used[r * NK + n] + rr[r];
  cnt[n] = cnt[n] + 1.0f;
}

}  // namespace vt
