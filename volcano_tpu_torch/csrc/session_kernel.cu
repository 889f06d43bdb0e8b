// One greedy allocate pass on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_session.py
// _make_kernel (launched by _pass_call): for each task in order, mask the
// nodes it fits, score them (binpack + least-requested + balanced), pick
// the lowest-index argmax and add the task to that node's state.  Results
// are bit-identical to ops/kernels.py _assign_step; the per-node
// arithmetic lives in session_math.cuh, the step's control logic in
// session_step.cuh.
//
// What bounds it: the scan is sequential — task k+1's scores depend on
// task k's pick — so every step is a sweep followed by a block-wide
// argmax.  The work is f32 operations (about 70 per scored node, six of
// them IEEE divisions) issued by one SM; the bytes are small (inputs are
// read once into L2, node state never leaves shared memory).  The design
// keeps all state on one SM and cuts the per-step work to what the step
// needs:
//   * one block of 1024 threads runs the whole pass as a loop over
//     tasks — the loop takes the place of the TPU's sequential grid;
//   * class-compacted node lists: a step sweeps only the nodes of the
//     task's feasibility class (cls_nodes[cls_off[c] : cls_off[c+1]],
//     ascending), threads striding over list positions; a node outside
//     the class is never loaded or scored;
//   * the read-only node planes come in list order (lnd = nd[:,
//     cls_nodes], gathered by the wrapper), so a position's planes load
//     beside its node id, not after it, and neighbouring threads read
//     neighbouring words;
//   * used lanes [R, NK] and pod counts [NK] stay resident in dynamic
//     shared memory for the whole pass ((R+1)*NK*4 bytes);
//   * the repeated-row fast path of the Pallas kernel: when the plane of
//     masked scores over the longest list fits beside the node state, it
//     lives in shared memory too, and a task whose row equals the
//     previous row bit for bit rescores only the previous pick (one
//     thread); every other thread keeps its best of the last step in
//     registers, and only the pick's warp redoes its warp argmax.  When
//     the plane does not fit, the same kernel sweeps the list at every
//     step (the wrapper decides from the sizes);
//   * the next task row and its list bounds are copied a whole step
//     ahead (cp.async, into a ring of three row buffers), off the serial
//     chain: a load into registers would not do, since a block barrier
//     waits for the thread's loads; the repeated-row test reads the
//     landed row before the step's first barrier;
//   * the argmax is warp shuffles over (value, key), then one warp over
//     the 32 warp results; a key packs (list position, node id), so the
//     pick carries its plane slot; thread 0 applies the update;
//   * least-requested runs in f32 or, for nodes outside the f32
//     floor-division envelope, in exact int32: a template flag beside R
//     (14 instances), so the f32 instances compile as they did before
//     the int mode.
// Two block barriers per task set the latency floor of a step.  One SM
// of 132 does the work: spreading a pass over a cluster of SMs is the
// next design step.
//
// The wide instances (R = vt::kWide, one per least-requested mode) take
// every session the shared-memory layout does not: node state beyond
// one block's shared memory (more than ~19,000 nodes at R = 2) or more
// than kMaxLanes lanes.  The same loop, with three changes: the used
// lanes and pod counts live in a global-memory scratch the wrapper
// allocates ((R+1)*NK*4 bytes, L2-resident at cluster sizes; the block's
// barriers order its stores for the other threads); the lane count is a
// run-time value and the task rows and tolerance sit in dynamic shared
// memory, the masked-score plane beside them where it fits and in a
// global scratch where it does not (each plane slot is only ever touched
// by one thread); a key is the list position alone, so node ids and
// list lengths have no 2^15 limit, and the pick's node is read back
// from the list by thread 0.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_argmax.cuh"
#include "session_math.cuh"
#include "session_step.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

using vt::warp_argmax;

// Task rows in flight: row t is read in slot t % kSlots while row t+1
// has landed and row t+2 is being copied.
constexpr int kSlots = 3;

// A 4-byte asynchronous copy from global to shared memory.  Unlike a load
// into a register, it is not waited for at a block barrier (a barrier
// completes every earlier load of the thread), only at cp.async.wait_all.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Read-only operands of one pass.
struct PassIn {
  const float* taskrow;   // [T, R+2]: resreq, class, active
  int T;
  const int* cls_off;     // [C+1] list bounds per class
  int C;
  const int* cls_nodes;   // [LT] node ids, ascending within a list
  const float* lnd;       // [3R+2, LT]: nd[:, cls_nodes], the planes in list order
  int LT;
  const float* nd;        // [3R+2, NK]: base | alloc | used0 | count0, maxt
  const float* tol;       // [R]
  const int* done;        // [1] or null: skip the pass
  int NK;
  int R;                  // lanes (read by the wide instances only)
  vt::Weights w;
};

// Outputs and scratch, allocated by the wrapper.
struct PassOut {
  int* tlist;   // [T, 2] scratch: each task's list start and length
  int* chosen;  // [T] node index or -1
  int* stats;   // [2] or null: full steps, fast steps
};

// gstate (wide instances): [R+1, NK] f32 scratch for the used lanes and
// pod counts; gplane: a global plane of plane_len scores, or null.
template <int R, bool LrInt>
__global__ void __launch_bounds__(kThreads, 1)
session_pass_kernel(PassIn in, PassOut out, int plane_len, float* gstate, float* gplane) {
  constexpr bool kWide = R == vt::kWide;
  const int nR = kWide ? in.R : R;
  const int RC = nR + 2;
  extern __shared__ float smem[];
  const int NK = in.NK;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_k[kWarps];
  __shared__ float srow_s[kWide ? 1 : kSlots * (R + 2)];
  __shared__ int slist[kSlots][2];    // the rows' list start and length
  __shared__ int ssame[kSlots];       // row equal to the row before it
  __shared__ int spick;          // key of the last pick, kNoPick after -1
  __shared__ float stol_s[kWide ? 1 : R];
  float* used;   // [R, NK]
  float* cnt;    // [NK]
  float* srow;   // [kSlots, RC]: task rows t, t+1 and t+2
  float* stol;   // [R]
  float* plane;  // [plane_len] masked scores, or null
  if constexpr (kWide) {
    used = gstate;
    cnt = gstate + static_cast<size_t>(nR) * NK;
    srow = smem;
    stol = smem + kSlots * RC;
    plane = plane_len > 0 ? (gplane != nullptr ? gplane : stol + nR) : nullptr;
  } else {
    used = smem;
    cnt = smem + static_cast<size_t>(R) * NK;
    srow = srow_s;
    stol = stol_s;
    plane = plane_len > 0 ? cnt + NK : nullptr;
  }

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = in.T;

  if (in.done != nullptr && *in.done != 0) {
    // the gang fixpoint settled: this round places nothing
    for (int t = tid; t < T; t += kThreads) out.chosen[t] = -1;
    if (out.stats != nullptr && tid < 2) out.stats[tid] = 0;
    return;
  }

  for (int t = tid; t < T; t += kThreads) {
    vt::task_list(in.taskrow[static_cast<size_t>(t) * RC + nR], in.C, in.cls_off,
                  out.tlist[2 * t], out.tlist[2 * t + 1]);
  }
  const float* used0 = in.nd + static_cast<size_t>(2 * nR) * NK;
  for (int i = tid; i < nR * NK; i += kThreads) used[i] = used0[i];
  for (int n = tid; n < NK; n += kThreads) cnt[n] = used0[nR * NK + n];
  for (int r = tid; r < nR; r += kThreads) stol[r] = in.tol[r];
  __syncthreads();  // tlist is read below, by warp 0

  const vt::NodeState ns{in.cls_nodes, in.lnd, in.LT, used, cnt, NK, nR};

  // warp 0 copies task k into slot k % kSlots: column c < RC from lane
  // c % 32, then its list start and length
  auto fetch = [&](int k) {
    if (k >= T) return;
    const int slot = k % kSlots;
    for (int c = lane; c < RC + 2; c += 32) {
      if (c < RC) {
        cp_async4(&srow[slot * RC + c], in.taskrow + static_cast<size_t>(k) * RC + c);
      } else {
        cp_async4(&slist[slot][c - RC], out.tlist + 2 * k + c - RC);
      }
    }
    cp_async_commit();
  };
  if (warp == 0) {
    fetch(0);
    cp_async_wait_all();
    fetch(1);
    if (lane == 0) {
      ssame[0] = 0;
      spick = vt::kNoPick;
    }
  }
  __syncthreads();

  float my_v = -INFINITY;  // this thread's best of its list positions
  int my_k = vt::kNoPick;
  int n_full = 0, n_fast = 0;  // thread 0's step counts
  for (int t = 0, cur = 0; t < T; ++t, cur = cur + 1 == kSlots ? 0 : cur + 1) {
    const int nxt = cur + 1 == kSlots ? 0 : cur + 1;
    const float* row = srow + cur * RC;
    const float act = row[nR + 1];
    const int start = slist[cur][0];
    const int len = slist[cur][1];
    const bool fast = plane != nullptr && ssame[cur] != 0;
    const int prev = spick;
    const int owner = prev == vt::kNoPick ? -1 : vt::key_pos_of<R>(prev) % kThreads;

    bool reduce = true;
    if (!fast) {
      if (act > 0.0f && len > 0) {
        vt::sweep_list<R, LrInt>(ns, start, len, tid, kThreads, -1, 0, plane, row, stol, act,
                                 in.w, my_v, my_k);
      } else {
        my_v = -INFINITY;
        my_k = vt::kNoPick;
      }
    } else {
      // only the previous pick changed: its owner rescores it; the other
      // warps' results from the last step stand
      reduce = owner >= 0 && warp == owner / 32;
      if (tid == owner) {
        vt::sweep_list<R, LrInt>(ns, start, len, tid, kThreads, vt::key_pos_of<R>(prev),
                                 vt::key_node_of<R>(prev, in.cls_nodes + start), plane, row,
                                 stol, act, in.w, my_v, my_k);
      }
    }
    if (reduce) {
      float bv = my_v;
      int bk = my_k;
      warp_argmax(bv, bk);
      if (lane == 0) {
        warp_v[warp] = bv;
        warp_k[warp] = bk;
      }
    }
    if (warp == 0 && t + 1 < T) {
      // task t+1 has landed (copied a step ago): test it against task t,
      // and start copying task t+2
      cp_async_wait_all();
      __syncwarp();
      if (lane == 0) ssame[nxt] = vt::same_row(srow + nxt * RC, row, RC);
      fetch(t + 2);
    }
    __syncthreads();

    if (warp == 0) {
      float bv = warp_v[lane];
      int bk = warp_k[lane];
      warp_argmax(bv, bk);
      if (lane == 0) {
        if (bv > -INFINITY) {  // some node is feasible
          const int n = vt::key_node_of<R>(bk, in.cls_nodes + start);
          vt::apply_pick<R>(used, cnt, NK, row, n, nR);
          out.chosen[t] = n;
          spick = bk;
        } else {
          out.chosen[t] = -1;
          spick = vt::kNoPick;
        }
        if (fast) {
          ++n_fast;
        } else {
          ++n_full;
        }
      }
    }
    __syncthreads();
  }
  if (out.stats != nullptr && tid == 0) {
    out.stats[0] = n_full;
    out.stats[1] = n_fast;
  }
}

template <int R, bool LrInt>
cudaError_t launch_mode(const PassIn& in, const PassOut& out, int plane_len, float* gstate,
                        float* gplane, cudaStream_t stream) {
  // shared layout: node state and plane; wide: task rows, tolerance and
  // the plane where it is not in global memory
  const size_t words =
      R == vt::kWide
          ? static_cast<size_t>(kSlots) * (in.R + 2) + in.R + (gplane != nullptr ? 0 : plane_len)
          : static_cast<size_t>(R + 1) * in.NK + plane_len;
  const size_t smem = words * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(session_pass_kernel<R, LrInt>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  session_pass_kernel<R, LrInt><<<1, kThreads, smem, stream>>>(in, out, plane_len, gstate,
                                                                gplane);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch(const PassIn& in, const PassOut& out, int plane_len, bool lr_int,
                   float* gstate, float* gplane, cudaStream_t stream) {
  return lr_int ? launch_mode<R, true>(in, out, plane_len, gstate, gplane, stream)
                : launch_mode<R, false>(in, out, plane_len, gstate, gplane, stream);
}

__device__ __forceinline__ long long global_ns() {
  long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// The serial chain every step of session_pass_kernel runs whatever the
// node count, timed in SM cycles on the pass's launch shape.  out:
//   [0] reps warp_argmax, all 32 warps at once (the argmax's first half)
//   [1] reps warp_argmax, warp 0 alone (its second half)
//   [2] reps block barriers back to back
//   [3] reps shared-memory store -> load round trips (the warp results,
//       the node update)
//   [4] thread 0 staging all T task rows into shared memory, each load's
//       address dependent on the row before (the next-row load of the
//       first design, which loaded it on the chain)
//   [5], [6] global-timer ns and SM cycles over the whole probe
// Summed per step, these are the pass's latency floor.
__global__ void __launch_bounds__(kThreads, 1)
step_probe_kernel(const float* __restrict__ taskrow, int T, int RC, int reps,
                  long long* __restrict__ out) {
  __shared__ float cell[kWarps];
  __shared__ float srow[vt::kMaxLanes + 2];
  const int tid = threadIdx.x;
  const long long ns0 = global_ns();
  const long long c0 = clock64();
  float bv = static_cast<float>((tid * 37) % 1000);
  int bi = tid;
  __syncthreads();

  long long t = clock64();
  for (int i = 0; i < reps; ++i) {
    warp_argmax(bv, bi);
    bv = bv + static_cast<float>(bi & 1);  // the next round depends on this one
  }
  if (tid == 0) out[0] = clock64() - t;
  __syncthreads();

  if (tid < 32) {
    t = clock64();
    for (int i = 0; i < reps; ++i) {
      warp_argmax(bv, bi);
      bv = bv + static_cast<float>(bi & 1);
    }
    if (tid == 0) out[1] = clock64() - t;
  }
  __syncthreads();

  t = clock64();
  for (int i = 0; i < reps; ++i) __syncthreads();
  if (tid == 0) out[2] = clock64() - t;

  if (tid == 0) {
    volatile float* v = cell;
    v[0] = bv;
    t = clock64();
    for (int i = 0; i < reps; ++i) v[0] = v[0] + 1.0f;
    out[3] = clock64() - t;

    volatile float* row = srow;
    int dep = 0;
    t = clock64();
    for (int k = 0; k < T; ++k) {
      const float* next = taskrow + static_cast<size_t>(k) * RC + dep;
      for (int r = 0; r < RC; ++r) row[r] = next[r];
      dep = static_cast<int>(row[0] * 0.0f);  // 0, but only once the row is in
    }
    out[4] = clock64() - t;
    out[5] = global_ns() - ns0;
    out[6] = clock64() - c0;
    cell[1] = bv + static_cast<float>(bi);  // keep the argmax chains live
  }
}

// One node's load-and-score latency on one thread, in SM cycles per node,
// each node's address dependent on the score before, and the score's
// cost with the whole block scoring at once.  out:
//   [0] thread 0: nodes 97 apart, planes from global memory (L2: each
//       line new), reps nodes
//   [1] thread 0: one node again and again (its lines in L1)
//   [2] thread 0: one node's planes already in registers (the score alone)
//   [3] all 1024 threads at once, each a chain of reps / 8 scores of its
//       own node from registers (the sweep's issue limit, where it binds)
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
score_probe_kernel(const float* __restrict__ nd, const float* __restrict__ rr,
                   const float* __restrict__ tol, int NK, int reps, vt::Weights w,
                   long long* __restrict__ out) {
  const float* base = nd;
  const float* alloc = nd + static_cast<size_t>(R) * NK;
  const float* used = nd + static_cast<size_t>(2 * R) * NK;
  const float* cnt = nd + static_cast<size_t>(3 * R) * NK;
  const float* maxt = nd + static_cast<size_t>(3 * R + 1) * NK;
  const int tid = threadIdx.x;
  float acc = 0.0f;
  if (tid == 0) {
    int n = 0;
    long long t = clock64();
    for (int i = 0; i < reps; ++i) {
      const float v = vt::masked_score(R, rr, tol, 1.0f, true, base + n, alloc + n, used + n,
                                       NK, cnt[n], maxt[n], w);
      acc = acc + v;
      n = (n + 97 + (v == 12345.5f ? 1 : 0)) % NK;
    }
    out[0] = clock64() - t;
    n = 0;
    t = clock64();
    for (int i = 0; i < reps; ++i) {
      const float v = vt::masked_score(R, rr, tol, 1.0f, true, base + n, alloc + n, used + n,
                                       NK, cnt[n], maxt[n], w);
      acc = acc + v;
      n = v == 12345.5f ? 1 : 0;
    }
    out[1] = clock64() - t;
  }
  const int n = tid % NK;
  float b[R], a[R], u[R];
  for (int r = 0; r < R; ++r) {
    b[r] = base[r * NK + n];
    a[r] = alloc[r * NK + n];
    u[r] = used[r * NK + n];
  }
  const float c = cnt[n], m = maxt[n];
  if (tid == 0) {
    const long long t = clock64();
    for (int i = 0; i < reps; ++i) {
      const float v = vt::masked_score(R, rr, tol, 1.0f, true, b, a, u, 1, c, m, w);
      acc = acc + v;
      u[0] = u[0] + (v == 12345.5f ? 1.0f : 0.0f);
    }
    out[2] = clock64() - t;
  }
  __syncthreads();
  const long long t = clock64();
  for (int i = 0; i < reps / 8; ++i) {
    const float v = vt::masked_score(R, rr, tol, 1.0f, true, b, a, u, 1, c, m, w);
    acc = acc + v;
    u[0] = u[0] + (v == 12345.5f ? 1.0f : 0.0f);
  }
  __syncthreads();
  if (tid == 0) out[3] = clock64() - t;
  if (acc == 12345.5f) out[4] = 1;  // keep the chains live
}

}  // namespace

// Launch the step probe on ``stream`` (out: 7 int64); returns the
// cudaError_t of the launch.
extern "C" int vt_step_probe(const float* taskrow, int T, int RC, int reps, long long* out,
                             void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  step_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(taskrow, T, RC,
                                                                          reps, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch the score probe for R = 2 lanes on ``stream`` (out: 5 int64).
// Returns the cudaError_t of the launch.
extern "C" int vt_score_probe(const float* nd, const float* rr, const float* tol, int NK,
                              int reps, float w_bp, float w_cpu, float w_mem, float w_scalar,
                              float w_lr, float w_bal, long long* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const vt::Weights w{w_bp, w_cpu, w_mem, w_scalar, w_lr, w_bal};
  score_probe_kernel<2><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(nd, rr, tol, NK,
                                                                              reps, w, out);
  return static_cast<int>(cudaGetLastError());
}

// Launch one pass on ``stream``.  ``lnd`` is nd[:, cls_nodes] ([3R+2, LT],
// LT = len(cls_nodes)), gathered by the caller.  ``lr_int`` nonzero scores
// least-requested by exact int32 division (the LrInt instances).
// ``plane_len`` > 0 keeps a plane of that many masked scores (at least
// the longest list) for the repeated-row fast path; 0 sweeps the list at
// every step.  ``gstate`` non-null ([R+1, NK] f32 scratch) runs the wide
// instance, any R >= 2, its node state there; ``gplane`` non-null
// ([plane_len] f32) puts its plane in global memory.  Null ``gstate``
// runs the shared-memory layout, the plane beside the node state.
// Returns the cudaError_t of the launch (0 on success): a launch refused
// for its shared memory never runs, and only cudaGetLastError reports
// it; cudaErrorInvalidValue for a lane count the shared layout has no
// instance for (2 <= R <= vt::kMaxLanes).
extern "C" int vt_session_pass(const float* taskrow, int T, int R, const int* cls_off, int C,
                               const int* cls_nodes, const float* lnd, int LT,
                               const float* nd, const float* tol, const int* done, int NK, float w_bp, float w_cpu, float w_mem,
                               float w_scalar, float w_lr, float w_bal, int lr_int, int plane_len,
                               float* gstate, float* gplane, int* tlist, int* chosen, int* stats,
                               void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PassIn in{taskrow, T,  cls_off, C,    cls_nodes, lnd, LT, nd, tol, done,
                  NK,      R,  vt::Weights{w_bp, w_cpu, w_mem, w_scalar, w_lr, w_bal}};
  const PassOut out{tlist, chosen, stats};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool li = lr_int != 0;
  if (gstate != nullptr) {
    err = R >= 2 ? launch<vt::kWide>(in, out, plane_len, li, gstate, gplane, s)
                 : cudaErrorInvalidValue;
    return static_cast<int>(err);
  }
  switch (R) {
    case 2: err = launch<2>(in, out, plane_len, li, nullptr, nullptr, s); break;
    case 3: err = launch<3>(in, out, plane_len, li, nullptr, nullptr, s); break;
    case 4: err = launch<4>(in, out, plane_len, li, nullptr, nullptr, s); break;
    case 5: err = launch<5>(in, out, plane_len, li, nullptr, nullptr, s); break;
    case 6: err = launch<6>(in, out, plane_len, li, nullptr, nullptr, s); break;
    case 7: err = launch<7>(in, out, plane_len, li, nullptr, nullptr, s); break;
    case 8: err = launch<8>(in, out, plane_len, li, nullptr, nullptr, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
