// The in-queue preempt pass on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/preempt_pallas.py
// _make_preempt_kernel (launched by _preempt_call): one launch replays
// the whole pass over a static slot schedule built on the host
// (build_schedule_slots) — BEGIN / ATTEMPT / END per starving job (a
// statement that commits only if the job ends pipelined) and one BURN
// per (queue, job) for the under-request sweep.  An attempt that fires
// marks the victims each node could give up, validates every node
// (future-idle plus the eligible victims' requests covers the request,
// pod-count headroom, class feasibility), takes the lowest-index best
// node by the static score, evicts victims on it in slot order until the
// request fits, and pipelines the preemptor there.  Results are
// bit-identical to ops/preempt_pack.py preempt_dense; the per-node
// arithmetic lives in preempt_math.cuh and session_math.cuh, the pass's
// control logic in preempt_step.cuh.
//
// What bounds it: the replay is sequential — each attempt reads the
// state the previous one left — so every fired attempt is a sweep, a
// block-wide argmax and a drain on one node, and every slot that does not
// fire is a few dependent loads on one thread.  The bytes are small (the
// inputs, ~3 MB at 10k nodes, sit in the 50 MB L2) and so are the
// operations; the serial chain of loads and barriers sets the floor once
// the sweeps are cut to what changed.  The design:
//   * one block of 1024 threads; thread 0 walks the schedule alone and
//     hands the block only the attempts that fire (one barrier), so
//     BEGIN, END, BURN and attempts that do not fire cost no barrier; it
//     reads each slot's job cursor and counts at once and the next
//     slot's row a slot ahead (across fired attempts too);
//   * queue-compacted slot lists: an attempt sweeps only the nodes that
//     hold a victim of its queue, and at each only that queue's slots
//     (qnode / qslot, ascending, derived from vjob on the card by the
//     wrapper);
//   * the repeated-attempt fast path of the Pallas kernel, widened: the
//     masked validity+score of every list position stays in shared memory
//     (the plane), each thread keeps its best of the last sweep in
//     registers, and an attempt with the key of the last one (class,
//     score class, priority, queue; the same job, or two jobs that own no
//     victim) rescores only the dirty positions — the last pick and the
//     nodes of an evicted victim's job whose gang allowance can flip —
//     on their owner threads, whose warps alone redo the warp argmax.
//     Where the plane does not fit, the same kernel sweeps the whole list
//     at every attempt (the wrapper decides from the sizes);
//   * per-slot planes in list order (the victim's job, priority, queue,
//     min_available and request), built at launch, so a list position's
//     slots load together and eligibility gathers only the eviction flag
//     and the job's ready count;
//   * the drain, on the chain, loads the pick's slots and state before
//     it stores anything, keeps that state in registers and leaves the
//     pick's new value in the plane from them, so a fast attempt's pick
//     owner reloads nothing; counts and ready/waiting updates are
//     reductions, which thread 0 does not wait for;
//   * the mutable state does not fit one block's shared memory (future
//     idle, pod counts and eviction flags are ~21 words per node, 849 KB
//     at 10k nodes), so it lives in global memory (L2-resident), written
//     by the wrapper's scratch tensors and never by the host;
//   * node scores are static (evict and pipeline never move ``used``):
//     one plane per distinct request row is computed at launch, or the
//     score is computed inline past SCORE_CLASS_CAP rows;
//   * a statement rollback replays an undo journal of what the statement
//     touched instead of copying the whole state at every BEGIN;
//   * the drain and the journal touch one node: thread 0 runs them.
// One SM of 132 does the work.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_argmax.cuh"
#include "preempt_math.cuh"
#include "preempt_step.cuh"
#include "session_math.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
preempt_pass_kernel(vt::PreemptIn in, vt::PreemptState st, int plane_len) {
  extern __shared__ float plane_smem[];
  float* plane = plane_len > 0 ? plane_smem : nullptr;  // [plane_len] masked values
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float srow[R + 2];  // the firing attempt's task row
  __shared__ float stol[R];
  __shared__ vt::Attempt sat;    // the firing attempt
  __shared__ int sfire;          // its task, -1: the schedule is done
  __shared__ int sfast;          // it reuses the plane
  __shared__ vt::Dirty sdirty;   // what the last drain dirtied

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NK = in.NK;
  const int J = in.J;
  const float* used = in.nd;
  const float* alloc = in.nd + static_cast<size_t>(R) * NK;
  const float* fi0 = in.nd + static_cast<size_t>(2 * R) * NK;
  const float* ncnt0 = in.nd + static_cast<size_t>(3 * R) * NK;

  // session open: state from the operands, static score planes, per-slot
  // planes
  for (int i = tid; i < R * NK; i += kThreads) st.fi[i] = fi0[i];
  for (int n = tid; n < NK; n += kThreads) st.ncnt[n] = ncnt0[n];
  for (int i = tid; i < in.K * NK; i += kThreads) st.evicted[i] = 0;
  for (int i = tid; i < in.KQ * in.LQ; i += kThreads) vt::list_planes<R>(in, st, i);
  for (int i = tid; i < in.P; i += kThreads) st.pipelined[i] = -1;
  for (int i = tid; i < J; i += kThreads) {
    st.cursor[i] = in.jobi[i];
    st.ready[i] = in.jobf[i];
    st.wait[i] = in.jobf[J + i];
  }
  for (int i = tid; i < in.SC * NK; i += kThreads) {
    const int c = i / NK;
    const int n = i - c * NK;
    st.spre[i] = vt::node_score(R, in.screq + c * R, alloc + n, used + n, NK, in.w);
  }
  if (tid < R) stol[tid] = in.tol[tid];
  if (tid < 5) st.stats[tid] = 0;
  if (tid == 0) sdirty = vt::clean();
  __syncthreads();

  vt::Journal jr;    // thread 0's
  vt::PlaneKey key;  // thread 0's: the key the plane holds
  vt::Walk w;        // thread 0's place in the schedule
  if (tid == 0) vt::load_slot(in, w);
  float my_v = -INFINITY;  // this thread's best of its list positions
  int my_i = vt::kNoPos;
  for (;;) {
    if (tid == 0) {
      int j = 0;
      const int p = vt::walk<R>(in, st, jr, key, w, j);
      sfire = p;
      if (p >= 0) {
        for (int r = 0; r < R + 2; ++r) srow[r] = in.ptask[p * (R + 2) + r];
        const vt::Attempt a = vt::attempt_of<R>(in, p, j, srow);
        const bool fast = plane != nullptr && in.SC > 0 && vt::same_key(key, a);
        key = vt::key_of(a);
        sat = a;
        sfast = fast;
        vt::add_to(&st.stats[0], 1);
        if (fast) vt::add_to(&st.stats[4], 1);
      }
    }
    __syncthreads();
    if (sfire < 0) break;
    const vt::Attempt a = sat;

    bool reduce = true;
    if (sfast == 0) {
      vt::sweep_full<R>(in, st, a, srow, stol, tid, kThreads, plane, my_v, my_i);
    } else {
      // only the dirty positions changed: their owners rescore them; the
      // other warps' results from the last attempt stand
      const bool touched =
          vt::sweep_dirty<R>(in, st, a, srow, stol, tid, kThreads, plane, sdirty, my_v, my_i);
      reduce = __any_sync(0xffffffffu, touched);
    }
    if (reduce) {
      float bv = my_v;
      int bi = my_i;
      vt::warp_argmax(bv, bi);
      if (lane == 0) {
        warp_v[warp] = bv;
        warp_i[warp] = bi;
      }
    }
    __syncthreads();

    if (warp == 0) {
      float bv = warp_v[lane];
      int bi = warp_i[lane];
      vt::warp_argmax(bv, bi);
      if (lane == 0) {
        vt::Dirty d = vt::clean();
        if (bv > -INFINITY) {
          vt::add_to(&st.stats[1], 1);
          vt::drain_and_pipeline<R>(in, st, jr, a, srow, stol, a.start + bi, plane, d);
        }
        sdirty = d;
      }
    }
    // the next round's barrier orders the drain before the next sweep
  }
}

template <int R>
cudaError_t launch(const vt::PreemptIn& in, const vt::PreemptState& st, int plane_len,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(plane_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      preempt_pass_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  preempt_pass_kernel<R><<<1, kThreads, smem, stream>>>(in, st, plane_len);
  return cudaGetLastError();
}

}  // namespace

// Launch one preempt pass on ``stream``.  ``plane_len`` > 0 keeps a plane
// of that many masked values (at least the longest queue list) in shared
// memory for the repeated-attempt fast path; 0 sweeps the list at every
// attempt.  Returns the cudaError_t of the launch (0 on success): a launch
// refused for its shared memory never runs, and only cudaGetLastError
// reports it; cudaErrorInvalidValue for a lane count the library has no
// instance for (2 <= R <= vt::kMaxLanes).
extern "C" int vt_preempt_pass(
    const int* sched, int S, const float* ptask, int P, int R, const float* screq, int SC,
    const uint8_t* cf, int C, const float* nd, const float* vr, const int* vjob, int K,
    const int* jobi, const float* jobf, int J, const float* tol, int NK, const int* qoff, int Q,
    const int* qnode, int LQ, const int* qslot, int KQ, const int* jlo, const int* jlist,
    float w_bp, float w_cpu, float w_mem, float w_scalar, float w_lr, float w_bal, int plane_len,
    float* fi, float* ncnt, float* ready, float* wait, int* cursor, float* spre, int* lvj,
    int* lprio, int* lqueue, float* lmin, float* lvr, int* jnode, float* jvals, int* jevict,
    int* jpipe, int* dirty,
    int* evicted, int* pipelined, int* stats, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const vt::PreemptIn in{sched, S,     ptask, P,    screq, SC,    cf,
                         C,     nd,    vr,    vjob, K,     jobi,  jobf,
                         J,     tol,   NK,    qoff, Q,     qnode, LQ,
                         qslot, KQ,    jlo,   jlist,
                         vt::Weights{w_bp, w_cpu, w_mem, w_scalar, w_lr, w_bal}};
  const vt::PreemptState st{fi,   ncnt,   ready, wait,  cursor, spre,    lvj,       lprio, lqueue,
                            lmin, lvr,    jnode, jvals, jevict, jpipe,  dirty,     evicted,
                            pipelined, stats};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: err = launch<2>(in, st, plane_len, s); break;
    case 3: err = launch<3>(in, st, plane_len, s); break;
    case 4: err = launch<4>(in, st, plane_len, s); break;
    case 5: err = launch<5>(in, st, plane_len, s); break;
    case 6: err = launch<6>(in, st, plane_len, s); break;
    case 7: err = launch<7>(in, st, plane_len, s); break;
    case 8: err = launch<8>(in, st, plane_len, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
