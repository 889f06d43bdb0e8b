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
// arithmetic lives in preempt_math.cuh and session_math.cuh.
//
// What bounds it: the replay is sequential — each attempt reads the
// state the previous one left — so every fired attempt is a sweep over
// all nodes (K victim slots each, with gathers from the job tables)
// followed by a block-wide argmax and a drain on one node; every slot
// that does not fire is a few dependent loads on one thread.  The bytes
// are small (the inputs, ~3 MB at 10k nodes, sit in the 50 MB L2) and so
// are the operations; the serial chain of loads and barriers per slot
// sets the floor.  The design:
//   * one block of 1024 threads; thread 0 walks the schedule alone and
//     hands the block only the attempts that fire (one barrier), so
//     BEGIN, END, BURN and attempts that do not fire cost no barrier;
//   * the mutable state does not fit one block's shared memory (future
//     idle, pod counts and eviction flags are ~21 words per node, 849 KB
//     at 10k nodes), so it lives in global memory (L2-resident), written
//     by the wrapper's scratch tensors and never by the host;
//   * nothing derivable is stored: a victim is alive iff not evicted; its
//     gang allowance is recomputed from its job's ready count; its
//     queue and priority are gathers through its job row;
//   * node scores are static (evict and pipeline never move ``used``):
//     one plane per distinct request row is computed at launch, or the
//     score is computed inline past SCORE_CLASS_CAP rows;
//   * a statement rollback replays an undo journal of what the statement
//     touched (node future-idle and pod count, evictions, pipelines)
//     instead of copying the whole state at every BEGIN;
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
#include "session_math.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Read-only operands of one pass.
struct PassIn {
  const int* sched;      // [S, 4]: kind, job, task (BURN: job's task end), pad
  int S;
  const float* ptask;    // [P, R+2]: resreq lanes, feasibility class, score class
  int P;
  const float* screq;    // [SC, R] distinct request rows (SC = 0: score inline)
  int SC;
  const uint8_t* cf;     // [C, NK] class feasibility
  int C;
  const float* nd;       // [3R+2, NK]: used | alloc | fi0 | ncnt0, nmax
  const float* vr;       // [R*K, NK] victim requests, row r*K + k
  const int* vjob;       // [K, NK] victim's job row, -1 = empty slot
  int K;
  const int* jobi;       // [3, J]: cursor0 (task start) | queue | priority
  const float* jobf;     // [3, J]: ready0 | waiting0 | min_available
  int J;
  const float* tol;      // [R]
  int NK;
  vt::Weights w;
};

// Mutable state and outputs, all allocated by the wrapper.
struct PassState {
  float* fi;        // [R, NK] future idle
  float* ncnt;      // [NK] pod count
  float* ready;     // [J]
  float* wait;      // [J]
  int* cursor;      // [J] next task per job (never rolled back)
  float* spre;      // [SC, NK] static score per score class
  int* jnode;       // [P] undo journal: node an attempt touched
  float* jvals;     // [P, R+1] its future idle and pod count before
  int* jevict;      // [P*K] evicted slots (k*NK + n)
  int* jpipe;       // [P] pipelined tasks
  int* evicted;     // [K, NK] out: 1 = evicted
  int* pipelined;   // [P] out: node or -1
  int* stats;       // [4] out: fired attempts, picks, evictions, rollbacks
};

__device__ __forceinline__ bool job_pipelined(const PassIn& in, const PassState& st, int j) {
  return st.wait[j] + st.ready[j] >= in.jobf[2 * in.J + j];
}

// Thread 0's undo journal of the open statement.
struct Journal {
  int nodes = 0, evicts = 0, pipes = 0;
  float saved_wait = 0.0f;
};

template <int R>
__device__ void rollback(const PassIn& in, const PassState& st, Journal& jr, int j) {
  const int NK = in.NK;
  for (int e = jr.evicts - 1; e >= 0; --e) {
    const int idx = st.jevict[e];
    st.evicted[idx] = 0;
    const int vj = in.vjob[idx];
    st.ready[vj] = st.ready[vj] + 1.0f;
  }
  for (int i = jr.nodes - 1; i >= 0; --i) {
    const int n = st.jnode[i];
    for (int r = 0; r < R; ++r) st.fi[r * NK + n] = st.jvals[i * (R + 1) + r];
    st.ncnt[n] = st.jvals[i * (R + 1) + R];
  }
  for (int i = 0; i < jr.pipes; ++i) st.pipelined[st.jpipe[i]] = -1;
  st.wait[j] = jr.saved_wait;
  jr = Journal{};
}

// Evict on node n in slot order until the request fits, then pipeline
// task p of job j there (preempt.go:216-259).  Eligibility is that of
// the attempt's start: the ready counts of evicted victims' jobs drop
// only after the drain.
template <int R>
__device__ void drain_and_pipeline(const PassIn& in, const PassState& st, Journal& jr,
                                   const float* rr, const float* tol, int p, int j,
                                   int pprio, int pq, int n) {
  const int NK = in.NK;
  const int K = in.K;
  st.jnode[jr.nodes] = n;
  for (int r = 0; r < R; ++r) st.jvals[jr.nodes * (R + 1) + r] = st.fi[r * NK + n];
  st.jvals[jr.nodes * (R + 1) + R] = st.ncnt[n];
  ++jr.nodes;

  float cum[R];
  for (int r = 0; r < R; ++r) cum[r] = 0.0f;
  const int first = jr.evicts;
  for (int k = 0; k < K; ++k) {
    const int idx = k * NK + n;
    const int vj = in.vjob[idx];
    if (vj < 0) continue;
    const bool elig = vt::victim_eligible(
        vj, st.evicted[idx] != 0, in.jobi[2 * in.J + vj], in.jobi[in.J + vj],
        in.jobf[2 * in.J + vj], st.ready[vj], j, pprio, pq);
    if (!elig || !vt::drain_not_fit<R>(rr, tol, st.fi + n, NK, cum)) continue;
    for (int r = 0; r < R; ++r) cum[r] = cum[r] + in.vr[(r * K + k) * NK + n];
    st.evicted[idx] = 1;
    st.jevict[jr.evicts++] = idx;
  }
  for (int e = first; e < jr.evicts; ++e) {
    const int vj = in.vjob[st.jevict[e]];
    st.ready[vj] = st.ready[vj] - 1.0f;
  }
  st.stats[2] += jr.evicts - first;
  for (int r = 0; r < R; ++r) st.fi[r * NK + n] = st.fi[r * NK + n] + cum[r];

  float zero[R];
  for (int r = 0; r < R; ++r) zero[r] = 0.0f;
  if (vt::fits_with<R>(rr, tol, st.fi + n, NK, zero)) {
    for (int r = 0; r < R; ++r) st.fi[r * NK + n] = st.fi[r * NK + n] - rr[r];
    st.ncnt[n] = st.ncnt[n] + 1.0f;
    st.wait[j] = st.wait[j] + 1.0f;
    st.pipelined[p] = n;
    st.jpipe[jr.pipes++] = p;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
preempt_pass_kernel(PassIn in, PassState st) {
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float srow[R + 2];  // the firing attempt's task row
  __shared__ float stol[R];
  __shared__ int ctl[4];         // task p (-1: the schedule is done), job, priority, queue

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int NK = in.NK;
  const int J = in.J;
  const float* used = in.nd;
  const float* alloc = in.nd + static_cast<size_t>(R) * NK;
  const float* fi0 = in.nd + static_cast<size_t>(2 * R) * NK;
  const float* ncnt0 = in.nd + static_cast<size_t>(3 * R) * NK;
  const float* nmax = in.nd + static_cast<size_t>(3 * R + 1) * NK;

  // session open: state from the operands, static score planes
  for (int i = tid; i < R * NK; i += kThreads) st.fi[i] = fi0[i];
  for (int n = tid; n < NK; n += kThreads) st.ncnt[n] = ncnt0[n];
  for (int i = tid; i < in.K * NK; i += kThreads) st.evicted[i] = 0;
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
  if (tid < 4) st.stats[tid] = 0;
  __syncthreads();

  Journal jr;  // thread 0's
  int s = 0;   // thread 0's schedule position
  for (;;) {
    if (tid == 0) {
      // walk the schedule to the next attempt that fires
      int fire_p = -1, fire_j = 0;
      for (; s < in.S; ++s) {
        const int kind = in.sched[4 * s];
        const int j = in.sched[4 * s + 1];
        const int p = in.sched[4 * s + 2];
        if (j < 0 || j >= J) continue;
        if (kind == vt::kSlotBegin) {
          jr = Journal{};
          jr.saved_wait = st.wait[j];
        } else if (kind == vt::kSlotAttempt) {
          const int cur = st.cursor[j];
          if (cur == p && p >= 0 && p < in.P && !job_pipelined(in, st, j)) {
            st.cursor[j] = cur + 1;
            fire_p = p;
            fire_j = j;
            ++s;
            break;
          }
        } else if (kind == vt::kSlotEnd) {
          if (!job_pipelined(in, st, j)) {
            rollback<R>(in, st, jr, j);
            st.stats[3] += 1;
          }
        } else if (kind == vt::kSlotBurn) {
          const int cur = st.cursor[j];
          if (cur < p) st.cursor[j] = cur + 1;
        }
      }
      ctl[0] = fire_p;
      if (fire_p >= 0) {
        ctl[1] = fire_j;
        ctl[2] = in.jobi[2 * J + fire_j];
        ctl[3] = in.jobi[J + fire_j];
        for (int r = 0; r < R + 2; ++r) srow[r] = in.ptask[fire_p * (R + 2) + r];
        st.stats[0] += 1;
      }
    }
    __syncthreads();
    const int p = ctl[0];
    if (p < 0) break;
    const int j = ctl[1];
    const int pprio = ctl[2];
    const int pq = ctl[3];
    const int cls = static_cast<int>(srow[R]);
    const int scl = static_cast<int>(srow[R + 1]);
    const uint8_t* cf_row =
        (cls >= 0 && cls < in.C) ? in.cf + static_cast<size_t>(cls) * NK : nullptr;

    // every node: eligible victims, validation, masked static score
    float bv = -INFINITY;
    int bi = INT_MAX;
    if (cf_row != nullptr) {
      for (int n = tid; n < NK; n += kThreads) {
        if (cf_row[n] == 0) continue;  // the class may not go here: -inf
        float vsum[R];
        for (int r = 0; r < R; ++r) vsum[r] = 0.0f;
        int vcnt = 0;
        for (int k = 0; k < in.K; ++k) {
          const int idx = k * NK + n;
          const int vj = in.vjob[idx];
          if (vj < 0) continue;
          if (!vt::victim_eligible(vj, st.evicted[idx] != 0, in.jobi[2 * J + vj],
                                   in.jobi[J + vj], in.jobf[2 * J + vj], st.ready[vj], j,
                                   pprio, pq))
            continue;
          for (int r = 0; r < R; ++r) vsum[r] = vsum[r] + in.vr[(r * in.K + k) * NK + n];
          ++vcnt;
        }
        if (!vt::node_validates<R>(srow, stol, st.fi + n, NK, vsum, vcnt, st.ncnt[n],
                                   nmax[n], true))
          continue;
        const float v = in.SC > 0 ? st.spre[scl * NK + n]
                                  : vt::node_score(R, srow, alloc + n, used + n, NK, in.w);
        if (v > bv) {  // ascending n: the first max of this thread's nodes
          bv = v;
          bi = n;
        }
      }
    }
    vt::warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();

    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      vt::warp_argmax(bv, bi);
      if (lane == 0 && bv > -INFINITY) {
        st.stats[1] += 1;
        drain_and_pipeline<R>(in, st, jr, srow, stol, p, j, pprio, pq, bi);
      }
    }
    // the next round's barrier orders the drain before the next sweep
  }
}

template <int R>
cudaError_t launch(const PassIn& in, const PassState& st, cudaStream_t stream) {
  preempt_pass_kernel<R><<<1, kThreads, 0, stream>>>(in, st);
  return cudaGetLastError();
}

}  // namespace

// Launch one preempt pass on ``stream``.  Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a lane count the
// library has no instance for (2 <= R <= vt::kMaxLanes).
extern "C" int vt_preempt_pass(
    const int* sched, int S, const float* ptask, int P, int R, const float* screq, int SC,
    const uint8_t* cf, int C, const float* nd, const float* vr, const int* vjob, int K,
    const int* jobi, const float* jobf, int J, const float* tol, int NK, float w_bp,
    float w_cpu, float w_mem, float w_scalar, float w_lr, float w_bal, float* fi, float* ncnt,
    float* ready, float* wait, int* cursor, float* spre, int* jnode, float* jvals, int* jevict,
    int* jpipe, int* evicted, int* pipelined, int* stats, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const PassIn in{sched, S,   ptask, P,  screq, SC, cf,  C,  nd,
                  vr,    vjob, K,    jobi, jobf, J, tol, NK,
                  vt::Weights{w_bp, w_cpu, w_mem, w_scalar, w_lr, w_bal}};
  const PassState st{fi,    ncnt,   ready,  wait,    cursor,    spre, jnode,
                     jvals, jevict, jpipe,  evicted, pipelined, stats};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 2: err = launch<2>(in, st, s); break;
    case 3: err = launch<3>(in, st, s); break;
    case 4: err = launch<4>(in, st, s); break;
    case 5: err = launch<5>(in, st, s); break;
    case 6: err = launch<6>(in, st, s); break;
    case 7: err = launch<7>(in, st, s); break;
    case 8: err = launch<8>(in, st, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
