// The control logic of the preempt pass over queue-compacted slot lists:
// the schedule walk, one thread's share of a full or a fast (repeated-
// attempt) sweep, the key that decides between them, the drain with its
// dirty set, and the statement rollback.
//
// Shared by the CUDA preempt kernel (preempt_kernel.cu) and the host test
// shim, which drives these functions in a loop that plays the block's
// threads one after another (tests/test_torch_preempt_step.py).
//
// Queue lists.  Queue q's list is the ascending run qnode[qoff[q] :
// qoff[q+1]] of the nodes that hold a victim of q; at list position g the
// column qslot[kk * LQ + g] (kk < KQ) holds those victims' slots in slot
// order, -1 past the last.  An attempt of queue q sweeps only q's list: a
// node with no victim of q has no eligible victim (vcnt = 0), so its value
// is -inf anyway, and a slot of another queue adds + 0.0 to the victims'
// sum, which leaves it unchanged.  Lists ascend, so a thread's first max
// over its positions is its lowest-node max, and the block argmax over
// (value, list position) keeps the reference's lowest-index tie-break.
// What a listed slot's eligibility reads of its victim (job, priority,
// queue, min_available, request) lies in per-slot planes in list order,
// built at launch, so a position's slots load kChunk at a time beside
// each other: two dependent loads (the planes; then the eviction flag and
// the job's ready count), not a chain per slot.
//
// The plane.  A fired attempt changes node state at one node, the pick
// (future idle, pod count, evictions), and, where it evicts a victim
// whose job has min_available != 1, the gang allowance of that job's
// victims on every node that holds one.  So the masked validity+score of
// every list position (``plane``, one float each) stays valid for the
// next attempt that has the same key, except at those nodes: the dirty
// set, the pick plus the nodes of each such job (the job -> position list
// jlist[jlo[j] : jlo[j+1]], positions in the job's queue list, which is
// the attempt's).  The key is (class, score class, priority, queue) and
// either the same job or two jobs that own no victim slot: eligibility
// depends on the preemptor's job only through vjob != pjob, which is true
// on every occupied slot for a job that owns none.  A rollback
// invalidates the plane; an attempt that picks nothing dirties nothing.
// The drain, whose thread has the pick's slots at hand, leaves the pick's
// new value under the attempt's key in the plane: the next attempt reads
// the plane only if its key is the same, and then the pick's owner only
// takes its best again.
#pragma once

#include <stdint.h>

#include "preempt_math.cuh"
#include "session_math.cuh"

namespace vt {

// List position of "no feasible node" (the argmax's identity).
constexpr int kNoPos = 0x7fffffff;

// Read-only operands of one pass.
struct PreemptIn {
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
  const int* qoff;       // [Q+1] queue list bounds
  int Q;
  const int* qnode;      // [LQ] node of each list position
  int LQ;
  const int* qslot;      // [KQ, LQ] the position's slots of its queue, -1 past the last
  int KQ;
  const int* jlo;        // [J+1] bounds of each job's run of jlist
  const int* jlist;      // list positions of the nodes that hold the job's victims
  Weights w;
};

// Listed slots loaded at once: a position's slots go kChunk at a time.
constexpr int kChunk = 4;

// Mutable state, scratch and outputs.
struct PreemptState {
  float* fi;        // [R, NK] future idle
  float* ncnt;      // [NK] pod count
  float* ready;     // [J]
  float* wait;      // [J]
  int* cursor;      // [J] next task per job (never rolled back)
  float* spre;      // [SC, NK] static score per score class
  int* lvj;         // [KQ, LQ] victim's job, -1 past the last  } per-slot planes
  int* lprio;       // [KQ, LQ] its priority                    } in list order,
  int* lqueue;      // [KQ, LQ] its queue                       } built once a
  float* lmin;      // [KQ, LQ] its min_available               } launch from the
  float* lvr;       // [R*KQ, LQ] its request, row r*KQ + kk    } operands
  int* jnode;       // [P] undo journal: node an attempt touched
  float* jvals;     // [P, R+1] its future idle and pod count before
  int* jevict;      // [P*K] evicted slots (k*NK + n)
  int* jpipe;       // [P] pipelined tasks
  int* dirty;       // [2*KQ] jlist runs of the last drain's gang-sensitive jobs
  int* evicted;     // [K, NK] out: 1 = evicted
  int* pipelined;   // [P] out: node or -1
  int* stats;       // [5] out: fired, picks, evictions, rollbacks, fast attempts
};

// One fired attempt, as the block sees it.
struct Attempt {
  int p, j, pprio, pq;
  int cls, scl;       // class and score class, truncated toward zero
  int own;            // job j owns an occupied victim slot
  int start, len;     // its queue's list: positions [start, start + len)
};

// Thread 0's undo journal of the open statement.
struct Journal {
  int nodes = 0, evicts = 0, pipes = 0;
  float saved_wait = 0.0f;
};

// The key of the attempt the plane was last computed for.
struct PlaneKey {
  int valid = 0;
  int j = 0, cls = 0, scl = 0, pprio = 0, pq = 0, own = 0;
};

// What the last drain dirtied: its pick's list position (-1: no pick) and
// ndirty runs of jlist in PreemptState::dirty.  No initializers: the
// kernel keeps one in shared memory.
struct Dirty {
  int pick;
  int ndirty;
};

// Nothing dirty: no pick.
VT_HD Dirty clean() { return Dirty{-1, 0}; }

// The plane of attempt ``a`` may be reused from the attempt of ``last``.
VT_HD bool same_key(const PlaneKey& last, const Attempt& a) {
  return last.valid != 0 && a.cls == last.cls && a.scl == last.scl && a.pprio == last.pprio &&
         a.pq == last.pq && (a.j == last.j || (a.own == 0 && last.own == 0));
}

VT_HD PlaneKey key_of(const Attempt& a) {
  PlaneKey k;
  k.valid = 1;
  k.j = a.j;
  k.cls = a.cls;
  k.scl = a.scl;
  k.pprio = a.pprio;
  k.pq = a.pq;
  k.own = a.own;
  return k;
}

// The list of queue pq: empty for a queue outside [0, Q).
VT_HD void queue_list(const PreemptIn& in, int pq, int& start, int& len) {
  start = 0;
  len = 0;
  if (pq >= 0 && pq < in.Q) {
    start = in.qoff[pq];
    len = in.qoff[pq + 1] - start;
  }
}

// The per-slot planes at i = kk * LQ + g, from the lists, vjob, vr and the
// job tables.
template <int R>
VT_HD void list_planes(const PreemptIn& in, const PreemptState& st, int i) {
  const int kk = i / in.LQ;
  const int g = i - kk * in.LQ;
  const int k = in.qslot[i];
  const int n = in.qnode[g];
  const int vj = k < 0 ? -1 : in.vjob[k * in.NK + n];
  const int s = vj < 0 ? 0 : vj;
  st.lvj[i] = vj;
  st.lprio[i] = in.jobi[2 * in.J + s];
  st.lqueue[i] = in.jobi[in.J + s];
  st.lmin[i] = in.jobf[2 * in.J + s];
  for (int r = 0; r < R; ++r)
    st.lvr[(r * in.KQ + kk) * in.LQ + g] = k < 0 ? 0.0f : in.vr[(r * in.K + k) * in.NK + n];
}

// Listed slot kk of list position g (node n, slot k): its victim's job,
// priority, queue and min_available.
VT_HD void listed_slot(const PreemptIn& in, const PreemptState& st, int kk, int g, int n, int k,
                       int& vj, int& prio, int& queue, float& vmin) {
  const int i = kk * in.LQ + g;
  vj = st.lvj[i];
  prio = st.lprio[i];
  queue = st.lqueue[i];
  vmin = st.lmin[i];
}

// Lane r of the request of that victim.
VT_HD float listed_req(const PreemptIn& in, const PreemptState& st, int kk, int g, int n, int k,
                       int r) {
  return st.lvr[(r * in.KQ + kk) * in.LQ + g];
}

VT_HD bool job_pipelined(const PreemptIn& in, const PreemptState& st, int j) {
  return st.wait[j] + st.ready[j] >= in.jobf[2 * in.J + j];
}

// *p += v.  On the card an atomic whose old value nobody reads, which
// compiles to a reduction: thread 0 does not wait for the word's round
// trip, so a count, a ready or a waiting update costs the serial chain
// nothing.  Only thread 0 writes these words, so the sums are exact and
// in program order; a value that is an integer in f32 stays one.
template <typename T>
VT_HD void add_to(T* p, T v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

// Listed slots kk0 .. kk0 + kChunk - 1 of one list position, as attempt a
// sees them: slot (-1: none), victim's job and min_available, eligibility.
struct SlotChunk {
  int k[kChunk];
  int vj[kChunk];
  float vmin[kChunk];
  bool elig[kChunk];
};

// Load one chunk of list position g (node n): every slot's planes first,
// then every slot's eviction flag and ready count, so the loads of the
// chunk's slots overlap.
VT_HD void load_chunk(const PreemptIn& in, const PreemptState& st, const Attempt& a, int g, int n,
                      int kk0, SlotChunk& c) {
  int prio[kChunk], queue[kChunk];
#pragma unroll
  for (int x = 0; x < kChunk; ++x) {
    const int kk = kk0 + x;
    c.k[x] = -1;
    c.vj[x] = -1;
    prio[x] = 0;
    queue[x] = 0;
    c.vmin[x] = 1.0f;
    if (kk < in.KQ) {
      c.k[x] = in.qslot[kk * in.LQ + g];
      listed_slot(in, st, kk, g, n, c.k[x], c.vj[x], prio[x], queue[x], c.vmin[x]);
    }
  }
#pragma unroll
  for (int x = 0; x < kChunk; ++x) {
    const bool ev = st.evicted[(c.k[x] < 0 ? 0 : c.k[x]) * in.NK + n] != 0;
    const float ready = st.ready[c.vj[x] < 0 ? 0 : c.vj[x]];
    c.elig[x] = victim_eligible(c.vj[x], ev, prio[x], queue[x], c.vmin[x], ready, a.j, a.pprio,
                                a.pq);
  }
}

// Masked validity+score of list position g for attempt a (request row rr):
// -inf where the class may not go, or the node does not validate.
template <int R>
VT_HD float position_value(const PreemptIn& in, const PreemptState& st, const Attempt& a,
                           const float* rr, const float* tol, int g) {
  const int NK = in.NK;
  const int n = in.qnode[g];
  const bool cls_ok =
      a.cls >= 0 && a.cls < in.C && in.cf[static_cast<size_t>(a.cls) * NK + n] != 0;
  float vsum[R];
  for (int r = 0; r < R; ++r) vsum[r] = 0.0f;
  int vcnt = 0;
  for (int kk0 = 0; kk0 < in.KQ; kk0 += kChunk) {
    SlotChunk c;
    load_chunk(in, st, a, g, n, kk0, c);
#pragma unroll
    for (int x = 0; x < kChunk; ++x) {
      for (int r = 0; r < R; ++r) {
        const float v = c.k[x] < 0 ? 0.0f : listed_req(in, st, kk0 + x, g, n, c.k[x], r);
        vsum[r] = c.elig[x] ? vsum[r] + v : vsum[r];  // slot order; an ineligible slot adds nothing
      }
      vcnt += c.elig[x] ? 1 : 0;
    }
  }
  const float* nmax = in.nd + static_cast<size_t>(3 * R + 1) * NK;
  if (!cls_ok ||
      !node_validates<R>(rr, tol, st.fi + n, NK, vsum, vcnt, st.ncnt[n], nmax[n], true))
    return -INFINITY;
  if (in.SC > 0) return st.spre[a.scl * NK + n];
  const float* used = in.nd;
  const float* alloc = in.nd + static_cast<size_t>(R) * NK;
  return node_score(R, rr, alloc + n, used + n, NK, in.w);
}

// One thread's share of a full sweep: list positions first, first +
// stride, ... of a's list, each value stored in ``plane`` (when given) at
// its position in the list.  Out: the thread's first max (value, position);
// (-inf, kNoPos) when none of its positions validates.
template <int R>
VT_HD void sweep_full(const PreemptIn& in, const PreemptState& st, const Attempt& a,
                      const float* rr, const float* tol, int first, int stride, float* plane,
                      float& bv, int& bi) {
  bv = -INFINITY;
  bi = kNoPos;
  for (int i = first; i < a.len; i += stride) {
    const float v = position_value<R>(in, st, a, rr, tol, a.start + i);
    if (plane != nullptr) plane[i] = v;
    if (v > bv) {  // ascending positions: the first max
      bv = v;
      bi = i;
    }
  }
}

// One thread's share of a fast attempt: rescore into the plane the dirty
// positions this thread owns (the nodes of the last drain's gang-sensitive
// jobs; the drain left the pick's new value there itself), then, if it
// owned any or the pick, take its best again from the plane.  Returns
// whether it did; (bv, bi), the thread's best of the last attempt, stand
// otherwise.
template <int R>
VT_HD bool sweep_dirty(const PreemptIn& in, const PreemptState& st, const Attempt& a,
                       const float* rr, const float* tol, int first, int stride, float* plane,
                       const Dirty& d, float& bv, int& bi) {
  bool touched = d.pick >= 0 && d.pick % stride == first;
  for (int x = 0; x < d.ndirty; ++x) {
    const int hi = st.dirty[2 * x + 1];
    for (int e = st.dirty[2 * x]; e < hi; ++e) {
      const int i = in.jlist[e] - a.start;
      if (i >= 0 && i < a.len && i % stride == first) {
        plane[i] = position_value<R>(in, st, a, rr, tol, a.start + i);
        touched = true;
      }
    }
  }
  if (touched) {
    bv = -INFINITY;
    bi = kNoPos;
    for (int i = first; i < a.len; i += stride) {
      if (plane[i] > bv) {
        bv = plane[i];
        bi = i;
      }
    }
  }
  return touched;
}

// Undo the open statement of job j (statement.go discard).
template <int R>
VT_HD void rollback(const PreemptIn& in, const PreemptState& st, Journal& jr, int j) {
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

// Thread 0's place in the schedule: slot s and its row, loaded a slot
// ahead (across fired attempts too).
struct Walk {
  int s = 0;
  int kind = 0, j = -1, p = 0;
};

// Load the row of slot w.s (nothing past the last).
VT_HD void load_slot(const PreemptIn& in, Walk& w) {
  if (w.s < in.S) {
    w.kind = in.sched[4 * w.s];
    w.j = in.sched[4 * w.s + 1];
    w.p = in.sched[4 * w.s + 2];
  }
}

// Thread 0's walk of the schedule from slot w.s (its row loaded) to the
// next attempt that fires: BEGIN opens a statement, END rolls back a job
// that did not end pipelined (and with it the plane's key), BURN consumes
// one task.  Returns the fired task, with its job in fj, or -1 past the
// last slot.  Each slot reads its job's cursor and counts at once (one
// dependent load on the chain) while the next slot's row loads.
template <int R>
VT_HD int walk(const PreemptIn& in, const PreemptState& st, Journal& jr, PlaneKey& key, Walk& w,
               int& fj) {
  while (w.s < in.S) {
    const int ck = w.kind, cj = w.j, cp = w.p;
    ++w.s;
    load_slot(in, w);
    if (cj < 0 || cj >= in.J) continue;
    const int cur = st.cursor[cj];
    const bool piped = job_pipelined(in, st, cj);
    if (ck == kSlotBegin) {
      jr = Journal{};
      jr.saved_wait = st.wait[cj];
    } else if (ck == kSlotAttempt) {
      if ((cur == cp) & (cp >= 0) & (cp < in.P) & !piped) {
        st.cursor[cj] = cur + 1;
        fj = cj;
        return cp;
      }
    } else if (ck == kSlotEnd) {
      if (!piped) {
        rollback<R>(in, st, jr, cj);
        add_to(&st.stats[3], 1);
        key.valid = 0;  // the state moved back: the plane is stale anywhere
      }
    } else if (ck == kSlotBurn) {
      if (cur < cp) st.cursor[cj] = cur + 1;
    }
  }
  return -1;
}

// The attempt of task p (request row ``row``) of job j.
template <int R>
VT_HD Attempt attempt_of(const PreemptIn& in, int p, int j, const float* row) {
  Attempt a;
  a.p = p;
  a.j = j;
  a.pprio = in.jobi[2 * in.J + j];
  a.pq = in.jobi[in.J + j];
  a.cls = static_cast<int>(row[R]);
  a.scl = static_cast<int>(row[R + 1]);
  a.own = in.jlo[j + 1] > in.jlo[j] ? 1 : 0;
  queue_list(in, a.pq, a.start, a.len);
  return a;
}

// Evict on the node at list position g in slot order until the request
// fits, then pipeline the attempt's task there (preempt.go:216-259).
// Eligibility is that of the attempt's start.  Out: the dirty set, this
// pick and the jlist runs of the evicted victims' jobs whose gang
// allowance can flip (min_available != 1); with a plane, the pick's new
// value under this attempt's key.
//
// The drain is on the serial chain, so it reads everything of the node
// before it stores anything (a load after a store the compiler cannot
// tell apart waits for it) and keeps the node's state in registers: the
// new future idle and pod count are stored once, the journal takes the
// old ones from registers, and the pick's new value comes from them and
// the eligible victims left on the node, summed in slot order as
// position_value would sum them at the next attempt of this key (an
// evicted victim is ineligible then; every other victim's eligibility is
// unchanged unless its job's allowance can flip, and then this node is in
// the dirty set and rescored).  A victim whose job has min_available 1
// has its job's ready count lowered at once, by a reduction: no
// eligibility reads it.  The others' drop after the drain.
template <int R>
VT_HD void drain_and_pipeline(const PreemptIn& in, const PreemptState& st, Journal& jr,
                              const Attempt& a, const float* rr, const float* tol, int g,
                              float* plane, Dirty& d) {
  const int NK = in.NK;
  const int n = in.qnode[g];
  float f[R];
  for (int r = 0; r < R; ++r) f[r] = st.fi[r * NK + n];
  float cnt = st.ncnt[n];
  const float nmax = in.nd[static_cast<size_t>(3 * R + 1) * NK + n];
  const bool cls_ok =
      a.cls >= 0 && a.cls < in.C && in.cf[static_cast<size_t>(a.cls) * NK + n] != 0;
  const float spre = in.SC > 0 ? st.spre[a.scl * NK + n] : 0.0f;

  float cum[R], rest[R];  // evicted victims' requests; the eligible ones' left
  for (int r = 0; r < R; ++r) {
    cum[r] = 0.0f;
    rest[r] = 0.0f;
  }
  int left = 0;
  const int first = jr.evicts;
  d.pick = g - a.start;
  d.ndirty = 0;
  for (int kk0 = 0; kk0 < in.KQ; kk0 += kChunk) {
    SlotChunk c;
    load_chunk(in, st, a, g, n, kk0, c);
    for (int x = 0; x < kChunk; ++x) {
      if (!c.elig[x]) continue;
      if (!drain_not_fit<R>(rr, tol, f, 1, cum)) {
        for (int r = 0; r < R; ++r)
          rest[r] = rest[r] + listed_req(in, st, kk0 + x, g, n, c.k[x], r);
        ++left;
        continue;
      }
      for (int r = 0; r < R; ++r)
        cum[r] = cum[r] + listed_req(in, st, kk0 + x, g, n, c.k[x], r);
      const int idx = c.k[x] * NK + n;
      st.evicted[idx] = 1;
      st.jevict[jr.evicts++] = idx;
      if (c.vmin[x] == 1.0f) {
        add_to(&st.ready[c.vj[x]], -1.0f);
      } else {
        st.dirty[2 * d.ndirty] = in.jlo[c.vj[x]];
        st.dirty[2 * d.ndirty + 1] = in.jlo[c.vj[x] + 1];
        ++d.ndirty;
      }
    }
  }
  if (d.ndirty > 0) {
    for (int e = first; e < jr.evicts; ++e) {
      const int vj = in.vjob[st.jevict[e]];
      if (in.jobf[2 * in.J + vj] != 1.0f) st.ready[vj] = st.ready[vj] - 1.0f;
    }
  }
  add_to(&st.stats[2], jr.evicts - first);

  st.jnode[jr.nodes] = n;
  for (int r = 0; r < R; ++r) st.jvals[jr.nodes * (R + 1) + r] = f[r];
  st.jvals[jr.nodes * (R + 1) + R] = cnt;
  ++jr.nodes;

  float zero[R];
  for (int r = 0; r < R; ++r) {
    f[r] = f[r] + cum[r];
    zero[r] = 0.0f;
  }
  if (fits_with<R>(rr, tol, f, 1, zero)) {
    for (int r = 0; r < R; ++r) f[r] = f[r] - rr[r];
    cnt = cnt + 1.0f;
    add_to(&st.wait[a.j], 1.0f);
    st.pipelined[a.p] = n;
    st.jpipe[jr.pipes++] = a.p;
  }
  for (int r = 0; r < R; ++r) st.fi[r * NK + n] = f[r];
  st.ncnt[n] = cnt;
  if (plane != nullptr) {
    float v = -INFINITY;
    if (node_validates<R>(rr, tol, f, 1, rest, left, cnt, nmax, cls_ok))
      v = in.SC > 0 ? spre : node_score(R, rr, in.nd + static_cast<size_t>(R) * NK + n, in.nd + n,
                                        NK, in.w);
    plane[d.pick] = v;
  }
}

}  // namespace vt
