// Native greedy allocate baseline — the stand-in for the reference's
// stock Go allocate hot loop (pkg/scheduler/actions/allocate/allocate.go
// per-task PredicateNodes/PrioritizeNodes/SelectBestNode,
// pkg/scheduler/util/scheduler_helper.go:64-211).
//
// A copy of volcano_tpu/native/baseline.cpp.
//
// Same semantics as the session kernel (volcano_tpu_torch/ops/kernels.py): per
// task in order — feasibility (resource fit with tolerance, label/taint
// bitsets, pod-count, node-ok) → binpack + least-requested + balanced
// score → lowest-index argmax → tentative allocate; then gang fixpoint
// rounds (discard jobs under minAvailable, rerun).  The node loop fans out
// over worker threads per task, mirroring the reference's 16-goroutine
// ParallelizeUntil.
//
// Built with g++ -O2 -shared; driven through ctypes (volcano_tpu_torch/native).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Args {
  int T, N, J, R, W;
  const float* task_resreq;       // [T,R]
  const int32_t* task_job;        // [T]
  const uint32_t* task_sel_bits;  // [T,W]
  const uint32_t* task_tol_bits;  // [T,W]
  const float* node_idle0;        // [N,R]
  const float* node_used0;        // [N,R]
  const float* node_alloc;        // [N,R]
  const uint32_t* node_label_bits;  // [N,W]
  const uint32_t* node_taint_bits;  // [N,W]
  const uint8_t* node_ok;           // [N]
  const int32_t* node_task_count0;  // [N]
  const int32_t* node_max_tasks;    // [N]
  const int32_t* job_min_available;  // [J]
  const int32_t* job_ready_count;    // [J]
  const float* tolerance;            // [R]
  int n_threads;
  int gang_rounds;
};

struct Weights {
  double binpack_weight = 1.0, binpack_cpu = 1.0, binpack_memory = 1.0;
  double least_requested_weight = 1.0, balanced_weight = 1.0;
};

inline bool feasible(const Args& a, const float* resreq, const uint32_t* sel,
                     const uint32_t* tol, const std::vector<float>& idle,
                     const std::vector<int32_t>& count, int n) {
  if (!a.node_ok[n]) return false;
  if (count[n] >= a.node_max_tasks[n]) return false;
  const float* id = idle.data() + (size_t)n * a.R;
  for (int r = 0; r < a.R; ++r) {
    bool lane_ok = resreq[r] < id[r] + a.tolerance[r];
    if (!lane_ok && r >= 2 && resreq[r] <= a.tolerance[r]) lane_ok = true;
    if (!lane_ok) return false;
  }
  const uint32_t* lb = a.node_label_bits + (size_t)n * a.W;
  const uint32_t* tb = a.node_taint_bits + (size_t)n * a.W;
  for (int w = 0; w < a.W; ++w) {
    if (sel[w] & ~lb[w]) return false;
    if (tb[w] & ~tol[w]) return false;
  }
  return true;
}

// Shared score body (binpack + least-requested + balanced) over raw
// used/alloc lane pointers — the allocate path passes its mutable used
// vector, the preempt path the static node_used (scores never move
// during a preempt pass, see ops/preempt_pack.py).
inline double score_at(const Weights& wt, const float* resreq,
                       const float* us, const float* al) {
  // binpack (binpack.go:200-259): cpu+memory lanes only by default.
  double bp = 0.0, wsum = 0.0;
  const double lane_w[2] = {wt.binpack_cpu, wt.binpack_memory};
  for (int r = 0; r < 2; ++r) {
    double req = resreq[r];
    if (req <= 0) continue;
    wsum += lane_w[r];
    double fin = req + us[r];
    if (al[r] <= 0 || fin > al[r]) continue;
    bp += fin * lane_w[r] / al[r];
  }
  double s = (wsum > 0 ? bp / wsum : 0.0) * 10.0 * wt.binpack_weight;

  // least requested + balanced (vendored k8s priorities), integer floors.
  int64_t lr = 0;
  double fracs[2] = {1.0, 1.0};
  for (int r = 0; r < 2; ++r) {
    int64_t req = (int64_t)(resreq[r] + us[r]);
    int64_t cap = (int64_t)al[r];
    if (cap > 0) {
      fracs[r] = (double)req / (double)cap;
      if (req <= cap) lr += (cap - req) * 10 / cap;
    }
  }
  s += wt.least_requested_weight * (double)(lr / 2);
  if (fracs[0] < 1.0 && fracs[1] < 1.0) {
    double diff = std::fabs(fracs[0] - fracs[1]);
    s += wt.balanced_weight * std::floor((1.0 - diff) * 10.0);
  }
  return s;
}

// Persistent worker pool — the per-task node sweep runs on long-lived
// threads (the reference's 16-goroutine ParallelizeUntil reuses a pool;
// spawning std::thread per task costs more than the sweep itself).
class Pool {
 public:
  explicit Pool(int n) : n_(n), stop_(false), epoch_(0), done_(0) {
    for (int i = 0; i < n_; ++i)
      workers_.emplace_back([this, i]() { Run(i); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(m_);
      stop_ = true;
      ++epoch_;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  // Runs fn(worker_index) on all workers; returns when all finish.
  void Dispatch(const std::function<void(int)>& fn) {
    {
      std::unique_lock<std::mutex> lk(m_);
      fn_ = &fn;
      done_ = 0;
      ++epoch_;
    }
    cv_.notify_all();
    std::unique_lock<std::mutex> lk(m_);
    cv_done_.wait(lk, [this]() { return done_ == n_; });
  }

 private:
  void Run(int idx) {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int)>* fn;
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [&]() { return epoch_ != seen; });
        seen = epoch_;
        if (stop_) return;
        fn = fn_;
      }
      (*fn)(idx);
      {
        std::unique_lock<std::mutex> lk(m_);
        if (++done_ == n_) cv_done_.notify_one();
      }
    }
  }

  int n_;
  bool stop_;
  uint64_t epoch_;
  int done_;
  const std::function<void(int)>* fn_ = nullptr;
  std::mutex m_;
  std::condition_variable cv_, cv_done_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

// Returns 0 on success; fills assignment[T] with node index or -1.
int baseline_allocate(const float* task_resreq, const int32_t* task_job,
                      const uint32_t* task_sel_bits, const uint32_t* task_tol_bits,
                      const float* node_idle, const float* node_used,
                      const float* node_alloc, const uint32_t* node_label_bits,
                      const uint32_t* node_taint_bits, const uint8_t* node_ok,
                      const int32_t* node_task_count, const int32_t* node_max_tasks,
                      const int32_t* job_min_available, const int32_t* job_ready_count,
                      const float* tolerance, int T, int N, int J, int R, int W,
                      int n_threads, int gang_rounds, int32_t* assignment) {
  Args a{T, N, J, R, W,
         task_resreq, task_job, task_sel_bits, task_tol_bits,
         node_idle, node_used, node_alloc, node_label_bits, node_taint_bits,
         node_ok, node_task_count, node_max_tasks, job_min_available,
         job_ready_count, tolerance, n_threads, gang_rounds};
  Weights wt;

  std::vector<uint8_t> active(T, 1);
  std::vector<int32_t> chosen(T, -1);

  const int threads = n_threads > 0 ? n_threads : 16;
  std::unique_ptr<Pool> pool_holder;
  Pool* pool = nullptr;
  if (threads > 1 && N >= 2048) {
    pool_holder.reset(new Pool(threads));
    pool = pool_holder.get();
  }

  for (int round = 0; round < gang_rounds; ++round) {
    // Reset state (discard semantics restore node accounting each round).
    std::vector<float> idle(node_idle, node_idle + (size_t)N * R);
    std::vector<float> used(node_used, node_used + (size_t)N * R);
    std::vector<int32_t> count(node_task_count, node_task_count + N);
    std::vector<int32_t> job_assigned(J, 0);
    std::fill(chosen.begin(), chosen.end(), -1);

    for (int t = 0; t < T; ++t) {
      if (!active[t]) continue;
      const float* resreq = task_resreq + (size_t)t * R;
      const uint32_t* sel = task_sel_bits + (size_t)t * W;
      const uint32_t* tol = task_tol_bits + (size_t)t * W;

      // Parallel node sweep (mirrors workqueue.ParallelizeUntil w/ 16
      // workers, scheduler_helper.go:110-111), deterministic reduce:
      // chunk-local best, then lowest-index winner across chunks.
      int best = -1;
      double best_score = -std::numeric_limits<double>::infinity();
      if (pool == nullptr) {
        for (int n = 0; n < N; ++n) {
          if (!feasible(a, resreq, sel, tol, idle, count, n)) continue;
          double sc = score_at(wt, resreq, used.data() + (size_t)n * a.R,
                               a.node_alloc + (size_t)n * a.R);
          if (sc > best_score) { best_score = sc; best = n; }
        }
      } else {
        std::vector<int> cb(threads, -1);
        std::vector<double> cs(threads,
                               -std::numeric_limits<double>::infinity());
        int chunk = (N + threads - 1) / threads;
        pool->Dispatch([&](int w) {
          int lo = w * chunk, hi = std::min(N, lo + chunk);
          for (int n = lo; n < hi; ++n) {
            if (!feasible(a, resreq, sel, tol, idle, count, n)) continue;
            double sc = score_at(wt, resreq, used.data() + (size_t)n * a.R,
                               a.node_alloc + (size_t)n * a.R);
            if (sc > cs[w]) { cs[w] = sc; cb[w] = n; }
          }
        });
        for (int w = 0; w < threads; ++w) {
          if (cb[w] >= 0 && cs[w] > best_score) { best_score = cs[w]; best = cb[w]; }
        }
      }

      if (best < 0) continue;
      chosen[t] = best;
      float* id = idle.data() + (size_t)best * R;
      float* us = used.data() + (size_t)best * R;
      for (int r = 0; r < R; ++r) { id[r] -= resreq[r]; us[r] += resreq[r]; }
      count[best] += 1;
      job_assigned[task_job[t]] += 1;
    }

    // Gang commit/discard.
    bool changed = false;
    for (int t = 0; t < T; ++t) {
      if (!active[t]) continue;
      int j = task_job[t];
      bool ready = job_assigned[j] + job_ready_count[j] >= job_min_available[j];
      if (!ready) { active[t] = 0; changed = true; }
    }
    if (!changed) break;
  }

  for (int t = 0; t < T; ++t)
    assignment[t] = active[t] ? chosen[t] : -1;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native greedy preempt baseline — the stand-in for the reference's stock
// preempt action (pkg/scheduler/actions/preempt/preempt.go:45-276): per
// preemptor, predicate+prioritize over all nodes, per-node victim
// validation, evict lowest-priority victims until fit, pipeline;
// statement-scoped commit/discard per phase-1 job (statement.go:309-337).
// Semantics mirror ops/preempt_pack.py preempt_dense exactly (same f32
// arithmetic envelope as the allocate baseline above).

namespace {

struct PArgs {
  int P, N, V, J, R, W;
  const float* task_resreq;        // [P,R]
  const uint32_t* task_sel_bits;   // [P,W]
  const uint32_t* task_tol_bits;   // [P,W]
  const float* node_used;          // [N,R] static across the pass
  const float* node_alloc;         // [N,R]
  const uint32_t* node_label_bits; // [N,W]
  const uint32_t* node_taint_bits; // [N,W]
  const uint8_t* node_ok;          // [N]
  const int32_t* node_max_tasks;   // [N]
  const float* vic_resreq;         // [V,R]
  const int32_t* vic_node;         // [V]
  const int32_t* vic_job;          // [V]
  const int64_t* job_prio;         // [J]
  const int32_t* job_min_avail;    // [J]
  const int32_t* job_queue;        // [J]
  const float* tolerance;          // [R]
};

inline bool p_static_feasible(const PArgs& a, int p, int n) {
  if (!a.node_ok[n]) return false;
  const uint32_t* sel = a.task_sel_bits + (size_t)p * a.W;
  const uint32_t* tol = a.task_tol_bits + (size_t)p * a.W;
  const uint32_t* lb = a.node_label_bits + (size_t)n * a.W;
  const uint32_t* tb = a.node_taint_bits + (size_t)n * a.W;
  for (int w = 0; w < a.W; ++w) {
    if (sel[w] & ~lb[w]) return false;
    if (tb[w] & ~tol[w]) return false;
  }
  return true;
}

inline bool p_fit(const float* resreq, const float* avail, const float* tol,
                  int R) {
  for (int r = 0; r < R; ++r) {
    bool ok = resreq[r] < avail[r] + tol[r];
    if (!ok && r >= 2 && resreq[r] <= tol[r]) ok = true;
    if (!ok) return false;
  }
  return true;
}

// Scores never move during a preempt pass (``used`` static) — shared
// body in score_at above.
inline double p_score(const PArgs& a, const Weights& wt, const float* resreq,
                      int n) {
  return score_at(wt, resreq, a.node_used + (size_t)n * a.R,
                  a.node_alloc + (size_t)n * a.R);
}

struct PState {
  std::vector<float> fi;        // [N,R]
  std::vector<int32_t> ncount;  // [N]
  std::vector<uint8_t> alive;   // [V]
  std::vector<uint8_t> evicted; // [V]
  std::vector<int32_t> ready;   // [J]
  std::vector<int32_t> waiting; // [J]
  std::vector<int32_t> pipelined; // [P]
};

// One _preempt try (preempt.go:181-259); mutates st on success.
bool p_attempt(const PArgs& a, const Weights& wt, PState& st, int p, int pjob,
               bool same_job, Pool* pool, int threads,
               std::vector<double>& vsum, std::vector<int32_t>& vcnt,
               std::vector<uint8_t>& elig) {
  const float* resreq = a.task_resreq + (size_t)p * a.R;
  const int64_t pprio = a.job_prio[pjob];

  // victim eligibility (priority ∩ gang ∩ phase filter), fixed per attempt
  std::fill(vsum.begin(), vsum.end(), 0.0);
  std::fill(vcnt.begin(), vcnt.end(), 0);
  bool any = false;
  for (int v = 0; v < a.V; ++v) {
    elig[v] = 0;
    if (!st.alive[v]) continue;
    int vj = a.vic_job[v];
    if (!(a.job_prio[vj] < pprio)) continue;
    if (same_job) {
      if (vj != pjob) continue;
    } else {
      if (a.job_queue[vj] != a.job_queue[pjob] || vj == pjob) continue;
    }
    int ma = a.job_min_avail[vj];
    if (!(ma <= st.ready[vj] - 1 || ma == 1)) continue;  // gang.go:75-94
    elig[v] = 1;
    any = true;
    int n = a.vic_node[v];
    for (int r = 0; r < a.R; ++r)
      vsum[(size_t)n * a.R + r] += (double)a.vic_resreq[(size_t)v * a.R + r];
    vcnt[n] += 1;
  }
  if (!any) return false;

  // node sweep: validation (preempt.go:261-276) + score argmax, lowest
  // index tie-break.  Parallel chunks mirror the reference's 16-way
  // PredicateNodes/PrioritizeNodes fan-out.
  auto node_valid = [&](int n) -> bool {
    if (!p_static_feasible(a, p, n)) return false;
    if (st.ncount[n] >= a.node_max_tasks[n]) return false;
    if (vcnt[n] <= 0) return false;
    const float* fi = st.fi.data() + (size_t)n * a.R;
    for (int r = 0; r < a.R; ++r) {
      float avail = fi[r] + (float)vsum[(size_t)n * a.R + r];
      bool ok = resreq[r] < avail + a.tolerance[r];
      if (!ok && r >= 2 && resreq[r] <= a.tolerance[r]) ok = true;
      if (!ok) return false;
    }
    return true;
  };

  int best = -1;
  double best_score = -std::numeric_limits<double>::infinity();
  if (pool == nullptr) {
    for (int n = 0; n < a.N; ++n) {
      if (!node_valid(n)) continue;
      double sc = p_score(a, wt, resreq, n);
      if (sc > best_score) { best_score = sc; best = n; }
    }
  } else {
    std::vector<int> cb(threads, -1);
    std::vector<double> cs(threads, -std::numeric_limits<double>::infinity());
    int chunk = (a.N + threads - 1) / threads;
    pool->Dispatch([&](int w) {
      int lo = w * chunk, hi = std::min(a.N, lo + chunk);
      for (int n = lo; n < hi; ++n) {
        if (!node_valid(n)) continue;
        double sc = p_score(a, wt, resreq, n);
        if (sc > cs[w]) { cs[w] = sc; cb[w] = n; }
      }
    });
    for (int w = 0; w < threads; ++w)
      if (cb[w] >= 0 && cs[w] > best_score) { best_score = cs[w]; best = cb[w]; }
  }
  if (best < 0) return false;

  // evict in array order (per-node eviction order) until the task fits
  float* fi = st.fi.data() + (size_t)best * a.R;
  for (int v = 0; v < a.V; ++v) {
    if (!elig[v] || a.vic_node[v] != best) continue;
    if (p_fit(resreq, fi, a.tolerance, a.R)) break;
    st.alive[v] = 0;
    st.evicted[v] = 1;
    for (int r = 0; r < a.R; ++r) fi[r] += a.vic_resreq[(size_t)v * a.R + r];
    st.ready[a.vic_job[v]] -= 1;
  }
  if (!p_fit(resreq, fi, a.tolerance, a.R)) return false;
  for (int r = 0; r < a.R; ++r) fi[r] -= resreq[r];
  st.ncount[best] += 1;
  st.waiting[pjob] += 1;
  st.pipelined[p] = best;
  return true;
}

}  // namespace

extern "C" {

// Returns 0 on success; fills evicted[V] (0/1) and pipelined[P] (node or -1).
int baseline_preempt(
    const float* task_resreq, const uint32_t* task_sel_bits,
    const uint32_t* task_tol_bits, const float* node_used,
    const float* node_alloc, const float* node_fi0,
    const uint32_t* node_label_bits, const uint32_t* node_taint_bits,
    const uint8_t* node_ok, const int32_t* node_task_count,
    const int32_t* node_max_tasks, const float* vic_resreq,
    const int32_t* vic_node, const int32_t* vic_job, const int64_t* job_prio,
    const int32_t* job_min_avail, const int32_t* job_ready0,
    const int32_t* job_waiting0, const int32_t* job_queue,
    const int32_t* job_pstart, const int32_t* job_pend,
    const int32_t* schedule, const float* tolerance, int P, int N, int V,
    int J, int R, int W, int S, int n_threads, uint8_t* evicted_out,
    int32_t* pipelined_out) {
  PArgs a{P, N, V, J, R, W,
          task_resreq, task_sel_bits, task_tol_bits,
          node_used, node_alloc, node_label_bits, node_taint_bits,
          node_ok, node_max_tasks, vic_resreq, vic_node, vic_job,
          job_prio, job_min_avail, job_queue, tolerance};
  Weights wt;

  PState st;
  st.fi.assign(node_fi0, node_fi0 + (size_t)N * R);
  st.ncount.assign(node_task_count, node_task_count + N);
  st.alive.assign(V, 1);
  st.evicted.assign(V, 0);
  st.ready.assign(job_ready0, job_ready0 + J);
  st.waiting.assign(job_waiting0, job_waiting0 + J);
  st.pipelined.assign(P, -1);
  std::vector<int32_t> cursor(job_pstart, job_pstart + J);

  const int threads = n_threads > 0 ? n_threads : 16;
  std::unique_ptr<Pool> pool_holder;
  Pool* pool = nullptr;
  if (threads > 1 && N >= 2048) {
    pool_holder.reset(new Pool(threads));
    pool = pool_holder.get();
  }

  std::vector<double> vsum((size_t)N * R);
  std::vector<int32_t> vcnt(N);
  std::vector<uint8_t> elig(V);

  auto job_pipelined = [&](int j) {
    return st.waiting[j] + st.ready[j] >= job_min_avail[j];
  };

  for (int s = 0; s < S; ++s) {
    int phase = schedule[(size_t)s * 2];
    int j = schedule[(size_t)s * 2 + 1];
    if (phase == 1) {
      // statement scope: commit iff the job ends pipelined; cursor is
      // NOT part of the rollback (the host PQ pops have no undo)
      PState saved = st;
      while (cursor[j] < job_pend[j]) {
        if (job_pipelined(j)) break;
        int p = cursor[j]++;
        p_attempt(a, wt, st, p, j, /*same_job=*/false, pool, threads, vsum,
                  vcnt, elig);
      }
      if (!job_pipelined(j)) st = std::move(saved);
    } else {
      while (cursor[j] < job_pend[j]) {
        int p = cursor[j]++;
        if (!p_attempt(a, wt, st, p, j, /*same_job=*/true, pool, threads,
                       vsum, vcnt, elig))
          break;
      }
    }
  }

  std::memcpy(evicted_out, st.evicted.data(), V);
  std::memcpy(pipelined_out, st.pipelined.data(), (size_t)P * 4);
  return 0;
}

}  // extern "C"
