// Per-node arithmetic of one preempt attempt: victim eligibility, the
// validation of a node (fit with the eligible victims' requests added
// back), and the eviction drain's not-fit test.
//
// The single copy shared by the CUDA preempt kernel (preempt_kernel.cu)
// and the host test shim, which compiles this header with g++.  Every
// expression follows volcano_tpu/ops/preempt_pallas.py
// _make_preempt_kernel (elig_view, masked_rows and the drain) operation
// for operation, so results are bit-identical to the reference under the
// flags session_math.cuh names (no FMA contraction, no fast math).
//
// A node's planes are read as p[r * stride] for lane r, so the same
// function serves [R, NK] planes (stride NK) and per-node vectors.
#pragma once

#include "session_math.cuh"

namespace vt {

// Slot kinds of the static schedule (preempt_pallas.py K_BEGIN1 ...).
constexpr int kSlotBegin = 0;
constexpr int kSlotAttempt = 1;
constexpr int kSlotEnd = 2;
constexpr int kSlotBurn = 5;

// Whether the victim in one slot may be evicted by a cross-job attempt
// of preemptor job pjob: the slot is occupied and not yet evicted; the
// gang plugin allows it (min_available 1, or the victim's job stays at
// or above min_available after losing one ready task); the victim's job
// has strictly lower priority; same queue, different job.
VT_HD bool victim_eligible(int vjob, bool evicted, int vprio, int vqueue, float vmin,
                           float vready, int pjob, int pprio, int pqueue) {
  if (vjob < 0 || evicted) return false;
  const bool gang_ok = vmin == 1.0f || vmin <= vready - 1.0f;
  return gang_ok && vprio < pprio && vqueue == pqueue && vjob != pjob;
}

// rr[r] < (fi[r] + extra[r]) + tol[r] on every lane; scalar lanes
// (r >= 2) also pass below tolerance (host LessEqual).  With ``extra``
// the eligible victims' summed requests this is the validation fit;
// with the drain's running sum it is the drain's fit test.
template <int R>
VT_HD bool fits_with(const float* rr, const float* tol, const float* fi, int stride,
                     const float* extra) {
  bool fit = true;
  for (int r = 0; r < R; ++r) {
    bool ok = rr[r] < (fi[r * stride] + extra[r]) + tol[r];
    if (r >= 2) ok = ok || rr[r] <= tol[r];
    fit = fit && ok;
  }
  return fit;
}

// The drain evicts the next eligible victim while this holds.
template <int R>
VT_HD bool drain_not_fit(const float* rr, const float* tol, const float* fi, int stride,
                         const float* cum) {
  return !fits_with<R>(rr, tol, fi, stride, cum);
}

// A node validates an attempt: its class may take the task, it has
// pod-count headroom, at least one victim is eligible, and the request
// fits future-idle plus the eligible victims' requests (vsum, summed in
// slot order).
template <int R>
VT_HD bool node_validates(const float* rr, const float* tol, const float* fi, int stride,
                          const float* vsum, int vcnt, float ncnt, float nmax, bool cls_ok) {
  return cls_ok && ncnt < nmax && vcnt > 0 && fits_with<R>(rr, tol, fi, stride, vsum);
}

}  // namespace vt
