// Per-node arithmetic of one greedy allocate step: resource fit, the
// three plugin scores and the masked value the argmax runs over.
//
// The single copy shared by the CUDA session kernel (session_kernel.cu)
// and the host test shim, which compiles this header with g++.  Every
// expression follows volcano_tpu/ops/pallas_session.py score_planes and
// ops/kernels.py _assign_step operation for operation, so the result is
// bit-identical to the reference as long as the compiler neither
// contracts a*b+c into a fused multiply-add (nvcc --fmad=false, g++
// -ffp-contract=off) nor relaxes IEEE division (never fast math).
//
// A node's planes are read as p[r * stride] for lane r, so the same
// function serves [R, NK] planes (stride NK) and per-node vectors.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define VT_HD __host__ __device__ __forceinline__
#else
#define VT_HD inline
#endif

namespace vt {

// Most resource lanes a task row may carry (cpu, memory, scalars).
constexpr int kMaxLanes = 8;
constexpr float kMaxPriority = 10.0f;

// Plugin weights (ops/kernels.py ScoreWeights, f32-rounded).
struct Weights {
  float bp;      // binpack_weight
  float cpu;     // binpack_cpu
  float mem;     // binpack_memory
  float scalar;  // binpack_scalar
  float lr;      // least_requested_weight
  float bal;     // balanced_resource_weight
};

VT_HD float lane_weight(const Weights& w, int r) {
  return r == 0 ? w.cpu : (r == 1 ? w.mem : w.scalar);
}

// rr[r] < idle[r] + tol[r] on every lane, idle = base - used; scalar
// lanes (r >= 2) also pass below tolerance (host LessEqual).
VT_HD bool fits(int R, const float* rr, const float* tol, const float* base,
                const float* used, int stride) {
  bool fit = true;
  for (int r = 0; r < R; ++r) {
    const float idle = base[r * stride] - used[r * stride];
    bool ok = rr[r] < idle + tol[r];
    if (r >= 2) ok = ok || rr[r] <= tol[r];
    fit = fit && ok;
  }
  return fit;
}

// binpack + least-requested + balanced, in score_planes' op order.
// max(alloc, 1) and alloc > 0 come from the alloc value already loaded.
VT_HD float node_score(int R, const float* rr, const float* alloc, const float* used,
                       int stride, const Weights& w) {
  // binpack: lanes with weight 0 are skipped, as score_planes does
  bool any = false;
  float bp = 0.0f;
  float ws = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float lw = lane_weight(w, r);
    if (lw == 0.0f) continue;
    const bool reqmask = rr[r] > 0.0f;
    const float cap = alloc[r * stride];
    const float req = rr[r] + used[r * stride];
    const bool valid = reqmask && cap > 0.0f && req <= cap;
    const float lane = valid ? req * lw / fmaxf(cap, 1.0f) : 0.0f;
    bp = any ? bp + lane : lane;
    any = true;
    ws = ws + (reqmask ? lw : 0.0f);
  }
  float s_bp = 0.0f;
  if (any) {
    s_bp = (ws > 0.0f ? bp / ws : 0.0f) * kMaxPriority;
    if (w.bp != 1.0f) s_bp = s_bp * w.bp;
  }

  // least-requested: f32 floor division with the multiply-back
  // correction; the balanced fractions reuse req / max(alloc, 1)
  float lr = 0.0f;
  float frac[2];
  for (int r = 0; r < 2; ++r) {
    const float cap = alloc[r * stride];
    const float c = fmaxf(cap, 1.0f);
    const bool pos = cap > 0.0f;
    const float req = rr[r] + used[r * stride];
    const float p = (cap - req) * kMaxPriority;
    float q = floorf(p / c);
    q = q + ((q + 1.0f) * c <= p ? 1.0f : 0.0f) - (q * c > p ? 1.0f : 0.0f);
    const float lane = (pos && req <= cap) ? q : 0.0f;
    lr = r == 0 ? lane : lr + lane;
    frac[r] = pos ? req / c : 1.0f;
  }
  const float s_lr = floorf(lr * 0.5f);

  const float diff = fabsf(frac[0] - frac[1]);
  float s_bal = floorf((1.0f - diff) * kMaxPriority);
  if (frac[0] >= 1.0f || frac[1] >= 1.0f) s_bal = 0.0f;

  return s_bp + w.lr * s_lr + w.bal * s_bal;
}

// The value the step's argmax runs over: the node score where the task
// may go there, -inf where it may not (and then the score is skipped).
VT_HD float masked_score(int R, const float* rr, const float* tol, float act, bool cls_ok,
                         const float* base, const float* alloc, const float* used,
                         int stride, float cnt, float maxt, const Weights& w) {
  const bool feasible =
      fits(R, rr, tol, base, used, stride) && cnt < maxt && cls_ok && act > 0.0f;
  if (!feasible) return -INFINITY;
  return node_score(R, rr, alloc, used, stride, w);
}

}  // namespace vt
