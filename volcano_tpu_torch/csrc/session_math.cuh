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
// function serves [R, NK] planes (stride NK) and per-node vectors; the
// two-stride forms read the read-only planes and the used lanes at
// strides of their own (the wide kernel: planes in list order, used
// lanes by node id).
//
// Least-requested has two modes, chosen by the template flag LrInt: the
// f32 floor division with its multiply-back correction, exact while node
// capacity x 10 stays below 2^24, and the exact int32 division of
// ops/kernels.py least_requested_score(int_exact=True) for nodes beyond
// that (2 TB DGX H100 nodes: 2,097,152 MiB x 10 >= 2^24).  A template
// flag, not a run-time one, so the f32 path compiles as it did before the
// int mode (a uniform run-time branch cost the f32 pass 3%).  The int
// mode follows XLA's int32 semantics, not C++'s: the f32 -> int32
// convert saturates (NaN -> 0), products and sums wrap, and // floors.
#pragma once

#include <limits.h>
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

// XLA's f32 -> int32 convert: toward zero, saturating at the int32
// range, NaN -> 0 (a C++ cast of an out-of-range value is undefined).
VT_HD int f32_to_i32(float x) {
  if (!(x == x)) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(x);
}

// int32 a + b, a - b and a * b wrapping modulo 2^32, as XLA's int32 ops
// do (signed overflow is undefined in C++).
VT_HD int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
VT_HD int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
VT_HD int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// a // d for d > 0: floor division, as jnp's // (C++ / truncates, which
// differs for a negative numerator, one that wrapped).
VT_HD int floor_div(int a, int d) {
  const int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

// One int-exact least-requested lane: ((cap - req) * 10) // max(cap, 1)
// where cap > 0 and req <= cap, else 0, from the f32 values converted.
VT_HD int lr_lane_int(float req, float cap) {
  const int reqi = f32_to_i32(req);
  const int capi = f32_to_i32(cap);
  if (!(capi > 0 && reqi <= capi)) return 0;
  return floor_div(wrap_mul(wrap_sub(capi, reqi), 10), capi);
}

VT_HD float lane_weight(const Weights& w, int r) {
  return r == 0 ? w.cpu : (r == 1 ? w.mem : w.scalar);
}

// rr[r] < idle[r] + tol[r] on every lane, idle = base - used; scalar
// lanes (r >= 2) also pass below tolerance (host LessEqual).  base is
// read at lane stride bs, used at us.
VT_HD bool fits(int R, const float* rr, const float* tol, const float* base, int bs,
                const float* used, int us) {
  bool fit = true;
  for (int r = 0; r < R; ++r) {
    const float idle = base[r * bs] - used[r * us];
    bool ok = rr[r] < idle + tol[r];
    if (r >= 2) ok = ok || rr[r] <= tol[r];
    fit = fit && ok;
  }
  return fit;
}

VT_HD bool fits(int R, const float* rr, const float* tol, const float* base,
                const float* used, int stride) {
  return fits(R, rr, tol, base, stride, used, stride);
}

// binpack + least-requested + balanced, in score_planes' op order;
// least-requested in int32 where LrInt.  max(alloc, 1) and alloc > 0
// come from the alloc value already loaded.  alloc is read at lane
// stride as, used at us.
template <bool LrInt = false>
VT_HD float node_score(int R, const float* rr, const float* alloc, int as, const float* used,
                       int us, const Weights& w) {
  // binpack: lanes with weight 0 are skipped, as score_planes does
  bool any = false;
  float bp = 0.0f;
  float ws = 0.0f;
  for (int r = 0; r < R; ++r) {
    const float lw = lane_weight(w, r);
    if (lw == 0.0f) continue;
    const bool reqmask = rr[r] > 0.0f;
    const float cap = alloc[r * as];
    const float req = rr[r] + used[r * us];
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
  // correction, or int32 division (LrInt); the balanced fractions reuse
  // req / max(alloc, 1)
  float lr = 0.0f;
  int lri = 0;
  float frac[2];
  for (int r = 0; r < 2; ++r) {
    const float cap = alloc[r * as];
    const float c = fmaxf(cap, 1.0f);
    const bool pos = cap > 0.0f;
    const float req = rr[r] + used[r * us];
    if (LrInt) {
      const int lane = lr_lane_int(req, cap);
      lri = r == 0 ? lane : wrap_add(lri, lane);
    } else {
      const float p = (cap - req) * kMaxPriority;
      float q = floorf(p / c);
      q = q + ((q + 1.0f) * c <= p ? 1.0f : 0.0f) - (q * c > p ? 1.0f : 0.0f);
      const float lane = (pos && req <= cap) ? q : 0.0f;
      lr = r == 0 ? lane : lr + lane;
    }
    frac[r] = pos ? req / c : 1.0f;
  }
  // int mode: (lane0 + lane1) // 2, converted to f32 (round to nearest)
  const float s_lr = LrInt ? static_cast<float>(floor_div(lri, 2)) : floorf(lr * 0.5f);

  const float diff = fabsf(frac[0] - frac[1]);
  float s_bal = floorf((1.0f - diff) * kMaxPriority);
  if (frac[0] >= 1.0f || frac[1] >= 1.0f) s_bal = 0.0f;

  return s_bp + w.lr * s_lr + w.bal * s_bal;
}

template <bool LrInt = false>
VT_HD float node_score(int R, const float* rr, const float* alloc, const float* used,
                       int stride, const Weights& w) {
  return node_score<LrInt>(R, rr, alloc, stride, used, stride, w);
}

// The value the step's argmax runs over: the node score where the task
// may go there, -inf where it may not (and then the score is skipped).
// base and alloc are read at lane stride bs, used at us.
template <bool LrInt = false>
VT_HD float masked_score(int R, const float* rr, const float* tol, float act, bool cls_ok,
                         const float* base, const float* alloc, int bs, const float* used,
                         int us, float cnt, float maxt, const Weights& w) {
  const bool feasible =
      fits(R, rr, tol, base, bs, used, us) && cnt < maxt && cls_ok && act > 0.0f;
  if (!feasible) return -INFINITY;
  return node_score<LrInt>(R, rr, alloc, bs, used, us, w);
}

template <bool LrInt = false>
VT_HD float masked_score(int R, const float* rr, const float* tol, float act, bool cls_ok,
                         const float* base, const float* alloc, const float* used,
                         int stride, float cnt, float maxt, const Weights& w) {
  return masked_score<LrInt>(R, rr, tol, act, cls_ok, base, alloc, stride, used, stride, cnt,
                             maxt, w);
}

}  // namespace vt
