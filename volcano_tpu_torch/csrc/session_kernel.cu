// One greedy allocate pass on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volcano_tpu/ops/pallas_session.py
// _make_kernel (launched by _pass_call): for each task in order, mask the
// nodes it fits, score them (binpack + least-requested + balanced), pick
// the lowest-index argmax and add the task to that node's state.  Results
// are bit-identical to ops/kernels.py _assign_step; the per-node
// arithmetic lives in session_math.cuh.
//
// What bounds it: the scan is sequential — task k+1's scores depend on
// task k's pick — so every step is a full pass over the nodes followed
// by a block-wide argmax.  The work is f32 operations (about 70 per
// node per task, six of them IEEE divisions); the bytes are small
// (inputs are read once into L2, node state never leaves shared
// memory).  The design keeps all state on one SM:
//   * one block of 1024 threads runs the whole pass as a loop over
//     tasks, threads striding over nodes — the loop takes the place of
//     the TPU's sequential grid;
//   * used lanes [R, NK] and pod counts [NK] stay resident in dynamic
//     shared memory for the whole pass ((R+1)*NK*4 bytes, 120 KB at 10k
//     nodes); the read-only node planes stream from global memory / L2;
//   * the argmax is warp shuffles, then one warp over the 32 warp
//     results; thread 0 applies the update and stages the next task row.
// Two block barriers per task set the latency floor of a step.  One SM
// of 132 does the work: spreading a pass over a cluster of SMs is the
// next design step.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_argmax.cuh"
#include "session_math.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

using vt::warp_argmax;

__global__ void __launch_bounds__(kThreads, 1)
session_pass_kernel(const float* __restrict__ taskrow,  // [T, R+2]: resreq, class, active
                    int T, int R,
                    const uint8_t* __restrict__ cf,  // [C, NK] class feasibility
                    int C,
                    const float* __restrict__ nd,  // [3R+2, NK]: base|alloc|used0|count0, maxt
                    const float* __restrict__ tol,       // [R]
                    const int* __restrict__ done,        // [1] or null: skip the pass
                    int NK, vt::Weights w,
                    int* __restrict__ chosen) {  // [T] node index or -1
  extern __shared__ float smem[];
  float* used = smem;                         // [R, NK]
  float* cnt = smem + static_cast<size_t>(R) * NK;  // [NK]
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float srow[vt::kMaxLanes + 2];  // the current task row
  __shared__ float stol[vt::kMaxLanes];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int RC = R + 2;

  if (done != nullptr && *done != 0) {
    // the gang fixpoint settled: this round places nothing
    for (int t = tid; t < T; t += kThreads) chosen[t] = -1;
    return;
  }

  const float* base = nd;
  const float* alloc = nd + static_cast<size_t>(R) * NK;
  const float* used0 = nd + static_cast<size_t>(2 * R) * NK;
  const float* cnt0 = nd + static_cast<size_t>(3 * R) * NK;
  const float* maxt = nd + static_cast<size_t>(3 * R + 1) * NK;

  for (int i = tid; i < R * NK; i += kThreads) used[i] = used0[i];
  for (int n = tid; n < NK; n += kThreads) cnt[n] = cnt0[n];
  if (tid < R) stol[tid] = tol[tid];
  if (tid < RC && T > 0) srow[tid] = taskrow[tid];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float act = srow[R + 1];
    const int cls = static_cast<int>(srow[R]);
    const uint8_t* cf_row =
        (cls >= 0 && cls < C) ? cf + static_cast<size_t>(cls) * NK : nullptr;

    float bv = -INFINITY;
    int bi = INT_MAX;
    if (act > 0.0f && cf_row != nullptr) {
      for (int n = tid; n < NK; n += kThreads) {
        const float v = vt::masked_score(R, srow, stol, act, cf_row[n] != 0, base + n,
                                         alloc + n, used + n, NK, cnt[n], maxt[n], w);
        if (v > bv) {  // ascending n: the first max of this thread's nodes
          bv = v;
          bi = n;
        }
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();

    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        if (bv > -INFINITY) {  // some node is feasible
          for (int r = 0; r < R; ++r) used[r * NK + bi] = used[r * NK + bi] + srow[r];
          cnt[bi] = cnt[bi] + 1.0f;
          chosen[t] = bi;
        } else {
          chosen[t] = -1;
        }
        if (t + 1 < T) {
          const float* next = taskrow + static_cast<size_t>(t + 1) * RC;
          for (int r = 0; r < RC; ++r) srow[r] = next[r];
        }
      }
    }
    __syncthreads();
  }
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
//       address dependent on the row before (the next-row load)
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

// Launch one pass on ``stream``.  Returns the cudaError_t of the launch
// (0 on success): a launch refused for its shared memory never runs, and
// only cudaGetLastError reports it.
extern "C" int vt_session_pass(const float* taskrow, int T, int R, const uint8_t* cf, int C,
                               const float* nd, const float* tol, const int* done, int NK,
                               float w_bp, float w_cpu, float w_mem, float w_scalar,
                               float w_lr, float w_bal, int* chosen, void* stream,
                               int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(R + 1) * NK * sizeof(float);
  err = cudaFuncSetAttribute(session_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const vt::Weights w{w_bp, w_cpu, w_mem, w_scalar, w_lr, w_bal};
  session_pass_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      taskrow, T, R, cf, C, nd, tol, done, NK, w, chosen);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
