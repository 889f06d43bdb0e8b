#!/usr/bin/env python3
"""Time each design step of the preempt kernel, in turns, on one GPU.

  python3 preempt_steps.py make PARENT   (in a git checkout: write the trees)
  python3 preempt_steps.py time          (on the card)

``make`` writes into ``_steps/`` (gitignored) one copy of the package
``volcano_tpu_torch/`` per step of the kernel's redesign, each made from
this checkout with the later steps taken out, and one of the package at
git commit PARENT, the kernel before the redesign:
  s0       the kernel before the redesign (PARENT): every fired attempt
           sweeps every node column with every victim slot;
  s1       the repeated-attempt fast path with the Pallas kernel's key
           (same job, class, score class) and its node-exact dirty set;
           each slot's victim job, priority, queue, min_available and
           request gathered through vjob and the job tables; no
           compaction (every queue's list holds every node with all its
           slots); the drain reloads what it stored;
  s2       + the wide key (class, score class, priority, queue; two jobs
           that own no victim slot);
  s3       + the per-slot planes in list order;
  s4       + the queue-compacted slot lists;
  this checkout: + the drain off the chain (node state in registers, the
           pick's new value from them, counts and ready/waiting updates as
           reductions, the slot row carried across fired attempts);
  gathers  this checkout without the per-slot planes (is step 3 still
           worth its scratch once the lists and the drain are in?).
Every tree but s0 keeps this checkout's schedule walk.

``time`` runs the 100k pods x 10k nodes preempt pass of each tree in its
own process, in turns (s0, s1, ..., this, gathers, then back): the mean
device ms of REPS launches after one warm-up (CUDA events), the launch
alone and through the wrapper, the plane-off launch where the tree has
one, the kernel's counts, and a digest of ``evicted`` and ``pipelined``,
which must be one for every tree.  It prints a JSON line per turn, then
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = os.path.join(ROOT, "_steps")
ORDER = ("s0", "s1", "s2", "s3", "s4", ".", "gathers")
CONFIG = "100k_pods_10k_nodes_preempt"
REPS = 5

#: taken out for s3: the lists become every node of the cluster in every
#: queue's list, with all its slots (the kernel's queue test then filters
#: them)
EVERY_NODE_LISTS = '''

def victim_lists(vjob, job_queue):
    """Every node in every queue's list, with all its slots."""
    K, NK = vjob.shape
    J = job_queue.shape[0]
    dev = vjob.device
    occupied = vjob >= 0
    vq = job_queue.long()[vjob.clamp_min(0).long()]
    Q = int(vq[occupied].max()) + 1 if bool(occupied.any()) else 0
    qoff = torch.arange(Q + 1, device=dev) * NK
    qnode = torch.arange(NK, device=dev).repeat(Q)
    qslot = torch.arange(K, device=dev)[:, None].expand(K, Q * NK)
    ks, ns = torch.nonzero(occupied, as_tuple=True)
    vj = vjob[ks, ns].long()
    jp = torch.unique(vj * (Q * NK) + qoff[vq[ks, ns]] + ns)  # by job, then position
    jlo = torch.zeros(J + 1, dtype=torch.long, device=dev)
    jlo[1:] = torch.cumsum(torch.bincount(jp // (Q * NK), minlength=J), 0)

    def i32(x):
        return x.to(torch.int32).contiguous()

    return dict(qoff=i32(qoff), qnode=i32(qnode), qslot=i32(qslot), jlo=i32(jlo),
                jlist=i32(jp % (Q * NK)), longest=NK if Q else 0)
'''

#: taken out for s2: eligibility and the drain gather through vjob, vr and
#: the job tables again, and the kernel builds no per-slot planes
SLOT_PLANES = [
    ("  const int i = kk * in.LQ + g;\n"
     "  vj = st.lvj[i];\n"
     "  prio = st.lprio[i];\n"
     "  queue = st.lqueue[i];\n"
     "  vmin = st.lmin[i];\n",
     "  vj = k < 0 ? -1 : in.vjob[k * in.NK + n];\n"
     "  const int s = vj < 0 ? 0 : vj;\n"
     "  prio = in.jobi[2 * in.J + s];\n"
     "  queue = in.jobi[in.J + s];\n"
     "  vmin = in.jobf[2 * in.J + s];\n"),
    ("  return st.lvr[(r * in.KQ + kk) * in.LQ + g];",
     "  return in.vr[(r * in.K + k) * in.NK + n];"),
]
NO_PLANE_BUILD = (
    "  for (int i = tid; i < in.KQ * in.LQ; i += kThreads) vt::list_planes<R>(in, st, i);\n", "")

#: taken out for s4 and before: the drain reloads what it stored and
#: updates counts and ready/waiting by read-modify-write
DRAIN_START = "// Evict on the node at list position g in slot order until the request"
DRAIN_END = "}  // namespace vt"
RELOADING_DRAIN = '''// Evict on the node at list position g in slot order until the request
// fits, then pipeline the attempt's task there (preempt.go:216-259).
// Eligibility is that of the attempt's start: the ready counts of evicted
// victims' jobs drop only after the drain.  Out: the dirty set, this pick
// and the jlist runs of the evicted victims' jobs whose gang allowance
// can flip (min_available != 1); with a plane, the pick's new value under
// this attempt's key.
template <int R>
VT_HD void drain_and_pipeline(const PreemptIn& in, const PreemptState& st, Journal& jr,
                              const Attempt& a, const float* rr, const float* tol, int g,
                              float* plane, Dirty& d) {
  const int NK = in.NK;
  const int n = in.qnode[g];
  st.jnode[jr.nodes] = n;
  for (int r = 0; r < R; ++r) st.jvals[jr.nodes * (R + 1) + r] = st.fi[r * NK + n];
  st.jvals[jr.nodes * (R + 1) + R] = st.ncnt[n];
  ++jr.nodes;

  float cum[R];
  for (int r = 0; r < R; ++r) cum[r] = 0.0f;
  const int first = jr.evicts;
  d.pick = g - a.start;
  d.ndirty = 0;
  for (int kk0 = 0; kk0 < in.KQ; kk0 += kChunk) {
    SlotChunk c;
    load_chunk(in, st, a, g, n, kk0, c);
    for (int x = 0; x < kChunk; ++x) {
      if (!c.elig[x] || !drain_not_fit<R>(rr, tol, st.fi + n, NK, cum)) continue;
      for (int r = 0; r < R; ++r)
        cum[r] = cum[r] + listed_req(in, st, kk0 + x, g, n, c.k[x], r);
      const int idx = c.k[x] * NK + n;
      st.evicted[idx] = 1;
      st.jevict[jr.evicts++] = idx;
      if (c.vmin[x] != 1.0f) {
        st.dirty[2 * d.ndirty] = in.jlo[c.vj[x]];
        st.dirty[2 * d.ndirty + 1] = in.jlo[c.vj[x] + 1];
        ++d.ndirty;
      }
    }
  }
  for (int e = first; e < jr.evicts; ++e) {
    const int vj = in.vjob[st.jevict[e]];
    st.ready[vj] = st.ready[vj] - 1.0f;
  }
  st.stats[2] += jr.evicts - first;
  for (int r = 0; r < R; ++r) st.fi[r * NK + n] = st.fi[r * NK + n] + cum[r];

  float zero[R];
  for (int r = 0; r < R; ++r) zero[r] = 0.0f;
  if (fits_with<R>(rr, tol, st.fi + n, NK, zero)) {
    for (int r = 0; r < R; ++r) st.fi[r * NK + n] = st.fi[r * NK + n] - rr[r];
    st.ncnt[n] = st.ncnt[n] + 1.0f;
    st.wait[a.j] = st.wait[a.j] + 1.0f;
    st.pipelined[a.p] = n;
    st.jpipe[jr.pipes++] = a.p;
  }
  if (plane != nullptr) plane[d.pick] = position_value<R>(in, st, a, rr, tol, g);
}

'''
REDUCTIONS = ("  atomicAdd(p, v);\n", "  *p += v;\n")

#: taken out for s1: the key asks for the same job
WIDE_KEY = ("(a.j == last.j || (a.own == 0 && last.own == 0))", "a.j == last.j")


def _patch(path: str, old: str, new: str) -> None:
    with open(path) as f:
        text = f.read()
    if old not in text:
        raise SystemExit(f"preempt_steps: {path} no longer holds the text a step takes out")
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def _replace_span(path: str, start: str, end: str, new: str) -> None:
    with open(path) as f:
        text = f.read()
    i, j = text.find(start), text.find(end)
    if i < 0 or j < i:
        raise SystemExit(f"preempt_steps: {path} no longer holds the span a step takes out")
    with open(path, "w") as f:
        f.write(text[:i] + new + text[j:])


def make(parent: str) -> None:
    shutil.rmtree(STEPS, ignore_errors=True)
    os.makedirs(os.path.join(STEPS, "s0"))
    archive = subprocess.run(["git", "archive", parent, "volcano_tpu_torch"], cwd=ROOT,
                             check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", os.path.join(STEPS, "s0")], input=archive, check=True)
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    for name in ("gathers", "s4", "s3", "s2", "s1"):
        tree = os.path.join(STEPS, name, "volcano_tpu_torch")
        shutil.copytree(os.path.join(ROOT, "volcano_tpu_torch"), tree, ignore=ignore)
        header = os.path.join(tree, "csrc", "preempt_step.cuh")
        if name != "gathers":
            _replace_span(header, DRAIN_START, DRAIN_END, RELOADING_DRAIN)
            _patch(header, *REDUCTIONS)
        if name in ("s3", "s2", "s1"):
            with open(os.path.join(tree, "ops", "preempt_kernel.py"), "a") as f:
                f.write(EVERY_NODE_LISTS)
        if name in ("gathers", "s2", "s1"):
            for old, new in SLOT_PLANES:
                _patch(header, old, new)
            _patch(os.path.join(tree, "csrc", "preempt_kernel.cu"), *NO_PLANE_BUILD)
        if name == "s1":
            _patch(header, *WIDE_KEY)
    print(f"preempt_steps: trees {', '.join(n for n in ORDER if n != '.')} in {STEPS}")


CHILD = r'''
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from volcano_tpu_torch.ops import preempt_kernel as pk_mod
from volcano_tpu_torch.ops.kernels import DEFAULT_WEIGHTS
from volcano_tpu_torch.ops.synthetic import BASELINE_CONFIGS, generate_preempt_packed

CONFIG, REPS = sys.argv[2], int(sys.argv[3])


def ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(ev, pipe):
    return hashlib.sha256(ev.cpu().numpy().tobytes() + pipe.cpu().numpy().tobytes()).hexdigest()


kwargs = {k: v for k, v in BASELINE_CONFIGS[CONFIG].items() if k != "preempt"}
pk = generate_preempt_packed(**kwargs)
arrays, dims, _ = pk_mod.prepare_preempt_arrays(pk)
inputs = pk_mod.ship_arrays(arrays, torch.device("cuda"))
names = getattr(pk_mod, "KERNEL_STATS", pk_mod.STATS)
stats = torch.zeros(len(names), dtype=torch.int32, device="cuda")
ev, pipe = pk_mod.preempt_pass_cuda(*inputs, stats=stats)
torch.cuda.synchronize()
wrapper_ms = ms(lambda: pk_mod.preempt_pass_cuda(*inputs), REPS)
out = dict(tree=sys.argv[1], ms=wrapper_ms, wrapper_ms=wrapper_ms,
           stats=dict(zip(names, stats.tolist())), digest=digest(ev, pipe), plane_off_ms=None)
if hasattr(pk_mod, "victim_lists"):
    pk_mod._check_pass_args(*inputs, DEFAULT_WEIGHTS, None, len(names))
    lists = pk_mod.victim_lists(inputs[6], inputs[7][1])
    plane_len = pk_mod.plan_plane(lists["longest"])
    out["ms"] = ms(lambda: pk_mod._launch(inputs, lists, DEFAULT_WEIGHTS, None, plane_len), REPS)
    off = lambda: pk_mod._launch(inputs, lists, DEFAULT_WEIGHTS, None, 0)
    if digest(*off()) != out["digest"]:
        raise SystemExit("the plane-off pass differs from the pass")
    out["plane_off_ms"] = ms(off, 3)
    out["plane_len"] = plane_len
print(json.dumps(out))
'''


def _tree(name: str) -> str:
    return ROOT if name == "." else os.path.join(STEPS, name)


def time_steps() -> int:
    for name in ORDER:
        if not os.path.isdir(os.path.join(_tree(name), "volcano_tpu_torch")):
            raise SystemExit(f"preempt_steps: no tree {name}; run make first")
    # build every tree's kernels at once, each in its own process
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
                                " from volcano_tpu_torch.ops import _build; _build.build()",
                                _tree(name)], stdout=subprocess.DEVNULL) for name in ORDER]
    if any(proc.wait() != 0 for proc in builds):
        return 1
    digests = set()
    for name in (*ORDER, *reversed(ORDER)):
        run = subprocess.run([sys.executable, "-c", CHILD, _tree(name), CONFIG, str(REPS)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        record = json.loads(run.stdout.strip().splitlines()[-1])
        record["tree"] = name
        digests.add(record["digest"])
        print(json.dumps(record), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if len(digests) != 1:
        print("preempt_steps: the trees' outputs differ", file=sys.stderr)
        return 1
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "make":
        make(sys.argv[2])
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "time":
        return time_steps()
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
