"""K6's accesses and K7's design choices, timed on the card against each other.

    python -m flnerf_tpu_torch.tools.lattice_probe [--n 393216]
        on uniform random points and a random 2^19 lattice table;
    chip_smoke.py phase 10 calls ``probe`` and ``probe_backward`` on the
    lattice trainer's own batch, table and gradients.

K6's variants are K6 (``lattice_fwd_kernel`` of ``ops/csrc/hash_lattice.cu``)
as a template over four switches, generated from the committed source by
four substitutions (each checked to apply once), timed by CUDA events on
the same inputs:
  SORTED     walk each level's points in ascending base-key order (the
             order K5 gives, ``lattice_sort_order``), where K6 walks them in
             their own order;
  PL_STORE   store at [p, l] of the [N, Lb*2] layout, where K6 stores at
             [l, p] of [Lb, N, 2];
  NO_GATHER  a value made from the corner's index instead of its 8 table
             loads;
  NO_STORE   no store (kept only for a value that never occurs).
SORTED | PL_STORE is the sorted walk of the kernel K6 replaced, PL_STORE
alone its point-order walk.

K7's variants (``BWD_VARIANTS``), by CUDA events and by the profiler's
device time: K7 (the tile skeleton of ``csrc/hash_corners.cuh`` on the
lattice geometry, 64 points a CTA, the warp merge), the same tile without
the merge (a live lane adds its 8 corners with 8 atomics), tiles of 128 and
256 points, and the kernel K7 replaced (one thread per (point, level),
level fastest, 8 atomics a live thread, no tile, no merge), kept here as a
source string.  Each variant's gradient is held against K7's (1e-4 of the
largest entry; exactly zero where K7's is).

All variants are built by nvcc into ``build/probe/`` from the committed
source with the variants appended.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from flnerf_tpu_torch.ops import _build

SORTED, PL_STORE, NO_GATHER, NO_STORE = 1, 2, 4, 8
VARIANTS = {
    "K6 (point order, [l, p] store)": 0,
    "no gather": NO_GATHER,
    "no store": NO_STORE,
    "no gather, no store (x01 and arithmetic)": NO_GATHER | NO_STORE,
    "[p, l] store (the replaced kernel, point order)": PL_STORE,
    "sorted order, [l, p] store": SORTED,
    "sorted order, [p, l] store (the replaced kernel)": SORTED | PL_STORE,
    "sorted order, no gather": SORTED | NO_GATHER,
}

# (what the committed K6 says, what the template says instead)
_SUBS = [
    ("__global__ void __launch_bounds__(kThreads)\n"
     "lattice_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table, int n,\n"
     "                   Lattice lv, float2* __restrict__ out) {",
     "template <int kV>\n__global__ void __launch_bounds__(kThreads)\n"
     "probe_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table, int n,\n"
     "                 Lattice lv, const int* __restrict__ order, float2* __restrict__ out) {"),
    ("  const int p = blockIdx.x * kThreads + threadIdx.x;\n  if (p >= n) return;\n"
     "  const float* xp",
     "  const int s = blockIdx.x * kThreads + threadIdx.x;\n  if (s >= n) return;\n"
     "  const int p = (kV & 1) ? order[(int64_t)l * n + s] : s;\n  const float* xp"),
    ("    const float2 f = __ldg(tab + idx[c]);",
     "    const float2 f = (kV & 4) ? make_float2((float)(idx[c] & 1023), 1e-9f)\n"
     "                              : __ldg(tab + idx[c]);"),
    ("  out[(int64_t)l * n + p] = acc;   // [L, N, 2]",
     "  if (!(kV & 8) || acc.x == 1234.5f)\n"
     "    out[(kV & 2) ? (int64_t)p * lv.L + l : (int64_t)l * n + p] = acc;"),
]

_LAUNCHER = """
extern "C" int probe_forward(int variant, const float* x01, const float* table, const int* order,
                             long long n, int L, long long t, const float* scales,
                             const uint32_t* mult, const uint32_t* offs, const uint32_t* strides,
                             const uint32_t* masks, const int* use_hash, float* out,
                             void* stream) {
  Lattice lv;
  const int err = make_lattice(L, t, scales, mult, offs, strides, masks, use_hash, lv);
  if (err != 0) return err;
  const float2* tab = reinterpret_cast<const float2*>(table);
  float2* o = reinterpret_cast<float2*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
%s
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


# The kernel K7 replaced (csrc/hash_lattice.cu before its tile): one thread
# per (point, level), level fastest, the gradient read through its strides,
# 8 float2 atomics a live thread.
REPLACED_K7 = r"""
__global__ void __launch_bounds__(kThreads)
replaced_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad_out,
                    int64_t g_level, int64_t g_point, int n, Lattice lv,
                    float2* __restrict__ grad_table) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n * lv.L) return;
  const int p = (int)(i / lv.L);
  const int l = (int)(i - (int64_t)p * lv.L);
  const float2 g = grad_out[l * g_level + p * g_point];
  if (g.x == 0.f && g.y == 0.f) return;
  const float* xp = x01 + (int64_t)p * 3;
  const float x[3] = {__ldg(xp), __ldg(xp + 1), __ldg(xp + 2)};
  uint32_t idx[8];
  float w[8];
  lattice_corners(x, lv, l, idx, w);
  float2* gt = grad_table + (int64_t)l * lv.t;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    atomicAdd(gt + idx[c], make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y)));
}
"""

# name -> (tile points, merge); None is the replaced kernel
BWD_VARIANTS = {
    "K7 (tile of 64, merge)": (64, True),
    "tile of 64, no merge": (64, False),
    "tile of 128, merge": (128, True),
    "tile of 256, merge": (256, True),
    "the replaced K7 (a thread per (point, level), no tile, no merge)": None,
}

_BWD_LAUNCHER = """
extern "C" int probe_backward(int variant, const float* x01, const float* grad, long long g_level,
                              long long g_point, long long n, int L, long long t,
                              const float* scales, const uint32_t* mult, const uint32_t* offs,
                              const uint32_t* strides, const uint32_t* masks,
                              const int* use_hash, float* grad_table, void* stream) {
  Lattice lv;
  const int err = make_lattice(L, t, scales, mult, offs, strides, masks, use_hash, lv);
  if (err != 0) return err;
  const float2* g = reinterpret_cast<const float2*>(grad);
  float2* gt = reinterpret_cast<float2*>(grad_table);
  cudaStream_t st = (cudaStream_t)stream;
  const LatticeGeo geo{lv};
  switch (variant) {
%s
    case -1:
      replaced_bwd_kernel<<<(unsigned)((n * L + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          x01, g, g_level, g_point, (int)n, lv, gt);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}
"""


def _bwd_code(how) -> int:
    """The launcher's case of a BWD_VARIANTS entry."""
    return -1 if how is None else how[0] * 2 + int(how[1])


def source() -> str:
    """The probe's CUDA source: hash_lattice.cu with a copy of K6 made a
    template, the replaced K7, and a launcher for each variant."""
    with open(os.path.join(_build.CSRC, "hash_lattice.cu")) as f:
        src = f.read()
    head = "__global__ void __launch_bounds__(kThreads)\n"
    start = src.index(head + "lattice_fwd_kernel")
    end = src.index("\n}\n", start) + 3
    k6 = src[start:end]
    for old, new in _SUBS:
        if k6.count(old) != 1:
            raise RuntimeError(f"K6's source no longer holds the probed line {old[:60]!r}")
        k6 = k6.replace(old, new)
    cases = "\n".join(
        f"    case {v}: probe_fwd_kernel<{v}><<<grid_of(n, L), kThreads, 0, st>>>("
        f"x01, tab, (int)n, lv, order, o); break;" for v in sorted(set(VARIANTS.values())))
    bwd_cases = "\n".join(
        f"    case {_bwd_code(how)}: return hashgrid::launch_tile_bwd<LatticeGeo, {how[0]}, "
        f"{str(how[1]).lower()}>(x01, g, g_point, g_level, n, L, geo, gt, st);"
        for how in BWD_VARIANTS.values() if how is not None)
    # the launchers at file scope see the source's anonymous namespace
    return (src[:end] + k6 + REPLACED_K7 + src[end:] + _LAUNCHER % cases
            + _BWD_LAUNCHER % bwd_cases)


_LIB: list = []


def build() -> ctypes.CDLL:
    """nvcc the probe into build/probe/ and load it (once a process)."""
    if _LIB:
        return _LIB[0]
    out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "lattice_probe.cu")
    with open(cu, "w") as f:
        f.write(source())
    so = cu[:-3] + ".so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so, cu],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"the K6 probe did not build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    lib.probe_forward.restype = ctypes.c_int
    lib.probe_forward.argtypes = [ctypes.c_int, P, P, P, LL, ctypes.c_int, LL] + [P] * 8
    lib.probe_backward.restype = ctypes.c_int
    lib.probe_backward.argtypes = [ctypes.c_int, P, P, LL, LL, LL, ctypes.c_int, LL] + [P] * 8
    _LIB.append(lib)
    return lib


def _ms(fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe(x01: torch.Tensor, table: torch.Tensor, spec) -> dict:
    """Variant name -> ms of K6's stripped variants on these inputs (the
    level-major order from ``lattice_sort_order``, built outside the timed
    loop).  Each variant's output is checked against K6's where it stores
    the same values."""
    from flnerf_tpu_torch.ops import hash_lattice as hl
    lib = build()
    n, lb = x01.shape[0], spec.n_big
    order = hl.lattice_sort_order(x01, spec)[:, :n].contiguous()
    level_args = hl._level_args(spec)
    want = hl.lattice_encode_forward(x01, table, spec)
    outs = {v: torch.empty((lb, n, 2), device=x01.device) for v in (0, PL_STORE, SORTED)}
    scratch = torch.empty((lb, n, 2), device=x01.device)

    def run(v):
        out = outs.get(v, scratch)
        rc = lib.probe_forward(v, x01.data_ptr(), table.data_ptr(), order.data_ptr(), n, lb,
                               spec.t_big, *level_args, out.data_ptr(),
                               torch.cuda.current_stream(x01.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K6 probe variant {v} failed: cudaError {rc}")

    for v in outs:
        run(v)
    torch.cuda.synchronize()
    got = {0: outs[0], SORTED: outs[SORTED],
           PL_STORE: outs[PL_STORE].view(n, lb, 2).transpose(0, 1)}
    for v, g in got.items():
        if not torch.equal(g, want):
            raise RuntimeError(f"K6 probe variant {v} differs from K6")
    return {name: _ms(lambda v=v: run(v)) for name, v in VARIANTS.items()}


def probe_backward(x01: torch.Tensor, spec, grads: dict) -> dict:
    """Name -> (ms by events, device ms) of K7 and its variants
    (``BWD_VARIANTS``) on each upstream gradient of ``grads`` (name ->
    [Lb, N, 2] as K7 is handed it, read in place through its strides):
    "<variant> on <gradient>".  Each variant adds into a gradient
    zero-filled outside the timed loop (its body's time) and is held
    against K7's result first."""
    from flnerf_tpu_torch.ops import hash_lattice as hl
    from flnerf_tpu_torch.tools.hash_probe import _time
    lib = build()
    n, lb = x01.shape[0], spec.n_big
    level_args = hl._level_args(spec)
    shape = (lb, spec.t_big, 2)
    buf = torch.zeros(shape, device=x01.device)

    def run(how, g, dst):
        rc = lib.probe_backward(_bwd_code(how), x01.data_ptr(), g.data_ptr(), g.stride(0) // 2,
                                g.stride(1) // 2, n, lb, spec.t_big, *level_args,
                                dst.data_ptr(), torch.cuda.current_stream(x01.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K7 probe variant {how} failed: cudaError {rc}")

    ms = {}
    for gname, g in grads.items():
        want = hl.lattice_encode_backward(x01, g, spec)
        scale = float(want.abs().max())
        for vname, how in BWD_VARIANTS.items():
            got = torch.zeros(shape, device=x01.device)
            run(how, g, got)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err > 1e-4 * scale or (scale == 0 and bool(got.any())):
                raise RuntimeError(f"K7 variant {vname!r} differs from K7 by {err} on the {gname} "
                                   f"gradient (largest entry {scale})")
            ms[f"{vname} on {gname}"] = _time(lambda how=how: run(how, g, buf))
    return ms


def finding_backward(ms: dict, gname: str) -> str:
    """One line for one gradient, by device time: K7 against the replaced
    kernel, the merge and the tile sizes."""
    k7 = ms[f"K7 (tile of 64, merge) on {gname}"][1]
    get = lambda v: ms[f"{v} on {gname}"][1]
    old = get("the replaced K7 (a thread per (point, level), no tile, no merge)")
    return (f"{gname} gradient (device time): K7 {k7:.4f} ms against the replaced {old:.4f} "
            f"({old / k7:.2f}x); without the merge {get('tile of 64, no merge') - k7:+.4f}; "
            f"tiles of 128 {get('tile of 128, merge') - k7:+.4f}, of 256 "
            f"{get('tile of 256, merge') - k7:+.4f}")


def finding(ms: dict) -> str:
    """One line: the share of K6's time each access takes."""
    full = ms["K6 (point order, [l, p] store)"]
    parts = [f"gathers {1 - ms['no gather'] / full:.0%}",
             f"store {1 - ms['no store'] / full:.0%}",
             f"x01 and arithmetic {ms['no gather, no store (x01 and arithmetic)'] / full:.0%}"]
    return (f"of K6's {full:.4f} ms in point order the stripped variants put "
            + ", ".join(parts) + "; the [p, l] store costs "
            f"{ms['[p, l] store (the replaced kernel, point order)'] - full:+.4f} ms, the sorted "
            f"walk {ms['sorted order, [l, p] store'] - full:+.4f} ms (before its keys and sort)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=393216)
    args = ap.parse_args()
    from flnerf_tpu_torch.ops import hash_lattice as hl
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda")
    spec = hl.make_lattice_spec(log2_hashmap_size=19, desired_resolution=4096)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((spec.n_big, spec.t_big, 2), generator=g, device=dev) * 2 - 1
    x = torch.rand((args.n, 3), generator=g, device=dev)
    ms = probe(x, table, spec)
    for name, t in ms.items():
        print(f"{t:9.4f} ms  {name}")
    print(finding(ms))
    wide = torch.randn((args.n, 2 * spec.num_levels), generator=g, device=dev)
    big = wide.view(args.n, spec.num_levels, 2)[:, spec.split.n_small:].transpose(0, 1)
    rays = torch.arange(args.n, device=dev) // 96          # 96 kept samples a ray
    grads = {"dense": big, "1 ray in 9": big * (rays % 9 == 0)[None, :, None]}
    bms = probe_backward(x, spec, grads)
    for name, (ev, dt) in bms.items():
        print(f"{ev:9.4f} ms by events, {dt:9.4f} ms of device time  {name}")
    for gname in grads:
        print(finding_backward(bms, gname))


if __name__ == "__main__":
    main()
