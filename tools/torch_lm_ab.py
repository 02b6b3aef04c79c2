#!/usr/bin/env python3
"""Time two checkouts' LM kernels B and C, and their forwards, on one GPU.

    python3 tools/torch_lm_ab.py OLD_ROOT [NEW_ROOT]

OLD_ROOT and NEW_ROOT (default: the checkout holding this script) are
roots of two checkouts of the repository whose
``spinrelax_tpu_torch/csrc/lm_hgc.cu`` export ``lm_hgc_f32`` and
``lm_cost_f32`` with one C signature (p, y, isg, dt, out, T, B, K,
s2_free, stream).  The script builds each checkout's kernel library with
that checkout's ``_build.py`` and prints:

1. each kernel's device time per launch at the forward's shape (B 1024,
   T 500, K 2, S2 free) and at a ladder rung (B 10 000, T 500, K 4, S2
   free): CUDA events around a CUDA graph of back-to-back launches
   (``chip_smoke.graph_ms``), timed in turns old, new, new, old, beside
   the bound ``chip_smoke.lm_bound`` computes;
2. each checkout's full-width forward (32 x 1000 x 1024, f32), each in a
   process of its own, in turns old, new, new, old: the median wall of 5
   calls after a first call, and from one torch.profiler run the
   device-busy time and kernels B's and C's launches and time per launch.

With ``--loops`` instead of OLD_ROOT it times this checkout's LM loop
both ways in one process (the wall differs up to 2x between processes): the
graph loop (one captured step, replayed; the host looks at the lanes once
per stall window) against the eager loop (``_eager=True``: every step
issued by the host, one sync per iteration), in turns eager, graph, graph,
eager, on the forward's fit (B 1024, T 500, K 2, S2 free, C(t) of
``entry.correlated_walk``) and a ladder rung (B 10 000, T 500, K 2, S2
free, ``entry.hetero_cohort``): median wall of 5 calls per turn, the
device-busy time and device kernel count of one profiled call, the steps
run and the slowest lane's iterations, and whether the outputs are equal
bit for bit.

    python3 tools/torch_lm_ab.py --loops

Needs one GPU; prints the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SHAPES = ((2, True, 1024, 500, 50), (4, True, 10_000, 500, 20))  # K, s2_free, B, T, reps


def _module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = _module("chip_smoke_ab", HERE / "chip_smoke.py")


def lm_kernel_of(name: str):
    """'B', 'C' or None for a profiled kernel name of either design: the
    one-thread-per-problem lm_hgc_kernel / lm_cost_kernel<K, s2_free>, or
    lm_kernel<K, s2_free, FULL> (chip_smoke.kernel_of, which also names
    kernel A)."""
    for key, old in (("B", "lm_hgc_kernel<"), ("C", "lm_cost_kernel<")):
        if old in name:
            return key
    return smoke.kernel_of(name)


def forward_run(root: Path) -> dict:
    """One checkout's forward, in this process (see the module docstring)."""
    sys.path.insert(0, str(root))
    import torch

    from spinrelax_tpu_torch.entry import correlated_walk
    from spinrelax_tpu_torch.parallel.pipeline import make_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    vecs = torch.from_numpy(correlated_walk(32, 1000, 1024, seed=0)).cuda()
    fwd = make_forward(tau_iso=4242.0, delta_t=1.0, n_components=2)
    smoke.wall_s(torch, lambda: fwd(vecs))  # builds the kernels, warms the allocator
    walls = sorted(smoke.wall_s(torch, lambda: fwd(vecs))[1] * 1e3 for _ in range(5))
    busy, per = smoke.device_profile(torch, lambda: fwd(vecs))
    lm = smoke.kernel_times(per, lm_kernel_of)
    return {"wall_ms": walls, "median_ms": walls[2], "busy_ms": busy,
            "device_events": sum(n for n, _ in per.values()),
            "lm": {k: {"launches": n, "us": us} for k, (n, us) in lm.items()}}


def kernel_times(torch, roots) -> None:
    libs = [_module(f"_build_ab{i}", r / "spinrelax_tpu_torch" / "_build.py").load()
            for i, r in enumerate(roots)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for K, s2f, B, T, reps in SHAPES:
        p, y, isg, dt = smoke.lm_operands(torch, gen, K, s2f, B, T)
        P = p.shape[0]
        out = torch.empty(B * (P * P + P + 1), device="cuda")
        for kern, full in (("lm_hgc_f32", True), ("lm_cost_f32", False)):
            def launcher(lib):
                fn = getattr(lib, kern)

                def go():
                    code = fn(p.data_ptr(), y.data_ptr(), isg.data_ptr(), dt.data_ptr(),
                              out.data_ptr(), T, B, K, int(s2f),
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{kern}: CUDA error {code}")
                return go

            old, new = (launcher(lib) for lib in libs)
            t_old, t_new = smoke.paired_ms(torch, old, new, reps=reps, timer=smoke.graph_ms)
            bound, by = smoke.lm_bound(K, s2f, B, T, full)
            print(f"{kern} at B {B}, T {T}, K {K}, S2 {'free' if s2f else 'fixed'}: "
                  f"old {t_old * 1e3:.3f} us ({bound / t_old:.2%} of bound), new "
                  f"{t_new * 1e3:.3f} us ({bound / t_new:.2%} of bound), bound "
                  f"{bound * 1e3:.3f} us ({by}); old / new {t_old / t_new:.2f}",
                  flush=True)


def loops_run() -> int:
    """Graph loop against eager loop, in turns in this process (see the
    module docstring)."""
    sys.path.insert(0, str(HERE))
    import torch

    from spinrelax_tpu_torch.entry import correlated_walk, hetero_cohort
    from spinrelax_tpu_torch.fit.engine import fit_multiexp_engine
    from spinrelax_tpu_torch.ops.autocorr import ct_palmer

    Ct, dCt = ct_palmer(torch.from_numpy(correlated_walk(32, 1000, 1024, seed=0)).cuda())
    dt = torch.arange(Ct.shape[0], dtype=Ct.dtype, device="cuda") + 1.0
    fwd = (dt, Ct.T.contiguous(), torch.where(dCt.T > 0, dCt.T, torch.ones_like(dCt.T)))
    rung = tuple(torch.tensor(a, dtype=torch.float32, device="cuda")
                 for a in hetero_cohort(10_000, 500))
    ok = True
    for name, args in (("forward fit, B 1024", fwd), ("ladder rung, B 10 000", rung)):
        def fit(eager, info=None):
            return fit_multiexp_engine(*args, K=2, s2_free=True, info=info, _eager=eager)

        fit(False)
        out, stats = {}, {True: [], False: []}
        for eager in (True, False, False, True):
            info = {}
            out[eager] = fit(eager, info)
            walls = sorted(smoke.wall_s(torch, lambda: fit(eager))[1] * 1e3 for _ in range(5))
            busy, per = smoke.device_profile(torch, lambda: fit(eager))
            stats[eager].append((walls[2], busy))
            print(f"{name}, K 2, S2 free, {'eager' if eager else 'graph'} loop: wall median "
                  f"{walls[2]:.3f} ms of 5 (min {walls[0]:.3f}, max {walls[-1]:.3f}); device "
                  f"busy {busy:.3f} ms, idle share {1 - busy / walls[2]:.1%}; "
                  f"{sum(n for n, _ in per.values())} device kernels and copies; "
                  f"{info['steps']} steps, slowest lane {info['iterations']} iterations",
                  flush=True)
        same = all(smoke.same_bits(torch, a, b) for a, b in zip(out[True], out[False]))
        ok &= same
        (we, be), (wg, bg) = ([statistics.mean(x) for x in zip(*stats[k])] for k in (True, False))
        print(f"{name}: eager {we:.3f} ms wall / {be:.3f} ms busy, graph {wg:.3f} ms wall / "
              f"{bg:.3f} ms busy, eager / graph {we / wg:.2f}; outputs equal bit for bit: "
              f"{same}", flush=True)
    return 0 if ok else 1


def main(argv) -> int:
    if argv == ["--loops"]:
        import torch

        if not torch.cuda.is_available():
            print("torch_lm_ab: needs a GPU", file=sys.stderr)
            return 3
        print(smoke.gpu_line(), flush=True)
        return loops_run()
    if len(argv) >= 2 and argv[0] == "--forward":
        print(json.dumps(forward_run(Path(argv[1]).resolve())))
        return 0
    if not 1 <= len(argv) <= 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = [Path(a).resolve() for a in argv] + ([HERE] if len(argv) == 1 else [])
    import torch

    if not torch.cuda.is_available():
        print("torch_lm_ab: needs a GPU", file=sys.stderr)
        return 3
    print(smoke.gpu_line(), flush=True)
    print(f"old {roots[0]}\nnew {roots[1]}", flush=True)
    kernel_times(torch, roots)
    runs = {0: [], 1: []}
    for side in (0, 1, 1, 0):
        res = subprocess.run([sys.executable, __file__, "--forward", str(roots[side])],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs[side].append(run)
        print(f"forward {'old' if side == 0 else 'new'}: {json.dumps(run)}", flush=True)
    for side, name in ((0, "old"), (1, "new")):
        walls = [w for r in runs[side] for w in r["wall_ms"]]
        busy = [r["busy_ms"] for r in runs[side]]
        print(f"forward {name}: median wall {statistics.median(walls):.2f} ms over "
              f"{len(walls)} calls (min {min(walls):.2f}, max {max(walls):.2f}); "
              f"device busy {busy[0]:.2f}, {busy[1]:.2f} ms", flush=True)
    print(smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
