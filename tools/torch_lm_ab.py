#!/usr/bin/env python3
"""Time two checkouts' LM kernels B and C, and the paths over their LM
(the forward, the DoF ladder, the streamed finish), on one GPU.

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
2. each checkout's full-width forward (32 x 1000 x 1024, f32), DoF
   ladder (``fit_ct_ladder`` on ``entry.hetero_cohort`` at 10 000 x 500,
   chip_smoke phase 5's input) and streamed finish (``run_finish`` on
   1024 residues: one group step of the forward's input, 64 weighted PAF
   samples a residue, Daniso 1.3), each checkout in a process of its own,
   in turns old, new, new, old: per path the median wall of 5 calls (3
   for the ladder) after a first call, and from one torch.profiler run
   the device-busy time and the LM kernels' launches and time per launch
   (B, C and, where the checkout has them, D and E).

With ``--loops`` instead of OLD_ROOT it times this checkout's LM loop
three ways in one process (the wall differs up to 2x between processes),
by swapping ``fit.engine._run_graph`` for the whole run: the graph loop
(one captured step, replayed; the host looks at the lanes once per stall
window), the windowed loop (every step issued by the host, no capture,
the lanes looked at once per stall window: ``fit.engine._replay`` with
the step in place of the replay) and the eager loop (every step issued by
the host, one sync per iteration: ``fit.engine._run_eager``).  In turns
eager, windowed, graph, graph, windowed, eager, on the same three paths,
after one call of each loop: per path and loop the median wall of 5
calls (3 for the ladder) a turn, after the turn's first call,
the device-busy time and device kernel count of one profiled call, and
whether the three loops' outputs are equal bit for bit.

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


PATHS = ("forward", "ladder", "finish")


def paths_run(root: Path) -> dict:
    """One checkout's forward, ladder and finish, in this process (see the
    module docstring)."""
    sys.path.insert(0, str(root))
    import torch

    from spinrelax_tpu_torch.entry import correlated_walk, hetero_cohort, paf_ensemble
    from spinrelax_tpu_torch.fit.expfit import fit_ct_ladder
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.ops.autocorr import palmer_group_update_pretiled, tile_palmer_group
    from spinrelax_tpu_torch.parallel.pipeline import make_forward
    from spinrelax_tpu_torch.parallel.streamed import run_finish

    torch.backends.cuda.matmul.allow_tf32 = False
    vecs = torch.from_numpy(correlated_walk(32, 1000, 1024, seed=0)).cuda()
    fwd = make_forward(tau_iso=4242.0, delta_t=1.0, n_components=2)
    dt, y, dy = hetero_cohort(10_000, 500)
    names = [str(i) for i in range(10_000)]
    yc, dyc = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in (y, dy))
    zero = torch.zeros((500, 1024), device="cuda")
    acc = palmer_group_update_pretiled(tile_palmer_group(vecs), zero, zero, 32, 1024)
    pv, pw = paf_ensemble(1024, 64, seed=1)
    fkw = dict(n_res=1024, delta_t=1.0, diffusion=Diffusion.axisymmetric(tau=4242.0, aniso=1.3),
               vecs=pv, weights=pw)
    runs = {"forward": (lambda: fwd(vecs), 5),
            "ladder": (lambda: fit_ct_ladder(names, dt, yc, dyc), 3),
            "finish": (lambda: run_finish(*acc, 32, **fkw), 5)}
    out = {}
    for name in PATHS:
        fn, n = runs[name]
        smoke.wall_s(torch, fn)  # builds the kernels, warms the allocator
        walls = sorted(smoke.wall_s(torch, fn)[1] * 1e3 for _ in range(n))
        busy, per = smoke.device_profile(torch, fn)
        lm = smoke.kernel_times(per, lm_kernel_of)
        out[name] = {"wall_ms": walls, "median_ms": walls[n // 2], "busy_ms": busy,
                     "device_events": sum(n for n, _ in per.values()),
                     "lm": {k: {"launches": m, "us": us} for k, (m, us) in lm.items()}}
    return out


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


def _leaves(x):
    """The numbers of a nested result (tensors, numeric arrays, floats), in
    a fixed order, as tensors."""
    import numpy as np
    import torch

    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (np.ndarray, np.number, float, int)):
        a = np.asarray(x)
        return [torch.from_numpy(np.ascontiguousarray(a))] if a.dtype.kind in "biufc" else []
    if isinstance(x, dict):
        return [a for k in sorted(x, key=str) for a in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _leaves(v)]
    if hasattr(x, "__dict__"):
        return _leaves(vars(x))
    return []


LOOPS = ("eager", "windowed", "graph", "graph", "windowed", "eager")


def loops_run() -> int:
    """Graph, windowed and eager loops, in turns in this process, on the
    forward, the ladder and the finish (see the module docstring)."""
    sys.path.insert(0, str(HERE))
    import torch

    from spinrelax_tpu_torch.entry import correlated_walk, hetero_cohort, paf_ensemble
    from spinrelax_tpu_torch.fit import engine
    from spinrelax_tpu_torch.fit.expfit import fit_ct_ladder
    from spinrelax_tpu_torch.models.diffusion import Diffusion
    from spinrelax_tpu_torch.ops.autocorr import palmer_group_update_pretiled, tile_palmer_group
    from spinrelax_tpu_torch.parallel.pipeline import make_forward
    from spinrelax_tpu_torch.parallel.streamed import run_finish

    torch.backends.cuda.matmul.allow_tf32 = False
    graph = engine._run_graph

    def windowed(step, live, max_iter, window, counters=()):
        return engine._replay(step, live, 0, max_iter, window)

    def eager(step, live, max_iter, window, counters=()):
        return engine._run_eager(step, live, max_iter, window)

    runners = {"graph": graph, "windowed": windowed, "eager": eager}
    vecs = torch.from_numpy(correlated_walk(32, 1000, 1024, seed=0)).cuda()
    fwd = make_forward(tau_iso=4242.0, delta_t=1.0, n_components=2)
    dt, y, dy = hetero_cohort(10_000, 500)
    names = [str(i) for i in range(10_000)]
    yc, dyc = (torch.tensor(a, dtype=torch.float32, device="cuda") for a in (y, dy))
    zero = torch.zeros((500, 1024), device="cuda")
    acc = palmer_group_update_pretiled(tile_palmer_group(vecs), zero, zero, 32, 1024)
    pv, pw = paf_ensemble(1024, 64, seed=1)
    fkw = dict(n_res=1024, delta_t=1.0, diffusion=Diffusion.axisymmetric(tau=4242.0, aniso=1.3),
               vecs=pv, weights=pw)
    runs = {"forward": (lambda: fwd(vecs), 5),
            "ladder": (lambda: fit_ct_ladder(names, dt, yc, dyc), 3),
            "finish": (lambda: run_finish(*acc, 32, **fkw), 5)}
    ok = True
    try:
        for path in PATHS:
            fn, n = runs[path]
            out, stats = {}, {k: [] for k in runners}
            for loop in runners:  # each loop's first call (side stream, pools) outside the turns
                engine._run_graph = runners[loop]
                smoke.wall_s(torch, fn)
            for loop in LOOPS:
                engine._run_graph = runners[loop]
                out[loop] = _leaves(smoke.wall_s(torch, fn)[0])
                walls = sorted(smoke.wall_s(torch, fn)[1] * 1e3 for _ in range(n))
                busy, per = smoke.device_profile(torch, fn)
                stats[loop].append((walls[n // 2], busy))
                print(f"{path}, {loop} loop: wall median {walls[n // 2]:.3f} ms of {n} (min "
                      f"{walls[0]:.3f}, max {walls[-1]:.3f}); device busy {busy:.3f} ms; "
                      f"{sum(m for m, _ in per.values())} device kernels and copies",
                      flush=True)
            same = all(len(out[k]) == len(out["graph"]) and all(
                smoke.same_bits(torch, a, b) for a, b in zip(out[k], out["graph"]))
                for k in runners)
            ok &= same
            means = {k: [statistics.mean(x) for x in zip(*v)] for k, v in stats.items()}
            print(f"{path}: " + ", ".join(f"{k} {w:.3f} ms wall / {b:.3f} ms busy"
                                          for k, (w, b) in means.items())
                  + f"; windowed / graph {means['windowed'][0] / means['graph'][0]:.2f}, "
                  f"eager / graph {means['eager'][0] / means['graph'][0]:.2f}; outputs equal "
                  f"bit for bit: {same}", flush=True)
    finally:
        engine._run_graph = graph
    return 0 if ok else 1


def main(argv) -> int:
    if argv == ["--loops"]:
        import torch

        if not torch.cuda.is_available():
            print("torch_lm_ab: needs a GPU", file=sys.stderr)
            return 3
        print(smoke.gpu_line(), flush=True)
        return loops_run()
    if len(argv) >= 2 and argv[0] == "--paths":
        print(json.dumps(paths_run(Path(argv[1]).resolve())))
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
        res = subprocess.run([sys.executable, __file__, "--paths", str(roots[side])],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        run = json.loads(res.stdout.strip().splitlines()[-1])
        runs[side].append(run)
        print(f"paths {'old' if side == 0 else 'new'}: {json.dumps(run)}", flush=True)
    for path in PATHS:
        for side, name in ((0, "old"), (1, "new")):
            walls = [w for r in runs[side] for w in r[path]["wall_ms"]]
            busy = [r[path]["busy_ms"] for r in runs[side]]
            print(f"{path} {name}: median wall {statistics.median(walls):.2f} ms over "
                  f"{len(walls)} calls (min {min(walls):.2f}, max {max(walls):.2f}); "
                  f"device busy {busy[0]:.2f}, {busy[1]:.2f} ms", flush=True)
    print(smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
