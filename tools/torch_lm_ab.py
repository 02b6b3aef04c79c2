#!/usr/bin/env python3
"""Time two checkouts' LM kernels B to E, and the paths over their LM
(the forward, the DoF ladder, the streamed finish), on one GPU.

    python3 tools/torch_lm_ab.py OLD_ROOT [NEW_ROOT]

OLD_ROOT and NEW_ROOT (default: the checkout holding this script) are
roots of two checkouts of the repository whose
``spinrelax_tpu_torch/csrc/lm_hgc.cu`` export ``lm_hgc_f32`` and
``lm_cost_f32`` with one C signature (p, y, isg, dt, out, T, B, K,
s2_free, stream), and whose ``csrc/lm_step.cu`` export
``lm_step_solve_f32`` and ``lm_step_gate_f32`` with one C signature each.
The script builds each checkout's kernel library with that checkout's
``_build.py`` and prints:

1. each kernel's device time per launch: B and C at the forward's shape
   (B 1024, T 500, K 2, S2 free) and at a ladder rung (B 10 000, T 500,
   K 4, S2 free), D and E there and at B 10 000 at the ladder's other
   rungs (K 1 S2 fixed and free, K 2, K 3) and at K 5 and K 8 (on
   ``chip_smoke.timed_step_state``, one state for both checkouts): CUDA
   events around a CUDA graph of back-to-back launches
   (``chip_smoke.graph_ms``), timed in turns old, new, new, old, beside
   the bound ``chip_smoke.lm_bound`` / ``step_bound`` computes;
2. each checkout's full-width forward (32 x 1000 x 1024, f32), DoF
   ladder (``fit_ct_ladder`` on ``entry.hetero_cohort`` at 10 000 x 500,
   chip_smoke phase 5's input) and streamed finish (``run_finish`` on
   1024 residues: one group step of the forward's input, 64 weighted PAF
   samples a residue, Daniso 1.3), each checkout in a process of its own,
   in turns old, new, new, old: per path the median wall of 5 calls (3
   for the ladder) after a first call, and from one torch.profiler run
   the device-busy time and the LM kernels' launches and time per launch
   (B, C and, where the checkout has them, D and E);
3. kernel E of each checkout as the last node of one step B, D, C, E
   (this checkout's B, D, C) captured alone in a CUDA graph and replayed
   50 times by the host, as ``fit.engine._run_graph`` replays it, at
   LAST_NODE_SHAPES, in turns old, new, new, old: E's mean time a launch
   as torch.profiler reads it (the measure of the in-situ times) and the
   replay's time by CUDA events.

With ``--insitu`` instead of OLD_ROOT it runs this checkout's forward,
ladder and finish under torch.profiler and prints each LM call's (B, P)
as kernel E's wrapper sees it and D's and E's mean time a launch by P;
then, at LAST_NODE_SHAPES, D and E as the profiler reads them alone (a
graph of 50 launches), inside a graph of 50 steps B, D, C, E, and as the
last node of a one-step graph replayed 50 times by the host.

    python3 tools/torch_lm_ab.py --insitu

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
# D and E also at the ladder's other rungs (K 1 S2 fixed / free, K 2, K 3) and K 5, K 8
STEP_SHAPES = SHAPES + tuple((K, s2f, 10_000, 500, 20) for K, s2f in (
    (1, False), (1, True), (2, True), (3, True), (5, True), (8, True)))
# (K, s2_free, B): the forward's LM call (P 5) and the ladder's K 3 rung (P 7)
LAST_NODE_SHAPES = ((2, True, 1024), (3, True, 10_000))


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


def lm_paths(torch) -> dict:
    """{path: (call, calls to time)}: the full-width forward (32 x 1000 x
    1024, f32), the DoF ladder on entry.hetero_cohort at 10 000 x 500 and
    the streamed finish on 1024 residues, on the checkout first on
    sys.path."""
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
    return {"forward": (lambda: fwd(vecs), 5),
            "ladder": (lambda: fit_ct_ladder(names, dt, yc, dyc), 3),
            "finish": (lambda: run_finish(*acc, 32, **fkw), 5)}


def paths_run(root: Path) -> dict:
    """One checkout's forward, ladder and finish, in this process (see the
    module docstring)."""
    sys.path.insert(0, str(root))
    import torch

    runs = lm_paths(torch)
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


def load_libs(roots) -> list:
    """Each checkout's kernel library, built by that checkout's _build.py."""
    return [_module(f"_build_ab{i}", r / "spinrelax_tpu_torch" / "_build.py").load()
            for i, r in enumerate(roots)]


def kernel_times(torch, libs) -> None:
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


def step_kernel_times(torch, libs) -> None:
    """Kernels D and E of both libraries on one state a shape."""
    sys.path.insert(0, str(HERE))
    from spinrelax_tpu_torch.ops import cuda_lm

    gen = torch.Generator(device="cuda").manual_seed(4)
    for K, s2f, B, T, reps in STEP_SHAPES:
        solve, ins, st, pt, g = smoke.timed_step_state(torch, cuda_lm, gen, K, s2f, B, T)
        P = cuda_lm.n_par(K, s2f)
        out = torch.empty(B * (2 * P + 3), device="cuda")
        outs = (out[: B * P], out[B * P : 2 * B * P], out[2 * B * P :])
        args = {"lm_step_solve_f32": [x.data_ptr() for x in (*solve, *outs, st[-1])] + [B, P],
                "lm_step_gate_f32": [x.data_ptr() for x in (*ins, *st, pt)] + [
                    B, P, g.max_iter, g.window, g.xtol, g.ftol, g.window * g.ftol,
                    g.xtol_rel, g.lam0, 100.0 * g.lam0, g.lam_stuck]}
        at_window = int(((st[2] + 1) % g.window == 0).sum())
        for kern, gate in (("lm_step_solve_f32", False), ("lm_step_gate_f32", True)):
            def launcher(lib):
                fn = getattr(lib, kern)

                def go():
                    code = fn(*args[kern], torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{kern}: CUDA error {code}")
                return go

            old, new = (launcher(lib) for lib in libs)
            t_old, t_new = smoke.paired_ms(torch, old, new, reps=reps, timer=smoke.graph_ms)
            bound, by = smoke.step_bound(P, B, gate, improved=B, at_window=at_window)
            print(f"{kern} at B {B}, K {K}, S2 {'free' if s2f else 'fixed'} (P {P}): "
                  f"old {t_old * 1e3:.3f} us ({bound / t_old:.2%} of bound), new "
                  f"{t_new * 1e3:.3f} us ({bound / t_new:.2%} of bound), bound "
                  f"{bound * 1e3:.3f} us ({by}); old / new {t_old / t_new:.2f}",
                  flush=True)


def _step_operands(torch, gen, K, s2f, B, T=500):
    """Kernels B to E's operands at random parameters, on a state that
    never freezes (lam 1e-3, it 0, max_iter and lam_stuck out of reach)."""
    import math

    from spinrelax_tpu_torch.fit import engine
    from spinrelax_tpu_torch.fit.lm import _to_constrained, _to_unconstrained
    from spinrelax_tpu_torch.ops import cuda_lm

    p, y, isg, dt = smoke.lm_operands(torch, gen, K, s2f, B, T)
    lo, hi = engine._bounds(K, s2f, dt[-1] * 10.0, torch.float32, "cuda")
    t = _to_unconstrained(p.T, lo, hi).contiguous()
    eps = torch.finfo(torch.float32).eps
    gates = cuda_lm.Gates(max_iter=2**31 - 1, window=8, xtol=1e-10, ftol=10.0 * eps,
                          xtol_rel=math.sqrt(eps), lam0=1e-3, lam_stuck=1e30)
    state = (t, torch.full((B,), 1e-3, device="cuda"),
             torch.zeros(B, dtype=torch.int32, device="cuda"),
             torch.full((B,), float("inf"), device="cuda"),
             torch.full((B,), float("inf"), device="cuda"),
             torch.zeros(B, dtype=torch.bool, device="cuda"),
             torch.ones((), dtype=torch.bool, device="cuda"))
    return dict(p=_to_constrained(t, lo, hi).T.contiguous(), ops=(y, isg, dt, K, s2f), lo=lo,
                span=hi - lo, state=state, gates=gates)


def _step(torch, cuda_lm, o, gate_lib=None):
    """One step B, D, C, E on o; E from gate_lib's lm_step_gate_f32 where
    given, else this checkout's wrapper."""
    st, g = o["state"], o["gates"]
    H_p, g_p, c_old = cuda_lm.hgc_cuda(o["p"], *o["ops"])
    t_new, pt_trial, stats = cuda_lm.step_solve_cuda(H_p, g_p, st[0], st[1], o["lo"],
                                                     o["span"], st[-1])
    c_new = cuda_lm.cost_cuda(pt_trial, *o["ops"])
    gate = (c_new, c_old, t_new, pt_trial, stats)
    if gate_lib is None:
        cuda_lm.step_gate_cuda(*gate, st, o["p"], g)
        return
    B, P = t_new.shape
    code = gate_lib.lm_step_gate_f32(
        *(x.data_ptr() for x in (*gate, *st, o["p"])), B, P, g.max_iter, g.window, g.xtol,
        g.ftol, g.window * g.ftol, g.xtol_rel, g.lam0, 100.0 * g.lam0, g.lam_stuck,
        torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"lm_step_gate_f32: CUDA error {code}")


def _profiled(torch, run) -> dict:
    """{'A' .. 'E': (launches, us per launch)} of run() as torch.profiler
    reads it (the card's activity only), profiled again until some LM
    kernel is seen (the profiler now and then loses a cycle's events)."""
    _, per = smoke.device_profile(torch, run, lambda per: bool(smoke.kernel_times(per)),
                                  cpu=False)
    return smoke.kernel_times(per)


def _graphed(torch, fn, reps: int):
    """A CUDA graph of reps calls of fn (after one call outside it)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replayed(torch, fn, reps: int = 50):
    """(profiler's {kernel: (launches, us)}, CUDA events' us a replay) of
    one call of fn captured alone and its graph replayed reps times by the
    host, as fit.engine._run_graph replays its step."""
    graph = _graphed(torch, fn, 1)

    def run():
        for _ in range(reps):
            graph.replay()

    return _profiled(torch, run), smoke.cuda_ms(torch, graph.replay, reps) * 1e3


def last_node_times(torch, libs) -> None:
    """Kernel E of both libraries as the last node of a replayed one-step
    graph (see the module docstring, item 3)."""
    sys.path.insert(0, str(HERE))
    from spinrelax_tpu_torch.ops import cuda_lm

    gen = torch.Generator(device="cuda").manual_seed(21)
    for K, s2f, B in LAST_NODE_SHAPES:
        o = _step_operands(torch, gen, K, s2f, B)
        res = {0: [], 1: []}
        for side in (0, 1, 1, 0):
            per, us = _replayed(torch, lambda: _step(torch, cuda_lm, o, libs[side]))
            res[side].append((per["E"][1], us))
        (e_old, r_old), (e_new, r_new) = ([statistics.mean(x) for x in zip(*res[s])]
                                          for s in (0, 1))
        print(f"E as the last node of a replayed one-step graph at B {B}, K {K}, S2 "
              f"{'free' if s2f else 'fixed'} (P {cuda_lm.n_par(K, s2f)}): old {e_old:.3f} us, "
              f"new {e_new:.3f} us a launch (profiler); replay old {r_old:.2f} us, new "
              f"{r_new:.2f} us (CUDA events)", flush=True)


def insitu_run() -> int:
    """Each LM call's (B, P) on the three paths and D's and E's in-situ
    times by P; D and E alone, in a graph of steps and as a replay's last
    node (see the module docstring)."""
    import re

    sys.path.insert(0, str(HERE))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spinrelax_tpu_torch.ops import cuda_lm

    shapes = []
    gate = cuda_lm.step_gate_cuda

    def seen(c_new, c_old, t_new, *a, **k):
        shapes.append(tuple(t_new.shape))
        return gate(c_new, c_old, t_new, *a, **k)

    seen.launches = 0  # fit.engine adds its replays to the counter it finds here
    cuda_lm.step_gate_cuda = seen
    try:
        for path, (fn, _) in lm_paths(torch).items():
            fn()
            torch.cuda.synchronize()
            shapes.clear()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = sorted((e.start_ns(), e.duration_ns() / 1e3, e.name())
                            for e in prof.profiler.kineto_results.events()
                            if e.device_type() == DeviceType.CUDA)
            by_p, last_p = {}, None
            for _, us, name in events:
                m = re.search(r"lm_step_solve_kernel<(\d+)", name)
                if m:
                    last_p = int(m.group(1))
                    by_p.setdefault(("D", last_p), []).append(us)
                elif smoke.kernel_of(name) == "E":
                    by_p.setdefault(("E", last_p), []).append(us)
            print(f"{path}: LM calls (B, P) {sorted(set(shapes))}", flush=True)
            for (k, P), us in sorted(by_p.items(), key=str):
                print(f"  {path} in situ {k} at P {P}: {len(us)} launches, mean "
                      f"{statistics.mean(us):.2f} us (min {min(us):.2f}, max {max(us):.2f})",
                      flush=True)
    finally:
        cuda_lm.step_gate_cuda = gate
    gen = torch.Generator(device="cuda").manual_seed(9)
    for K, s2f, B in LAST_NODE_SHAPES:
        o = _step_operands(torch, gen, K, s2f, B)
        ins = []

        def step():
            _step(torch, cuda_lm, o)

        def d():
            cuda_lm.step_solve_cuda(*ins[0], o["state"][-1])

        def e():
            cuda_lm.step_gate_cuda(*ins[1], o["state"], o["p"], o["gates"])

        H_p, g_p, c_old = cuda_lm.hgc_cuda(o["p"], *o["ops"])
        st = o["state"]
        ins.append((H_p, g_p, st[0], st[1], o["lo"], o["span"]))
        t_new, pt_trial, stats = cuda_lm.step_solve_cuda(*ins[0], st[-1])
        ins.append((cuda_lm.cost_cuda(pt_trial, *o["ops"]), c_old, t_new, pt_trial, stats))
        tag = f"B {B}, K {K}, S2 {'free' if s2f else 'fixed'} (P {cuda_lm.n_par(K, s2f)})"
        for name, fn in (("D alone", d), ("E alone", e)):
            graph = _graphed(torch, fn, 50)
            us = _profiled(torch, graph.replay)[name[0]][1]
            print(f"{tag}, a graph of 50 x {name}: {us:.2f} us a launch (profiler)", flush=True)
        graph = _graphed(torch, step, 50)
        per = _profiled(torch, graph.replay)
        print(f"{tag}, a graph of 50 steps B, D, C, E: " + ", ".join(
            f"{k} {us:.2f} us" for k, (_, us) in sorted(per.items())) + " a launch (profiler)",
            flush=True)
        per, us = _replayed(torch, step)
        print(f"{tag}, one step captured alone, replayed 50 times: " + ", ".join(
            f"{k} {u:.2f} us" for k, (_, u) in sorted(per.items()))
            + f" a launch (profiler); {us:.2f} us a replay (CUDA events)", flush=True)
    return 0


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

    from spinrelax_tpu_torch.fit import engine

    graph = engine._run_graph

    def windowed(step, live, max_iter, window, counters=()):
        return engine._replay(step, live, 0, max_iter, window)

    def eager(step, live, max_iter, window, counters=()):
        return engine._run_eager(step, live, max_iter, window)

    runners = {"graph": graph, "windowed": windowed, "eager": eager}
    runs = lm_paths(torch)
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
    if argv == ["--insitu"]:
        import torch

        if not torch.cuda.is_available():
            print("torch_lm_ab: needs a GPU", file=sys.stderr)
            return 3
        print(smoke.gpu_line(), flush=True)
        code = insitu_run()
        print(smoke.gpu_line(), flush=True)
        return code
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
    libs = load_libs(roots)
    kernel_times(torch, libs)
    step_kernel_times(torch, libs)
    last_node_times(torch, libs)
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
