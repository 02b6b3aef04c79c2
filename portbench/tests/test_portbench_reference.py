"""The plain reference against the plain mathematics it stands for, at
small sizes on the CPU: loops and closed forms, no port, no JAX."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.gen import systems, xtcwrite  # noqa: E402
from portbench.reference import ctfit, globalfit, judge, physics, traj  # noqa: E402

F64 = torch.float64


def unit_walk(F, B, seed):
    rng = np.random.default_rng(seed)
    v = np.cumsum(rng.normal(size=(F, B, 3)) * 0.2, axis=0) + rng.normal(size=(1, B, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_lag_sums_against_a_loop():
    v = unit_walk(64, 3, 0)
    D = 32
    want = np.array([[np.sum(np.einsum("fi,fi->f", v[:-d, b], v[d:, b]) ** 2)
                      for d in range(1, D + 1)] for b in range(3)])
    got = traj.lag_sums(torch.as_tensor(v).transpose(0, 1), D).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_chunk_ct_and_pooled():
    v = torch.as_tensor(unit_walk(200, 4, 1).reshape(2, 100, 4, 3))
    ct = traj.chunk_ct(v)
    s = traj.lag_sums(v.transpose(1, 2), 50)
    want = -0.5 + 1.5 * s / (100 - torch.arange(1, 51, dtype=F64))
    torch.testing.assert_close(ct, want)
    m, sem = traj.pooled(ct, 2)
    torch.testing.assert_close(m, ct.mean(0))
    torch.testing.assert_close(sem, ct.std(0, correction=0) / (math.sqrt(2) - 1))


def test_horn_recovers_a_rotation():
    rng = np.random.default_rng(2)
    ref = rng.normal(size=(20, 3))
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.sign(q[:, :1])
    frames = systems.quat_rotate(np.broadcast_to(ref, (5, 20, 3)).copy(), q) + 3.0
    S = traj.frame_correlations(torch.as_tensor(frames), torch.as_tensor(ref),
                                torch.ones(20, dtype=F64))
    got = traj.horn_quats(S)
    np.testing.assert_allclose(got.numpy(), q, atol=1e-10)
    assert float(traj.angle_gap(got, -got).max()) < 1e-7


def test_dq_tensors_of_a_fixed_spin():
    """A constant rotation rate about z: every pair vector is (0, 0,
    sin(lag w / 2)), so M holds sin^2 in its zz entry alone."""
    w = 0.01
    t = np.arange(400)
    q = np.stack([np.cos(w * t / 2), 0 * t, 0 * t, np.sin(w * t / 2)], 1)
    M = traj.dq_tensors(torch.as_tensor(q), [1, 10, 100]).numpy()
    for i, lag in enumerate((1, 10, 100)):
        want = np.zeros((3, 3))
        want[2, 2] = math.sin(w * lag / 2) ** 2
        np.testing.assert_allclose(M[i], want, atol=1e-14)


def test_fit_decay_exact():
    x = torch.arange(1, 101, dtype=F64) * 10.0
    y = 0.5 * torch.exp(-x / 321.0) + 0.5
    assert abs(traj.fit_decay(x, y) / 321.0 - 1) < 1e-9


def test_principal_frame_aligns_axes():
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    q = traj.principal_frame(torch.as_tensor(R))
    out = traj.rotate(torch.as_tensor(R), q).numpy()
    np.testing.assert_allclose(np.abs(out), np.eye(3), atol=1e-12)


def test_lambert_hist_against_numpy():
    v = torch.as_tensor(unit_walk(500, 2, 4))
    got = traj.lambert_hist(v, 12, 6).numpy()
    for b in range(2):
        x = v[:, b].numpy()
        h, _, _ = np.histogram2d(np.arctan2(x[:, 1], x[:, 0]), x[:, 2], bins=(12, 6),
                                 range=((-np.pi, np.pi), (-1, 1)))
        np.testing.assert_array_equal(got[b], h)


def test_j_symmtop_isotropic_limit():
    """At Daniso 1 the axisymmetric J is the isotropic model-free form
    zeta [S2 tau / (1 + w^2 tau^2) + sum C k / (k^2 + w^2)], k = 1/tau + 1/tau_k,
    whatever the vector."""
    pair = physics.Pair(600.133)
    diso, tau_c = 1 / (6 * 4000.0), 4000.0
    v = torch.nn.functional.normalize(torch.randn(3, 5, 3, dtype=F64), dim=-1)
    S2 = torch.tensor([0.8, 0.7, 0.9], dtype=F64)
    C = torch.tensor([[0.1, 0.05], [0.2, 0.0], [0.05, 0.02]], dtype=F64)
    tau = torch.tensor([[20.0, 300.0], [50.0, 1.0], [10.0, 900.0]], dtype=F64)
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]], dtype=F64)
    J = physics.j_symmtop(pair.omega, v, diso, 1.0, S2, C, tau, mask, 0.9)
    w = torch.tensor(pair.omega, dtype=F64)
    k = 1 / tau_c + 1 / tau
    want = 0.9 * (S2[:, None] * tau_c / (1 + (w * tau_c) ** 2)
                  + ((C * mask)[..., None] * k[..., None] / (k[..., None] ** 2 + w ** 2)).sum(1))
    torch.testing.assert_close(J, want[:, None, :].expand_as(J))


def test_rates_against_the_formulas():
    pair = physics.Pair(850.13)
    J = torch.tensor([[4e3, 2e2, 5.0, 3.0, 2.5]], dtype=F64)
    R1, R2, sig, rho = physics.rates_from_j(pair, J, physics.CSA_N)
    dd, csa = pair.f_dd, pair.f_csa(physics.CSA_N)
    j = J[0].tolist()
    assert math.isclose(float(R1), 1e-12 * (dd * (j[2] + 3 * j[1] + 6 * j[4]) + csa * j[1]))
    assert math.isclose(float(R2), 1e-12 * (0.5 * dd * (4 * j[0] + j[2] + 3 * j[1] + 6 * j[4]
                                                          + 6 * j[3])
                                            + csa / 6 * (4 * j[0] + 3 * j[1])))
    assert math.isclose(float(rho), j[1] / j[0])
    assert math.isclose(float(sig), 1e-12 * (267.513 / -27.116) * dd * (6 * j[4] - j[2]))


def test_weighted_stats():
    x = torch.tensor([[1.0, 2.0, 4.0]], dtype=F64)
    w = torch.tensor([[1.0, 0.0, 3.0]], dtype=F64)
    m, s = physics.wstats(x, w)
    assert math.isclose(float(m), 3.25) and math.isclose(float(s), math.sqrt(1.6875))


def test_refine_reaches_an_exact_model():
    t = torch.arange(1, 301, dtype=F64) * 2.0
    S2, C, tau = torch.tensor([0.7]), torch.tensor([[0.1, 0.15]]), torch.tensor([[8.0, 150.0]])
    mask = torch.ones((1, 2), dtype=F64)
    y = ctfit.model(t, S2.double(), C.double(), tau.double(), mask)
    sigma = torch.full_like(y, 1e-3)
    f, f0, (S2n, Cn, taun) = ctfit.refine(t, y, sigma, torch.tensor([0.65], dtype=F64),
                                          torch.tensor([[0.12, 0.13]], dtype=F64),
                                          torch.tensor([[10.0, 120.0]], dtype=F64), mask,
                                          torch.tensor([True]))
    assert float(f) < 1e-12 * float(f0)
    torch.testing.assert_close(taun, tau.double(), rtol=1e-6, atol=0)


def test_chisq_against_a_loop():
    """The global fit's chi-square: the mean over experiments of each one's
    masked mean of (v - t)^2 / (err^2 + sd^2)."""
    rng = np.random.default_rng(5)
    n = 6
    models = dict(names=[str(i) for i in range(n)], S2=0.6 + 0.3 * rng.random(n),
                  C=0.05 * rng.random((n, 2)), tau=np.array([[10.0, 300.0]] * n))
    vecs = torch.nn.functional.normalize(torch.randn(n, 7, 3, dtype=F64), dim=-1)
    w = rng.random((n, 7))
    ex = [dict(kind=k, mhz=m, names=["1", "3", "4"], values=rng.random(3) + 0.5,
               errors=0.05 * rng.random(3) + 0.01) for k in ("R1", "NOE") for m in (600.0, 800.0)]
    prob = globalfit.Problem(models, vecs, w, ex, physics.ZETA, physics.CSA_N, F64, "cpu")
    pred = prob.predict(1e-5, 1.2)
    total = 0.0
    for e in ex:
        v, sd = (a.numpy() for a in pred[(e["kind"], e["mhz"])])
        idx = [int(s) for s in e["names"]]
        total += np.mean((v[idx] - e["values"]) ** 2 / (e["errors"] ** 2 + sd[idx] ** 2))
    assert math.isclose(float(prob.chisq(1e-5, 1.2)), total / len(ex), rel_tol=1e-12)


def test_minimise_finds_the_truth_of_exact_data():
    n = 8
    rng = np.random.default_rng(6)
    models = dict(names=[str(i) for i in range(n)], S2=0.6 + 0.3 * rng.random(n),
                  C=0.05 * rng.random((n, 2)), tau=np.array([[10.0, 300.0]] * n))
    vecs = torch.nn.functional.normalize(torch.randn(n, 9, 3, dtype=F64), dim=-1)
    w = rng.random((n, 9)) + 0.1
    prob = globalfit.Problem(models, vecs, w, [], physics.ZETA, physics.CSA_N, F64, "cpu")
    prob.pairs = {m: physics.Pair(m) for m in (600.0, 850.0)}
    pred = prob.predict(9e-6, 1.3)
    ex = [dict(kind=k, mhz=m, names=models["names"], values=pred[(k, m)][0].numpy(),
               errors=np.full(n, 0.02)) for k in ("R1", "R2", "NOE") for m in (600.0, 850.0)]
    prob = globalfit.Problem(models, vecs, w, ex, physics.ZETA, physics.CSA_N, F64, "cpu")
    d, a, f = globalfit.minimise(prob, 1.1e-5, 1.1)
    assert abs(d / 9e-6 - 1) < 1e-6 and abs(a / 1.3 - 1) < 1e-6


def test_quantise_rounds_half_away():
    x = np.array([[[0.000015, -0.000015, 1.234565]]], dtype=np.float32)
    q = xtcwrite.quantise(x, 1e5)
    assert q.tolist() == [[[np.int32(np.float32(0.000015) * np.float32(1e5) + 0.5),
                            -np.int32(np.float32(0.000015) * np.float32(1e5) + 0.5),
                            np.int32(np.float32(1.234565) * np.float32(1e5) + 0.5)]]]


def test_encoder_writes_the_port_codecs_bytes(tmp_path):
    """The trimmed encoder and the port's whole codec write the same file
    (runs, absolute atoms, a coordinate spread past 2^24 quanta)."""
    from spinrelax_tpu_torch.io import native

    rng = np.random.default_rng(5)
    xyz = np.cumsum(rng.normal(0, 0.05, (7, 40, 3)), axis=1).astype(np.float32)
    xyz[3, 7] += 300.0
    times = np.arange(7, dtype=np.float32) * 2.0
    ours, port = tmp_path / "ours.xtc", tmp_path / "port.xtc"
    xtcwrite.write_xtc(str(ours), xyz, times, 1000.0)
    native.write_xtc(str(port), xyz, times, precision=1000.0)
    assert ours.read_bytes() == port.read_bytes()


def test_judge_gaps():
    assert judge.rel_gap([1.0, 2.0], [1.0, 1.0]) == 1.0
    assert judge.abs_gap([1.0, np.nan], [1.0, 1.0]) == float("inf")
    assert judge.moved_share([[3, 1]], [[2, 2]]) == 0.25
    lims = judge.judged({"a": 1.0, "b": 3.0, "c": 0.0}, {"a": 2.0, "b": 2.0})
    assert [x["ok"] for x in lims] == [True, False, False]


@pytest.mark.parametrize("scan", ["qmul", "ou"])
def test_generator_scans_against_loops(scan):
    rng = np.random.default_rng(7)
    if scan == "qmul":
        steps = systems.rotation_walk_steps(rng.normal(scale=0.05, size=(37, 3)))
        cur, want = steps[0], [steps[0]]
        for s in steps[1:]:
            cur = systems.qmul(cur, s)
            want.append(cur)
        np.testing.assert_allclose(systems.prefix_qmul(steps), np.array(want), atol=1e-14)
    else:
        k = rng.normal(size=(37, 4))
        a = np.array([0.9, 0.5, 0.99, 0.0])
        x, want = np.zeros(4), []
        for row in k:
            x = a * x + row
            want.append(x.copy())
        np.testing.assert_allclose(systems.prefix_ou(k, a), np.array(want), atol=1e-12)
