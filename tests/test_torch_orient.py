"""spinrelax_tpu_torch's core.quaternion, core.geometry and ops.orient
against spinrelax_tpu's on the CPU, on the same seeded numpy inputs.

float64 agrees to 1e-12 (quaternion, geometry) and 1e-9 (orient: the
eigenvector of Horn's 4x4 matrix comes from two LAPACK-style solvers);
float32 orient to 1e-5.  Quaternions from ``eigh`` are compared up to the
sign the solver happened to return before the double-cover reduction, and
equal after it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinrelax_tpu.core import geometry as jgeo
from spinrelax_tpu.core import quaternion as jqt
from spinrelax_tpu.ops import orient as jor
from spinrelax_tpu_torch.core import geometry as tgeo
from spinrelax_tpu_torch.core import quaternion as tqt
from spinrelax_tpu_torch.ops import orient as tor


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_state():
    """Clear jax's compiled-program caches before this module (see
    tests/test_review_fixes_r3.py); two torch threads per xdist worker."""
    jax.clear_caches()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(2)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _quats(rng, *shape):
    q = rng.normal(size=shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(rng, *shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(t, j, atol=1e-12):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


# --- core.quaternion ---------------------------------------------------------

_Q_CASES = {
    "qnorm": lambda m, q, p, v, u: m.qnorm(q * 3.0),
    "qnorm_zero": lambda m, q, p, v, u: m.qnorm(q * 0.0),
    "vecnorm": lambda m, q, p, v, u: m.vecnorm(v * 0.3),
    "qmult": lambda m, q, p, v, u: m.qmult(q, p),
    "qmult_broadcast": lambda m, q, p, v, u: m.qmult(q, p[0]),
    "qconj": lambda m, q, p, v, u: m.qconj(q),
    "qinvert": lambda m, q, p, v, u: m.qinvert(q),
    "qreduce": lambda m, q, p, v, u: m.qreduce(q),
    "qreduce_ref": lambda m, q, p, v, u: m.qreduce(q, p),
    "rotate_vector": lambda m, q, p, v, u: m.rotate_vector(v, q),
    "rotate_vector_unnormalised": lambda m, q, p, v, u: m.rotate_vector(v, q * 2.5),
    "rotate_vector_broadcast": lambda m, q, p, v, u: m.rotate_vector(v, q[0], normalised=True),
    "axangle_to_quat": lambda m, q, p, v, u: m.axangle_to_quat(v * 2.0, q[..., 0] * 3.0),
    "quat_v1v2": lambda m, q, p, v, u: m.quat_v1v2(v, u),
    "quat_v1v2_parallel": lambda m, q, p, v, u: m.quat_v1v2(v, v),
    "quat_v1v2_antiparallel": lambda m, q, p, v, u: m.quat_v1v2(v, -v),
    "quat_to_mat": lambda m, q, p, v, u: m.quat_to_mat(q),
    "mat_to_quat": lambda m, q, p, v, u: m.mat_to_quat(m.quat_to_mat(q)),
    "slerp": lambda m, q, p, v, u: m.slerp(q, p, 0.3),
    "slerp_same": lambda m, q, p, v, u: m.slerp(q, q, 0.7),
}


@pytest.mark.parametrize("name", sorted(_Q_CASES))
def test_quaternion_function_matches_jax(rng, name):
    """Every core.quaternion function on (5, 7) batches, float64, 1e-12."""
    q, p, v, u = _quats(rng, 5, 7), _quats(rng, 5, 7), _vecs(rng, 5, 7), _vecs(rng, 5, 7)
    got = _Q_CASES[name](tqt, *_t(q, p, v, u))
    want = _Q_CASES[name](jqt, *map(jnp.asarray, (q, p, v, u)))
    assert got.dtype == torch.float64
    _close(got, want)


@pytest.mark.parametrize("fn", ["frame_transform", "frame_transform_min"])
def test_frame_transform_matches_jax(rng, fn):
    """Orthonormal frames (rows of random rotation matrices, and the lab
    frame with flipped axes: the antiparallel branch), float64, 1e-12."""
    axes = np.asarray(jqt.quat_to_mat(jnp.asarray(_quats(rng, 9))))
    axes = np.concatenate([axes, np.diag([1.0, -1.0, -1.0])[None],
                           np.diag([-1.0, -1.0, 1.0])[None]])
    _close(getattr(tqt, fn)(*_t(axes)), getattr(jqt, fn)(jnp.asarray(axes)))


def test_random_quats_are_unit_reduced_and_uniform():
    """Draws differ from JAX's (another generator); the construction does
    not: unit norm, w >= 0 after the reduction, and Shoemake-uniform --
    |w| of a uniform rotation has mean 4 / (3 pi) -- within 5 sigma."""
    gen = torch.Generator().manual_seed(11)
    q = tqt.random_quats(gen, 20000)
    assert q.shape == (20000, 4) and q.dtype == torch.float64
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-12)
    assert (q[:, 0] >= 0).all()
    assert abs(float(q[:, 0].mean()) - 4 / (3 * np.pi)) < 5 * 0.27 / np.sqrt(20000)
    raw = tqt.random_quats(torch.Generator().manual_seed(11), 20000, reduce=False)
    assert (raw[:, 0] < 0).any() and torch.equal(tqt.qreduce(raw), q)
    assert tqt.random_quats(gen, 3, dtype=torch.float32).dtype == torch.float32


# --- core.geometry -----------------------------------------------------------

@pytest.mark.parametrize("fn,kind", [("xyz_to_rtp", "xyz"), ("xyz_to_pt", "unit"),
                                     ("pt_to_xyz", "pt"), ("rtp_to_xyz", "rtp")])
def test_geometry_transform_matches_jax(rng, fn, kind):
    """float64, 1e-12, including a zero vector and the poles."""
    unit = np.concatenate([_vecs(rng, 40), [[0, 0, 1.0], [0, 0, -1.0], [-1.0, 0, 0]]])
    pt = np.stack([rng.uniform(-np.pi, np.pi, 30), rng.uniform(0, np.pi, 30)], axis=-1)
    x = {"xyz": np.concatenate([unit * rng.uniform(0.1, 3, (43, 1)), np.zeros((1, 3))]),
         "unit": unit, "pt": pt,
         "rtp": np.concatenate([rng.uniform(0.1, 3, (30, 1)), pt], axis=-1)}[kind]
    _close(getattr(tgeo, fn)(*_t(x)), getattr(jgeo, fn)(jnp.asarray(x)))


def _hist_vectors(rng, dtype):
    """(3, 500) unit vectors with samples on bin edges: the poles, phi = pi
    (the clipped top bin), phi = -pi and an exact interior edge."""
    v = _vecs(rng, 3, 500)
    v[0, :5] = [[0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, -0.0, 0], [0, 1, 0]]
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("with_valid", [False, True])
def test_lambert_histogram_counts_equal_jax(rng, dtype, with_valid):
    """Counts equal exactly (int32), with and without ``valid``; invalid
    samples vanish; the edges agree to the dtype's rounding."""
    v = _hist_vectors(rng, dtype)
    valid = rng.uniform(size=500) < 0.7 if with_valid else None
    jh, jp, jc = jgeo.lambert_histogram(jnp.asarray(v), 24, 12, valid=valid)
    th, tp, tc = tgeo.lambert_histogram(
        *_t(v), 24, 12, valid=None if valid is None else torch.from_numpy(valid))
    assert th.dtype == torch.int32 and th.shape == (3, 24, 12)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert int(th.sum()) == 3 * (int(valid.sum()) if with_valid else 500)
    tol = 1e-6 if dtype == np.float32 else 1e-15
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp, dtype=np.float64), atol=tol)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc, dtype=np.float64), atol=tol)


def test_lambert_histogram_truncates_toward_zero():
    """The bin cast truncates toward zero like JAX's astype(int32): a z
    component a hair past -1 (clipped) and the exact bottom edge fall in
    bin 0, never in bin -1."""
    v = torch.tensor([[[0.0, -1e-9, -1.0], [1.0, 0.0, 0.0], [-1.0, -1e-30, 0.0]]],
                     dtype=torch.float64)
    th, _, _ = tgeo.lambert_histogram(v, 8, 4)
    jh, _, _ = jgeo.lambert_histogram(jnp.asarray(v.numpy()), 8, 4)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_lambert_hist_to_vecs_matches_jax(rng):
    hist = rng.integers(0, 50, (4, 12, 6))
    _, ep, ec = tgeo.lambert_histogram(torch.zeros(1, 1, 3, dtype=torch.float64), 12, 6)
    tv, tw = tgeo.lambert_hist_to_vecs(torch.from_numpy(hist), ep, ec)
    jv, jw = jgeo.lambert_hist_to_vecs(hist, ep.numpy(), ec.numpy())
    _close(tv, jv)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


# --- ops.orient ---------------------------------------------------------------

def _trajectory(rng, n_frames=60, n_atoms=30, dtype=np.float64, flip_at=None):
    """A reference, and frames = the reference rotated by a slow random walk
    of rotations, translated and jittered.  ``flip_at``: from that frame on
    the walk is composed with a turn of 179.9 degrees about x, so the Horn
    quaternion's w crosses zero between two frames."""
    ref = rng.normal(size=(n_atoms, 3))
    q = np.empty((n_frames, 4))
    cur = _quats(rng)
    for t in range(n_frames):
        step = np.concatenate([[1.0], 0.05 * rng.normal(size=3)])
        cur = np.asarray(jqt.qnorm(jqt.qmult(jnp.asarray(cur), jnp.asarray(step))))
        q[t] = cur
    if flip_at is not None:
        half = np.deg2rad(179.9) / 2
        turn = np.array([np.cos(half), np.sin(half), 0.0, 0.0])
        q[flip_at:] = np.asarray(jqt.qmult(jnp.asarray(q[flip_at:]), jnp.asarray(turn)))
    frames = np.asarray(jqt.rotate_vector(jnp.asarray(ref)[None], jnp.asarray(q)[:, None]))
    frames = frames + rng.normal(size=(n_frames, 1, 3)) + 0.01 * rng.normal(size=frames.shape)
    w = rng.uniform(0.2, 1.0, n_atoms)
    return frames.astype(dtype), ref.astype(dtype), w.astype(dtype)


def test_horn_matrix_matches_jax(rng):
    S = rng.normal(size=(6, 3, 3))
    _close(tor._horn_K(*_t(S)), jor._horn_K(jnp.asarray(S)))


@pytest.mark.parametrize("weighted", [False, True])
def test_orientation_quats_match_jax(rng, weighted):
    """Before the scan: equal up to sign (|q . q'| = 1 to 1e-9); after the
    double-cover reduction and the sign-continuity pass: equal."""
    frames, ref, w = _trajectory(rng)
    w = w if weighted else None
    S = np.einsum("ai,faj->fij", ref - ref.mean(0), frames - frames.mean(1, keepdims=True))
    _, tv = torch.linalg.eigh(tor._horn_K(*_t(S)))
    _, jv = jnp.linalg.eigh(jor._horn_K(jnp.asarray(S)))
    dots = np.abs(np.sum(tv[..., -1].numpy() * np.asarray(jv[..., -1]), axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-9)
    got = tor.orientation_quats(*_t(frames, ref), None if w is None else torch.from_numpy(w))
    want = jor.orientation_quats(frames, ref, w)
    _close(got, want, atol=1e-9)
    _close(tor._quats_from_S(*_t(S), continuous=False),
           jor._quats_from_S(jnp.asarray(S), continuous=False), atol=1e-9)


def test_sign_continuity_flip_matches_the_sequential_scan(rng):
    """A chunk whose rotation passes 180 degrees: the reduced quaternions
    (w >= 0) jump to the other image between two frames, the continuity pass
    flips every later frame, and the result equals JAX's sequential scan; a
    dot product of exactly zero restarts the running sign at +1, as the scan
    does."""
    frames, ref, _ = _trajectory(rng, n_frames=80, flip_at=37)
    S = np.einsum("ai,faj->fij", ref - ref.mean(0), frames - frames.mean(1, keepdims=True))
    reduced = tor._quats_from_S(*_t(S), continuous=False)
    cont = tor._quats_from_S(*_t(S), continuous=True)
    flipped = (torch.sum(reduced * cont, dim=-1) < 0).numpy()
    assert flipped.any() and not flipped.all()
    assert (torch.sum(cont[1:] * cont[:-1], dim=-1) >= 0).all()
    _close(cont, jor._quats_from_S(jnp.asarray(S), continuous=True), atol=1e-9)

    q = np.array([[1.0, 0, 0, 0], [-1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, -1.0, 0, 0],
                  [0, 1.0, 0, 0], [0, 0, -1.0, 0], [0, 0, 1.0, 0]])

    def scan(q):
        out, prev = [], q[0]
        for qi in q:
            prev = qi * (1.0 if np.sum(prev * qi) >= 0 else -1.0)
            out.append(prev)
        return np.array(out)

    np.testing.assert_array_equal(tor._sign_continuous(torch.from_numpy(q)).numpy(), scan(q))
    rq = _quats(rng, 200) * rng.choice([-1.0, 1.0], (200, 1))
    np.testing.assert_array_equal(tor._sign_continuous(torch.from_numpy(rq)).numpy(), scan(rq))


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_bond_vectors_and_superpose_match_jax(rng, dtype, atol):
    frames, ref, w = _trajectory(rng, dtype=dtype, flip_at=20)
    idx_h, idx_x = np.array([1, 4, 7, 22]), np.array([0, 3, 6, 21])
    got = tor.bond_vectors(*_t(frames, ref), idx_h, idx_x, torch.from_numpy(w))
    want = jor.bond_vectors(frames, ref, idx_h, idx_x, w)
    assert got.raw.dtype == got.fitted.dtype == torch.from_numpy(frames).dtype
    _close(got.raw, want.raw, atol)
    _close(got.fitted, want.fitted, atol)
    _close(tor.superpose(*_t(frames, ref), torch.from_numpy(w)),
           jor.superpose(frames, ref, w), atol * 10)
    _close(tor.superpose(*_t(frames, ref)), jor.superpose(frames, ref), atol * 10)


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_bond_obs_route_matches_jax(rng, dtype, atol):
    """bond_obs_matrix and bond_obs_host equal JAX's bit for bit (numpy and
    the same native loop); float32 in gives float32, float64 float64;
    bond_vectors_from_obs agrees with JAX's and with bond_vectors."""
    frames, ref, w = _trajectory(rng, dtype=dtype)
    idx_h, idx_x = np.array([1, 4, 7, 22]), np.array([0, 3, 6, 21])
    np.testing.assert_array_equal(tor.bond_obs_matrix(ref, w), jor.bond_obs_matrix(ref, w))
    traw, tS = tor.bond_obs_host(frames, ref, idx_h, idx_x, w)
    jraw, jS = jor.bond_obs_host(frames, ref, idx_h, idx_x, w)
    assert traw.dtype == tS.dtype == dtype
    np.testing.assert_array_equal(traw, jraw)
    np.testing.assert_array_equal(tS, jS)
    got = tor.bond_vectors_from_obs(*_t(traw, tS))
    want = jor.bond_vectors_from_obs(jraw, jS)
    _close(got.raw, want.raw, atol)
    _close(got.fitted, want.fitted, atol)
    whole = tor.bond_vectors(*_t(frames, ref), idx_h, idx_x, torch.from_numpy(w))
    _close(got.fitted, whole.fitted.numpy(), atol * 10)
