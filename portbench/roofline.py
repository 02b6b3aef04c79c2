"""The card's peaks and the least time of each of the port's kernels, a
frozen copy of ``chip_smoke.bound_ms`` / ``acf_bound`` / ``lm_bound`` /
``step_bound``: the bytes each input read once and each output written
once over 3.35 TB/s, and the float32 operations (an FMA 2, a multiply,
add, exp, division or square root 1) over 67 TFLOP/s, the H100 SXM's
published peaks at 700 W."""

from __future__ import annotations

HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12


def bound_ms(n_bytes: float, n_flops: float):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, n_flops / FP32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def acf_operations(n_bonds: int, n_frames: int, n_deltas: int) -> float:
    """Kernel A's operations: the fewer of two ways to the same lag sums.
    The direct sum: sum_{d<=D} (F - d) terms a bond, each a 3-term dot (1
    multiply, 2 FMAs) and 1 FMA, 7 flops.  By FFT: the 6 component
    products (6F multiplies), each autocorrelation a real FFT and its
    inverse at N = the power of two >= F + D (2 x 2.5 N log2 N) and its
    power spectrum (1.5 N), and the weighted sum of the 6 (6 FMAs a lag)."""
    direct = 7 * (n_deltas * n_frames - n_deltas * (n_deltas + 1) // 2)
    n = 1 << (n_frames + n_deltas - 1).bit_length()
    log2n = n.bit_length() - 1
    fft = 6 * n_frames + 6 * (5 * n * log2n + 1.5 * n) + 12 * n_deltas
    return float(n_bonds * min(direct, fft))


def acf_bound(n_bonds: int, n_frames: int, n_deltas: int):
    """bound_ms of kernel A: the input read once, the (D, B) output written
    once, and :func:`acf_operations`."""
    return bound_ms(4 * n_bonds * (3 * n_frames + n_deltas),
                    acf_operations(n_bonds, n_frames, n_deltas))


def lm_bound(K: int, s2f: bool, B: int, T: int, full: bool):
    """bound_ms of kernel B (full) or C at (B, T).  Per (t, b) the residual
    takes K multiplies, K exps, K FMAs and 3 flops more, its square 1 FMA;
    kernel B adds the P Jacobian planes (2K or 3K multiplies, 3K) and the
    P(P+1)/2 + P FMAs of J^T J and J^T r."""
    P = 2 * K + int(s2f)
    flops = 4 * K + 5
    if full:
        flops += (K if s2f else 2 * K) + 3 * K + 2 * (P * (P + 1) // 2 + P)
    out = B * (P * P + P + 1) if full else B
    return bound_ms(4 * (2 * T * B + T + P * B + out), flops * T * B)


def step_bound(P: int, B: int, gate: bool, improved: int = 0, at_window: int = 0):
    """bound_ms of kernel D (gate False) or E at P parameters and B lanes.
    D reads H_p's lower triangle, g_p, t, lam, lo and span, and writes
    t_new, the trial parameters and the three norms; E reads the two
    costs, the three norms, lam, it, c_best, c_mark and done, and t_new and
    the trial parameters on the ``improved`` lanes, and writes lam, it,
    c_best and done, c_mark on the ``at_window`` lanes, t and the next
    parameters on the ``improved`` lanes, and live.  Operations: D's
    sigmoids, chain rule, damped matrix, Cholesky and substitutions;
    E's 11 a lane."""
    if gate:
        n_bytes = B * (4 * 9 + 1 + 4 * 3 + 1) + improved * 4 * 4 * P + at_window * 4 + 1
        return bound_ms(n_bytes, 11 * B)
    tri = P * (P + 1) // 2
    flops = 8 * P + 2 * tri + 8 * P + (tri - P) + P
    flops += sum(2 * j + 2 + (P - 1 - j) * (2 * j + 1) for j in range(P))
    flops += 2 * sum(2 * i + 1 for i in range(P))
    flops += 9 * P + 2
    n_bytes = 4 * B * (tri + 2 * P + 1) + 8 * P + 4 * B * (2 * P + 3) + 1
    return bound_ms(n_bytes, flops * B)
