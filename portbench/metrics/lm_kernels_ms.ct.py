"""Device milliseconds a job spends in the LM's kernels B to E
(lm_kernel<...>, lm_kernel_wide<...>, lm_step_solve_kernel<...>,
lm_step_gate_kernel<...>), by name in the profiler, a mean over the
traced window's jobs."""

UNIT = "ms"


def read(t):
    spent = t.kernel_seconds(lambda n: "lm_kernel" in n or "lm_step_" in n)
    if not t.records or not t.kernels:
        return None
    return 1e3 * spent / len(t.records)
