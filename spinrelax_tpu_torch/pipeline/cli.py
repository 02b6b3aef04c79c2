"""Command-line helpers of the port (``spinrelax_tpu/pipeline/cli.py``).
Only what ``pipeline.runall`` needs is ported: :func:`_parse_csa`.  The
subcommands wait for ROADMAP item 14."""

from __future__ import annotations

import os
import sys

import numpy as np


def _parse_csa(csa_arg, names):
    """--csa argument: numeric value or file; autoscale from ppm
    (calculate-relaxations-from-Ct.py:701-743)."""
    if csa_arg is None:
        return None
    if os.path.exists(csa_arg):
        from ..io import xvg

        resid, vals = xvg.load_xy(csa_arg)
        if abs(vals[0]) > 1.0:
            vals = vals * 1e-6
        order = {str(int(r)): v for r, v in zip(resid, vals)}
        missing = [str(n) for n in names if str(n) not in order]
        if missing:
            # The reference exits with a resid-mismatch message here
            # (sanity_check_two_list, calculate-relaxations-from-Ct.py:730).
            sys.exit(
                "= = = ERROR: CSA file %r lacks residues present in the "
                "fitted-Ct data: %s" % (csa_arg, ", ".join(missing[:8]))
            )
        return np.array([order[str(n)] for n in names])
    val = float(csa_arg)
    if abs(val) > 1.0:
        val *= 1e-6
    return np.full(len(names), val)
