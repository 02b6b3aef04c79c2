"""Scatter plot of fitted C(t) parameters (plot-fittedCt-values.py
equivalent): per-residue (tau_i, C_i) components as a colour-mapped
scatter with S2_slow / S2_fast panels above/below, mirroring the
reference's layout (plot-fittedCt-values.py:146-196).  Out-of-range tau
components are shifted into the S2 panels when --tmin/--tmax are given
(plot-fittedCt-values.py:115-127) unless --noshift.

Divergences from the reference, on purpose:
  * with no -o the reference calls plt.show(); this CLI is headless, so
    it writes fittedCt.pdf instead;
  * the reference crashes with NameError (`pPlotS2f` typo,
    plot-fittedCt-values.py:157) when S2_slow is all zero but S2_fast is
    not — the intended layout is implemented.

The port's copy of ``spinrelax_tpu/pipeline/plotting.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import argparse

import numpy as np


def _point_size(frac, smin, smax):
    """plot-fittedCt-values.py:12-13 — marker area from amplitude."""
    return (smin + frac * (smax - smin)) ** 2.0


def _update_range(rng, lo, hi):
    out = list(rng)
    if lo is not None:
        out[0] = lo
    if hi is not None:
        out[1] = hi
    return out


def _int_round(val, mod, up=False):
    return val + mod - (val % mod) if up else val - (val % mod)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="spinrelax plot-ct",
        description="Plot fitted C(t) parameters as a per-residue scatter.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-v", action="store_true", dest="bVerbose",
                   help="Turn on debug output.")
    p.add_argument("-f", dest="inFile", required=True)
    p.add_argument("-o", dest="outFile", default=None)
    p.add_argument("--cmap", default="jet")
    p.add_argument("--tmin", type=float, default=None,
                   help="Minimum time constant to plot; faster components "
                        "are assigned to S2_fast.")
    p.add_argument("--tmax", type=float, default=None,
                   help="Maximum time constant to plot; slower components "
                        "are assigned to S2_slow.")
    p.add_argument("--noshift", action="store_true",
                   help="Drop out-of-range components instead of shifting "
                        "them into the S2 panels.")
    p.add_argument("--tu", default="ps")
    p.add_argument("--figx", type=float, default=5.0)
    p.add_argument("--figy", type=float, default=3.0)
    p.add_argument("--smin", type=float, default=5.0,
                   help="Cosmetic resizing of the points.")
    p.add_argument("--smax", type=float, default=10.0,
                   help="Cosmetic resizing of the points.")
    p.add_argument("--xmin", type=float, default=None)
    p.add_argument("--xmax", type=float, default=None)
    p.add_argument("--xlabel", default="Residue index")
    p.add_argument("--sequence", default=None,
                   help="Switch tick labelling from numbers to a given "
                        "sequence (list or single string).")
    p.add_argument("--xshift", type=float, default=None,
                   help="Shift the x-range numbering; with --sequence, the "
                        "position of the first residue.")
    p.add_argument("--title", default=None)
    a = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..io.fittedct import read_fittedct

    cts = read_fittedct(a.inFile, device="cpu")  # a plot: host arrays
    print(f"= = = Read {a.inFile} and found {len(cts.names)} sets of parameters.")
    S2 = np.asarray(cts.S2)
    C = np.asarray(cts.C)
    tau = np.asarray(cts.tau)
    mask = np.asarray(cts.mask) > 0
    s2fast = np.asarray(cts.s2_fast())
    resids = np.array([float(n) for n in cts.names])
    if a.sequence is None and a.xshift is not None:
        resids = resids + float(a.xshift)

    if a.bVerbose:
        for i, name in enumerate(cts.names):
            comps = " ".join(
                f"(C={C[i, k]:.4g}, tau={tau[i, k]:.4g})"
                for k in range(C.shape[1]) if mask[i, k]
            )
            print(f"...model {name}: S2={S2[i]:.4g} S2_fast={s2fast[i]:.4g} {comps}")
    print(f"= = = ..,with a total count of {int(mask.sum())} transient components.")

    # Component scatter + shift semantics (plot-fittedCt-values.py:115-130):
    # shifting happens only against EXPLICIT --tmin/--tmax bounds.
    s2_slow_plot = S2.astype(float).copy()
    s2_fast_plot = s2fast.astype(float).copy()
    pts = []  # (resid, tau, size, C)
    for i in range(len(resids)):
        for k in range(C.shape[1]):
            if not mask[i, k]:
                continue
            t = tau[i, k]
            if a.tmin is not None and t < a.tmin:
                if not a.noshift:
                    s2_fast_plot[i] += C[i, k]
                continue
            if a.tmax is not None and t > a.tmax:
                if not a.noshift:
                    s2_slow_plot[i] += C[i, k]
                continue
            pts.append((resids[i], t, _point_size(C[i, k], a.smin, a.smax), C[i, k]))
    pts = np.array(pts) if pts else np.zeros((0, 4))

    plot_s2s = bool(np.any(s2_slow_plot > 0))
    plot_s2f = bool(np.any(s2_fast_plot > 0))

    fig = plt.figure(figsize=(a.figx, a.figy))
    fig.subplots_adjust(hspace=0.05)
    ax1 = ax3 = None
    if plot_s2s and plot_s2f:
        ax1 = plt.subplot2grid((5, 1), (0, 0))
        ax2 = plt.subplot2grid((5, 1), (1, 0), rowspan=3)
        ax3 = plt.subplot2grid((5, 1), (4, 0))
    elif plot_s2s:
        ax1 = plt.subplot2grid((5, 1), (0, 0))
        ax2 = plt.subplot2grid((5, 1), (1, 0), rowspan=4)
    elif plot_s2f:
        ax2 = plt.subplot2grid((5, 1), (0, 0), rowspan=4)
        ax3 = plt.subplot2grid((5, 1), (4, 0))
    else:
        ax2 = plt.subplot2grid((5, 1), (0, 0), rowspan=5)
    ax_list = [ax for ax in (ax1, ax2, ax3) if ax is not None]

    sc = ax2.scatter(
        pts[:, 0], pts[:, 1], s=pts[:, 2], c=pts[:, 3], alpha=1.0,
        cmap=a.cmap, vmin=0.0, vmax=1.0, linewidths=0.5, edgecolors="black",
    )
    ax2.set_yscale("log")
    ax2.set_ylabel(f"$\\tau$ components [{a.tu}]")

    if a.xmin is not None or a.xmax is not None:
        ax2.set_xlim(_update_range(ax2.get_xlim(), a.xmin, a.xmax))
    x_min, x_max = ax2.get_xlim()
    if a.tmin is not None or a.tmax is not None:
        ax2.set_ylim(_update_range(ax2.get_ylim(), a.tmin, a.tmax))

    for ax, vals, label in ((ax1, s2_slow_plot, "S$^2$"),
                            (ax3, s2_fast_plot, "S$^2_{fast}$")):
        if ax is None:
            continue
        ax.scatter(
            resids, vals, s=_point_size(vals, a.smin, a.smax), c=vals,
            alpha=1.0, cmap=a.cmap, vmin=0.0, vmax=1.0,
            linewidths=0.5, edgecolors="black",
        )
        ax.set_ylabel(label)
        ax.set_xlim(ax2.get_xlim())
        ax.set_ylim([0.0, 1.0])
        ax.set_yticks([0.5, 1.0])
        ax.set_yticks([0.1, 0.2, 0.3, 0.4, 0.6, 0.7, 0.8, 0.9], minor=True)

    for ax in ax_list:
        ax.set_xlabel(a.xlabel)
        ax.grid(which="both", color="lightgrey", linestyle=":", linewidth=1)
        ax.set_axisbelow(True)

    # Tick placement (plot-fittedCt-values.py:197-221).
    if a.sequence is None:
        x_range = x_max - x_min
        for ax in ax_list:
            if x_range <= 10:
                ax.set_xticks(np.arange(x_min, x_max))
            elif x_range <= 50:
                ax.set_xticks(np.arange(x_min, x_max), minor=True)
                ax.set_xticks(np.arange(_int_round(x_min, 5, True), x_max, 5))
            elif x_range <= 200:
                ax.set_xticks(np.arange(_int_round(x_min, 2, True), x_max, 2), minor=True)
                ax.set_xticks(np.arange(_int_round(x_min, 10, True), x_max, 10))
            else:
                ax.set_xticks(np.arange(_int_round(x_min, 5, True), x_max, 5), minor=True)
                ax.set_xticks(np.arange(_int_round(x_min, 20, True), x_max, 20))
    else:
        shift = 1.0 if a.xshift is None else a.xshift
        labels = a.sequence.split()
        if len(labels) == 1:
            labels = list(labels[0])
        for ax in ax_list:
            ax.set_xticks(np.arange(shift, len(labels) + shift))
            ax.set_xticklabels(labels)

    # Only the bottom panel keeps tick labels.
    empty = [""] * len(ax2.get_xticklabels())
    if ax1 is not None:
        ax1.set_xticklabels(empty)
    if ax3 is not None:
        ax2.set_xticklabels(empty)

    if a.title is not None:
        plt.suptitle(a.title)
    fig.subplots_adjust(right=0.9)
    cbar_ax = fig.add_axes([0.92, 0.1, 0.01, 0.8])
    fig.colorbar(sc, cax=cbar_ax)

    out = a.outFile if a.outFile else "fittedCt.pdf"
    fig.savefig(out, dpi=150)
    print(f"= = Wrote {out}")


if __name__ == "__main__":
    main()
