"""xmgrace/xvg-family text I/O.

Host-side readers/writers for the reference's inter-stage wire formats
(``general_scripts.py:47-381``).  Formats are preserved byte-compatibly
where downstream reference tooling parses them (e.g. ``%g`` float
rendering, ``&`` set terminators, ``@s%d legend`` lines).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import csv

import numpy as np

from .zopen import topen


_COMMENT = ("#", "@")


def _data_lines(fn: str):
    with topen(fn) as fp:
        for line in fp:
            if not line.strip():
                continue
            yield line


def load_matrix(fn: str) -> np.ndarray:
    """Whitespace table -> 2D array, skipping #/@/& lines
    (general_scripts.py:29-45)."""
    rows = []
    for line in _data_lines(fn):
        if line[0] in _COMMENT or line[0] == "&":
            continue
        rows.append([float(x) for x in line.split()])
    if not rows:
        # np.array([]) is 1-D; letting it through surfaces later as a
        # cryptic "too many indices" in m[:, 0] — name the file instead
        # (truncated/not-yet-written tables are a real resume scenario).
        raise ValueError(f"{fn}: no data rows (only comments/blank lines)")
    return np.array(rows)


def load_xy(fn: str) -> Tuple[np.ndarray, np.ndarray]:
    """(general_scripts.py:47-56)."""
    m = load_matrix(fn)
    return m[:, 0], m[:, 1]


def load_xys(fn: str) -> Tuple[np.ndarray, np.ndarray]:
    """x plus remaining columns (general_scripts.py:58-67)."""
    m = load_matrix(fn)
    return m[:, 0], m[:, 1:]


def load_xydy(fn: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    m = load_matrix(fn)
    if m.shape[1] < 3:
        raise ValueError(f"{fn}: expected a third dy column")
    return m[:, 0], m[:, 1], m[:, 2]


def load_sxydylist(fn: str, key: str = "legend"):
    """Multi-set xmgrace file keyed by legend strings
    (general_scripts.py:182-213).  Returns
    (legends, x(nSets,nPts), y(nSets,nPts), dy(nSets,nPts) or [])."""
    legs: List[str] = []
    xlist, ylist, dylist = [], [], []
    x, y, dy = [], [], []
    for line in _data_lines(fn):
        parts = line.split()
        if line[0] in _COMMENT:
            if key in line:
                legs.append(parts[-1].strip('"'))
            continue
        if line[0] == "&":
            if x:
                xlist.append(x)
                ylist.append(y)
                if dy:
                    dylist.append(dy)
            x, y, dy = [], [], []
            continue
        x.append(float(parts[0]))
        y.append(float(parts[1]))
        if len(parts) > 2:
            dy.append(float(parts[2]))
    if x:
        xlist.append(x)
        ylist.append(y)
        if dy:
            dylist.append(dy)
    if dylist and len(dylist) != len(xlist):
        # The reference's loader (general_scripts.py:182-213) silently
        # returns a dy list shorter than x/y here, and downstream numpy
        # broadcasting then fits residues against the WRONG error bars.
        # That is a defect, not a quirk worth replicating (SURVEY §2.7).
        raise ValueError(
            f"{fn}: {len(dylist)} of {len(xlist)} sets carry a dy column "
            "— mixed with/without-error sets cannot be aligned"
        )
    if dylist:
        return legs, np.array(xlist), np.array(ylist), np.array(dylist)
    return legs, np.array(xlist), np.array(ylist), []


def print_xy(fn: str, x, y, dy=None, header: str = ""):
    """(general_scripts.py:231-241); python str() rendering to match."""
    with topen(fn, "w") as fp:
        if header:
            print(header, file=fp)
        if dy is None or len(dy) == 0:
            for xi, yi in zip(x, y):
                print(xi, yi, file=fp)
        else:
            for xi, yi, di in zip(x, y, dy):
                print(xi, yi, di, file=fp)


def print_xydy(fn: str, x, y, dy, header: str = ""):
    print_xy(fn, x, y, dy, header)


def print_xylist(fn: str, x, ylist, cols: bool = False, header: str = ""):
    """(general_scripts.py:246-273)."""
    ylist = np.asarray(ylist)
    with topen(fn, "w") as fp:
        if header:
            print(header, file=fp)
        if ylist.ndim == 1:
            for xi, yi in zip(x, ylist):
                print(xi, yi, file=fp)
            print("&", file=fp)
        else:
            if cols:
                for j in range(ylist.shape[1]):
                    s = "%g " % x[j] + " ".join("%g" % ylist[i][j] for i in range(ylist.shape[0]))
                    print(s, file=fp)
                print("&", file=fp)
            else:
                for i in range(ylist.shape[0]):
                    for j in range(len(x)):
                        print(x[j], ylist[i][j], file=fp)
                    print("&", file=fp)


def _default_printoptions() -> bool:
    """The native renderer copies numpy's DEFAULT printoptions; under any
    user override (set_printoptions) the rows go through numpy's own
    formatter (the JAX package's rule, ``spinrelax_tpu/io/xvg.py:150``)."""
    po = np.get_printoptions()
    return (
        po["precision"] == 8 and not po["suppress"] and po["sign"] == "-"
        and po["floatmode"] == "maxprec" and po["nanstr"] == "nan"
        and po["infstr"] == "inf" and po.get("legacy") in (False, None)
        and po["linewidth"] >= 75 and po.get("formatter") is None
        # rows are <= 3 elements; threshold <= 3 would summarize them
        and po["threshold"] > 3
    )


def _native_rows(x, ylist) -> bool:
    """Whether ``native.format_sxy`` renders these rows: default
    printoptions, float64 x, float32/float64 rows of at most 3 values."""
    return (ylist.ndim == 3 and ylist.shape[-1] <= 3
            and ylist.dtype in (np.float32, np.float64)
            and np.asarray(x).dtype == np.float64 and _default_printoptions())


def print_sxylist(fn: str, legend, x, ylist, header: Sequence[str] = ()):
    """Legend-keyed multi-set output (general_scripts.py:275-290).
    ylist may be (nSets, nPts) or (nSets, nPts, nCols).

    The ndim == 3 rows are numpy's aligned ``str(ndarray)`` rendering (the
    reference prints str(row).strip('[]')).  ``native.format_sxy`` renders
    the same bytes in C, one set per call; numpy's row formatter takes what
    the renderer does not render (see :func:`_native_rows`)."""
    ylist = np.asarray(ylist)
    native_rows = _native_rows(x, ylist)
    if native_rows:
        from . import native

        xarr = np.ascontiguousarray(x, dtype=np.float64)
    with topen(fn, "w") as fp:
        for line in header:
            print(line, file=fp)
        for i in range(ylist.shape[0]):
            print('@s%d legend "%s"' % (i, legend[i]), file=fp)
            if native_rows:
                fp.write(native.format_sxy(xarr, ylist[i]).decode("ascii"))
            elif ylist.ndim == 3:
                for j in range(len(x)):
                    # reference: str(ndarray).strip('[]') -- numpy's
                    # aligned rendering, incl. its padding whitespace
                    print(x[j], str(ylist[i, j]).strip("[]"), file=fp)
            else:
                for j in range(len(x)):
                    print(x[j], ylist[i, j], file=fp)
            print("&", file=fp)


def print_gplot_hist(fn: str, hist, edges, header: str = "", sphere: bool = False):
    """Gnuplot-style histogram dump with optional spherical completion
    (general_scripts.py:327-381)."""
    hist = np.asarray(hist)
    nbins = hist.shape
    dim = len(nbins)
    with topen(fn, "w") as fp:
        if header:
            print(header, file=fp)
        print("# DIMENSIONS: %i" % dim, file=fp)
        print(
            "# BINWIDTH: "
            + " ".join("%g" % ((edges[i][-1] - edges[i][0]) / nbins[i]) for i in range(dim)),
            file=fp,
        )
        print("# NBINS: " + " ".join("%g" % nbins[i] for i in range(dim)), file=fp)
        if sphere:
            if dim != 2:
                raise ValueError("spherical histogram output requires 2D data")
            xmin = 0.5 * (edges[0][0] + edges[0][1])
            ymin, ymax = edges[1][0], edges[1][-1]
            for ex in range(nbins[0]):
                xavg = 0.5 * (edges[0][ex] + edges[0][ex + 1])
                print("%g %g %g" % (xavg, ymin, hist[ex][0]), file=fp)
                for ey in range(nbins[1]):
                    yavg = 0.5 * (edges[1][ey] + edges[1][ey + 1])
                    print("%g %g %g" % (xavg, yavg, hist[ex][ey]), file=fp)
                print("%g %g %g" % (xavg, ymax, hist[ex][-1]), file=fp)
                print("", file=fp)
            print("%g %g %g" % (xmin + 2 * np.pi, ymin, hist[0][0]), file=fp)
            for ey in range(nbins[1]):
                yavg = 0.5 * (edges[1][ey] + edges[1][ey + 1])
                print("%g %g %g" % (xmin + 2 * np.pi, yavg, hist[0][ey]), file=fp)
            print("%g %g %g" % (xmin + 2 * np.pi, ymax, hist[0][-1]), file=fp)
            print("", file=fp)
        else:
            for index, val in np.ndenumerate(hist):
                s = " ".join(
                    "%g" % (0.5 * (edges[i][index[i]] + edges[i][index[i] + 1]))
                    for i in range(dim)
                )
                print(s + " %g" % val, file=fp)
                if index[-1] == nbins[-1] - 1:
                    print("", file=fp)


def format_header_legend(legends, s_init: int = 0, step: int = 1) -> str:
    out = ""
    s = s_init
    for leg in legends:
        out += '@s%i legend "%s"\n' % (s, leg)
        s += step
    return out


def format_float_with_error(val: float, err: float, prec: int = 4) -> str:
    """Value +- error rendered to a common exponent
    (general_scripts.py:18-27)."""
    # A zero operand must inherit the OTHER operand's exponent (the
    # reference's log10(0) = -inf drops out of max()); exponent 0 only
    # when both are zero.
    exp_val = np.floor(np.log10(abs(val))) if val != 0 else -np.inf
    exp_err = np.floor(np.log10(abs(err))) if err != 0 else -np.inf
    exp_max = max(exp_val, exp_err)
    exp_out = int(exp_max) if np.isfinite(exp_max) else 0
    return "%.*fe%i +- %.*fe%i" % (
        prec, val * 10.0**-exp_out, exp_out, prec, err * 10.0**-exp_out, exp_out,
    )


def load_block_as_numpy(fn: str, ignores: str = "#@", newblock: str = "&"):
    """Freeform block loader (general_scripts.py:86-143): 2D table, or 3D
    when multiple '&'-terminated (or blank-line-separated) blocks exist.
    'alpha' in ``ignores`` also skips lines starting with a letter."""
    alpha = "alpha" in ignores
    if alpha:
        ignores = ignores.replace("alpha", "")
    out3d, out2d = [], []
    with topen(fn) as fp:
        for line in fp:
            if not line.strip():
                if not newblock and out2d:
                    out3d.append(out2d)
                    out2d = []
                continue
            c = line[0]
            if c in ignores or (alpha and c.isalpha()):
                continue
            if newblock and c in newblock:
                out3d.append(out2d)
                out2d = []
                continue
            out2d.append([float(x) for x in line.split()])
    if not out3d:
        return np.array(out2d)
    if out2d:
        out3d.append(out2d)
    if len(out3d) == 1:
        return np.array(out3d[0])
    return np.array(out3d)


def load_xylist(fn: str):
    """'&'-separated list of xy sets (general_scripts.py:145-160)."""
    xs, ys = [], []
    x, y = [], []
    with topen(fn) as fp:
        for line in fp:
            if not line.strip() or line[0] in "#@":
                continue
            if line[0] == "&":
                xs.append(x)
                ys.append(y)
                x, y = [], []
                continue
            parts = line.split()
            x.append(float(parts[0]))
            y.append(float(parts[1]))
    if x:
        xs.append(x)
        ys.append(y)
    return xs, ys


def load_xydylist(fn: str):
    """'&'-separated list of xydy sets (general_scripts.py:162-180)."""
    xs, ys, dys = [], [], []
    x, y, dy = [], [], []
    with topen(fn) as fp:
        for line in fp:
            if not line.strip() or line[0] in "#@":
                continue
            if line[0] == "&":
                xs.append(x)
                ys.append(y)
                dys.append(dy)
                x, y, dy = [], [], []
                continue
            parts = line.split()
            x.append(float(parts[0]))
            y.append(float(parts[1]))
            dy.append(float(parts[2]))
    if x:
        xs.append(x)
        ys.append(y)
        dys.append(dy)
    return xs, ys, dys


def print_R_hist(fn: str, hist, edges, header: str = ""):
    """R-style histogram dump with bin borders per line
    (general_scripts.py:310-325)."""
    hist = np.asarray(hist)
    nbins = hist.shape
    dim = len(nbins)
    with topen(fn, "w") as fp:
        if header:
            print(header, file=fp)
        print("# DIMENSIONS: %i" % dim, file=fp)
        print(
            "# BINWIDTH: "
            + " ".join("%g" % ((edges[i][-1] - edges[i][0]) / nbins[i]) for i in range(dim)),
            file=fp,
        )
        print("# NBINS: " + " ".join("%g" % nbins[i] for i in range(dim)), file=fp)
        for index, val in np.ndenumerate(hist):
            s = " ".join(
                "%g %g" % (edges[i][index[i]], edges[i][index[i] + 1]) for i in range(dim)
            )
            print(s + " %g" % val, file=fp)


def print_gplot_4d(fn: str, datablock, x, y, z, header: str = ""):
    """Scalar field on a 3D grid as gnuplot x y z value lines
    (general_scripts.py:383-399)."""
    datablock = np.asarray(datablock)
    if datablock.ndim != 3:
        raise ValueError("print_gplot_4d requires 3D data")
    with topen(fn, "w") as fp:
        if header:
            print(header, file=fp)
        for i in range(datablock.shape[0]):
            for j in range(datablock.shape[1]):
                for k in range(datablock.shape[2]):
                    print(
                        "%g %g %g %g" % (x[i], y[j], z[k], datablock[i, j, k]),
                        file=fp,
                    )


def print_numpy_block(fn: str, data, header: str = "", delim: str = "&", axis: int = -1):
    """Unformatted 2D/3D dump (general_scripts.py:401-445)."""
    data = np.asarray(data)
    if axis not in (0, -1):
        raise ValueError("axis must be 0 or -1")
    if data.ndim > 3:
        raise ValueError("cannot deal with 4+ dimensional arrays")
    with topen(fn, "w") as fp:
        if header:
            print(header, file=fp)
        if data.ndim == 2:
            # reference uses csv.writer: full-precision str() fields and
            # \r\n terminators — byte parity requires the same.
            writer = csv.writer(fp, delimiter=" ")
            rows = data if axis == -1 else data.T
            for row in rows:
                writer.writerow(row)
        else:
            blocks = data if axis == -1 else np.moveaxis(data, 0, -1)
            for block in blocks:
                for row in block:
                    print(" ".join("%g " % v for v in row), file=fp)
                    print("", file=fp)
                print(delim, file=fp)
