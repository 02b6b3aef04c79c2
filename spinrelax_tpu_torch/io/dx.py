"""OpenDX volumetric I/O for 3D delta-q histograms (VMD-compatible).

Replaces ``dxio.py:15-122``; same unit conventions (default Angstrom with
nm<->A scaling of coordinates and 1/vol scaling of densities).  (Port of
``spinrelax_tpu/io/dx.py``; files carry the JAX package's header line, so
both packages write the same bytes.)
"""

from __future__ import annotations

import numpy as np

from .zopen import topen


def read_dx(fn: str, units: str = "A"):
    scale = 0.1 if units == "A" else 1.0
    if units not in ("A", "nm"):
        raise ValueError("units must be 'A' or 'nm'")
    dims = np.zeros(3, dtype=int)
    orig = np.zeros(3)
    abc = np.zeros((3, 3))
    deltadim = 0
    data = None
    count = 0
    ntot = 0
    with topen(fn) as fp:
        header = True
        for line in fp:
            if not line.strip() or line[0] == "#":
                continue
            parts = line.split()
            if header:
                if parts[0] == "origin":
                    orig = scale * np.array([float(x) for x in parts[1:4]])
                elif parts[0] == "object":
                    if parts[1] == "1":
                        dims = np.array([int(x) for x in parts[-3:]])
                    if parts[1] == "3":
                        ntot = int(parts[-3])
                        if ntot != int(np.prod(dims)):
                            raise ValueError(f"{fn}: data count != dims product")
                        data = np.zeros(ntot)
                        header = False
                elif parts[0] == "delta":
                    abc[deltadim] = scale * np.array([float(x) for x in parts[1:4]])
                    deltadim += 1
            else:
                if count >= ntot:
                    # Data complete: tolerate the trailing footer
                    # (object "density" class field / attribute lines,
                    # which write_dx itself emits) but fail cleanly on
                    # surplus NUMERIC values instead of silently
                    # dropping them.
                    try:
                        float(parts[0])
                    except ValueError:
                        continue
                    raise ValueError(
                        f"{fn}: more data values than the declared "
                        f"{ntot} items"
                    )
                for tok in parts:
                    if count >= ntot:
                        # Per-token bound: an over-long final line must
                        # fail cleanly, not IndexError past the array.
                        raise ValueError(
                            f"{fn}: more data values than the declared "
                            f"{ntot} items"
                        )
                    data[count] = float(tok)
                    count += 1
    if data is None:
        raise ValueError(
            f"{fn}: no 'data follows' section found (truncated DX file?)"
        )
    if count != ntot:
        # A file cut off mid-data would otherwise return silently
        # zero-padded densities.
        raise ValueError(
            f"{fn}: data section truncated ({count} of {ntot} values)"
        )
    data = (1.0 / scale**3) * np.reshape(data, dims, order="C")
    return data, dims, orig, abc


def write_dx(fn: str, data, dims, orig, abc, units: str = "A", scale_data: bool = True):
    scale = 10.0 if units == "A" else 1.0
    if units not in ("A", "nm"):
        raise ValueError("units must be 'A' or 'nm'")
    data = np.asarray(data)
    if tuple(dims) != data.shape:
        raise ValueError(f"dims {dims} do not match data shape {data.shape}")
    out_abc = scale * np.asarray(abc, dtype=float)
    if out_abc.ndim == 1:
        out_abc = np.diag(out_abc)
    out_orig = scale * np.asarray(orig, dtype=float)
    with topen(fn, "w") as fp:
        print("#DX-file written by spinrelax_tpu", file=fp)
        print("object 1 class gridpositions counts %i %i %i" % tuple(dims), file=fp)
        print("origin %g %g %g" % tuple(out_orig), file=fp)
        for i in range(3):
            print("delta %g %g %g" % tuple(out_abc[i]), file=fp)
        print("object 2 class gridpositions counts %i %i %i" % tuple(dims), file=fp)
        ntot = int(np.prod(dims))
        print("object 3 class array type double rank 0 items %i data follows" % ntot, file=fp)
        flat = data.flatten(order="C")
        if scale_data:
            flat = flat / scale**3
        for pos in range(0, len(flat), 3):
            print(" ".join("%g" % v for v in flat[pos : pos + 3]), file=fp)
        print("", file=fp)
        print('object "density [%s^-3]" class field' % units, file=fp)
