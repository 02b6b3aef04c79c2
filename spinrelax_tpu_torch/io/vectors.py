"""Vector-distribution persistence (.npz PhiTheta / LambertCylindrical);
the port's copy of ``spinrelax_tpu/io/vectors.py`` over its own
``core.geometry`` (numpy in, numpy out).

The reference stores per-residue bond-vector distributions either as raw
(phi, theta) samples or as Lambert-cylindrical histograms in compressed
.npz (calculate-Ct-from-traj.py:602-630) and reloads them for relaxation
calculations (spectral_densities.py:279-306,
calculate-relaxations-from-Ct.py:424-454).  Both formats are reproduced
bit-compatibly so either tool can read the other's files.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core import geometry


def _pt_to_xyz(pt) -> np.ndarray:
    return geometry.pt_to_xyz(torch.as_tensor(np.asarray(pt))).numpy()


def save_phitheta(fn: str, names, phithetas: np.ndarray):
    """Save raw (phi, theta) samples: data (nRes, nSamples, 2)."""
    np.savez_compressed(
        fn,
        names=np.asarray(names),
        dataType="PhiTheta",
        axisLabels=["phi", "theta"],
        bHistogram=False,
        data=np.asarray(phithetas),
    )


def save_histogram(fn: str, names, hist: np.ndarray, edges_phi, edges_cos):
    """Save Lambert-cylindrical histograms: hist (nRes, nPhi, nCos)."""
    edges = np.empty(2, dtype=object)
    edges[0] = np.asarray(edges_phi)
    edges[1] = np.asarray(edges_cos)
    np.savez_compressed(
        fn,
        names=np.asarray(names),
        dataType="LambertCylindrical",
        bHistogram=True,
        edges=edges,
        axisLabels=["phi", "cos(theta)"],
        data=np.asarray(hist),
    )


def load_vector_distribution(fn: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Load a vector distribution -> (names, vecs (nRes, nSamp, 3),
    weights (nRes, nSamp) or None), mirroring
    read_vector_distribution_from_file
    (calculate-relaxations-from-Ct.py:424-454).

    Accepts the npz formats (PhiTheta samples / Lambert histogram) AND
    the TextPhiTheta ``.dat`` xvg blocks the text writers emit — so a
    ``-vecstorage TextPhiTheta`` workflow round-trips through run-all
    without crashing on np.load of a text file."""
    if not fn.endswith((".npz", ".npy")):
        from . import xvg

        legs, phis, thetas, _ = xvg.load_sxydylist(fn, "legend")
        pt = np.stack(
            [np.asarray(phis, dtype=np.float64),
             np.asarray(thetas, dtype=np.float64)], axis=-1
        )
        return np.asarray(legs), _pt_to_xyz(pt), None
    obj = np.load(fn, allow_pickle=True)
    if not isinstance(obj, np.lib.npyio.NpzFile):
        # A bare .npy array would crash below with a cryptic IndexError
        # on obj["names"]; no writer in this package produces one.
        raise ValueError(
            f"{fn!r} is a bare .npy array, not a vector-distribution npz "
            "(PhiTheta / LambertCylindrical)"
        )
    names = obj["names"]
    if obj["bHistogram"]:
        if str(obj["dataType"]) != "LambertCylindrical":
            raise ValueError(f"unsupported histogram projection: {obj['dataType']}")
        edges = obj["edges"]
        vecs, weights = geometry.lambert_hist_to_vecs(
            torch.as_tensor(obj["data"]),
            *(torch.as_tensor(np.asarray(e, dtype=np.float64)) for e in edges[:2]))
        return names, vecs.numpy().copy(), weights.numpy()
    if str(obj["dataType"]) != "PhiTheta":
        raise ValueError(f"unsupported npz datatype: {obj['dataType']}")
    return names, _pt_to_xyz(obj["data"]), None


class PhiThetaStreamWriter:
    """Constant-memory writer for per-frame (phi, theta) vector samples.

    The on-disk formats (save_phitheta npz / TextPhiTheta .dat,
    calculate-Ct-from-traj.py:330-356) are residue-major, but a streaming
    trajectory pass produces frame-major chunks.  Chunks of shape
    (nFrames, nRes, 2) are appended to a raw temp file; close() performs
    the transpose residue-by-residue through memmaps and assembles the
    final artefact without ever materialising the full array in RAM.
    """

    def __init__(self, fn: str, names, fmt: str = "npz"):
        if fmt not in ("npz", "text"):
            raise ValueError(f"unknown PhiTheta format {fmt!r}")
        self.fn, self.names, self.fmt = fn, list(names), fmt
        self._tmp = fn + ".stream.tmp"
        self._fh = open(self._tmp, "wb")
        self._n = 0

    def append(self, pt: np.ndarray):
        """pt: (nFrames, nRes, 2) float array for one chunk."""
        pt = np.ascontiguousarray(pt, dtype=np.float64)
        if pt.ndim != 3 or pt.shape[1] != len(self.names) or pt.shape[2] != 2:
            raise ValueError(f"bad chunk shape {pt.shape}")
        pt.tofile(self._fh)
        self._n += pt.shape[0]

    def abort(self) -> None:
        """Remove the temp file after the PRODUCING stage failed before
        close() (close() cleans up after its own failures).  Idempotent;
        also invoked best-effort from __del__ so an exception between
        __init__ and close() does not leave the multi-GB temp behind
        (bounded to one file — the fixed name truncates on reuse)."""
        import os

        try:
            if not self._fh.closed:
                self._fh.close()
        except Exception:
            pass
        if os.path.exists(self._tmp):
            try:
                os.remove(self._tmp)
            except OSError:
                pass

    def __del__(self):
        try:
            self.abort()
        except Exception:
            pass

    def close(self):
        import os
        import zipfile
        import io as _io

        self._fh.close()
        n_res = len(self.names)
        datafile = self.fn + ".data.npy"
        try:
            if self._n == 0:
                raise ValueError(
                    f"no vector frames were streamed into {self.fn!r} "
                    "(empty trajectory or selection?)"
                )
            # memmap inside the try so the temp file is removed even when
            # it (or the zip assembly below) fails.
            src = np.memmap(
                self._tmp, dtype=np.float64, mode="r",
                shape=(self._n, n_res, 2),
            )
            # Frame-chunked transpose into a residue-major memmap, for
            # BOTH formats: whole-column reads (src[:, i]) touch ~one
            # page per frame once the temp file exceeds the page cache
            # (~n_res x read amplification — the text branch used to pay
            # exactly that).  Reading sequential frame blocks and writing
            # contiguous out[i, s:e] slices keeps total I/O at
            # O(file size).
            out = np.lib.format.open_memmap(
                datafile, mode="w+", dtype=np.float64, shape=(n_res, self._n, 2)
            )
            chunk = max(1, (64 << 20) // max(n_res * 16, 1))
            for s in range(0, self._n, chunk):
                e = min(self._n, s + chunk)
                block = np.array(src[s:e])  # (e-s, nRes, 2) sequential
                for i in range(n_res):
                    out[i, s:e] = block[:, i, :]
            out.flush()
            if self.fmt == "npz":
                del out
                meta = {
                    "names": np.asarray(self.names),
                    "dataType": np.asarray("PhiTheta"),
                    "axisLabels": np.asarray(["phi", "theta"]),
                    "bHistogram": np.asarray(False),
                }
                with zipfile.ZipFile(self.fn, "w", zipfile.ZIP_DEFLATED) as z:
                    for k, v in meta.items():
                        buf = _io.BytesIO()
                        np.save(buf, v)
                        z.writestr(k + ".npy", buf.getvalue())
                    z.write(datafile, "data.npy")  # streamed from disk
            else:
                with open(self.fn, "w") as fp:
                    for i, rid in enumerate(self.names):
                        print('@s%d legend "%s"' % (i, rid), file=fp)
                        col = np.asarray(out[i])  # contiguous (n, 2) read
                        for j in range(col.shape[0]):
                            print("%g %g" % (col[j, 0], col[j, 1]), file=fp)
                        print("&", file=fp)
                del out
            del src
        finally:
            for leftover in (self._tmp, datafile):
                if os.path.exists(leftover):
                    try:
                        os.remove(leftover)
                    except OSError:
                        pass
