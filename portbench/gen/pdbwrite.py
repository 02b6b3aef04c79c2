"""The benchmark's PDB writer: the port's fixed-column ATOM format
(``io/pdb.write_pdb``), frozen here so the inputs do not move with the
program.  :func:`as_read` gives the coordinates a reader gets back."""

from __future__ import annotations

import numpy as np


def write_pdb(fn: str, atom_names, res_names, res_seqs, chain_ids, occupancies, elements,
              xyz_nm: np.ndarray) -> None:
    """One model, (nAtoms, 3) nm coordinates."""
    with open(fn, "w") as fp:
        for i in range(len(atom_names)):
            x, y, z = np.asarray(xyz_nm[i], dtype=np.float64) * 10.0
            name = atom_names[i]
            pname = f" {name:<3s}" if len(name) < 4 else name
            print("ATOM  %5d %4s %-4s%1s%4d    %8.3f%8.3f%8.3f%6.2f%6.2f          %2s"
                  % (i + 1, pname, res_names[i][:4], chain_ids[i] or "A", res_seqs[i],
                     x, y, z, occupancies[i], 0.0, elements[i]), file=fp)
        print("END", file=fp)


def as_read(xyz_nm: np.ndarray) -> np.ndarray:
    """The coordinates in nm as the file holds them: Angstrom to 3 decimals."""
    a = np.asarray(xyz_nm, dtype=np.float64) * 10.0
    return np.array([float("%.3f" % v) for v in a.ravel()]).reshape(a.shape) / 10.0
