"""Reader/writer for the ``*_fittedCt.dat`` inter-stage wire format.

Format (fitting_Ct_functions.py:242-261 writer, :432-481 parser):

    # Residue: 4
    # Chi-Square: 1.2e-05
    # Param S2_fast: 0.02 +- 0.0
    # Param S2_0: 0.82 +- 0.01
    # Param C_a: 0.07 +- 0.001
    # Param tau_a: 11.6 +- 0.35
    @s0 legend "Res 4"
    <model curve>
    &
    <target curve>
    &

(Port of ``spinrelax_tpu/io/fittedct.py`` over the port's CtModelSet.)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .zopen import topen

from ..models.ctmodel import CtModelSet

GREEK = ["a", "b", "g", "d", "e", "z", "h"]


def read_fittedct(fn: str, device="cuda") -> CtModelSet:
    """Parse the # Residue / # Param header blocks into a float64
    CtModelSet on ``device`` (fitting_Ct_functions.py:432-481 semantics;
    the card unless ``device="cpu"``)."""
    names, S2s, s2fasts = [], [], []
    C_lists, tau_lists, dC_lists, dtau_lists = [], [], [], []
    dS2s, chis = [], []

    cur = None

    def flush():
        nonlocal cur
        if cur is None:
            return
        names.append(cur["name"])
        S2s.append(cur["S2"])
        dS2s.append(cur["dS2"])
        s2fasts.append(cur["s2fast"] is not None)
        keys = list(cur["C"].keys())
        C_lists.append([cur["C"][k] for k in keys])
        tau_lists.append([cur["tau"].get(k, 1.0) for k in keys])
        dC_lists.append([cur["dC"].get(k, 0.0) for k in keys])
        dtau_lists.append([cur["dtau"].get(k, 0.0) for k in keys])
        chis.append(cur["chi"])
        cur = None

    with topen(fn) as fp:
        for line in fp:
            if line.startswith("#"):
                parts = line.split()
                if len(parts) < 2:
                    continue
                if parts[1].startswith("Residue"):
                    if cur is not None:
                        # New parameter section while one is open: the
                        # reference treats this as a format error; we
                        # flush instead (curves may be omitted).
                        flush()
                    cur = dict(
                        name=str(parts[-1]), S2=None, dS2=0.0, s2fast=None,
                        C={}, tau={}, dC={}, dtau={}, chi=np.nan,
                    )
                elif parts[1].startswith("Chi") and cur is not None:
                    cur["chi"] = float(parts[-1])
                elif parts[1].startswith("Param") and cur is not None:
                    pname = parts[2].rstrip(":")
                    value = float(parts[-3]) if "+-" in line else float(parts[-1])
                    error = float(parts[-1]) if "+-" in line else 0.0
                    if pname.startswith("S2_0"):
                        cur["S2"] = value
                        cur["dS2"] = error
                    elif pname.startswith("S2_fast"):
                        cur["s2fast"] = value
                    elif pname.startswith("C_"):
                        cur["C"][pname[2]] = value
                        cur["dC"][pname[2]] = error
                    elif pname.startswith("tau_"):
                        cur["tau"][pname[4]] = value
                        cur["dtau"][pname[4]] = error
            else:
                # Any non-comment line ends the parameter section
                # (fitting_Ct_functions.py:470-478).
                if cur is not None:
                    flush()
    flush()

    return CtModelSet.from_lists(
        names=names,
        S2=S2s,
        C_list=C_lists,
        tau_list=tau_lists,
        s2fast=s2fasts,
        dS2=dS2s,
        dC_list=dC_lists,
        dtau_list=dtau_lists,
        chisq=chis,
        device=device,
    )


def write_fittedct(
    fn: str,
    cts: CtModelSet,
    dt: Optional[np.ndarray] = None,
    targets: Optional[np.ndarray] = None,
):
    """Write fittedCt format.  If ``dt``/``targets`` are given, the fitted
    model curve and the target decay are appended per residue as in
    autoCorrelations.export (fitting_Ct_functions.py:107-126)."""
    def host(a):
        return None if a is None else a.cpu().numpy()

    cts_np = {k: host(getattr(cts, k)) for k in
              ("S2", "C", "tau", "mask", "s2fast", "dS2", "dC", "dtau", "chisq")}
    s2fast_vals = host(cts.s2_fast())
    curves = None if dt is None else host(cts.eval(np.asarray(dt)))

    with topen(fn, "w") as fp:
        s = 0
        for i, name in enumerate(cts.names):
            has_fit = cts_np["chisq"] is not None and np.isfinite(cts_np["chisq"][i])
            print("# Residue: %s " % name, file=fp)
            if has_fit:
                print("# Chi-Square: %g " % cts_np["chisq"][i], file=fp)
            # Byte-parity with the reference's report(style='xmgrace')
            # for FITTED models (fitting_Ct_functions.py:244-254): the
            # non-S2fast S2_0 error is the LITERAL '+- 0.0'.  Unfitted
            # models deliberately keep the '+-' form the reference's
            # report() omits (:255-261): the reference's OWN reader
            # (read_fittedCt_parameters:453, float(l[-3])) crashes on
            # its no-'+-' style, so emitting it would break the wire
            # format for both toolchains.
            dS2 = 0.0 if cts_np["dS2"] is None else cts_np["dS2"][i]
            k_real = int(np.sum(cts_np["mask"][i]))
            if cts_np["s2fast"][i] > 0:
                print("# Param S2_fast: %g +- 0.0" % s2fast_vals[i], file=fp)
                print("# Param S2_0: %g +- %g" % (cts_np["S2"][i], dS2), file=fp)
            else:
                # Literal '0.0' ALWAYS — the reference prints the real
                # dS2 only for S2fast models (fitting_Ct_functions.py:
                # 249-251); emitting a nonzero dS2 here would break
                # byte-parity for every fitted non-S2fast model.
                print("# Param S2_0: %g +- 0.0" % cts_np["S2"][i], file=fp)
            for k in range(k_real):
                dC = 0.0 if cts_np["dC"] is None else cts_np["dC"][i, k]
                dtau = 0.0 if cts_np["dtau"] is None else cts_np["dtau"][i, k]
                print("# Param C_%s: %g +- %g" % (GREEK[k], cts_np["C"][i, k], dC), file=fp)
                print("# Param tau_%s: %g +- %g" % (GREEK[k], cts_np["tau"][i, k], dtau), file=fp)
            if curves is not None:
                print('@s%d legend "Res %s"' % (s, name), file=fp)
                for t, y in zip(np.asarray(dt), curves[i]):
                    print("%8g %8g" % (t, y), file=fp)
                print("&", file=fp)
                if targets is not None:
                    for t, y in zip(np.asarray(dt), np.asarray(targets)[i]):
                        print("%8g %8g" % (t, y), file=fp)
                    print("&", file=fp)
                # One set per residue without targets: advancing by 2
                # would attach later legends to nonexistent set indices.
                s += 2 if targets is not None else 1
            else:
                print("", file=fp)
