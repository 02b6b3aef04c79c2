"""BMRB entry -> experiment-file converter
(parse-relaxations-from-BMRB-entry.py equivalent).

Pulls heteronuclear T1/R1, T2/R2 and NOE save-frames from a BMRB
NMR-STAR file, converts time constants [s] to rates [s^-1], and writes
the header-annotated experiment files consumed by ``spinrelax
multifield``.

Unlike the reference (which hard-requires the pynmrstar package), local
files are parsed with the built-in NMR-STAR reader (io/nmrstar.py);
pynmrstar is only needed for fetching entries from the BMRB API by
accession number.

The port's copy of ``spinrelax_tpu/io/bmrb.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np

from . import nmrstar
from .experiments import ExperimentData, write_experiment

_CATEGORIES = {
    "heteronucl_T1_relaxation": "R1",
    "heteronucl_T2_relaxation": "R2",
    "heteronucl_NOEs": "NOE",
}


def _first(values, default=None):
    if values is None:
        return default
    for v in values:
        if v not in (".", "?", None, ""):
            return v
    return default


def _loop_for(sf: nmrstar.SaveFrame, expt_type: str):
    """Pick the data loop holding Val/Val_err columns."""
    for loop in sf.loops:
        if loop.get_tag("Val") is not None or loop.get_tag(f"{expt_type}_val") is not None \
           or loop.get_tag("T1_val") is not None or loop.get_tag("T2_val") is not None:
            return loop
    return sf.loops[-1] if sf.loops else None


def _values_and_errors(loop: nmrstar.Loop, expt_type: str):
    for base in ("Val", f"{expt_type}_val", "T1_val", "T2_val"):
        vals = loop.get_tag(base)
        if vals is not None:
            errs = loop.get_tag(base + "_err")
            return vals, errs
    return None, None


# Reference get_isotopes element->isotope fallback
# (parse-relaxations-from-BMRB-entry.py:86-99).
_ISO_BY_ELEMENT = {"H": "1", "C": "13", "N": "15", "O": "17"}


def _isotopes_from_loop(loop: nmrstar.Loop) -> List[str]:
    """Suffix-aware isotope labels, matching the reference's startswith
    tag scan (get_isotopes, parse-relaxations-from-BMRB-entry.py:76-105):
    NOE loops carry Atom_type_1/Atom_type_2 etc., and a null isotope
    number is guessed from the element (13C, 15N, ...) rather than
    hard-coded to 15."""
    import re as _re

    def _suffixes(prefix):
        # 'Atom_type' / 'Atom_type_1' / ... — not 'Atom_type_details'.
        return {
            t[len(prefix):]: t
            for t in loop.tags
            if t.startswith(prefix) and _re.fullmatch(r"(_\d+)?", t[len(prefix):])
        }

    # Pair isotope and element columns BY SUFFIX: a loop that carries
    # Atom_type_1 but no Atom_isotope_number column at all must still
    # use the element fallback (zip over the two tag lists silently
    # returned [] there, defaulting everything to 15N — wrong physics
    # for a 13C experiment).
    iso_by_suffix = _suffixes("Atom_isotope_number")
    out = []
    for suf, et in sorted(_suffixes("Atom_type").items()):
        el = _first(loop.get_tag(et))
        if el is None:
            continue
        it = iso_by_suffix.get(suf)
        num = _first(loop.get_tag(it)) if it is not None else None
        if num is None:
            num = _ISO_BY_ELEMENT.get(el)
            if num is None:
                raise ValueError(
                    f"unsupported atom type {el!r} in relaxation loop "
                    "(expected H/C/N/O)"
                )
        out.append(f"{num}{el}")
    return out


def parse_bmrb_entry(entry: nmrstar.Entry, out_prefix: str = "expt") -> List[str]:
    written: List[str] = []
    count = 0
    for cat, expt_type in _CATEGORIES.items():
        for sf in entry.frames_by_category(cat):
            freq = _first([sf.get_tag("Spectrometer_frequency_1H")])
            if freq is None:
                # The reference fails loudly on a missing frequency
                # (KeyError at :149); a fabricated default would silently
                # compute every observable at the wrong field.  Raise —
                # not sys.exit — so programmatic callers can catch it
                # (main() converts it to the loud CLI exit below).
                raise ValueError(
                    "save-frame %r has no Spectrometer_frequency_1H tag"
                    % sf.name
                )
            loop = _loop_for(sf, expt_type)
            if loop is None:
                continue
            vals, errs = _values_and_errors(loop, expt_type)
            if vals is None:
                continue
            resid = loop.get_tag("Comp_index_ID") or loop.get_tag("Comp_index_ID_1")
            if resid is None:
                continue
            isotopes = _isotopes_from_loop(loop)
            # Convention: second nucleus is 1H (reference :172-175).
            if len(isotopes) > 1 and isotopes[0] == "1H":
                isotopes = [isotopes[1], isotopes[0]]
            nuclei_a = isotopes[0] if isotopes else "15N"

            keep = [
                i for i, v in enumerate(vals) if v not in (".", "?", "")
            ]
            values = np.array([float(vals[i]) for i in keep])
            if errs is not None and all(
                errs[i] not in (".", "?", "") for i in keep
            ):
                errors = np.array([float(errs[i]) for i in keep])
            else:
                # All-or-none: a null Val_err must not become sigma=0
                # (downstream chi-squares divide by error^2).
                errors = None
            names = np.array([str(resid[i]) for i in keep])

            # Units: T1/T2 in seconds -> rates (reference :164-168; the
            # reference only converts 's' — 'ms' handling is an
            # extension, with errors taken to seconds first so the
            # err_R = R * err_T convention stays consistent).
            unit = None
            if expt_type != "NOE":
                unit = sf.get_tag(f"T{expt_type[-1]}_val_units") or sf.get_tag("Val_units")
                if unit == "s":
                    rates = 1.0 / values
                    if errors is not None:
                        errors = rates * errors
                    values = rates
                elif unit in ("ms",):
                    rates = 1000.0 / values
                    if errors is not None:
                        errors = rates * (errors / 1000.0)
                    values = rates

            count += 1
            # Reference filename scheme (:193): prefix_type_freq_<frame
            # ID>_<sample condition list ID>.dat, so frames sharing
            # type+freq stay distinguishable.
            expt_id = _first([sf.get_tag("ID")], str(count))
            cond_id = _first([sf.get_tag("Sample_condition_list_ID")], "1")
            fn = "%s_%s_%s_%s_%s.dat" % (
                out_prefix, expt_type, freq, expt_id, cond_id,
            )
            write_experiment(
                fn,
                ExperimentData(
                    expt_type=expt_type,
                    nuclei_a=nuclei_a,
                    nuclei_b="1H",
                    frequency=float(freq),
                    freq_unit="MHz",
                    names=names,
                    values=values,
                    errors=errors,
                ),
            )
            written.append(fn)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="spinrelax bmrb",
        description="Convert BMRB relaxation save-frames to experiment files.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-i", "--id", default=None, help="BMRB accession number (needs pynmrstar + network)")
    p.add_argument("-f", "--infn", default=None, help="local NMR-STAR file")
    p.add_argument("-o", "--outpref", default="expt")
    a = p.parse_args(argv)
    if a.infn:
        entry = nmrstar.parse_file(a.infn)
    elif a.id:
        try:
            from pynmrstar import Entry as PyEntry
        except ImportError:
            sys.exit(
                "= = = ERROR: fetching by accession number requires the "
                "optional pynmrstar package; pass a local file with -f instead"
            )
        raw = str(PyEntry.from_database(a.id))
        entry = nmrstar.parse(raw)
    else:
        sys.exit("= = = ERROR: give either --id or --infn")
    try:
        files = parse_bmrb_entry(entry, a.outpref)
    except ValueError as e:
        sys.exit("= = = ERROR: %s" % e)
    print("= = Finished. %i files written:" % len(files))
    for f in files:
        print("    %s" % f)


if __name__ == "__main__":
    main()
