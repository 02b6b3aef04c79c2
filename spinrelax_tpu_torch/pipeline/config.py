"""Unified typed configuration for the workflow and its stages.

The reference's configuration is two disjoint levels of string flags —
~30 bash options in run-all.bash:118-267 re-parsed into per-script
argparse flags (SURVEY §5 "config/flag system") — with physical defaults
buried as code constants.  Here ONE set of frozen dataclasses is the
single source of truth for both levels:

- :class:`WorkflowConfig` (composed of :class:`IOParams`,
  :class:`TumblingParams`, :class:`PhysicsParams`,
  :class:`ExperimentParams`) drives ``run_workflow`` — the typed,
  importable equivalent of the run-all CLI.
- The CLI layer (``runall.main``) is a thin argparse shim whose flag
  names/defaults are GENERATED from these dataclasses via
  ``add_workflow_args`` — a flag cannot drift from the config field it
  fills.
- Stage functions (pipeline/stages.py) take keyword arguments drawn
  from the same fields; ``WorkflowConfig`` carries everything a stage
  needs, so library users skip strings entirely:

      cfg = WorkflowConfig(io=IOParams(outpref="run1"), ...)
      run_workflow(cfg)

Port of ``spinrelax_tpu/pipeline/config.py``: the same flags, fields and
defaults.  ``devices`` > 0 runs the sharded stream and fits over a mesh of
that many processes, one per device (``run_workflow``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..constants import DEFAULT_ZETA

VEC_STORAGE_CHOICES = ("Histogram", "PhiTheta", "TextPhiTheta")


@dataclass(frozen=True)
class IOParams:
    """File layout: where inputs live and what artefacts are called."""

    outpref: str = "rotdif"
    folders_file: Optional[str] = None  # file listing replica folders
    traj: str = "solute.npz"  # per-folder solute trajectory (npz/pdb/xtc)
    refpdb: str = "reference.pdb"
    qfile: str = "colvar-qorient"
    vec_storage: str = "Histogram"
    stream_groups: int = 0  # >0: constant-memory C(t) stage group size
    devices: int = 0  # >0: shard the streamed C(t) over an n-device mesh

    def __post_init__(self):
        if self.vec_storage not in VEC_STORAGE_CHOICES:
            raise ValueError(
                f"vec_storage must be one of {VEC_STORAGE_CHOICES}, "
                f"got {self.vec_storage!r}"
            )


@dataclass(frozen=True)
class TumblingParams:
    """Global rotational diffusion stage (dq) + external overrides."""

    tau_mem: float = 10000.0  # memory time [ps]; lag grid = tau/100
    num_chunks: int = 4
    d_ext: Optional[Tuple[float, ...]] = None  # Diso [aniso [rhomb]] ps^-1
    tau_ext: Optional[float] = None  # external tau_iso [ps]
    q_ext: Optional[Tuple[float, float, float, float]] = None


@dataclass(frozen=True)
class PhysicsParams:
    """Physical constants/selections shared by every stage (the values
    the reference hides as code defaults, SURVEY §5)."""

    zeta: float = DEFAULT_ZETA  # (1.02/1.04)^6 QM zero-point correction
    csa_file: Optional[str] = None
    fit_atoms: str = "occupancy > 0"
    temp_md: float = 300.0
    temp_exp: float = 297.0
    d2o_exp: float = 0.09


@dataclass(frozen=True)
class ExperimentParams:
    """Prediction/fit targets."""

    bfields_mhz: Tuple[float, ...] = (600.133,)
    fit_modes: Optional[Tuple[str, ...]] = None  # e.g. ("Diso", "Diso,rsCSA")
    exp_files: Optional[Tuple[str, ...]] = None
    do_jomega: bool = False


@dataclass(frozen=True)
class WorkflowConfig:
    """The full run-all configuration — one typed object, both levels."""

    io: IOParams = field(default_factory=IOParams)
    tumbling: TumblingParams = field(default_factory=TumblingParams)
    physics: PhysicsParams = field(default_factory=PhysicsParams)
    experiments: ExperimentParams = field(default_factory=ExperimentParams)
    force: bool = False

    def validate(self) -> "WorkflowConfig":
        if self.experiments.fit_modes and not self.experiments.exp_files:
            raise ValueError(
                "fit modes selected, but no experimental file has been given"
            )
        if (
            self.io.devices > 0
            and self.io.stream_groups <= 0
            and not self.experiments.fit_modes
        ):
            raise ValueError(
                "-devices shards the streamed C(t) stage and/or the "
                "multi-field fits: it requires -stream GROUPS or -fit MODE"
            )
        return self


# ---------------------------------------------------------------------------
# argparse bridge: flags are generated from the dataclass fields so the
# CLI cannot drift from the typed config.
# ---------------------------------------------------------------------------

# (flag, aliases, section, field, kwargs-overrides)
_FLAG_TABLE = [
    ("-out", ("--outpref",), "io", "outpref", {}),
    ("-folders", (), "io", "folders_file", {"help": "file listing replica folders"}),
    ("-sxtc", (), "io", "traj", {"help": "solute trajectory per folder (npz/pdb/xtc)"}),
    ("-refpdb", (), "io", "refpdb", {}),
    ("-qfile", (), "io", "qfile", {}),
    ("-vecstorage", (), "io", "vec_storage", {"choices": VEC_STORAGE_CHOICES}),
    ("-stream", (), "io", "stream_groups", {
        "type": int, "metavar": "GROUPS",
        "help": "constant-memory C(t) stage: stream trajectories in "
                "GROUPS Palmer chunks per device step "
                "(supports all -vecstorage modes)"}),
    ("-devices", (), "io", "devices", {
        "type": int, "metavar": "N",
        "help": "shard the streamed C(t) accumulation (-stream) and the "
                "multi-field fits (-fit) over an N-device ('rep','res') mesh, "
                "one process per device, started by torchrun"}),
    ("-t_mem", (), "tumbling", "tau_mem", {"type": float, "help": "memory time [ps]"}),
    ("-num_chunks", (), "tumbling", "num_chunks", {"type": int}),
    ("-D_ext", (), "tumbling", "d_ext", {
        "nargs": "+", "type": float,
        "help": "external Diso [aniso [rhomb]] in ps^-1"}),
    ("-tau_ext", (), "tumbling", "tau_ext", {"type": float, "help": "external tau_iso [ps]"}),
    ("-q_ext", (), "tumbling", "q_ext", {"nargs": 4, "type": float}),
    ("-zeta", (), "physics", "zeta", {"type": float}),
    ("-csafile", (), "physics", "csa_file", {}),
    ("-fitatoms", (), "physics", "fit_atoms", {}),
    ("-Temp_MD", (), "physics", "temp_md", {"type": float}),
    ("-Temp_Exp", (), "physics", "temp_exp", {"type": float}),
    ("-D2O_Exp", (), "physics", "d2o_exp", {"type": float}),
    ("-Bfields", (), "experiments", "bfields_mhz", {"nargs": "+", "type": float, "help": "[MHz]"}),
    ("-fit", (), "experiments", "fit_modes", {
        "nargs": "+", "help": "optimisation modes, e.g. Diso Diso,rsCSA"}),
    ("-expfiles", (), "experiments", "exp_files", {"nargs": "+"}),
    ("-Jw", (), "experiments", "do_jomega", {"action": "store_true"}),
    ("-bForce", ("--force",), None, "force", {"action": "store_true"}),
]

_SECTIONS = {
    "io": IOParams,
    "tumbling": TumblingParams,
    "physics": PhysicsParams,
    "experiments": ExperimentParams,
}


def _default_of(section: Optional[str], name: str):
    cls = _SECTIONS[section] if section else WorkflowConfig
    for f in dataclasses.fields(cls):
        if f.name == name:
            if f.default is not dataclasses.MISSING:
                return f.default
            return f.default_factory()  # pragma: no cover
    raise KeyError(f"{cls.__name__}.{name}")


def add_workflow_args(parser) -> None:
    """Populate an ArgumentParser with run-all flags whose defaults come
    from the dataclass fields (single source of truth)."""
    for flag, aliases, section, name, kw in _FLAG_TABLE:
        kwargs = dict(kw)
        if "action" not in kwargs:
            kwargs.setdefault("default", _default_of(section, name))
        elif kwargs["action"] == "store_true":
            # store_true implies default False; if a dataclass default
            # ever becomes True the CLI would silently override it for
            # every run — hold the single-source-of-truth invariant for
            # boolean fields too.
            assert _default_of(section, name) is False, (
                f"{section or 'WorkflowConfig'}.{name} defaults True but "
                f"its flag is store_true (use BooleanOptionalAction)"
            )
        kwargs["dest"] = f"{section}__{name}" if section else name
        parser.add_argument(flag, *aliases, **kwargs)


def config_from_namespace(ns) -> WorkflowConfig:
    """argparse Namespace (from add_workflow_args) -> WorkflowConfig."""
    by_section = {k: {} for k in _SECTIONS}
    top = {}
    for flag, aliases, section, name, kw in _FLAG_TABLE:
        dest = f"{section}__{name}" if section else name
        val = getattr(ns, dest)
        if isinstance(val, list):
            val = tuple(val)
        if section:
            by_section[section][name] = val
        else:
            top[name] = val
    return WorkflowConfig(
        io=IOParams(**by_section["io"]),
        tumbling=TumblingParams(**by_section["tumbling"]),
        physics=PhysicsParams(**by_section["physics"]),
        experiments=ExperimentParams(**by_section["experiments"]),
        **top,
    ).validate()
