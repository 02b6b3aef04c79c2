"""Content-hashed stage resume.

The reference resumes purely on output-file existence
(run-all.bash:322-364 etc.), which silently reuses stale artefacts when
inputs change.  This adds an opt-in manifest: each stage records the
sha256 of its inputs next to its outputs; a stage is skipped only when
outputs exist AND the recorded input set + hashes + parameters still
match (SURVEY §5's "artefact-snapshot semantics around one jitted
pipeline, content-hashed inputs").

Port of ``spinrelax_tpu/pipeline/manifest.py``: the same JSON at the same
path (``<out_prefix>.manifest.json``), so either package resumes over the
other's artefacts.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Sequence

# (path, size, mtime_ns) -> digest: avoids re-reading multi-GB
# trajectories when stage_is_current and record_stage hash the same
# unchanged file within (or across) invocations.
_DIGEST_CACHE: Dict[tuple, str] = {}


def _hash_file(path: str, block: int = 1 << 20) -> str:
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    hit = _DIGEST_CACHE.get(key)
    if hit is not None:
        return hit
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        while True:
            b = fp.read(block)
            if not b:
                break
            h.update(b)
    digest = h.hexdigest()
    _DIGEST_CACHE[key] = digest
    return digest


def _manifest_path(out_prefix: str) -> str:
    return out_prefix + ".manifest.json"


def stage_is_current(
    out_prefix: str,
    stage: str,
    inputs: Sequence[str],
    outputs: Sequence[str],
    params: Dict = None,
) -> bool:
    """True iff every output exists and the manifest's recorded input
    SET, hashes, and parameters match the current state."""
    if not all(os.path.exists(o) for o in outputs):
        return False
    mf = _manifest_path(out_prefix)
    if not os.path.exists(mf):
        # No manifest: fall back to the reference's existence semantics.
        return True
    try:
        with open(mf) as fp:
            data = json.load(fp)
    except Exception:
        # A manifest that EXISTS but cannot be parsed (disk error, hand
        # edit) must not silently bless possibly-stale artefacts — one
        # spurious re-run is strictly safer than stale reuse, which is
        # the exact failure this module exists to prevent.
        return False
    rec = data.get(stage)
    if rec is None:
        return True
    if params is not None and rec.get("params") != _jsonify(params):
        return False
    recorded = rec.get("inputs", {})
    # An input added since the record (e.g. a new replica folder) must
    # invalidate the stage, not just changes to previously seen files.
    current = {p for p in inputs if os.path.exists(p)}
    if current != set(recorded):
        return False
    for path, digest in recorded.items():
        if not os.path.exists(path) or _hash_file(path) != digest:
            return False
    return True


def record_stage(
    out_prefix: str,
    stage: str,
    inputs: Sequence[str],
    params: Dict = None,
):
    mf = _manifest_path(out_prefix)
    data = {}
    if os.path.exists(mf):
        try:
            with open(mf) as fp:
                data = json.load(fp)
        except Exception:
            data = {}
    data[stage] = {
        "inputs": {p: _hash_file(p) for p in inputs if os.path.exists(p)},
        "params": _jsonify(params or {}),
    }
    # Atomic replace: a crash mid-write must not leave a truncated
    # manifest (stage_is_current treats an unparseable manifest as
    # stale and forces a spurious full re-run of every stage).
    tmp = mf + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(data, fp, indent=1, sort_keys=True)
    os.replace(tmp, mf)


def _jsonify(params: Dict):
    """JSON-ROUND-TRIPPED params: tuples become lists, KEYS become
    strings, etc., so the result compares equal against what json.load
    returns from the manifest (a stored tuple or an int key would
    otherwise mismatch forever -> permanent silent cache miss; mixed-type
    keys would crash json.dump(sort_keys=True))."""
    out = {}
    for k, v in params.items():
        try:
            out[str(k)] = json.loads(json.dumps(v))
        except TypeError:
            out[str(k)] = repr(v)
    return out
