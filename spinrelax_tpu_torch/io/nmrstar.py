"""Minimal NMR-STAR (STAR v2/3) parser — enough to read BMRB relaxation
entries without the optional pynmrstar dependency.

Handles: save-frames, free tags (``_Category.Tag value``), multi-line
semicolon values, loops (``loop_`` ... ``stop_``) with quoted tokens, and
null values ('.'/'?').

The port's copy of ``spinrelax_tpu/io/nmrstar.py`` (host-side numpy; the same bytes).
"""

from __future__ import annotations

import dataclasses
import re
import shlex
from typing import Dict, List, Optional

from .zopen import topen


@dataclasses.dataclass
class Loop:
    category: str
    tags: List[str]  # tag names without the _Category. prefix
    rows: List[List[str]]

    def get_tag(self, name: str) -> Optional[List[str]]:
        lname = name.lower()
        for i, t in enumerate(self.tags):
            if t.lower() == lname:
                return [r[i] for r in self.rows]
        return None


@dataclasses.dataclass
class SaveFrame:
    name: str
    tags: Dict[str, str]  # 'Category.Tag' -> value
    loops: List[Loop]

    @property
    def category(self) -> Optional[str]:
        for k, v in self.tags.items():
            if k.split(".")[-1].lower() in ("sf_category", "saveframe_category"):
                return v
        return None

    def get_tag(self, name: str) -> Optional[str]:
        lname = name.lower()
        for k, v in self.tags.items():
            if k.split(".")[-1].lower() == lname:
                return v
        return None


@dataclasses.dataclass
class Entry:
    saveframes: List[SaveFrame]

    def frames_by_category(self, category: str) -> List[SaveFrame]:
        return [
            sf for sf in self.saveframes
            if (sf.category or "").lower() == category.lower()
        ]


def _tokenize(line: str) -> List[str]:
    """Whitespace tokens honouring single/double quotes."""
    out = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n:
            break
        if line[i] in "'\"":
            q = line[i]
            j = i + 1
            while j < n and not (line[j] == q and (j + 1 == n or line[j + 1].isspace())):
                j += 1
            out.append(line[i + 1 : j])
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            out.append(line[i:j])
            i = j
    return out


def parse(text: str) -> Entry:
    lines = text.splitlines()
    i = 0
    saveframes: List[SaveFrame] = []
    cur: Optional[SaveFrame] = None

    def read_semicolon_value(start):
        """lines[start] begins with ';' — read until closing ';' line."""
        vals = []
        j = start + 1
        while j < len(lines) and not lines[j].startswith(";"):
            vals.append(lines[j])
            j += 1
        return "\n".join(vals), j + 1

    n = len(lines)
    while i < n:
        raw = lines[i]
        line = raw.strip()
        if not line or line.startswith("#"):
            i += 1
            continue
        if line.startswith("save_") and len(line) > 5:
            cur = SaveFrame(name=line[5:], tags={}, loops=[])
            saveframes.append(cur)
            i += 1
            continue
        if line == "save_":
            cur = None
            i += 1
            continue
        if line.startswith("loop_"):
            tags = []
            cat = ""
            i += 1
            while i < n:
                t = lines[i].strip()
                if t.startswith("_"):
                    full = t.split()[0]
                    if "." in full:
                        cat, tag = full[1:].split(".", 1)
                    else:
                        cat, tag = "", full[1:]
                    tags.append(tag)
                    i += 1
                elif not t or t.startswith("#"):
                    i += 1
                else:
                    break
            if not tags:
                # A 'loop_' with no _tags would make the drain loop below
                # spin forever on the first data token (len(pending) >= 0
                # is always true) — fail the parse instead.
                raise ValueError(
                    f"malformed NMR-STAR: loop_ at line {i} has no tags"
                )
            rows: List[List[str]] = []
            pending: List[str] = []
            while i < n:
                t = lines[i].strip()
                if t == "stop_":
                    i += 1
                    break
                if not t or t.startswith("#"):
                    i += 1
                    continue
                if t.startswith(";"):
                    val, i = read_semicolon_value(i)
                    pending.append(val)
                else:
                    pending.extend(_tokenize(lines[i]))
                    i += 1
                while len(pending) >= len(tags):
                    rows.append(pending[: len(tags)])
                    pending = pending[len(tags) :]
            loop = Loop(category=cat, tags=tags, rows=rows)
            if cur is not None:
                cur.loops.append(loop)
            continue
        if line.startswith("_"):
            parts = _tokenize(line)
            full = parts[0][1:]
            key = full if "." in full else "." + full
            if len(parts) >= 2:
                value = parts[1]
                i += 1
            else:
                # Value on following line(s), possibly semicolon-delimited.
                i += 1
                while i < n and not lines[i].strip():
                    i += 1
                if i < n and lines[i].startswith(";"):
                    value, i = read_semicolon_value(i)
                else:
                    value = lines[i].strip().strip("'\"")
                    i += 1
            if cur is not None:
                cur.tags[key] = value
            continue
        i += 1
    return Entry(saveframes)


def parse_file(fn: str) -> Entry:
    with topen(fn) as fp:
        return parse(fp.read())
