"""graftlint baseline: the allowlist of accepted violations.

A baseline entry suppresses matching violations — it is how a genuinely
wall-clock-only site (process uptime, the CLI serve deadline) coexists
with the clock rule. Every entry must carry a non-empty ``reason``
(``--check`` fails otherwise: an allowlist nobody can audit is worse
than none), and every entry must still match at least one live
violation (a stale entry means the violation was fixed — delete the
entry, don't let the allowlist rot).

Matching is identity-based, not line-based: ``(rule, file, call[,
context])`` — line numbers churn on every edit; the thing being allowed
does not. An entry that omits ``context`` matches the call anywhere in
the file (one entry covers the three serve-deadline sites in cli.py).

Format (karpenter_provider_aws_tpu_torch/tools/lint/baseline.json):

    {"version": 1,
     "entries": [{"rule": "clock-discipline",
                  "file": "karpenter_provider_aws_tpu_torch/cli.py",
                  "call": "time.monotonic",
                  "reason": "why this is allowed"}]}
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

from .rules import Violation

VERSION = 1


def load(path) -> List[Dict]:
    p = Path(path)
    if not p.exists():
        return []
    doc = json.loads(p.read_text())
    if doc.get("version") != VERSION:
        raise ValueError(f"{path}: unsupported baseline version "
                         f"{doc.get('version')!r} (want {VERSION})")
    entries = doc.get("entries", [])
    for e in entries:
        for k in ("rule", "file"):
            if not e.get(k):
                raise ValueError(f"{path}: baseline entry missing {k!r}: {e}")
    return entries


def save(path, entries: List[Dict]) -> None:
    doc = {"version": VERSION,
           "entries": sorted(entries, key=lambda e: (
               e["rule"], e["file"], e.get("call", ""),
               e.get("context", "")))}
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def entry_matches(entry: Dict, v: Violation) -> bool:
    if entry["rule"] != v.rule or entry["file"] != v.file:
        return False
    if entry.get("call") not in (None, v.call):
        return False
    if entry.get("context") not in (None, v.context):
        return False
    return True


def apply(violations: List[Violation], entries: List[Dict]
          ) -> Tuple[List[Violation], List[Dict], List[Dict]]:
    """Partition into (unbaselined violations, used entries, stale
    entries). An entry may cover many violations; a violation is
    suppressed by the first entry that matches it."""
    used: List[Dict] = []
    used_ids = set()
    unbaselined: List[Violation] = []
    for v in violations:
        for e in entries:
            if entry_matches(e, v):
                if id(e) not in used_ids:
                    used_ids.add(id(e))
                    used.append(e)
                break
        else:
            unbaselined.append(v)
    stale = [e for e in entries if id(e) not in used_ids]
    return unbaselined, used, stale


def problems(entries: List[Dict], stale: List[Dict]) -> List[str]:
    """--check failures that come from the baseline itself."""
    out = []
    for e in entries:
        if not str(e.get("reason", "")).strip():
            out.append(f"baseline entry {e.get('rule')}:{e.get('file')}"
                       f":{e.get('call', '*')} has no reason — every "
                       "allowlisted violation must say why")
    for e in stale:
        out.append(f"stale baseline entry {e.get('rule')}:{e.get('file')}"
                   f":{e.get('call', '*')} matches no current violation "
                   "— delete it (the violation was fixed)")
    return out
