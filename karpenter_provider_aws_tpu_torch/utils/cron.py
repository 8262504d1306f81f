"""Minimal 5-field cron matching for disruption-budget schedules.

The reference's NodePool disruption budgets take a crontab ``schedule``
plus a ``duration``; the budget only constrains disruptions while inside
an active window (reference website concepts/disruption.md:193-222; CRD
karpenter.sh_nodepools.yaml:97-112 requires schedule and duration
together). Supported field syntax: ``*``, numbers, comma lists, ranges
(``a-b``) and steps (``*/n``, ``a-b/n``) — the subset the reference's
docs exercise (e.g. ``@ 0 9 * * 1-5`` style windows written as
``0 9 * * 1-5``). Times are UTC, like the reference.
"""

from __future__ import annotations

import time
from typing import Sequence, Set

_FIELD_RANGES = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))


def _parse_field(spec: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in spec.split(","):
        step, stepped = 1, False
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            stepped = True
            if step < 1:
                raise ValueError(f"bad cron step {step_s!r}")
        if part == "*":
            start, end = lo, hi
        elif part == "":
            # a bare empty part is a typo ('0, 0 * * *'); silently
            # expanding it to match-all would widen the window 60x
            raise ValueError("empty cron field part (stray comma?)")
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        elif stepped:
            # 'N/step' means N through max stepped (vixie/robfig
            # semantics: '0/6' in the hour field = 0,6,12,18 — and
            # '0/1' every hour, NOT just hour 0)
            start, end = int(part), hi
        else:
            start = end = int(part)
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise ValueError(f"cron field value out of range: {part!r}")
        out.update(range(start, end + 1, step))
    return out


class Cron:
    """A parsed 5-field crontab expression; ``matches(ts)`` tests a UTC
    epoch timestamp against minute/hour/dom/month/dow."""

    def __init__(self, expr: str):
        fields: Sequence[str] = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron needs 5 fields, got {expr!r}")
        self.minute, self.hour, self.dom, self.month, self.dow = (
            _parse_field(f, lo, hi)
            for f, (lo, hi) in zip(fields, _FIELD_RANGES))
        # like standard cron: when BOTH day fields are restricted the
        # match is an OR; the reference's windows use one or the other,
        # and the simple AND is what its docs' examples imply — keep AND
        # unless both are restricted, then OR (vixie-cron behavior)
        self._dom_star = fields[2] == "*"
        self._dow_star = fields[4] == "*"

    def matches(self, ts: float) -> bool:
        t = time.gmtime(ts)
        if t.tm_min not in self.minute or t.tm_hour not in self.hour \
                or t.tm_mon not in self.month:
            return False
        wday = (t.tm_wday + 1) % 7  # gmtime: Mon=0; cron: Sun=0
        dom_ok = t.tm_mday in self.dom
        dow_ok = wday in self.dow
        if self._dom_star or self._dow_star:
            return dom_ok and dow_ok
        return dom_ok or dow_ok

    def in_window(self, ts: float, duration: float) -> bool:
        """Is ``ts`` inside a window opened by a matching minute and
        lasting ``duration`` seconds? (cron fires at whole minutes; scan
        back over every minute the window could have opened at)."""
        m = int(ts) // 60 * 60
        lookback = int(max(duration, 0.0) + 59) // 60
        for k in range(lookback + 1):
            occ = m - k * 60
            if occ <= ts < occ + duration and self.matches(occ):
                return True
        return False
