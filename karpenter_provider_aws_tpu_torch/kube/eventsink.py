"""Mirror recorder events into the apiserver as ``events`` objects.

The reference's controllers publish Kubernetes Events through the
manager's recorder (pkg/controllers/interruption/events/events.go,
pkg/cloudprovider/events) and the documented debugging flow is
``kubectl get events``. In API mode this sink gives the same surface:
every `events.Recorder.publish` also creates an object of kind
``events`` in the apiserver, so ``kpctl get events`` (and the REST
``/apis/events`` route, including watches) see the stream a real
cluster would.

Retention is the sink's job, like an apiserver's event TTL: only the
newest EVENTS_RETAINED events are kept; older ones are deleted as new
ones arrive, so a chatty controller can never grow the store without
bound. The sink periodically re-lists the store (RELIST_EVERY) and
re-adopts every name it finds, so events written by OTHER actors age
out under the same ceiling instead of accumulating untracked. The
in-memory recorder ring (events.MAX_EVENTS) is unaffected — tests and
the direct stratum keep reading that.
"""

from __future__ import annotations

import itertools
from collections import deque

from .apiserver import AlreadyExistsError, FakeAPIServer, NotFoundError

EVENTS_RETAINED = 1000
# every this-many creates the sink re-lists the store and re-adopts ALL
# event names, so events written by OTHER actors (a second operator, a
# test harness, kpctl apply) age out too instead of growing the store
# unboundedly between restarts
RELIST_EVERY = 256


class ApiEventSink:
    """``Recorder.sink`` implementation writing through an apiserver.

    Called under the recorder's lock, so creates are ordered exactly as
    published. Event names are sequential (``ev-000001``); against a
    pre-populated server the counter skips forward past collisions so a
    restarted operator keeps appending rather than failing.
    """

    def __init__(self, api: FakeAPIServer, retained: int = EVENTS_RETAINED,
                 relist_every: int = RELIST_EVERY):
        self._api = api
        self._retained = retained
        self._relist_every = relist_every
        # adopt whatever a prior run left behind: retention must cover
        # the WHOLE store, not just this instance's writes, and the
        # counter resumes past the newest adopted name so appends rarely
        # collide (the create loop still handles races). Order and resume
        # NUMERICALLY — lexicographic order breaks past ev-999999 (a
        # 7-digit name sorts before 6-digit ones), which would age out
        # the newest events and re-issue taken names after a restart.
        self._since_relist = 0
        numbered = self._adopt()
        start = numbered[-1][0] + 1 if numbered else 1
        self._seq = itertools.count(max(start, 1))

    @staticmethod
    def _numbered(objs):
        numbered = []
        for o in objs:
            name = o["metadata"]["name"]
            tail = name.rsplit("-", 1)[-1]
            numbered.append((int(tail) if tail.isdigit() else -1, name))
        numbered.sort()
        return numbered

    def _adopt(self):
        """Re-list the store and track EVERY event name, oldest first, so
        retention covers externally-written events too. Returns the
        numerically-sorted (seq, name) list."""
        existing, _ = self._api.list("events")
        numbered = self._numbered(existing)
        self._names: deque = deque(n for _, n in numbered)
        return numbered

    def __call__(self, event) -> None:
        spec = {
            "name": "",   # filled per attempt below
            "time": event.time,
            "type": event.type,
            "reason": event.reason,
            "objectKind": event.object_kind,
            "objectName": event.object_name,
            "message": event.message,
        }
        while True:
            spec["name"] = f"ev-{next(self._seq):06d}"
            try:
                self._api.create("events", spec)
                break
            except AlreadyExistsError:
                continue
        self._names.append(spec["name"])
        # periodic re-adopt: names created by actors other than this sink
        # would otherwise stay untracked forever and grow the store past
        # EVENTS_RETAINED; the counter never rewinds (create collisions
        # keep skipping forward), only the tracked-name set refreshes
        self._since_relist += 1
        if self._since_relist >= self._relist_every:
            self._since_relist = 0
            self._adopt()
        while len(self._names) > self._retained:
            try:
                self._api.delete("events", self._names.popleft())
            except NotFoundError:
                pass   # someone else aged it out — retention still holds
