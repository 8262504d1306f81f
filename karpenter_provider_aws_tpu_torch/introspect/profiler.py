"""Whole-process wall-clock sampling profiler + burn-triggered capture.

The third leg of the attribution story: traces (trace/) explain ONE
request, ``/debug/vars`` explains current state, and this profiler
explains WHERE TIME GOES over an interval — which frames the write path
burns under 15k-pod API churn, whether the watch fan-out or the solver
decode owns the p99. Zero dependencies: a daemon thread samples
``sys._current_frames()`` at ``hz`` (default 50) and folds each
thread's stack into a bounded count store; the deterministic stratum
calls ``sample_once()`` under FakeClock instead.

Exports (served at ``/debug/pprof/profile`` on both the metrics server
and the REST apiserver; ``kpctl profile`` is the CLI):

- **folded / collapsed-stack text** — ``thread;root;..;leaf N`` lines,
  the flamegraph.pl / speedscope / `pprof -flame` input format,
- **Chrome trace-event JSON** — consecutive identical samples merged
  into B/E duration events per frame (the standard samples→spans
  reconstruction), loadable in Perfetto next to an xprof device trace,
- **top frames** — inclusive/self sample counts per frame.

Cost model: one sample walks every live thread's stack (~tens of µs for
a dozen threads); at 50 Hz that is well under 1% of one core, and the
profiler measures ITSELF (``avg_sample_ms`` / ``overhead_pct`` in
``stats()``) so the <5% bound is observable, not asserted. Disabled
(the default — nothing constructs a profiler unless ``--profile`` or a
harness does): zero threads, zero allocation, zero hooks anywhere on
the hot path — pinned by tests/test_profiler.py.

``BurnCapture`` is the flight-recorder analog for profiles: when the
SLO tracker sustains burn >= 1.0 (its exactly-once-per-episode edge) or
a pass grossly exceeds the latency budget, it snapshots the profile's
top frames + the contention accounting + the device cost model into a
bounded ring keyed to the episode — the 3 a.m. degradation ships with
its own evidence (``/debug/pprof/captures``).
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..utils.clock import WALL
from . import contention

DEFAULT_HZ = 50.0
MAX_STACK_DEPTH = 48
MAX_UNIQUE_STACKS = 20_000   # bounded store: beyond this, samples count
                             # as dropped instead of growing memory
RAW_RING = 4096              # recent raw samples kept for Chrome export


def _norm_thread(name: str) -> str:
    """Bound thread-name cardinality: 'Thread-12 (run)' → 'Thread-N (run)'."""
    return "".join("N" if c.isdigit() else c for c in name)


class SamplingProfiler:
    """Aggregating wall-clock sampler over ``sys._current_frames()``.

    ``start()`` runs the daemon sampler; ``sample_once()`` serves the
    deterministic stratum (``clock`` — FakeClock — stamps the sample
    time; frame capture is real either way)."""

    def __init__(self, hz: float = DEFAULT_HZ, clock=None,
                 max_stacks: int = MAX_UNIQUE_STACKS,
                 max_depth: int = MAX_STACK_DEPTH,
                 raw_ring: int = RAW_RING):
        self.hz = max(float(hz), 0.1)
        self._clock = clock
        self.max_stacks = int(max_stacks)
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        # folded stack ("thr;root;..;leaf") -> samples
        self._counts: Dict[str, int] = {}
        # (t, thread, frames-root-first) for the Chrome reconstruction
        self._raw: Deque[Tuple[float, str, Tuple[str, ...]]] = deque(
            maxlen=int(raw_ring))
        self.samples = 0
        self.dropped_stacks = 0
        self.started_at: Optional[float] = None
        self.sample_cost_s = 0.0      # self-measured profiler overhead
        # code-object -> "file.py:func" label memo: the per-frame string
        # build dominates sample cost; code objects are stable for the
        # process lifetime, so one format each bounds the work to dict
        # lookups (~5x cheaper per sample, measured)
        self._frame_labels: Dict[object, str] = {}
        # tid -> normalized thread name, rebuilt only when an unknown
        # tid appears (thread births are rare; per-sample
        # threading.enumerate() + re-normalization measured ~30% of the
        # whole sample cost)
        self._tid_names: Dict[int, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _now(self) -> float:
        return (self._clock.now() if self._clock is not None
                else WALL.now())

    # ---- sampling ---------------------------------------------------------

    def sample_once(self) -> int:
        """Sample every live thread once; returns threads sampled."""
        t0 = time.perf_counter()
        t = self._now()
        me = threading.get_ident()
        frames = sys._current_frames()
        n = 0
        labels = self._frame_labels
        names = self._tid_names
        if any(tid not in names for tid in frames):
            # a thread was born (or this is the first sample): refresh
            # the whole map once, then go back to pure dict lookups
            names = self._tid_names = {
                th.ident: _norm_thread(th.name)
                for th in threading.enumerate()}
        with self._lock:
            for tid, frame in frames.items():
                if tid == me:
                    continue   # never profile the sampler's own stack
                stack: List[str] = []
                depth = 0
                f = frame
                while f is not None and depth < self.max_depth:
                    co = f.f_code
                    label = labels.get(co)
                    if label is None:
                        if len(labels) > 4 * self.max_stacks:
                            labels.clear()   # runaway codegen bound
                        label = labels[co] = (
                            f"{co.co_filename.rsplit('/', 1)[-1]}"
                            f":{co.co_name}")
                    stack.append(label)
                    depth += 1
                    f = f.f_back
                stack.reverse()   # root-first, the folded convention
                thr = names.get(tid) or f"tid-{tid}"
                key = thr + ";" + ";".join(stack)
                if key in self._counts:
                    self._counts[key] += 1
                elif len(self._counts) < self.max_stacks:
                    self._counts[key] = 1
                else:
                    self.dropped_stacks += 1
                self._raw.append((t, thr, tuple(stack)))
                n += 1
            self.samples += 1
            if self.started_at is None:
                self.started_at = t
        self.sample_cost_s += time.perf_counter() - t0
        return n

    def start(self) -> "SamplingProfiler":
        if self._thread is not None and self._thread.is_alive():
            return self

        def run():
            interval = 1.0 / self.hz
            while not self._stop.is_set():
                try:
                    self.sample_once()
                except Exception:
                    pass   # the profiler must never die mid-run
                self._stop.wait(interval)
        self._stop.clear()
        self._thread = threading.Thread(target=run, name="sampling-profiler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._raw.clear()
            self.samples = 0
            self.dropped_stacks = 0
            self.started_at = None
            self.sample_cost_s = 0.0

    # ---- exports ----------------------------------------------------------

    def folded(self) -> str:
        """Collapsed-stack text: one ``stack count`` line per unique
        folded stack — flamegraph.pl / speedscope input."""
        with self._lock:
            items = sorted(self._counts.items())
        return "".join(f"{k} {v}\n" for k, v in items)

    def top(self, n: int = 20) -> List[Dict]:
        """Top frames by inclusive samples (+ self samples where the
        frame was the leaf)."""
        incl: Dict[str, int] = {}
        self_c: Dict[str, int] = {}
        with self._lock:
            items = list(self._counts.items())
        for key, count in items:
            frames = key.split(";")[1:]   # drop the thread prefix
            if not frames:
                continue
            for fr in set(frames):
                incl[fr] = incl.get(fr, 0) + count
            leaf = frames[-1]
            self_c[leaf] = self_c.get(leaf, 0) + count
        ranked = sorted(incl.items(), key=lambda kv: -kv[1])[:n]
        return [{"frame": fr, "inclusive": c, "self": self_c.get(fr, 0)}
                for fr, c in ranked]

    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON from the raw sample ring: per thread,
        consecutive samples sharing a stack prefix merge into one
        complete ("X") event per frame — the flame chart renders the
        sampled timeline directly."""
        with self._lock:
            raw = list(self._raw)
        interval = 1.0 / self.hz
        by_thread: Dict[str, List[Tuple[float, Tuple[str, ...]]]] = {}
        for t, thr, stack in raw:
            by_thread.setdefault(thr, []).append((t, stack))
        events: List[Dict] = []
        tids = {}
        for thr, samples in sorted(by_thread.items()):
            tid = tids.setdefault(thr, len(tids) + 1)
            samples.sort(key=lambda s: s[0])
            open_frames: List[Tuple[str, float]] = []   # (frame, start)

            def close(depth: int, t_end: float):
                while len(open_frames) > depth:
                    fr, t_start = open_frames.pop()
                    events.append({
                        "name": fr, "ph": "X", "cat": "sample",
                        "ts": round(t_start * 1e6, 1),
                        "dur": round(max(t_end - t_start, interval) * 1e6, 1),
                        "pid": 1, "tid": tid,
                        "args": {"depth": len(open_frames)}})

            prev_t = None
            for t, stack in samples:
                if prev_t is not None and t - prev_t > 2 * interval:
                    close(0, prev_t + interval)   # gap: the thread idled
                common = 0
                for (fr, _), new in zip(open_frames, stack):
                    if fr != new:
                        break
                    common += 1
                close(common, t)
                for fr in stack[common:]:
                    open_frames.append((fr, t))
                prev_t = t
            if prev_t is not None:
                close(0, prev_t + interval)
            events.append({"ph": "M", "name": "thread_name", "pid": 1,
                           "tid": tid, "args": {"name": thr}})
        events.append({"ph": "M", "name": "process_name", "pid": 1,
                       "tid": 0, "args": {"name": "karpenter-tpu"}})
        return {"displayTimeUnit": "ms", "traceEvents": events}

    # ---- introspection ----------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            unique = len(self._counts)
            # one "sample" is one sampling round over ALL threads; a
            # frame's inclusive count is per thread-stack — percentages
            # must divide by the thread-stack total, not the round count
            stack_samples = sum(self._counts.values())
        avg_ms = (self.sample_cost_s / self.samples * 1e3
                  if self.samples else 0.0)
        return {
            "enabled": 1.0,
            "hz": self.hz,
            "samples": self.samples,
            "stack_samples": stack_samples,
            "unique_stacks": unique,
            "dropped_stacks": self.dropped_stacks,
            "avg_sample_ms": round(avg_ms, 4),
            # self-measured: fraction of one core the sampler itself eats
            "overhead_pct": round(avg_ms * self.hz / 10.0, 3),
            "running": 1.0 if (self._thread is not None
                               and self._thread.is_alive()) else 0.0,
        }

    def headroom_probe(self) -> Dict[str, float]:
        """Unique-stack store occupancy (introspect/headroom.py): a
        queue-kind bound — exhausting it means NEW stacks stop being
        attributed (counted by the pre-existing ``dropped_stacks``),
        which is evidence loss, not retention policy."""
        with self._lock:
            unique = len(self._counts)
        return {"depth": float(unique), "capacity": float(self.max_stacks),
                "drops": float(self.dropped_stacks)}


# ---- burn-triggered capture -------------------------------------------------


class BurnCapture:
    """Bounded episode-keyed retention of profile+contention snapshots.

    Two triggers, both rate-limited by construction:

    - ``on_sustained_burn`` — wired to ``SloTracker.on_sustained``,
      which fires EXACTLY ONCE per sustained-burn episode and re-arms on
      recovery (introspect/slo.py): one capture per episode, for free.
    - ``note_latency`` — a single pass so far over budget
      (``slow_pass_factor`` x the 200 ms bar) captures immediately,
      re-armed only after a within-budget pass AND ``cooldown_seconds``
      — a stretch of slow passes yields one capture, not a capture
      storm.

    Retention is a ``deque(maxlen=retain)``: repeated episodes keep the
    newest N captures, flight-recorder style. Each capture carries the
    profiler's top frames + folded size, the contention top list, and
    the device cost model summary — enough to answer "what was the
    process doing" without shipping the whole profile.
    """

    def __init__(self, clock, retain: int = 8,
                 latency_budget_seconds: float = 0.200,
                 slow_pass_factor: float = 10.0,
                 cooldown_seconds: float = 60.0):
        self._clock = clock
        self._lock = threading.Lock()
        self.captures: Deque[Dict] = deque(maxlen=max(int(retain), 1))
        self.capture_count = 0
        self.latency_budget_seconds = latency_budget_seconds
        self.slow_pass_factor = slow_pass_factor
        self.cooldown_seconds = cooldown_seconds
        self._slow_armed = True
        self._last_slow_capture = float("-inf")

    def resize(self, retain: int) -> None:
        with self._lock:
            self.captures = deque(self.captures, maxlen=max(int(retain), 1))

    # -- triggers --

    def on_sustained_burn(self, kind: str, burn: float, detail: str) -> None:
        """SloTracker.on_sustained hook: one capture per episode."""
        self.capture(f"slo-{kind}-burn", burn=round(burn, 3), detail=detail)

    def note_latency(self, seconds: float) -> None:
        """Per-pass hook (SloTracker.record_latency): a grossly
        over-budget pass captures once, then re-arms only after a
        within-budget pass + cooldown."""
        threshold = self.latency_budget_seconds * self.slow_pass_factor
        now = self._clock.now()
        with self._lock:
            if seconds <= self.latency_budget_seconds:
                if now - self._last_slow_capture >= self.cooldown_seconds:
                    self._slow_armed = True
                return
            if seconds < threshold or not self._slow_armed:
                return
            self._slow_armed = False
            self._last_slow_capture = now
        self.capture("slow-pass",
                     pass_seconds=round(seconds, 4),
                     budget_seconds=self.latency_budget_seconds)

    # -- the capture itself --

    def capture(self, reason: str, **meta) -> Dict:
        snap: Dict = {
            "t": round(self._clock.now(), 3),
            "reason": reason,
            **meta,
        }
        try:
            from . import profiler_instance
            prof = profiler_instance()
            if prof is not None:
                snap["profile"] = {
                    "samples": prof.samples,
                    "top": prof.top(20),
                }
        except Exception:
            pass
        try:
            snap["contention"] = [
                {"lock": name, "waitP99Ms": round(p99 * 1e3, 3),
                 "contended": n}
                for name, p99, n in contention.top_waits(5)]
        except Exception:
            pass
        try:
            from ..solver import costmodel
            snap["device"] = costmodel.model().summary()
        except Exception:
            pass
        with self._lock:
            self.capture_count += 1
            snap["episode"] = self.capture_count
            self.captures.append(snap)
        return snap

    # -- reporting --

    def stats(self) -> Dict:
        with self._lock:
            last = self.captures[-1] if self.captures else None
            return {
                "retained": len(self.captures),
                "total": self.capture_count,
                "last_t": last["t"] if last else 0.0,
                **({"last_reason": last["reason"]} if last else {}),
            }

    def doc(self) -> Dict:
        with self._lock:
            return {"captures": list(self.captures),
                    "total": self.capture_count,
                    "retain": self.captures.maxlen}

    def headroom_probe(self) -> Dict[str, float]:
        """Capture-ring occupancy (introspect/headroom.py).
        ``kind="ring"`` — flight-recorder retention: keeping only the
        newest N episodes is the design, not loss."""
        with self._lock:
            depth = len(self.captures)
            return {"depth": float(depth),
                    "capacity": float(self.captures.maxlen or 0),
                    "drops": float(max(self.capture_count - depth, 0)),
                    "kind": "ring"}
