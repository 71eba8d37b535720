"""Engine telemetry: structured step tracing, metrics, lifecycle spans.

The part of ``src/repro/serve/telemetry.py`` that the two-phase, chunked
and speculative engines, the host KV tier and the engine fleet call,
copied near-verbatim (numpy and the standard library only); the
device-trace capture uses ``torch.profiler`` where the JAX package used
``jax.profiler``. A fleet stamps each replica's events with its index
(``set_engine``), and the Chrome export gives each replica a process
track of its own.

UKL's pitch is that linking the hot process into the kernel *keeps* Linux's
battle-tested observability — perf, ftrace, /proc — where classic unikernels
throw it away. This module is that retained tooling for the serving engine:
the linked (compiled) serve programs stay fully inspectable from the
ordinary host side, without changing a single token the engine produces.

Three cooperating pieces:

``TraceRecorder``
    An append-only store of typed, timestamped events — ``engine_step``
    (with a pack / dispatch / device / host-bookkeeping phase breakdown),
    ``prefill_chunk``, ``decode_microsteps``, ``verify_window``,
    ``swap_out`` / ``swap_in`` / ``demote`` / ``promote``, ``preempt``,
    ``admit`` / ``complete``, ``pack``, ``budget`` — plus per-request
    lifecycle *spans* (``queued → prefilling → decoding → {swapped |
    preempted} → done``) keyed by rid. Exports as JSONL (one raw event
    per line) and as Chrome-trace JSON (loadable in ``chrome://tracing``
    / Perfetto: engine steps are duration events on an "engine" track,
    requests are async spans). The two exports round-trip:
    ``load_trace`` reads either back into raw events.

``MetricsRegistry``
    Counters, gauges and monotonic-bucket histograms (TTFT, inter-token
    latency, step duration, chunk utilization) with labeled families.
    Renders a Prometheus-style text exposition (``render``), a flat
    snapshot dict (``snapshot``) — the co-process ``MetricWriter`` sink's
    payload — and a one-line stats log (``line``).

``Telemetry``
    The hook bundle the engine (and the KV backend) actually call. Each
    hook updates the recorder and/or the registry; the module-level
    ``NULL_TELEMETRY`` singleton is the zero-cost disabled implementation —
    every hook is a no-op and ``now()`` returns 0.0 without reading a
    clock, so a disabled engine takes no timestamps and allocates nothing.

The span state machine mirrors the scheduler's legal transitions
(``SPAN_TRANSITIONS``); ``validate_spans`` checks a trace against it and
``validate_events`` checks every event against ``EVENT_SCHEMA``.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Event taxonomy
# ---------------------------------------------------------------------------

#: event type -> required arg keys (the trace schema; ``validate_events``)
EVENT_SCHEMA: Dict[str, frozenset] = {
    # one engine step: phase durations in seconds; ``kind`` names the
    # program family (decode | serve_chunk | verify | prefill_admit)
    "engine_step": frozenset({"step", "kind", "pack_s", "dispatch_s",
                              "device_s", "host_s"}),
    # child duration event of an engine_step (one per non-empty phase)
    "step_phase": frozenset({"phase"}),
    # one granted prompt chunk entering the device this step
    "prefill_chunk": frozenset({"slot", "rid", "start", "len"}),
    # the decode half of a step: how many slots advanced by k tokens
    "decode_microsteps": frozenset({"slots", "k"}),
    # one verify row's outcome: drafted vs model-accepted tokens
    "verify_window": frozenset({"slot", "rid", "drafted", "accepted"}),
    # the chunk packer's decision for this step
    "pack": frozenset({"budget", "decode_tokens", "granted"}),
    "admit": frozenset({"rid", "slot", "prompt_len"}),
    "complete": frozenset({"rid", "tokens", "ttft_s"}),
    "preempt": frozenset({"rid", "slot", "mode"}),
    # block movement across the device<->host tier boundary
    "swap_out": frozenset({"slot", "blocks", "bytes"}),
    "swap_in": frozenset({"slot", "blocks", "bytes"}),
    "demote": frozenset({"blocks", "bytes"}),
    "promote": frozenset({"blocks", "bytes"}),
    # a tier move that could not complete (host/device alloc exhaustion):
    # ``op`` names the failed direction; the engine falls back to recompute
    "swap_fail": frozenset({"slot", "blocks", "op"}),
    # one drain of the async SwapStream: deferred device->host transfers
    # completed at a step boundary (``transfers`` chains, ``blocks`` total)
    "swap_stream": frozenset({"transfers", "blocks", "bytes"}),
    # speculative host->device copy for the resume-head swapped victim:
    # ``status`` is issued | hit (consumed by swap-in) | cancel (dropped)
    "prefetch": frozenset({"blocks", "status"}),
    # host-side work hidden under device execution (dispatch pipelining):
    # ``kind`` is drain | prefetch | pack; ``hidden_s`` the overlapped time
    "overlap": frozenset({"kind", "hidden_s"}),
    # a BudgetTuner adjustment of the chunked token budget
    "budget": frozenset({"old", "new"}),
    # a prefill->decode disaggregation handoff: the finished KV chain of
    # ``rid`` left replica ``src`` (swap-out) and landed in replica
    # ``dst``'s pool (swap-in) via the shared host tier
    "handoff": frozenset({"rid", "src", "dst", "blocks", "bytes"}),
    # per-request lifecycle span transition (rid/state at top level)
    "span": frozenset(),
}

#: request lifecycle states, in nominal order
SPAN_STATES = ("queued", "prefilling", "decoding", "swapped", "preempted",
               "done")

#: the engine's legal lifecycle transitions (None = not yet seen).
#: queued->prefilling is admission; prefilling->decoding is the last prompt
#: chunk absorbed (the first generated token); a request whose budget is
#: that one token goes straight to done; swap preemption parks a slot
#: mid-prefill or mid-decode and resume returns it to whichever phase it
#: left; recompute preemption requeues the request (preempted->queued), and
#: a failed swap-in falls back the same way (swapped->queued).
SPAN_TRANSITIONS: Dict[Optional[str], frozenset] = {
    None: frozenset({"queued"}),
    "queued": frozenset({"prefilling"}),
    "prefilling": frozenset({"decoding", "swapped", "preempted", "done"}),
    "decoding": frozenset({"swapped", "preempted", "done"}),
    "swapped": frozenset({"prefilling", "decoding", "queued"}),
    "preempted": frozenset({"queued"}),
    "done": frozenset(),
}

_STEP_PHASES = ("pack", "dispatch", "device", "host")


def validate_events(events: Iterable[dict]) -> None:
    """Raise ValueError on the first event violating ``EVENT_SCHEMA``."""
    for i, ev in enumerate(events):
        et = ev.get("type")
        if et not in EVENT_SCHEMA:
            raise ValueError(f"event {i}: unknown type {et!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or math.isnan(ts):
            raise ValueError(f"event {i} ({et}): bad ts {ts!r}")
        if et == "span":
            if ev.get("state") not in SPAN_STATES:
                raise ValueError(f"event {i}: bad span state "
                                 f"{ev.get('state')!r}")
            if not isinstance(ev.get("rid"), int):
                raise ValueError(f"event {i}: span needs an int rid")
            continue
        args = ev.get("args", {})
        missing = EVENT_SCHEMA[et] - set(args)
        if missing:
            raise ValueError(f"event {i} ({et}): missing args "
                             f"{sorted(missing)}")


def validate_spans(events: Iterable[dict]) -> Dict[int, List[str]]:
    """Check every request's span transitions against the scheduler's
    legal state machine (``SPAN_TRANSITIONS``). Returns {rid: [states]};
    raises ValueError on the first illegal transition."""
    paths: Dict[int, List[str]] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        rid, state = ev["rid"], ev["state"]
        prev = paths.setdefault(rid, [])
        cur = prev[-1] if prev else None
        if state not in SPAN_TRANSITIONS[cur]:
            raise ValueError(
                f"rid {rid}: illegal span transition {cur} -> {state} "
                f"(path so far: {prev})")
        prev.append(state)
    return paths


# ---------------------------------------------------------------------------
# TraceRecorder
# ---------------------------------------------------------------------------

class TraceRecorder:
    """Append-only typed event store with JSONL / Chrome-trace exporters.

    Purely passive: timestamps are supplied by the caller (``Telemetry``
    owns the clock), so the recorder never reads time itself and replay
    under a fake clock is exact.
    """

    def __init__(self):
        self.events: List[dict] = []
        #: fleet replica id stamped onto every event while set (the fleet
        #: runtime points this at the replica it is ticking); None = the
        #: single-engine default, which emits exactly the pre-fleet format
        self.eng: Optional[int] = None

    def __len__(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()

    def emit(self, etype: str, ts: float, dur: float = 0.0, **args) -> None:
        ev = {"type": etype, "ts": ts, "args": args}
        if dur:
            ev["dur"] = dur
        if self.eng is not None:
            ev["eng"] = self.eng
        self.events.append(ev)

    def span(self, rid: int, state: str, ts: float) -> None:
        ev = {"type": "span", "rid": int(rid), "state": state, "ts": ts}
        if self.eng is not None:
            ev["eng"] = self.eng
        self.events.append(ev)

    def step(self, kind: str, step: int, t0: float, pack_s: float,
             dispatch_s: float, device_s: float, host_s: float,
             **extra) -> None:
        """One engine step: the parent duration event plus one child
        duration event per non-empty phase (contained time ranges — Chrome
        nests them under the parent on the engine track)."""
        durs = (pack_s, dispatch_s, device_s, host_s)
        total = sum(durs)
        self.emit("engine_step", t0, dur=total, step=step, kind=kind,
                  pack_s=pack_s, dispatch_s=dispatch_s, device_s=device_s,
                  host_s=host_s, **extra)
        t = t0
        for phase, d in zip(_STEP_PHASES, durs):
            if d > 0:
                self.emit("step_phase", t, dur=d, phase=phase, step=step)
            t += d

    # -- exporters ----------------------------------------------------------

    def export_jsonl(self, path: str) -> int:
        """One raw event per line; returns the number of lines written."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.events)

    def chrome_trace(self) -> dict:
        """The events as a Chrome-trace (``chrome://tracing`` / Perfetto)
        JSON object: engine steps (and their phases) as duration events on
        the "engine" process track, every other event as an instant there,
        and request lifecycles as async spans on a "requests" process —
        one async slice per lifecycle state, keyed by rid."""
        return chrome_trace(self.events)

    def export_chrome(self, path: str) -> int:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return len(self.events)


_ENGINE_PID = 1


def chrome_trace(events: Iterable[dict]) -> dict:
    """Raw recorder events -> Chrome-trace JSON dict (see
    ``TraceRecorder.chrome_trace``). Every exported event carries its raw
    type as ``args.etype`` so ``load_trace`` can reconstruct the raw
    stream from either export format.

    Fleet traces (events stamped with a replica id ``eng``) put each
    replica on its own process track named ``engine/<i>``, with the
    request spans on a ``requests`` process after the last engine pid.
    Single-engine traces keep the engine=1, requests=2 pids."""
    events = list(events)
    engs = sorted({ev.get("eng", 0) for ev in events} | {0})
    multi = any("eng" in ev for ev in events)
    req_pid = _ENGINE_PID + engs[-1] + 1
    out: List[dict] = [
        {"ph": "M", "pid": _ENGINE_PID + e, "name": "process_name",
         "args": {"name": f"engine/{e}" if multi else "engine"}}
        for e in engs
    ] + [
        {"ph": "M", "pid": req_pid, "name": "process_name",
         "args": {"name": "requests"}},
    ]
    open_spans: Dict[int, Tuple[str, float]] = {}
    last_ts = 0.0
    for ev in events:
        et, ts = ev["type"], ev["ts"]
        us = ts * 1e6
        last_ts = max(last_ts, ts)
        eng = {} if "eng" not in ev else {"eng": ev["eng"]}
        pid = _ENGINE_PID + ev.get("eng", 0)
        if et == "span":
            rid, state = ev["rid"], ev["state"]
            prev = open_spans.pop(rid, None)
            if prev is not None:
                out.append({"ph": "e", "cat": "request", "id": rid,
                            "name": prev[0], "pid": req_pid, "ts": us,
                            "args": {}})
            out.append({"ph": "b", "cat": "request", "id": rid,
                        "name": state, "pid": req_pid, "ts": us,
                        "args": dict({"etype": "span", "rid": rid,
                                      "state": state}, **eng)})
            open_spans[rid] = (state, ts)
        elif et in ("engine_step", "step_phase"):
            name = (et if et == "engine_step"
                    else f"phase:{ev['args']['phase']}")
            out.append({"ph": "X", "cat": "engine", "name": name,
                        "pid": pid, "tid": 0, "ts": us,
                        "dur": ev.get("dur", 0.0) * 1e6,
                        "args": dict(ev["args"], etype=et, **eng)})
        else:
            out.append({"ph": "i", "s": "t", "cat": "engine", "name": et,
                        "pid": pid, "tid": 0, "ts": us,
                        "args": dict(ev["args"], etype=et, **eng)})
    # close dangling spans (e.g. a request still in flight at export time)
    for rid, (state, _) in sorted(open_spans.items()):
        out.append({"ph": "e", "cat": "request", "id": rid, "name": state,
                    "pid": req_pid, "ts": last_ts * 1e6, "args": {}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def load_trace(path: str) -> List[dict]:
    """Read a trace file back into raw recorder events. Accepts both
    export formats: JSONL (one raw event per line) and Chrome-trace JSON
    (reconstructed from each exported event's ``args.etype``)."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if not isinstance(doc, dict) or "traceEvents" not in doc:  # JSONL
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]
    events: List[dict] = []
    for ev in doc.get("traceEvents", []):
        et = (ev.get("args") or {}).get("etype")
        if ev.get("ph") == "M" or et is None or ev.get("ph") == "e":
            continue
        ts = ev["ts"] / 1e6
        eng = (ev.get("args") or {}).get("eng")
        if et == "span":
            raw = {"type": "span", "rid": ev["args"]["rid"],
                   "state": ev["args"]["state"], "ts": ts}
            if eng is not None:
                raw["eng"] = eng
            events.append(raw)
            continue
        args = {k: v for k, v in ev["args"].items()
                if k not in ("etype", "eng")}
        raw = {"type": et, "ts": ts, "args": args}
        if ev.get("dur"):
            raw["dur"] = ev["dur"] / 1e6
        if eng is not None:
            raw["eng"] = eng
        events.append(raw)
    events.sort(key=lambda e: e["ts"])
    return events


def span_latencies(events: Iterable[dict]) -> Dict[int, Dict[str, float]]:
    """Per-request timings derived from span transitions: {rid:
    {"ttft_s", "latency_s"}} where TTFT is first ``queued`` -> first
    ``decoding`` (the first generated token — exactly how the engine
    stamps ``Completion.first_token_s``) and latency is first ``queued``
    -> ``done``. Requests that never reached a state omit its key."""
    marks: Dict[int, Dict[str, float]] = {}
    for ev in events:
        if ev["type"] != "span":
            continue
        m = marks.setdefault(ev["rid"], {})
        if ev["state"] in ("queued", "decoding", "done"):
            m.setdefault(ev["state"], ev["ts"])
    out: Dict[int, Dict[str, float]] = {}
    for rid, m in marks.items():
        d: Dict[str, float] = {}
        if "queued" in m and "decoding" in m:
            d["ttft_s"] = m["decoding"] - m["queued"]
        if "queued" in m and "done" in m:
            d["latency_s"] = m["done"] - m["queued"]
        out[rid] = d
    return out


# ---------------------------------------------------------------------------
# MetricsRegistry
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: default histogram buckets for latencies (seconds, exponential)
LATENCY_BUCKETS = (.0001, .00025, .0005, .001, .0025, .005, .01, .025, .05,
                   .1, .25, .5, 1.0, 2.5, 5.0, 10.0, 30.0)
#: buckets for 0..1 ratios (chunk budget utilization)
RATIO_BUCKETS = (.1, .2, .3, .4, .5, .6, .7, .8, .9, 1.0)


class _Metric:
    """One child of a family (a concrete label binding)."""

    __slots__ = ("kind", "value", "buckets", "counts", "total", "n")

    def __init__(self, kind: str, buckets: Optional[Tuple[float, ...]]):
        self.kind = kind
        self.value = 0.0
        self.buckets = buckets
        if kind == "histogram":
            self.counts = [0] * (len(buckets) + 1)      # +Inf bucket
            self.total = 0.0
            self.n = 0

    def inc(self, v: float = 1.0) -> None:
        if self.kind != "counter":
            raise TypeError(f"inc() on a {self.kind}")
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v

    def set(self, v: float) -> None:
        if self.kind != "gauge":
            raise TypeError(f"set() on a {self.kind}")
        self.value = float(v)

    def observe(self, v: float) -> None:
        if self.kind != "histogram":
            raise TypeError(f"observe() on a {self.kind}")
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.total += v
        self.n += 1


class _Family:
    """A named metric family: children keyed by label values."""

    def __init__(self, kind: str, name: str, help: str,
                 label_names: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        if kind == "histogram":
            if not buckets or list(buckets) != sorted(set(buckets)):
                raise ValueError(f"{name}: histogram buckets must be a "
                                 "strictly increasing sequence")
        self.kind, self.name, self.help = kind, name, help
        self.label_names = tuple(label_names)
        self.buckets = tuple(buckets) if buckets else None
        self.children: Dict[Tuple[str, ...], _Metric] = {}
        if not self.label_names:
            self.children[()] = _Metric(kind, self.buckets)

    def labels(self, **labels) -> _Metric:
        if set(labels) != set(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {tuple(labels)}")
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = _Metric(self.kind, self.buckets)
        return child

    # no-label conveniences
    def inc(self, v: float = 1.0) -> None:
        self.children[()].inc(v)

    def set(self, v: float) -> None:
        self.children[()].set(v)

    def observe(self, v: float) -> None:
        self.children[()].observe(v)


def _fmt_labels(names, values, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """A process-local registry of labeled metric families.

    ``const_labels`` (e.g. backend / linkage preset) are appended to every
    family's label set — the serving analogue of per-target labels. The
    exposition (``render``) is Prometheus text format; ``snapshot`` is the
    flat dict a co-process ``MetricWriter`` sink consumes; ``line`` is the
    periodic one-line stats log (``--log-interval``).
    """

    def __init__(self, const_labels: Optional[Dict[str, str]] = None):
        self.const_labels = dict(const_labels or {})
        self.families: Dict[str, _Family] = {}

    def _family(self, kind: str, name: str, help: str, labels=(),
                buckets=None) -> _Family:
        fam = self.families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(f"{name} already registered as {fam.kind}")
            return fam
        fam = _Family(kind, name, help, tuple(labels), buckets)
        self.families[name] = fam
        return fam

    def counter(self, name: str, help: str = "", labels=()) -> _Family:
        return self._family("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> _Family:
        return self._family("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=LATENCY_BUCKETS) -> _Family:
        return self._family("histogram", name, help, labels, buckets)

    def reset(self) -> None:
        """Zero every child in place (families and label bindings stay)."""
        for fam in self.families.values():
            for m in fam.children.values():
                m.value = 0.0
                if m.kind == "histogram":
                    m.counts = [0] * (len(m.buckets) + 1)
                    m.total, m.n = 0.0, 0

    def render(self) -> str:
        """Prometheus text exposition of every family."""
        const = [f'{k}="{v}"' for k, v in sorted(self.const_labels.items())]
        cstr = ",".join(const)
        lines: List[str] = []
        for name in sorted(self.families):
            fam = self.families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                m = fam.children[key]
                if fam.kind == "histogram":
                    cum = 0
                    for b, c in zip(m.buckets, m.counts):
                        cum += c
                        lab = _fmt_labels(fam.label_names, key,
                                          (cstr + "," if cstr else "")
                                          + f'le="{b}"')
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lab = _fmt_labels(fam.label_names, key,
                                      (cstr + "," if cstr else "")
                                      + 'le="+Inf"')
                    lines.append(f"{name}_bucket{lab} {m.n}")
                    base = _fmt_labels(fam.label_names, key, cstr)
                    lines.append(f"{name}_sum{base} {m.total}")
                    lines.append(f"{name}_count{base} {m.n}")
                else:
                    lab = _fmt_labels(fam.label_names, key, cstr)
                    lines.append(f"{name}{lab} {m.value}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, float]:
        """Flat {\"name{label=v}\": value} dict (histograms contribute
        ``_sum`` and ``_count``) — the ``MetricWriter`` sink payload."""
        out: Dict[str, float] = {}
        for name, fam in sorted(self.families.items()):
            for key in sorted(fam.children):
                m = fam.children[key]
                lab = _fmt_labels(fam.label_names, key)
                if fam.kind == "histogram":
                    out[f"{name}_sum{lab}"] = m.total
                    out[f"{name}_count{lab}"] = float(m.n)
                else:
                    out[f"{name}{lab}"] = m.value
        return out

    def quantile(self, name: str, q: float, **labels) -> float:
        """Histogram quantile estimate from the monotonic buckets (upper
        bucket bound containing the q-th sample; +Inf falls back to the
        last finite bound). The trace, not the registry, is the exact
        source — this is the cheap online estimate."""
        fam = self.families[name]
        m = fam.labels(**labels) if fam.label_names else fam.children[()]
        if m.kind != "histogram" or m.n == 0:
            return float("nan")
        rank = q * m.n
        cum = 0
        for b, c in zip(m.buckets, m.counts):
            cum += c
            if cum >= rank:
                return b
        return m.buckets[-1]

    def line(self, prefix: str = "") -> str:
        """The periodic one-line stats log: every counter/gauge as k=v,
        histograms as their count + estimated p50/p99."""
        parts: List[str] = [prefix] if prefix else []
        for name, fam in sorted(self.families.items()):
            for key in sorted(fam.children):
                m = fam.children[key]
                lab = _fmt_labels(fam.label_names, key)
                if fam.kind == "histogram":
                    if m.n:
                        parts.append(f"{name}{lab}.n={m.n}")
                        p50 = self.quantile(name, .5, **dict(
                            zip(fam.label_names, key)))
                        p99 = self.quantile(name, .99, **dict(
                            zip(fam.label_names, key)))
                        parts.append(f"{name}{lab}.p50<={p50:g}")
                        parts.append(f"{name}{lab}.p99<={p99:g}")
                else:
                    v = m.value
                    parts.append(f"{name}{lab}="
                                 f"{int(v) if v == int(v) else round(v, 6)}")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# Telemetry: the hook bundle the engine calls
# ---------------------------------------------------------------------------

class Telemetry:
    """Bundles a ``TraceRecorder`` and/or ``MetricsRegistry`` behind the
    hook methods the engine and KV backends call.

    ``sink``: an optional co-process consumer of periodic registry
    snapshots — anything with ``submit(step, metrics_dict)`` (the
    ``repro_torch.core.coprocess.MetricWriter`` contract: UKL's ordinary
    user process reading from the linked-in hot one). Snapshots are
    pushed every ``log_interval`` seconds alongside the one-line log.

    ``profile_dir``: capture a ``torch.profiler`` device trace around the
    first ``profile_steps`` engine steps of the (post-warmup) run.
    """

    def __init__(self, trace: bool = True, metrics: bool = True,
                 log_interval: float = 0.0,
                 log_fn: Callable[[str], None] = print,
                 sink: Any = None,
                 profile_dir: Optional[str] = None, profile_steps: int = 8,
                 const_labels: Optional[Dict[str, str]] = None):
        self.trace: Optional[TraceRecorder] = TraceRecorder() if trace \
            else None
        self.metrics: Optional[MetricsRegistry] = None
        self.log_interval = log_interval
        self.log_fn = log_fn
        self.sink = sink
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self._profiling = False
        self._profiled = False
        self._last_log = None
        self._clock: Callable[[], float] = lambda: 0.0
        if metrics:
            self.metrics = m = MetricsRegistry(const_labels)
            self._steps = m.counter("engine_steps_total",
                                    "engine steps by program kind",
                                    labels=("kind",))
            self._phase_s = m.counter(
                "engine_phase_seconds_total",
                "host wall-clock per step phase", labels=("phase",))
            self._tokens = m.counter("engine_tokens_total",
                                     "tokens through the engine",
                                     labels=("phase",))
            self._admits = m.counter("engine_admissions_total",
                                     "requests admitted to a slot")
            self._completes = m.counter("engine_completions_total",
                                        "requests finished")
            self._preempts = m.counter("engine_preemptions_total",
                                       "pool-pressure preemptions",
                                       labels=("mode",))
            self._swap_blocks = m.counter(
                "kv_tier_blocks_total",
                "KV blocks across the device<->host boundary",
                labels=("op",))
            self._tier_bytes = m.counter(
                "kv_tier_bytes_total",
                "bytes across the device<->host boundary", labels=("op",))
            self._tier_raw = m.counter(
                "kv_tier_raw_bytes_total",
                "uncompressed bytes the moved blocks decode to (equals "
                "kv_tier_bytes_total unless the cache is quantized)",
                labels=("op",))
            self._swap_fails = m.counter(
                "kv_swap_failures_total",
                "tier moves that fell back to recompute", labels=("op",))
            self._stream_drains = m.counter(
                "kv_swap_stream_transfers_total",
                "async swap-stream transfers completed at drains")
            self._prefetch_c = m.counter(
                "kv_prefetch_total",
                "speculative swap-in copies by outcome", labels=("status",))
            self._overlap_s = m.counter(
                "engine_overlap_seconds_total",
                "host work hidden under device execution", labels=("kind",))
            self._handoffs = m.counter(
                "fleet_handoffs_total",
                "prefill->decode chains moved between fleet replicas")
            self._spec = m.counter("spec_tokens_total",
                                   "speculative tokens", labels=("kind",))
            self._budget_adj = m.counter("chunk_budget_adjustments_total",
                                         "BudgetTuner AIMD moves")
            self._budget_g = m.gauge("chunk_budget", "current token budget")
            self._queue_g = m.gauge("queue_depth", "requests waiting")
            self._active_g = m.gauge("active_slots", "occupied slots")
            self._swapped_g = m.gauge("swapped_requests",
                                      "swap-suspended requests")
            self._ttft_h = m.histogram("ttft_seconds",
                                       "time to first token")
            self._lat_h = m.histogram("request_latency_seconds",
                                      "arrival to completion")
            self._gap_h = m.histogram("inter_token_seconds",
                                      "gap between token emissions")
            self._step_h = m.histogram("step_seconds",
                                       "engine step duration")
            self._util_h = m.histogram("chunk_utilization_ratio",
                                       "packed tokens / budget",
                                       buckets=RATIO_BUCKETS)
    # -- clock / lifecycle --------------------------------------------------

    def now(self) -> float:
        return self._clock()

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Adopt the engine run's relative clock, so trace timestamps and
        ``Completion`` timestamps are the same timeline (the trace-derived
        TTFT matches ``serve_report`` exactly)."""
        self._clock = clock
        self._last_log = None

    def set_engine(self, eng: Optional[int]) -> None:
        """Stamp subsequent trace events with a fleet replica id (None =
        the single-engine default). The fleet runtime brackets each
        replica's tick with this, so one shared recorder yields a process
        track a replica in the Chrome export."""
        if self.trace is not None:
            self.trace.eng = eng

    def reset(self) -> None:
        """Drop recorded events and zero metrics (after compile warmup)."""
        if self.trace is not None:
            self.trace.clear()
        if self.metrics is not None:
            self.metrics.reset()

    # -- engine step --------------------------------------------------------

    def step(self, kind: str, step: int, t0: float, pack_s: float,
             dispatch_s: float, device_s: float, host_s: float,
             queued: int = 0, active: int = 0, swapped: int = 0,
             **extra) -> None:
        if self.trace is not None:
            self.trace.step(kind, step, t0, pack_s, dispatch_s, device_s,
                            host_s, **extra)
        if self.metrics is not None:
            self._steps.labels(kind=kind).inc()
            for phase, d in zip(_STEP_PHASES,
                                (pack_s, dispatch_s, device_s, host_s)):
                self._phase_s.labels(phase=phase).inc(d)
            self._step_h.observe(pack_s + dispatch_s + device_s + host_s)
            self._queue_g.set(queued)
            self._active_g.set(active)
            self._swapped_g.set(swapped)
        self._maybe_log(step)

    def _maybe_log(self, step: int) -> None:
        if self.metrics is None or (self.log_interval <= 0
                                    and self.sink is None):
            return
        now = self._clock()
        if self._last_log is not None and \
                now - self._last_log < max(self.log_interval, 0.0):
            return
        self._last_log = now
        if self.log_interval > 0:
            self.log_fn(self.metrics.line(prefix=f"[serve t={now:.2f}s]"))
        if self.sink is not None:
            self.sink.submit(step, self.metrics.snapshot())

    # -- request lifecycle --------------------------------------------------

    def state(self, rid: int, state: str, ts: float) -> None:
        if self.trace is not None:
            self.trace.span(rid, state, ts)

    def admit(self, rid: int, slot: int, prompt_len: int, ts: float) -> None:
        if self.trace is not None:
            self.trace.emit("admit", ts, rid=rid, slot=slot,
                            prompt_len=prompt_len)
            self.trace.span(rid, "prefilling", ts)
        if self.metrics is not None:
            self._admits.inc()

    def complete(self, c, ts: float) -> None:
        """``c`` is a ``repro_torch.serve.scheduler.Completion``."""
        if self.trace is not None:
            self.trace.emit("complete", ts, rid=c.rid,
                            tokens=int(len(c.tokens)), ttft_s=c.ttft_s)
            self.trace.span(c.rid, "done", ts)
        if self.metrics is not None:
            self._completes.inc()
            self._ttft_h.observe(c.ttft_s)
            self._lat_h.observe(c.latency_s)

    def preempt(self, rid: int, slot: int, mode: str, ts: float) -> None:
        if self.trace is not None:
            self.trace.emit("preempt", ts, rid=rid, slot=slot, mode=mode)
        if self.metrics is not None:
            self._preempts.labels(mode=mode).inc()

    def emit_gap(self, gap_s: float) -> None:
        if self.metrics is not None:
            self._gap_h.observe(gap_s)

    # -- step internals -----------------------------------------------------

    def prefill_chunk(self, slot: int, rid: int, start: int, n: int,
                      ts: float) -> None:
        if self.trace is not None:
            self.trace.emit("prefill_chunk", ts, slot=slot, rid=rid,
                            start=start, len=n)
        if self.metrics is not None:
            self._tokens.labels(phase="prefill").inc(n)

    def prefill_tokens(self, n: int) -> None:
        if self.metrics is not None:
            self._tokens.labels(phase="prefill").inc(n)

    def decode_microsteps(self, slots: int, k: int, ts: float) -> None:
        if self.trace is not None:
            self.trace.emit("decode_microsteps", ts, slots=slots, k=k)
        if self.metrics is not None:
            self._tokens.labels(phase="decode").inc(slots * k)

    def verify_window(self, slot: int, rid: int, drafted: int,
                      accepted: int, ts: float) -> None:
        """One verify row's outcome: ``drafted`` tokens fed after the
        committed one, ``accepted`` of them confirmed (1 + accepted
        emitted)."""
        if self.trace is not None:
            self.trace.emit("verify_window", ts, slot=slot, rid=rid,
                            drafted=drafted, accepted=accepted)
        if self.metrics is not None:
            self._spec.labels(kind="drafted").inc(drafted)
            self._spec.labels(kind="accepted").inc(accepted)
            self._tokens.labels(phase="decode").inc(1 + accepted)

    def pack(self, budget: int, decode_tokens: int, granted: int,
             ts: float) -> None:
        if self.trace is not None:
            self.trace.emit("pack", ts, budget=budget,
                            decode_tokens=decode_tokens, granted=granted)
        if self.metrics is not None and budget > 0:
            self._util_h.observe(min((decode_tokens + granted) / budget,
                                     1.0))

    def budget_adjust(self, old: int, new: int, ts: float) -> None:
        if old == new:
            return
        if self.trace is not None:
            self.trace.emit("budget", ts, old=old, new=new)
        if self.metrics is not None:
            self._budget_adj.inc()
            self._budget_g.set(new)

    # -- KV tier movement (called from PagedKV) -----------------------------

    def swap_out(self, slot: int, blocks: int, nbytes: int,
                 raw_bytes: Optional[int] = None) -> None:
        self._tier("swap_out", blocks, nbytes, raw_bytes, slot=slot)

    def swap_in(self, slot: int, blocks: int, nbytes: int,
                raw_bytes: Optional[int] = None) -> None:
        self._tier("swap_in", blocks, nbytes, raw_bytes, slot=slot)

    def demote(self, nbytes: int, raw_bytes: Optional[int] = None) -> None:
        self._tier("demote", 1, nbytes, raw_bytes)

    def promote(self, nbytes: int, raw_bytes: Optional[int] = None) -> None:
        self._tier("promote", 1, nbytes, raw_bytes)

    def _tier(self, op: str, blocks: int, nbytes: int,
              raw_bytes: Optional[int] = None, **args) -> None:
        """``raw_bytes`` is what the moved blocks decode to uncompressed —
        given only by quantized caches, where wire bytes != logical bytes;
        the raw counter falls back to ``nbytes`` so the compressed/raw
        ratio is well-defined (1.0) for unquantized engines too."""
        if self.trace is not None:
            extra = {} if raw_bytes is None else {"raw_bytes": raw_bytes}
            self.trace.emit(op, self._clock(), blocks=blocks, bytes=nbytes,
                            **extra, **args)
        if self.metrics is not None:
            self._swap_blocks.labels(op=op).inc(blocks)
            self._tier_bytes.labels(op=op).inc(nbytes)
            self._tier_raw.labels(op=op).inc(
                nbytes if raw_bytes is None else raw_bytes)

    def handoff(self, rid: int, src: int, dst: int, blocks: int,
                nbytes: int) -> None:
        """A prefill->decode disaggregation handoff: ``rid``'s finished KV
        chain left replica ``src`` and landed in replica ``dst``'s pool
        (the swap_out / swap_in pair it rode is traced on each replica's
        track; this event is the edge between them)."""
        if self.trace is not None:
            self.trace.emit("handoff", self._clock(), rid=rid, src=src,
                            dst=dst, blocks=blocks, bytes=nbytes)
        if self.metrics is not None:
            self._handoffs.inc()

    def swap_fail(self, slot: int, blocks: int, op: str) -> None:
        """A tier move that could not complete (alloc exhaustion): ``op``
        is the failed direction (swap_out | swap_in). Makes the engine's
        fallback to recompute visible in traces and counters."""
        if self.trace is not None:
            self.trace.emit("swap_fail", self._clock(), slot=slot,
                            blocks=blocks, op=op)
        if self.metrics is not None:
            self._swap_fails.labels(op=op).inc()

    def swap_stream(self, transfers: int, blocks: int, nbytes: int,
                    raw_bytes: Optional[int] = None) -> None:
        """One non-empty drain of the async swap stream."""
        if self.trace is not None:
            extra = {} if raw_bytes is None else {"raw_bytes": raw_bytes}
            self.trace.emit("swap_stream", self._clock(),
                            transfers=transfers, blocks=blocks,
                            bytes=nbytes, **extra)
        if self.metrics is not None:
            self._stream_drains.inc(transfers)

    def prefetch(self, blocks: int, status: str) -> None:
        """A speculative swap-in copy event: issued | hit | cancel."""
        if self.trace is not None:
            self.trace.emit("prefetch", self._clock(), blocks=blocks,
                            status=status)
        if self.metrics is not None:
            self._prefetch_c.labels(status=status).inc()

    def overlap(self, kind: str, hidden_s: float) -> None:
        """Host-side work run under device execution (drain | prefetch |
        pack) — this time lands inside the step's device phase instead of
        its host/pack phases."""
        if self.trace is not None:
            self.trace.emit("overlap", self._clock(), kind=kind,
                            hidden_s=hidden_s)
        if self.metrics is not None:
            self._overlap_s.labels(kind=kind).inc(hidden_s)

    # -- torch.profiler capture ---------------------------------------------

    def profile_tick(self, step: int) -> None:
        """Capture a ``torch.profiler`` trace (CPU, plus CUDA when a GPU is
        there) around the first ``profile_steps`` steps: start before step
        0, stop once the count is reached (or at ``close``), and write it to
        ``<profile_dir>/trace.json`` (Chrome format)."""
        if self.profile_dir is None or self._profiled:
            return
        if not self._profiling:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self._profiling = True
            self._profile_t0 = step
        elif step - self._profile_t0 >= self.profile_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        import os
        self._prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(self.profile_dir, "trace.json"))
        self._profiling = False
        self._profiled = True

    def close(self) -> None:
        """Stop an in-flight profiler capture and flush the sink."""
        if self._profiling:
            self._stop_profile()
        if self.sink is not None and hasattr(self.sink, "close"):
            self.sink.close()


class _NullTelemetry(Telemetry):
    """The zero-cost disabled recorder: every hook is a no-op and ``now``
    never reads a clock, so the engine's timestamp calls vanish. One
    shared singleton (``NULL_TELEMETRY``) — never mutate it."""

    def __init__(self):
        self.trace = None
        self.metrics = None
        self.sink = None
        self.profile_dir = None
        self.log_interval = 0.0

    def now(self) -> float:
        return 0.0

    def set_clock(self, clock) -> None:
        pass

    def set_engine(self, *a, **k) -> None:
        pass

    def reset(self) -> None:
        pass

    def step(self, *a, **k) -> None:
        pass

    def state(self, *a, **k) -> None:
        pass

    def admit(self, *a, **k) -> None:
        pass

    def complete(self, *a, **k) -> None:
        pass

    def preempt(self, *a, **k) -> None:
        pass

    def emit_gap(self, *a, **k) -> None:
        pass

    def prefill_chunk(self, *a, **k) -> None:
        pass

    def prefill_tokens(self, *a, **k) -> None:
        pass

    def decode_microsteps(self, *a, **k) -> None:
        pass

    def verify_window(self, *a, **k) -> None:
        pass

    def pack(self, *a, **k) -> None:
        pass

    def budget_adjust(self, *a, **k) -> None:
        pass

    def swap_out(self, *a, **k) -> None:
        pass

    def swap_in(self, *a, **k) -> None:
        pass

    def demote(self, *a, **k) -> None:
        pass

    def promote(self, *a, **k) -> None:
        pass

    def handoff(self, *a, **k) -> None:
        pass

    def swap_fail(self, *a, **k) -> None:
        pass

    def swap_stream(self, *a, **k) -> None:
        pass

    def prefetch(self, *a, **k) -> None:
        pass

    def overlap(self, *a, **k) -> None:
        pass

    def profile_tick(self, *a, **k) -> None:
        pass

    def close(self) -> None:
        pass


#: the shared disabled-telemetry singleton (see ``_NullTelemetry``)
NULL_TELEMETRY = _NullTelemetry()
