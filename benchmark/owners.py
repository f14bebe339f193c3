"""Which of the program's spans launched each device event of a traced
stretch: the device seconds of a chrome trace (Tracer.events) by owner,
phase and kernel family (trace.kernel_family).

The program's spans are its record_function ranges named train.*, model.*
and infer.* (vs_seg_tpu_torch/core/observability.py:span). A device event
(kernel, copy, memset), clipped to the stretch's "bench.traced" window, is
launched by the cuda_runtime or cuda_driver call with the same
`correlation`; the spans open on the launching thread at that call are the
event's, or, where that thread holds none (autograd's device thread),
those open then on the main thread, the one that holds the window. The
phase is the outermost of them, the owner the innermost. A launch inside a
backward op ("autograd::engine::evaluate_function: ...") is owned instead
by the innermost span around the forward op that made its node: the
latest op with the same "Sequence number" outside any backward op, on the
main thread where one is there (torch's chrome trace gives a forward op a
"Fwd thread id" of 0, so the backward op's cannot name the thread). A
device event with no span is unowned: owner and phase None.

No kind calls it yet. A training kind would keep
`attribute(tracer.events)` beside its trace summary, and per-layer
readers of the phases and of levels 0-1 would be `phase_ms` and
`elementwise_ms` of it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from benchmark.trace import DEVICE_CATS, WINDOW_SPAN, kernel_family

PROGRAM = ("train.", "model.", "infer.")
BACKWARD = "autograd::engine::evaluate_function: "
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ELEMENTWISE = ("elementwise", "reduction")


class _Ranges:
    """One thread's nested ranges (start, end, payload); `at(times)` gives,
    for each time, the payloads of the innermost and the outermost range
    open then, or (None, None)."""

    def __init__(self):
        self.items: List[Tuple[float, float, object]] = []

    def add(self, start: float, end: float, payload) -> None:
        self.items.append((start, end, payload))

    def at(self, times: List[float]) -> List[tuple]:
        ranges = sorted(self.items, key=lambda r: (r[0], -r[1]))
        order = sorted(range(len(times)), key=times.__getitem__)
        out: List[tuple] = [(None, None)] * len(times)
        stack: List[tuple] = []
        j = 0
        for q in order:
            t = times[q]
            while j < len(ranges) and ranges[j][0] <= t:
                while stack and stack[-1][1] < ranges[j][0]:
                    stack.pop()
                stack.append(ranges[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            # a parent that closed before an open child (rounding) is
            # passed over
            open_ = [r for r in stack if r[1] >= t]
            if open_:
                out[q] = (open_[-1][2], open_[0][2])
        return out


def _query(ranges: Dict[int, _Ranges], queries: List[Tuple[int, float]]
           ) -> List[tuple]:
    """(innermost, outermost) payloads at each (tid, time)."""
    out: List[tuple] = [(None, None)] * len(queries)
    by_tid: Dict[int, List[int]] = {}
    for i, (tid, _) in enumerate(queries):
        by_tid.setdefault(tid, []).append(i)
    for tid, idx in by_tid.items():
        if tid not in ranges:
            continue
        got = ranges[tid].at([queries[i][1] for i in idx])
        for i, g in zip(idx, got):
            out[i] = g
    return out


def _seq(e: dict) -> Optional[int]:
    s = e.get("args", {}).get("Sequence number")
    return None if s is None or int(s) < 0 else int(s)


def attribute(events: list) -> Optional[dict]:
    """{"device_s": {(owner, phase, family): seconds}, "spans": the names
    of the program's spans in the trace} of a traced stretch's events;
    None without the stretch's window."""
    windows = [e for e in events if e.get("name") == WINDOW_SPAN]
    if not windows:
        return None
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    main = windows[0].get("tid")

    spans: Dict[int, _Ranges] = {}
    backward: Dict[int, _Ranges] = {}
    launches: Dict[int, Tuple[int, float]] = {}
    forward_ops: List[dict] = []
    names = set()
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation" and name.startswith(PROGRAM):
            spans.setdefault(e["tid"], _Ranges()).add(
                e["ts"], e["ts"] + e["dur"], name)
            names.add(name)
        elif cat == "cpu_op" and _seq(e) is not None:
            if name.startswith(BACKWARD):
                backward.setdefault(e["tid"], _Ranges()).add(
                    e["ts"], e["ts"] + e["dur"], _seq(e))
            else:
                forward_ops.append(e)
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])

    # forward ops by sequence number: those outside every backward op
    inside = _query(backward, [(e["tid"], e["ts"]) for e in forward_ops])
    made: Dict[int, List[Tuple[float, int]]] = {}
    for e, (bwd, _) in zip(forward_ops, inside):
        if bwd is None:
            made.setdefault(_seq(e), []).append((e["ts"], e["tid"]))

    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t > s:
            corr = e.get("args", {}).get("correlation")
            device.append((t - s, kernel_family(e["name"]),
                           launches.get(corr)))

    queries = [d[2] or (None, 0.0) for d in device]
    found = _query(spans, queries)
    fallback = _query(spans, [(main, q[1]) for q in queries])
    in_bwd = _query(backward, queries)
    # the forward op behind each backward launch, and the spans around it
    fwd_at = [None if seq is None else _forward_op(made.get(seq), main)
              for seq, _ in in_bwd]
    fwd_found = _query(spans, [f or (None, 0.0) for f in fwd_at])

    out: Dict[tuple, float] = {}
    for i, (dur, fam, _) in enumerate(device):
        inner, outer = found[i] if found[i][0] is not None else fallback[i]
        if fwd_at[i] is not None and fwd_found[i][0] is not None:
            inner = fwd_found[i][0]
        key = (inner, outer, fam)
        out[key] = out.get(key, 0.0) + dur / 1e6
    return {"device_s": out, "spans": sorted(names)}


def _forward_op(ops: Optional[List[Tuple[float, int]]], main
                ) -> Optional[Tuple[int, float]]:
    """(tid, time) of the latest of a sequence number's forward ops `ops`
    ((time, tid)), on the main thread where one is there."""
    if not ops:
        return None
    ts, tid = max([o for o in ops if o[1] == main] or ops)
    return tid, ts


def level(owner: Optional[str]) -> Optional[str]:
    """The level of a model.<child> owner, as benchmark/kinds'
    LevelEvents reads a child's name: the suffix after its last "_", or
    "bottom" for the bottom's children; None for any other owner."""
    if not owner or not owner.startswith("model."):
        return None
    child = owner[len("model."):]
    if child.startswith("bottom"):
        return "bottom"
    return child.rsplit("_", 1)[-1] if "_" in child else None


def phase_ms(att: Optional[dict], steps: int, phase: str
             ) -> Optional[float]:
    """Device ms a step launched within the span `phase` of an attributed
    stretch of `steps` training steps; None where the trace holds no such
    span or no device event."""
    if not att or not att["device_s"] or phase not in att["spans"]:
        return None
    s = sum(v for (_, ph, _), v in att["device_s"].items() if ph == phase)
    return 1e3 * s / steps


def elementwise_ms(att: Optional[dict], steps: int, levels
                   ) -> Optional[float]:
    """Elementwise and reduction device ms a step owned by the model.*
    spans of `levels` (strings, as `level` gives them), forward and
    backward; None where the trace holds no model.* span or no device
    event."""
    if (not att or not att["device_s"]
            or not any(n.startswith("model.") for n in att["spans"])):
        return None
    s = sum(v for (own, _, fam), v in att["device_s"].items()
            if fam in ELEMENTWISE and level(own) in levels)
    return 1e3 * s / steps


def table(att: Optional[dict], steps: int) -> List[str]:
    """The owners table, ms a step: a line per owner and phase with its
    device time by kernel family, heaviest first; then the elementwise and
    reduction ms the table holds by owner kind."""
    if not att or not att["device_s"] or not att["spans"]:
        return []
    rows: Dict[tuple, Dict[str, float]] = {}
    for (own, ph, fam), v in att["device_s"].items():
        row = rows.setdefault((own or "unowned", ph or "-"), {})
        row[fam] = row.get(fam, 0.0) + 1e3 * v / steps
    lines = []
    for (own, ph), fams in sorted(rows.items(),
                                  key=lambda kv: -sum(kv[1].values())):
        parts = ", ".join(f"{f} {ms:.3f}" for f, ms in sorted(
            fams.items(), key=lambda kv: -kv[1]))
        lines.append(f"owner {own} in {ph}: {sum(fams.values()):.3f} ms "
                     f"({parts})")
    ew: Dict[str, float] = {}
    for (own, _, fam), v in att["device_s"].items():
        if fam in ELEMENTWISE:
            kind = ("model" if level(own) is not None
                    else own or "unowned")
            ew[kind] = ew.get(kind, 0.0) + 1e3 * v / steps
    lines.append("elementwise and reduction ms a step by owner: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(ew.items(), key=lambda kv: -kv[1])))
    return lines
