"""The program's own spans and counters in the profiler slice
(`sdn3d_tpu_torch.utils.phases.profiled()`), against the card's idle
time: every nanosecond of each gap between two consecutive busy intervals
(the breakdown's gaps, `common.busy_intervals` of the slice's device
events) is put down to the stage-level span the host was in at that
time, the innermost where they nest, or to "outside" where it was in
none.  A program without the log, a log without spans or a log that
dropped spans reads None: the readers of these metrics then report
nothing."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from perfbench.harness import common

# the stage-level spans: the chain's stages, the training step's parts
LEVEL = ("stage.", "train.forward", "train.backward", "train.optimizer")

_MEMO = "span_idle"


def program_log() -> Optional[Dict]:
    """The port's profiled log, None where the port keeps none (a port
    older than the log runs this benchmark too)."""
    from sdn3d_tpu_torch.utils import phases
    read = getattr(phases, "profiled", None)
    return read() if read is not None else None


def segments(spans: Sequence[Tuple[int, int, str]]
             ) -> List[Tuple[int, int, str]]:
    """Disjoint, sorted (start, end, name) pieces of the spans' union:
    at each instant the innermost span (the latest opened of those open)."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []         # (end, name), open spans
    at = None                                  # where the pieces reach

    def emit(upto: int, name: str) -> None:
        nonlocal at
        if upto > at:
            out.append((at, upto, name))
            at = upto

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(*stack.pop())
        if stack:
            emit(s, stack[-1][1])
        at = s if at is None else max(at, s)
        stack.append((e, name))
    while stack:
        emit(*stack.pop())
    return out


def attribute(busy: Sequence[Tuple[int, int]],
              pieces: Sequence[Tuple[int, int, str]]) -> Dict:
    """{"idle_ns": name -> ns, "outside_ns", "gap_ns"} of the gaps between
    consecutive busy intervals over the disjoint sorted pieces."""
    idle: Dict[str, int] = {}
    gap_ns = inside = 0
    j = 0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        if g1 <= g0:
            continue
        gap_ns += g1 - g0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                idle[name] = idle.get(name, 0) + ov
                inside += ov
            k += 1
    return {"idle_ns": idle, "outside_ns": gap_ns - inside, "gap_ns": gap_ns}


def idle(t: Dict, log: Optional[Dict] = None) -> Optional[Dict]:
    """The slice's idle time by stage-level span ("idle_ns",
    "outside_ns", "gap_ns") and the log's counters ("counts"), computed
    once a traced run and kept in `t`; None as the module says."""
    if _MEMO in t:
        return t[_MEMO]
    log = program_log() if log is None else log
    out = None
    if log is not None and log["spans"] and not log["dropped"]:
        level = [(s.start_ns, s.end_ns, s.name) for s in log["spans"]
                 if s.name.startswith(LEVEL)]
        out = attribute(common.busy_intervals(t["device_events"]),
                        segments(level))
        out["counts"] = dict(log["counts"])
    t[_MEMO] = out
    return out


def idle_ms_per_unit(t: Dict, span: str) -> Optional[float]:
    """Idle ms under `span` per request pair or step of the slice."""
    r = idle(t)
    if r is None or not t.get("units_prof"):
        return None
    return r["idle_ns"].get(span, 0) / t["units_prof"] / 1e6


def outside_share(t: Dict) -> Optional[float]:
    """The share of the slice's idle time under no stage-level span, %."""
    r = idle(t)
    if r is None or not r["gap_ns"]:
        return None
    return r["outside_ns"] / r["gap_ns"] * 100.0
