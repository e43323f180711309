"""The port's spans and counters, and its per-phase accounting.

Counterpart of sdn3d_tpu/utils/phases.py.  `phase(name)` opens a span and
`count(name, n)` adds to a counter; both record while the phase records
are on (`reset(True)`) or while a torch profiler runs, and cost one branch
and no allocation otherwise.

- Phase records on: each span adds its wall seconds and a call to its
  name's phase record, with the host<->device bytes `add_bytes` gives it,
  and each counter adds to its own; `snapshot()` reads both.  Device-phase
  callers route results through `block()`, which then synchronises the
  card, so a phase's wall time includes the device work it launched (this
  serialises phases that could otherwise overlap: the breakdown is for
  attribution).
- Under a profiler: each span also opens a host event of its name on the
  profiler's timeline, and goes into a bounded log with its start and end
  in `time.time_ns()` (the profiler's clock), the span it opened inside
  and an id shared by every span of one request or training step (the
  id given to the outermost span).  Counters go into the log's totals.
  `profiled()` reads and empties the log; `reset()` leaves it alone.

Usage:
    from sdn3d_tpu_torch.utils import phases
    with phases.phase("chain.request", request_id):
        with phases.phase("geo.render"):
            out = phases.block(fn(x))      # synchronise iff phase records on
    phases.add_bytes("geo.fetch", arr)     # count a host fetch
    phases.count("count.encode")
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# torch.profiler.record_function and NVTX ranges open user annotations,
# which kineto mirrors on the card as `gpu_user_annotation` device events:
# a trace reader that takes every CUDA event as device work would count
# each span as busy time.  _RecordFunctionFast puts a plain host event on
# the timeline, as an aten operator's, and nothing on the card.
try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:                        # older torch: the log alone
    _RecordFunctionFast = None

enabled = False
LOG_CAP = 1 << 18                          # spans the profiled log keeps

_LOCK = threading.Lock()
# name -> [seconds, calls, bytes, first_call_seconds]
_TIMES: Dict[str, List[float]] = {}
_COUNTS: Dict[str, int] = {}


class Span(NamedTuple):
    """One closed span of the profiled log: `sid` its own id, `parent`
    the sid of the span it opened inside (0 at the top), `rid` the id of
    its request or step (None where no enclosing span gave one)."""
    name: str
    start_ns: int
    end_ns: int
    sid: int
    parent: int
    rid: Optional[int]


_SPANS: List[Span] = []
_PROF_COUNTS: Dict[str, int] = {}
_dropped = 0
_SIDS = itertools.count(1)
_LOCAL = threading.local()


def _open_spans() -> list:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class _Off:
    """The span returned while nothing records: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rid", "sid", "parent", "start", "_logged", "_rf")

    def __init__(self, name: str, rid: Optional[int]):
        self.name = name
        self.rid = rid

    def __enter__(self):
        stack = _open_spans()
        up = stack[-1] if stack else None
        self.parent = up.sid if up is not None else 0
        if self.rid is None and up is not None:
            self.rid = up.rid
        self.sid = next(_SIDS)
        stack.append(self)
        self._logged = _autograd_profiler._is_profiler_enabled
        self._rf = (_RecordFunctionFast(self.name) if self._logged
                    and _RecordFunctionFast is not None else None)
        self.start = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.time_ns()
        _open_spans().pop()
        global _dropped
        with _LOCK:
            if enabled:
                dt = (end - self.start) / 1e9
                rec = _TIMES.setdefault(self.name, [0.0, 0, 0, 0.0])
                if rec[1] == 0:
                    rec[3] = dt      # first call carries one-time set-up
                rec[0] += dt
                rec[1] += 1
            if self._logged:
                if len(_SPANS) < LOG_CAP:
                    _SPANS.append(Span(self.name, self.start, end, self.sid,
                                       self.parent, self.rid))
                else:
                    _dropped += 1
        return False


def phase(name: str, rid: Optional[int] = None):
    """A span named `name`, as a context manager.  `rid` is the id of its
    request or step; without one it takes the enclosing span's."""
    if enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name, rid)
    return _OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    if enabled or _autograd_profiler._is_profiler_enabled:
        with _LOCK:
            if enabled:
                _COUNTS[name] = _COUNTS.get(name, 0) + n
            if _autograd_profiler._is_profiler_enabled:
                _PROF_COUNTS[name] = _PROF_COUNTS.get(name, 0) + n


def reset(on: bool = True) -> None:
    """Clear the phase records and counters and turn them on or off; the
    profiled log stays."""
    global enabled
    with _LOCK:
        _TIMES.clear()
        _COUNTS.clear()
        enabled = on


def profiled() -> Dict[str, object]:
    """The log of what recorded under a profiler since the last read:
    "spans" (Span, in the order they closed), "counts" (name -> total)
    and "dropped" (spans past LOG_CAP).  Reading empties the log."""
    global _dropped
    with _LOCK:
        out = {"spans": list(_SPANS), "counts": dict(_PROF_COUNTS),
               "dropped": _dropped}
        _SPANS.clear()
        _PROF_COUNTS.clear()
        _dropped = 0
    return out


def block(tree):
    """torch.cuda.synchronize() iff the phase records are on and the card
    is in use (so instrumented phases charge their own device work instead
    of the next fetch).  Returns `tree` unchanged."""
    if enabled and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


def _nbytes(x) -> int:
    """Bytes of a tensor, an array or a HostFetch (0 for anything else)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0))


def add_bytes(name: str, *arrays) -> None:
    """Attribute transfer volume (either direction) to a phase."""
    if not enabled:
        return
    n = sum(_nbytes(a) for a in arrays)
    with _LOCK:
        rec = _TIMES.setdefault(name, [0.0, 0, 0, 0.0])
        rec[2] += n


def snapshot() -> Dict[str, Dict[str, float]]:
    """Each phase record ({"s", "calls", "MB"}; first_s isolates the first
    call and steady_avg_s is the per-call mean over the remaining calls,
    the serving rate) and each counter ({"n"}), by name."""
    with _LOCK:
        out = {}
        for k, v in sorted(_TIMES.items()):
            rec = {"s": v[0], "calls": v[1], "MB": v[2] / 1e6}
            if v[1] > 1:
                rec["first_s"] = v[3]
                rec["steady_avg_s"] = (v[0] - v[3]) / (v[1] - 1)
            out[k] = rec
        for k, n in sorted(_COUNTS.items()):
            out[k] = {"n": n}
        return out
