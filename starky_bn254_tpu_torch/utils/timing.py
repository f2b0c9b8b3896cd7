"""The port's one span recorder (the analogue of plonky2's TimingTree).

    tt = TimingTree("prove", device)        # the phase tree: barriers at its phases
    prove(air, trace, pi, cfg, timing=tt)
    print(tt.render()); tt.as_dict()        # for structured logging / bench JSON

    rec = Recorder("run")                   # spans only: no barrier anywhere
    with recording(rec):
        prove(air, trace, pi, cfg)          # prove's spans land in rec, under "prove"
    [(s.path, s.start_ns, s.end_ns, s.request, s.counts) for s in rec.spans]

Each span records its name and its parent (its `path`, "a/b/c" below the
recorder's root), its start and end on time.time_ns() (the clock of
torch.profiler's device trace), a request id (a caller's request or a
stream's batch: given, else the thread's `request(...)`, else the
parent's) and counts where its layer has them (rows, row blocks).

Two kinds of boundary:
- `scope(name)`: a prove's phase. In a TimingTree it synchronizes the card
  at both ends, so a phase's time includes the device work it launched
  (launches are asynchronous: without the barrier a multi-second commit
  reads as a few milliseconds and its time lands in whichever later phase
  first waits). In a Recorder it is a span.
- `span(name)`: finer work (tracegen's parts, composition's row blocks, the
  pipeline's stages). It never synchronizes, in either.

Code deep in the prover reaches the recorder through `current()`, set by
`recording(rec)` for the calling thread only (the entry points set the
one they were given; work handed to another thread takes its recorder as
an argument, as prove_pipelined's prefetch thread does). Where nobody
asked for timing it is NOOP: its scopes and spans are one shared
do-nothing context, so nothing is built and nothing synchronizes. Where
none is set while a torch.profiler trace runs, it is DEVICE_TRACE, a
Recorder that keeps the traced work's spans, to name what the device
trace shows. It keeps them until its `clear()`: a process that profiles
more than once clears it between, or records under a recorder of its
own. A recorder keeps its spans in memory until its caller reads them.
Each thread has its own stack: a thread's spans nest under its own open
spans only, never under another thread's.
"""

from __future__ import annotations

import threading
import time

import torch


def _sync(device) -> None:
    """A TimingTree's barrier at a phase boundary."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class Span:
    __slots__ = ("name", "path", "request", "start_ns", "end_ns", "counts", "children")

    def __init__(self, name: str, parent: Span | None, request, counts: dict, start_ns: int):
        self.name = name
        self.path = f"{parent.path}/{name}" if parent is not None and parent.path else name
        self.request = request if request is not None else (
            parent.request if parent is not None else None)
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.counts = counts
        self.children: list[Span] = []

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Null:
    """The shared do-nothing context of NOOP's scopes and spans."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_thread = threading.local()  # the thread's recorder (recording()) and request id (request())


class _Open:
    """One span of a recorder, opened on entry and closed on exit."""

    __slots__ = ("rec", "name", "request", "counts", "barrier", "span")

    def __init__(self, rec: Recorder, name: str, request, counts: dict, barrier: bool):
        self.rec, self.name, self.request, self.counts, self.barrier = (
            rec, name, request, counts, barrier)

    def __enter__(self) -> Span:
        if self.barrier:
            _sync(self.rec.device)
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        request = self.request if self.request is not None else getattr(_thread, "request", None)
        s = Span(self.name, parent, request, self.counts, time.time_ns())
        if parent is not None:
            parent.children.append(s)
        stack.append(s)
        self.span = s
        return s

    def __exit__(self, *exc):
        if self.barrier:
            _sync(self.rec.device)
        self.span.end_ns = time.time_ns()
        self.rec._stack().pop()
        self.rec.spans.append(self.span)
        return False


class Recorder:
    """Spans only: no boundary synchronizes. `spans` holds every closed
    span of every thread, in the order they closed."""

    active = True
    barriers = False  # whether scope() synchronizes the card (at self.device)

    def __init__(self, name: str = "root"):
        self.spans: list[Span] = []
        self.root = Span(name, None, None, {}, time.time_ns())
        self.root.path = ""  # the root names the recorder, not a level of the paths
        self._local = threading.local()
        self._local.stack = [self.root]

    def _stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:  # a thread's first span: its own stack, empty
            self._local.stack = []
            return self._local.stack

    def scope(self, name: str, **counts) -> _Open:
        """A phase (a TimingTree's barrier boundary)."""
        return _Open(self, name, None, counts, self.barriers)

    def span(self, name: str, request=None, **counts) -> _Open:
        """Finer work; never a barrier."""
        return _Open(self, name, request, counts, False)

    def add(self, name: str, start_ns: int, end_ns: int, request=None, **counts) -> Span:
        """A span timed elsewhere (another process's stamps), as a child of
        this thread's open span."""
        with self.span(name, request, **counts) as s:
            pass
        s.start_ns, s.end_ns = start_ns, end_ns
        return s

    def count(self, **counts) -> None:
        """Counts of this thread's innermost open span."""
        stack = self._stack()
        if stack:
            stack[-1].counts.update(counts)

    def clear(self) -> None:
        self.spans.clear()
        self.root.children.clear()

    def finish(self) -> None:
        self.root.end_ns = time.time_ns()

    def render(self) -> str:
        if self.root.end_ns is None:
            self.finish()
        lines: list[str] = []

        def walk(node: Span, depth: int):
            counts = "".join(f"  {k}={v}" for k, v in node.counts.items())
            lines.append(f"{'  ' * depth}{node.ms:9.1f}ms  {node.name}{counts}")
            for c in node.children:
                walk(c, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def as_dict(self) -> dict:
        if self.root.end_ns is None:
            self.finish()

        def walk(node: Span):
            d = {"name": node.name, "ms": node.ms}
            if node.request is not None:
                d["request"] = node.request
            if node.counts:
                d["counts"] = dict(node.counts)
            if node.children:
                d["children"] = [walk(c) for c in node.children]
            return d

        return walk(self.root)


class TimingTree(Recorder):
    """The phase tree: on a CUDA device its creation, finish() and both ends
    of every scope() synchronize the card; its spans never do."""

    barriers = True

    def __init__(self, name: str = "root", device=None):
        super().__init__(name)
        self.device = torch.device(device) if device is not None else None
        _sync(self.device)
        self.root.start_ns = time.time_ns()

    def finish(self) -> None:
        _sync(self.device)
        super().finish()


class _Noop:
    """No timing: nothing is built, nothing synchronizes."""

    active = False

    def scope(self, name: str, **counts) -> _Null:
        return _NULL

    def span(self, name: str, request=None, **counts) -> _Null:
        return _NULL

    def add(self, name: str, start_ns: int, end_ns: int, request=None, **counts) -> None:
        return None

    def count(self, **counts) -> None:
        pass

    def finish(self) -> None:
        pass


NOOP = _Noop()
# the spans of work run while torch.profiler traces and no recorder is set
DEVICE_TRACE = Recorder("device trace")


def _profiling() -> bool:
    """Whether a torch.profiler trace runs: the flag torch.profiler sets
    on entry and clears on exit (torch has no public one; the CPU tests
    hold it, so a torch that renames it fails a test, not the metrics)."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", False)


def current():
    """The recorder this thread set by recording(); else DEVICE_TRACE while
    a torch.profiler trace runs; else NOOP."""
    rec = getattr(_thread, "current", None)
    if rec is not None:
        return rec
    return DEVICE_TRACE if _profiling() else NOOP


def span(name: str, request=None, **counts):
    """current().span(...): a span of the current recorder."""
    return current().span(name, request, **counts)


def count(**counts) -> None:
    """Counts of the current recorder's innermost open span (this thread's)."""
    current().count(**counts)


class recording:
    """`with recording(rec):` makes rec this thread's current recorder
    (NOOP: none, even under a profiler; None: the default)."""

    __slots__ = ("rec", "_saved")

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self._saved = getattr(_thread, "current", None)
        _thread.current = self.rec
        return self.rec

    def __exit__(self, *exc):
        _thread.current = self._saved
        return False


class request:
    """`with request(i):` tags this thread's spans opened inside with
    request id i (a caller's request, a stream's batch)."""

    __slots__ = ("rid", "_saved")

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self):
        self._saved = getattr(_thread, "request", None)
        _thread.request = self.rid
        return self.rid

    def __exit__(self, *exc):
        _thread.request = self._saved
        return False


class entry(recording):
    """An entry point's recording (prove, fri_prove, prove_batch_fri,
    prove_pipelined): `with entry(timing, "prove") as rec:`. A recorder the
    caller passed as `timing` is the entry's own (its root stands for the
    entry) and is current inside; with None the entry records into
    current(), inside a span `name`."""

    __slots__ = ("_span",)

    def __init__(self, timing, name: str, **counts):
        super().__init__(timing if timing is not None else current())
        self._span = _NULL if timing is not None else self.rec.span(name, **counts)

    def __enter__(self):
        super().__enter__()
        self._span.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        return super().__exit__(*exc)
