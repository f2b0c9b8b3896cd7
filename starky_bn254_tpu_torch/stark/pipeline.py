"""Pipelined proving: overlap host witness generation with proving on the card.

A proving service's end-to-end rate is bounded by max(tracegen, prove),
not their sum: witness generation runs on the host (numpy and the native
C++ chains) while the prove runs on the card. `prove_pipelined` keeps one
tracegen in flight ahead of the prove loop:

- Tracegen runs in a forked worker process, not a thread: its numpy
  sections would hold the GIL and starve the prove's dispatch loop, which
  issues tens of thousands of launches per prove. The child runs numpy and
  the native library only, never torch, caps the native chains at two
  threads (STARKY_NATIVE_THREADS) and lowers its priority, and streams
  the trace back over a pipe as raw words. Forks happen from the main
  thread while no prefetch thread is alive.
- A prefetch thread joins the worker, reads the pipe into a pinned host
  tensor and copies it to the card with `non_blocking=True` on a side
  stream, then records an event. Before the prove, the prove's stream
  waits on that event and the tensor is `record_stream`-ed to it, so the
  copy of batch i+1 overlaps the prove of batch i. A failed staging
  raises: there is no quiet return to a host trace.
- `utils.memhygiene.trim()` runs at every batch boundary.

Spans (utils.timing; none unless a caller set a recorder or a
torch.profiler trace runs), each batch's tagged with its index: on the
dispatch thread `pipeline` over the stream and under it, a batch each,
`wait` (in `_Prefetch.get()`), `fork` (the next batch's worker and
thread), `prove` (the parent of that prove's own spans) and `trim` (the
trace freed, `memhygiene.trim()`); on
the prefetch thread, a `pipeline` span a batch with `read` (the header
wait and the pipe read), `worker tracegen` (the child's own stamps,
sent in the pipe's header) and `copy` (the staging copy's launch; its
device time, `device_ms`, from an event pair on the side stream, read
once the stream has ended).

Steady state holds two traces on the card (the one being proved and the
next), ~212 MB each at the G1ExpAir(128) shape.
"""

from __future__ import annotations

import os
import signal
import struct
import threading
import time
import warnings

import numpy as np
import torch

from ..utils import memhygiene
from ..utils import timing as tm
from .air import Air
from .config import StarkConfig
from .proof import StarkProof
from .prover import _mesh_device, _prove_device, prove

# ok, trace rows, trace columns, public inputs (or message bytes), the
# child's tracegen start and end on time.time_ns()
_HEAD = struct.Struct("<?QQQqq")


def _child(air: Air, inputs, w: int) -> int:
    """The forked worker's body: tracegen, then the result on the pipe."""
    try:
        # leave the parent's dispatch thread a core: an uncapped native
        # tracegen beside a prove inflates the prove's wall clock
        os.nice(10)
    except OSError:
        pass
    os.environ.setdefault("STARKY_NATIVE_THREADS", "2")
    with os.fdopen(w, "wb") as f:
        t0 = time.time_ns()
        try:
            with tm.recording(tm.NOOP):  # spans made here would never reach the parent
                trace, pi = air.generate_trace_and_pi(inputs)
            trace = np.ascontiguousarray(trace, dtype=np.uint64)
            pi = np.ascontiguousarray(pi, dtype=np.uint64)
        except BaseException:
            import traceback

            msg = traceback.format_exc().encode()
            f.write(_HEAD.pack(False, 0, 0, len(msg), t0, time.time_ns()))
            f.write(msg)
            return 1
        f.write(_HEAD.pack(True, trace.shape[0], trace.shape[1], pi.shape[0], t0, time.time_ns()))
        f.write(memoryview(trace).cast("B"))
        f.write(memoryview(pi).cast("B"))
    return 0


def _read_into(f, buf: memoryview) -> None:
    got = 0
    while got < len(buf):
        k = f.readinto(buf[got:])
        if not k:
            raise RuntimeError(f"tracegen worker's pipe closed after {got} of {len(buf)} bytes")
        got += k


class _Tracegen:
    """One forked worker running air.generate_trace_and_pi(inputs).

    join() reads the result and reaps the child; cancel() kills and reaps
    it unless it is reaped already, so it never signals a PID that may
    since belong to another process. After join(), `stamps` holds the
    child's tracegen start and end (time.time_ns())."""

    def __init__(self, air: Air, inputs):
        r, w = os.pipe()
        with warnings.catch_warnings():
            # the process has torch's threads; the child touches none of
            # their state (numpy and the native library only)
            warnings.filterwarnings("ignore", message=".*fork", category=DeprecationWarning)
            pid = os.fork()
        if pid == 0:  # the child: no torch, no return into the caller's code
            code = 1
            try:
                os.close(r)
                code = _child(air, inputs, w)
            finally:
                os._exit(code)
        os.close(w)
        self.pid = pid
        self._r = os.fdopen(r, "rb")
        self._lock = threading.Lock()
        self._reaped = False
        self.stamps: tuple[int, int] | None = None

    def _reap(self) -> int:
        with self._lock:
            if self._reaped:
                return 0
            _, status = os.waitpid(self.pid, 0)
            self._reaped = True
            return status

    def join(self, pin: bool) -> tuple[torch.Tensor, np.ndarray]:
        """The trace as an int64 tensor (pinned when `pin`) and the public
        inputs; raises what the worker raised."""
        try:
            head = self._r.read(_HEAD.size)
            if len(head) < _HEAD.size:
                raise RuntimeError(
                    f"tracegen worker {self.pid} died before writing its header "
                    f"(wait status {self._reap()})")
            ok, rows, cols, k, t0, t1 = _HEAD.unpack(head)
            self.stamps = (t0, t1)
            if not ok:
                raise RuntimeError("tracegen worker raised:\n"
                                   + self._r.read(k).decode(errors="replace"))
            trace = torch.empty((rows, cols), dtype=torch.int64, pin_memory=pin)
            _read_into(self._r, memoryview(trace.numpy()).cast("B"))
            pi = np.empty(k, dtype=np.uint64)
            _read_into(self._r, memoryview(pi).cast("B"))
        finally:
            self._r.close()
            self._reap()
        return trace, pi

    def cancel(self) -> None:
        with self._lock:
            if self._reaped:
                return
            try:
                os.kill(self.pid, signal.SIGKILL)
            except ProcessLookupError:  # exited, not yet reaped
                pass
            os.waitpid(self.pid, 0)
            self._reaped = True


class _Prefetch:
    """Joins a tracegen worker and stages its trace on `device` from a
    thread: on a card, a copy on `stream` from pinned memory, ended by an
    event the prove's stream waits on. Its spans go to `rec`, tagged with
    the batch's index; with an active recorder on a card, `copy_timing`
    holds the copy's span and its start and end events."""

    def __init__(self, tracegen: _Tracegen, device: torch.device, stream, rec, batch: int):
        self._tracegen = tracegen
        self._result = None
        self._exc = None
        self.copy_timing = None
        self._thread = threading.Thread(target=self._run, args=(device, stream, rec, batch),
                                        daemon=True)
        self._thread.start()

    def _run(self, device, stream, rec, batch):
        try:
            with rec.span("pipeline", request=batch):
                self._stage(device, stream, rec)
        except BaseException as e:  # raised again by get()
            self._exc = e

    def _stage(self, device, stream, rec):
        with rec.span("read"):
            host, pi = self._tracegen.join(pin=stream is not None)
        rec.add("worker tracegen", *self._tracegen.stamps, rows=host.shape[0])
        if stream is None:
            with rec.span("copy"):
                self._result = (host.to(device), pi, None)
            return
        timed = rec.active
        with rec.span("copy") as span, torch.cuda.stream(stream):
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            trace = host.to(device, non_blocking=True)
            done = torch.cuda.Event(enable_timing=timed)
            done.record(stream)
        if timed:
            self.copy_timing = (span, start, done)
        self._result = (trace, pi, done)

    def get(self) -> tuple[torch.Tensor, np.ndarray]:
        """The staged trace, ready for the current stream, and its public
        inputs."""
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        trace, pi, done = self._result
        if done is not None:
            current = torch.cuda.current_stream(trace.device)
            current.wait_event(done)
            trace.record_stream(current)
        return trace, pi

    def abort(self) -> None:
        """Kill the worker (its pipe closes, so the thread's read ends) and
        wait for the thread."""
        self._tracegen.cancel()
        self._thread.join(timeout=60)


def prove_pipelined(
    air: Air,
    input_batches: list,
    cfg: StarkConfig,
    on_proof=None,
    device=None,
    mesh=None,
) -> list[StarkProof]:
    """Proves one statement per input batch, overlapping batch i+1's trace
    generation (forked worker) and its copy to the card with batch i's
    prove. Each element of `input_batches` is the `inputs` list
    `air.generate_trace_and_pi` takes. Returns the proofs in order, each
    byte-identical to a sequential `prove` of the same inputs.

    `on_proof(i, wall_time)` fires as each proof completes; a service's
    steady rate times from the first completed proof, excluding the fill
    (batch 0's tracegen and copy have nothing to overlap with). device:
    where the proves run; None is the current CUDA device, and raises when
    there is no card. mesh: a parallel.sharded.Mesh each prove runs over
    (prove's mesh); the traces are staged on its first device. Its spans
    (module docstring) go to utils.timing.current()."""
    dev = _prove_device(device) if mesh is None else _mesh_device(mesh, device)
    if not input_batches:
        return []
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    proofs: list[StarkProof] = []
    copies = []
    with tm.entry(None, "pipeline", batches=len(input_batches)) as rec:
        prefetch = _Prefetch(_Tracegen(air, input_batches[0]), dev, stream, rec, 0)
        try:
            for i in range(len(input_batches)):
                with tm.request(i):
                    with rec.span("wait"):
                        trace, pi = prefetch.get()
                        if prefetch.copy_timing is not None:
                            copies.append(prefetch.copy_timing)
                        prefetch = None
                    if i + 1 < len(input_batches):
                        # fork first (no prefetch thread is alive here), then
                        # hand the worker to the next prefetch thread
                        with rec.span("fork"):
                            prefetch = _Prefetch(_Tracegen(air, input_batches[i + 1]), dev,
                                                 stream, rec, i + 1)
                    proofs.append(prove(air, trace, pi, cfg, mesh=mesh, device=dev))
                    with rec.span("trim"):
                        del trace
                        memhygiene.trim()
                if on_proof is not None:
                    on_proof(i, time.time())
        except BaseException:
            # the in-flight worker must not run on unsupervised
            if prefetch is not None:
                prefetch.abort()
            raise
    for span, start, done in copies:  # the stream has ended: read the copies' device times
        done.synchronize()
        span.counts["device_ms"] = start.elapsed_time(done)
    return proofs
