"""The in-process exchange of a rank grid: halo strips and a max reduction.

Counterpart of the collectives that ``jax.shard_map`` code runs over a
device mesh (``lax.ppermute`` of halo strips in
``nextsimdg_tpu/dynamics/stencil.py``, ``lax.pmax`` in
``nextsimdg_tpu/dynamics/transport.py``). Here the ranks of a P x Q grid
are threads of one process (``run_ranks``), each holding its block on its
device; several or all of them may share one card, which NCCL and
``torch.distributed`` cannot do (neither puts two ranks on one GPU).

Each rank talks to the grid through its ``RankExchange``, whose interface
is kept narrow so that a ring spanning processes
(``parallel.process_exchange.ProcessRing``, over ``torch.distributed``)
implements the same one: per axis (``RankExchange.axes``), ``start`` posts
a strip to the -1 and/or the +1 neighbour and ``wait`` returns the neighbours' strips
(zeros at a closed global wall); ``max`` reduces a small tensor over all
ranks and returns it on the host. An axis of the grid is closed or
periodic (``InProcessRing.periodic``, the global mesh's axes): on a
periodic axis the neighbours form a ring, the last rank's +1 neighbour
being the first (the counterpart of ``lax.ppermute`` over a ring
permutation), so an axis of one rank is its own neighbour on either side,
and nothing is a wall.

On CUDA every rank has a compute stream (its thread's current stream while
it steps) and a copy stream. ``start`` records an event on the compute
stream after the strips are staged; ``wait`` makes the receiver's copy
stream wait on the sender's event, copies the strip into a buffer of the
receiver's (a peer copy when the devices differ), and makes the receiver's
compute stream wait on the copy's event, never on the whole device. The
host only blocks until the sender has posted its strip, which it does as
soon as it has issued the work before it, so the copy runs on the device
while the kernels issued before the ``wait`` still run. ``max`` costs one
device-to-host copy for the whole grid.

An exception in one rank aborts the others: every wait has a timeout and
returns at once, raising ``RankAborted``, once any rank has failed.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

#: Seconds any rank waits for a neighbour's strip or the reduction before
#: the grid is declared hung and aborted.
WAIT_TIMEOUT = 300.0


class RankAborted(RuntimeError):
    """Raised in a rank whose grid was aborted by another rank's failure."""


@dataclass
class _Posted:
    strip: torch.Tensor
    event: object  # the sender's torch.cuda.Event, or None on the CPU


class InProcessRing:
    """The shared mailbox of the ranks of one grid.

    ``shape`` = (px, py) ranks; ``devices`` = one torch.device per rank
    this process holds, in row-major rank order (rank = ix * py + iy);
    ``local``: the ranks this process holds (default: all, the grid lives
    in this process). ``periodic``: (x, y), whether each axis is a ring;
    closed until ``RankGrid.periodic`` sets it. On CUDA devices each rank
    gets its own compute and copy streams.

    A strip is posted under the key (receiving rank, axis, side, sequence
    number), side being the edge it arrives at: on a ring of two ranks both
    neighbours are the same rank, and its two strips of one exchange stay
    apart by their sides.
    """

    def __init__(self, shape, devices, timeout: float = WAIT_TIMEOUT, local=None) -> None:
        self.shape = (int(shape[0]), int(shape[1]))
        self.periodic = (False, False)
        self.n_ranks = self.shape[0] * self.shape[1]
        local = list(range(self.n_ranks)) if local is None else [int(r) for r in local]
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != len(local):
            raise ValueError(f"{len(local)} ranks need {len(local)} devices, got {len(devices)}")
        self.timeout = float(timeout)
        self._cond = threading.Condition()
        self._mail = {}
        self._barrier = threading.Barrier(len(local), timeout=self.timeout)
        self._reduce_in = [None] * len(local)
        self._reduce_out = None
        self._failure = None
        # Each run of the grid (run_ranks) is a generation; a rank thread
        # left behind by an earlier run raises at its next exchange.
        self._generation = 0
        self.ranks = [RankExchange(self, r, i) for i, r in enumerate(local)]

    # -- where the ranks live --------------------------------------------------
    #: Whether ranks of the grid live in other processes.
    spans_processes = False

    def holds(self, rank: int) -> bool:
        """Whether this process holds ``rank`` (every rank, in process)."""
        return True

    def _start_remote(self, rank, axis, seq, to_prev, to_next, event) -> None:
        """Post the strips of a ``start`` that cross to another process, and
        their answers' receives (none: every neighbour is in process)."""

    def _end_remote(self, rank, axis, seq) -> None:
        """Release what a ``wait`` sent to other processes (nothing here)."""

    def _reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The max over the processes of this process's reduction (itself)."""
        return t

    # -- failure -------------------------------------------------------------
    def abort(self, exc: BaseException) -> None:
        """Wake every waiting rank with ``RankAborted``; the first failure
        is kept."""
        with self._cond:
            if self._failure is None:
                self._failure = exc
            self._cond.notify_all()
        self._barrier.abort()

    def reset(self) -> None:
        """Clear a failure and the mailbox, so that the grid can run again;
        start a new generation."""
        with self._cond:
            self._failure = None
            self._mail.clear()
            self._generation += 1
            self._cond.notify_all()
        self._barrier.reset()

    def _stale(self) -> bool:
        """Whether the calling thread belongs to an earlier run."""
        generation = getattr(threading.current_thread(), "ring_generation", None)
        return generation is not None and generation != self._generation

    def _check(self) -> None:
        if self._failure is not None:
            raise RankAborted(f"another rank failed: {self._failure!r}")
        if self._stale():
            raise RankAborted("this rank's run of the grid was aborted")

    # -- point to point ------------------------------------------------------
    def _post(self, key, posted: _Posted) -> None:
        with self._cond:
            self._check()
            self._mail[key] = posted
            self._cond.notify_all()

    def _take(self, key) -> _Posted:
        with self._cond:
            ready = self._cond.wait_for(
                lambda: key in self._mail or self._failure is not None or self._stale(),
                self.timeout,
            )
            self._check()
            if not ready:
                raise TimeoutError(f"no strip {key} within {self.timeout} s")
            return self._mail.pop(key)

    # -- reduction -------------------------------------------------------------
    def _barrier_wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            self._check()
            raise TimeoutError(f"the ranks did not meet within {self.timeout} s") from None


class RankExchange:
    """One rank's exchange: its coordinates in the grid and its collectives.
    ``rank`` is its index in the grid, ``local`` its index among the ranks
    of its process (the same where the grid lives in one process)."""

    def __init__(self, ring: InProcessRing, rank: int, local: int = None) -> None:
        self.ring = ring
        self.rank = rank
        self.local = rank if local is None else local
        self.shape = ring.shape
        self.coords = divmod(rank, ring.shape[1])
        self.device = ring.devices[self.local]
        self.axes = (AxisExchange(self, 0), AxisExchange(self, 1))
        self._streams = None
        self._in_flight = []
        self._local = threading.local()

    def _seq(self):
        """The calling thread's count of exchanges per axis: each run of
        the grid starts its rank threads at zero, and a thread left behind
        by an earlier run keeps its own."""
        if not hasattr(self._local, "seq"):
            self._local.seq = [0, 0]
        return self._local.seq

    def streams(self):
        """(compute, copy) CUDA streams of this rank; None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._streams is None:
            self._streams = (
                torch.cuda.Stream(self.device), torch.cuda.Stream(self.device)
            )
        return self._streams

    def neighbour(self, axis: int, step: int):
        """The rank index of the neighbour ``step`` (+-1) along ``axis``, or
        None beyond a closed global wall; on a periodic axis the ranks form
        a ring (an axis of one rank is its own neighbour)."""
        coords = list(self.coords)
        coords[axis] += step
        if not 0 <= coords[axis] < self.shape[axis]:
            if not self.ring.periodic[axis]:
                return None
            coords[axis] %= self.shape[axis]
        return coords[0] * self.shape[1] + coords[1]

    def _record(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _receive(self, posted: _Posted) -> torch.Tensor:
        """A copy of the neighbour's strip on this rank's device, ordered
        on its compute stream after the copy (see the module docstring)."""
        strip = posted.strip
        if self.device.type != "cuda":
            return strip.to(self.device, copy=True)
        compute, copy = self.streams()
        self._in_flight = [(e, s) for e, s in self._in_flight if not e.query()]
        with torch.cuda.stream(copy):
            copy.wait_event(posted.event)
            buf = torch.empty(strip.shape, dtype=strip.dtype, device=self.device)
            buf.copy_(strip, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        compute.wait_event(done)
        buf.record_stream(compute)
        # The sender's strip stays referenced until the copy has run.
        self._in_flight.append((done, strip))
        return buf

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over all ranks, on the host (one
        device-to-host copy for the ranks of a process, made by its first
        rank; across processes one all-reduce of that host copy)."""
        ring = self.ring
        ring._check()
        ring._reduce_in[self.local] = _Posted(t, self._record())
        ring._barrier_wait()
        if self.local == 0:
            parts = []
            for posted in ring._reduce_in:
                if posted.event is not None:
                    torch.cuda.current_stream(self.device).wait_event(posted.event)
                parts.append(posted.strip.to(self.device))
            ring._reduce_out = ring._reduce_max(torch.stack(parts).amax(dim=0).cpu())
        ring._barrier_wait()
        return ring._reduce_out


class AxisExchange:
    """A rank's exchange along one grid axis: the counterpart of a device
    mesh axis name."""

    def __init__(self, rank: RankExchange, axis: int) -> None:
        self.rank = rank
        self.axis = axis

    @property
    def size(self) -> int:
        """Ranks along this axis."""
        return self.rank.shape[self.axis]

    @property
    def index(self) -> int:
        """This rank's coordinate along this axis."""
        return self.rank.coords[self.axis]

    @property
    def periodic(self) -> bool:
        """Whether this axis is a ring: no rank holds a global wall."""
        return self.rank.ring.periodic[self.axis]

    def start(self, to_prev, to_next):
        """Post ``to_prev`` to the -1 neighbour and ``to_next`` to the +1
        neighbour (either may be None: nothing is sent that way), after the
        work already issued that produces them. Returns the handle for
        ``wait``."""
        rank, ring = self.rank, self.rank.ring
        counts = rank._seq()
        seq = counts[self.axis]
        counts[self.axis] += 1
        event = rank._record()
        ring._start_remote(rank, self.axis, seq, to_prev, to_next, event)
        for strip, step, side in ((to_prev, -1, "from_next"), (to_next, 1, "from_prev")):
            dst = rank.neighbour(self.axis, step)
            if strip is not None and dst is not None and ring.holds(dst):
                ring._post((dst, self.axis, side, seq), _Posted(strip, event))
        return seq, to_prev, to_next

    def wait(self, handle):
        """(from_prev, from_next): the -1 neighbour's ``to_next`` and the +1
        neighbour's ``to_prev`` strips of the matching ``start`` (on a ring
        the wrapped neighbour's), zeros beyond a closed global wall, None
        where nothing was sent."""
        seq, to_prev, to_next = handle
        rank, ring = self.rank, self.rank.ring
        out = []
        # What arrives from the -1 side has the shape of what this rank sends
        # to the +1 side, and the other way round.
        for like, step, side in ((to_next, -1, "from_prev"), (to_prev, 1, "from_next")):
            src = rank.neighbour(self.axis, step)
            if like is None:
                out.append(None)
            elif src is None:
                out.append(torch.zeros_like(like))
            elif ring.holds(src):
                out.append(rank._receive(ring._take((rank.rank, self.axis, side, seq))))
            else:
                out.append(ring._receive_remote(rank, (rank.rank, self.axis, side, seq)))
        ring._end_remote(rank, self.axis, seq)
        return tuple(out)


def run_ranks(ring: InProcessRing, fn):
    """Run ``fn(rank_exchange)`` for every rank of ``ring`` that this
    process holds, each in its own thread (on CUDA with the rank's device
    current and its compute stream as the current stream), and return the
    results in rank order (``RankExchange.local``).

    On CUDA each rank's compute stream first waits for the work already
    issued on the caller's current stream, and the caller's stream waits
    for the ranks' work before this returns. An exception in one rank
    aborts the others (they raise ``RankAborted`` at their next wait); the
    first one is raised here. A rank still running after the ring's timeout
    aborts the grid with ``TimeoutError``; so does a rank that has not
    stopped the ring's timeout after an abort (it is left behind: a daemon
    thread). Each rank's thread takes the caller's intra-op thread count
    (``torch.get_num_threads``): a new thread's OpenMP default is every
    core, which every rank of a grid on the CPU would take at once.
    """
    ring.reset()
    n_threads = torch.get_num_threads()
    starts = {}
    for rank in ring.ranks:
        if rank.device.type == "cuda" and rank.device not in starts:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(rank.device))
            starts[rank.device] = event
    results = [None] * len(ring.ranks)
    errors = [None] * len(ring.ranks)
    ends = [None] * len(ring.ranks)

    def body(rank: RankExchange) -> None:
        try:
            torch.set_num_threads(n_threads)
            streams = rank.streams()
            if streams is None:
                results[rank.local] = fn(rank)
                return
            torch.cuda.set_device(rank.device)
            streams[0].wait_event(starts[rank.device])
            with torch.cuda.stream(streams[0]):
                results[rank.local] = fn(rank)
                ends[rank.local] = rank._record()
        except BaseException as exc:  # noqa: BLE001 - handed to the caller below
            errors[rank.local] = exc
            if not ring._stale():  # a rank left behind must not abort a later run
                ring.abort(exc)

    threads = [
        threading.Thread(target=body, args=(rank,), name=f"rank{rank.rank}", daemon=True)
        for rank in ring.ranks
    ]
    for thread in threads:
        thread.ring_generation = ring._generation
        thread.start()
    _wait_for(ring, threads)
    first = next((e for e in errors if e is not None and not isinstance(e, RankAborted)), None)
    if first is None:
        first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    for rank, event in zip(ring.ranks, ends):
        if event is not None:
            torch.cuda.current_stream(rank.device).wait_event(event)
    return results


def _wait_for(ring: InProcessRing, threads) -> None:
    """Until every rank thread has stopped: abort the grid after the ring's
    timeout, and raise ``TimeoutError`` for ranks that have not stopped the
    ring's timeout after an abort."""
    start, aborted_at = time.monotonic(), None
    while any(thread.is_alive() for thread in threads):
        now = time.monotonic()
        if ring._failure is None and now - start > ring.timeout:
            ring.abort(TimeoutError(f"the ranks still ran after {ring.timeout} s"))
        if ring._failure is not None:
            aborted_at = now if aborted_at is None else aborted_at
            if now - aborted_at > ring.timeout:
                hung = [thread.name for thread in threads if thread.is_alive()]
                raise TimeoutError(f"ranks {hung} did not stop after the grid was aborted")
        next(thread for thread in threads if thread.is_alive()).join(0.01)
