"""The exchange of a rank grid spread over processes (``torch.distributed``).

Counterpart of the process-spanning collectives that the JAX package's
``shard_map`` programs run once ``jax.distributed`` joins the processes
(``nextsimdg_tpu/parallel/multiprocess.py``). Process p of the default
group holds ranks p K to p K + K - 1 of the grid (K =
``ranks_per_process``), each a thread of ``exchange.run_ranks``. A
``ProcessRing`` is an ``InProcessRing`` for those K ranks: a neighbour in
the same process goes through its mailbox, a neighbour in another process
through ``isend``/``irecv``, tagged by (source rank, axis, side, sequence
number), so model and kernel code see the same ``RankExchange`` interface.

Strips by backend:

* gloo on the CPU: the receives are posted at ``start``, the strips sent
  there (copies, so the sender may write its planes at once); ``wait``
  waits for the receives, then for this exchange's sends.
* gloo with ranks on a card (host-staged): at ``start`` the strip is copied
  into a pinned host buffer on the rank's copy stream after the compute
  stream's event, and sent once that copy's event has completed; the
  receives land in pinned buffers posted at ``start``, while the kernels
  issued before ``wait`` run. In ``wait`` each received buffer is copied to
  the card on the copy stream, and the compute stream waits on that copy's
  event, never on the whole device. A pinned buffer goes back to its
  rank's pool only once its send has completed or its copy's event has
  passed.
* nccl (a card for every process): one ``batch_isend_irecv`` a ``start``,
  the receives before the sends, the sends to a peer in the order of its
  receives. Written for clusters, and unverified: one card cannot host two
  NCCL ranks. One rank a process: NCCL matches a pair's messages by order,
  not by tag.

Gloo calls from the K rank threads of a process are issued under one lock;
the collectives (``max``'s all-reduce, ``gather_blocks``, ``all_true``) run
on one thread of each process, in the same order everywhere.

Faults: every wait keeps the ring's timeout (``exchange.WAIT_TIMEOUT``) and
a wait that runs out raises ``TimeoutError``. A process cannot wake its
threads out of a gloo wait, so ``abort`` calls ``on_abort`` (the worker of
``parallel.multiprocess`` writes its verdict and exits); a process that
exits closes its connections, and the waits of its peers fail at once.
"""

from __future__ import annotations

import datetime
import threading

import torch
import torch.distributed as dist

from ..state import tree_leaves, tree_map
from .exchange import WAIT_TIMEOUT, InProcessRing, RankExchange

_SIDES = {"from_prev": 0, "from_next": 1}


class ProcessRing(InProcessRing):
    """The ranks of this process in a grid over the default process group.

    ``devices``: one per rank of this process; ``ranks_per_process``: K, the
    same in every process (the group's size times K is the grid's rank
    count). ``on_abort``: called with the first failure after the ranks of
    this process were woken."""

    spans_processes = True

    def __init__(self, shape, devices, ranks_per_process: int, timeout: float = WAIT_TIMEOUT) -> None:
        if not dist.is_initialized():
            raise RuntimeError("a rank grid across processes needs torch.distributed: "
                               "call parallel.distributed.initialize first")
        k = int(ranks_per_process)
        self.process, self.n_processes = dist.get_rank(), dist.get_world_size()
        n = int(shape[0]) * int(shape[1])
        if k < 1 or self.n_processes * k != n:
            raise ValueError(
                f"a {shape[0]}x{shape[1]} grid has {n} ranks, not {self.n_processes} processes x {k}"
            )
        self.ranks_per_process = k
        super().__init__(shape, devices, timeout, local=range(self.process * k, (self.process + 1) * k))
        self.backend = dist.get_backend()
        cuda = {d.type for d in self.devices} == {"cuda"}
        if self.backend == "nccl" and (k != 1 or not cuda):
            raise ValueError("nccl carries one rank a process, on its card")
        self.staged = self.backend == "gloo" and cuda
        self._lock = threading.Lock()
        self._wait = datetime.timedelta(seconds=self.timeout)
        self.on_abort = None
        for rank in self.ranks:
            rank._remote = _Remote()
        # Each tag is unique among the messages in flight: the sequence
        # numbers wrap far beyond any exchange's lifetime.
        self._seq_wrap = (2**31 - 1) // (n * 4)

    # -- where the ranks live --------------------------------------------------
    def holds(self, rank: int) -> bool:
        return rank // self.ranks_per_process == self.process

    def process_of(self, rank: int) -> int:
        return rank // self.ranks_per_process

    def abort(self, exc: BaseException) -> None:
        super().abort(exc)
        if self.on_abort is not None:
            self.on_abort(exc)

    def reset(self) -> None:
        super().reset()
        for rank in self.ranks:
            rank._remote.forget()

    def _tag(self, src: int, axis: int, side: str, seq: int) -> int:
        return (((seq % self._seq_wrap) * self.n_ranks + src) * 2 + axis) * 2 + _SIDES[side]

    def _issue(self, call, /, *args, **kwargs):
        with self._lock:
            return call(*args, **kwargs)

    # -- point to point --------------------------------------------------------
    def _start_remote(self, rank, axis, seq, to_prev, to_next, event) -> None:
        state = rank._remote
        recvs, sends = [], []
        # What arrives from the -1 side has the shape of what this rank
        # sends to the +1 side (the neighbours run the same program).
        for like, step, side in ((to_next, -1, "from_prev"), (to_prev, 1, "from_next")):
            src = rank.neighbour(axis, step)
            if like is not None and src is not None and not self.holds(src):
                recvs.append((src, side, like))
        for strip, step, side in ((to_next, 1, "from_prev"), (to_prev, -1, "from_next")):
            dst = rank.neighbour(axis, step)
            if strip is not None and dst is not None and not self.holds(dst):
                sends.append((dst, side, strip))
        if not recvs and not sends:
            return
        if self.backend == "nccl":
            self._start_nccl(rank, axis, seq, recvs, sends, state)
            return
        for src, side, like in recvs:
            buf = state.take(like.shape, like.dtype, pinned=self.staged)
            work = self._issue(dist.irecv, buf, self.process_of(src), tag=self._tag(src, axis, side, seq))
            state.recvs[(axis, side, seq)] = (work, buf, src)
        for dst, side, strip in sends:
            if self.staged:
                buf = state.stage(rank, strip, event)
            else:
                buf = strip.detach().clone(memory_format=torch.contiguous_format)
            work = self._issue(dist.isend, buf, self.process_of(dst), tag=self._tag(rank.rank, axis, side, seq))
            state.sends.setdefault((axis, seq), []).append((work, buf))

    def _start_nccl(self, rank, axis, seq, recvs, sends, state) -> None:
        ops = []
        for src, side, like in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype, device=rank.device)
            ops.append(dist.P2POp(dist.irecv, buf, self.process_of(src)))
            state.recvs[(axis, side, seq)] = (None, buf, src)
        for dst, _, strip in sends:
            buf = strip.detach().contiguous()
            ops.append(dist.P2POp(dist.isend, buf, self.process_of(dst)))
            state.sends.setdefault((axis, seq), []).append((None, buf))
        works = dist.batch_isend_irecv(ops)
        state.batches[(axis, seq)] = works

    def _receive_remote(self, rank, key) -> torch.Tensor:
        _, axis, side, seq = key
        state = rank._remote
        work, buf, src = state.recvs.pop((axis, side, seq))
        if self.backend == "nccl":
            for batch_work in state.batches.pop((axis, seq), ()):
                batch_work.wait()
            return buf
        self._await(work, f"no strip {key} from rank {src}")
        if not self.staged:
            return buf
        compute, copy = rank.streams()
        with torch.cuda.stream(copy):
            out = torch.empty(buf.shape, dtype=buf.dtype, device=rank.device)
            out.copy_(buf, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        compute.wait_event(done)
        out.record_stream(compute)
        state.release(buf, done)
        return out

    def _end_remote(self, rank, axis, seq) -> None:
        state = rank._remote
        for batch_work in state.batches.pop((axis, seq), ()):
            batch_work.wait()
        for work, buf in state.sends.pop((axis, seq), ()):
            if work is not None:
                self._await(work, f"strip {(axis, seq)} of rank {rank.rank} not taken")
            if self.staged:
                state.release(buf, None)

    def _await(self, work, what: str) -> None:
        try:
            work.wait(self._wait)
        except RuntimeError as err:
            self._check()
            if "imed out" in str(err):
                raise TimeoutError(f"{what} within {self.timeout} s") from err
            raise RuntimeError(f"{what}: {err}") from err

    # -- collectives, one thread of each process -------------------------------
    def _host_or_card(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.devices[0]) if self.backend == "nccl" else t.cpu()

    def _reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        buf = self._host_or_card(t)
        self._issue(dist.all_reduce, buf, op=dist.ReduceOp.MAX)
        return buf.cpu()

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds in every process (an all-reduce MIN)."""
        buf = self._host_or_card(torch.tensor([1 if flag else 0], dtype=torch.int32))
        self._issue(dist.all_reduce, buf, op=dist.ReduceOp.MIN)
        return bool(buf.item())

    def barrier(self) -> None:
        self._issue(dist.barrier)

    def gather_blocks(self, blocks, root: int = 0):
        """Every rank's block (tensors or trees of them) on the host of
        process ``root``, in rank order; None in the other processes. All
        leaves of a process's blocks travel as one buffer in one gather."""
        leaves = tree_leaves(list(blocks))
        if len({leaf.dtype for leaf in leaves}) != 1:
            raise ValueError(f"blocks of one dtype gather as one buffer, got {sorted({str(x.dtype) for x in leaves})}")
        flat = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])
        if flat.is_cuda and self.backend != "nccl":
            flat = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True).copy_(flat)
        mine = self.process == root
        parts = [torch.empty_like(flat) for _ in range(self.n_processes)] if mine else None
        self._issue(dist.gather, flat, parts, dst=root)
        if not mine:
            return None
        out = []
        for part in parts:
            part, offset = part.cpu(), [0]

            def take(leaf):
                start = offset[0]
                offset[0] += leaf.numel()
                return part[start: offset[0]].view(leaf.shape)

            out.extend(tree_map(take, list(blocks)))
        return out


class _Remote:
    """A rank's traffic with other processes: the receives and sends in
    flight, and its pool of pinned host buffers (host-staged only)."""

    def __init__(self) -> None:
        self._free = {}
        self._busy = []
        self.forget()

    def forget(self) -> None:
        """Drop the traffic of an earlier run of the grid."""
        self.recvs, self.sends, self.batches = {}, {}, {}

    def take(self, shape, dtype, pinned: bool) -> torch.Tensor:
        if not pinned:
            return torch.empty(shape, dtype=dtype)
        still = []
        for buf, event in self._busy:
            if event is None or event.query():
                self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)
            else:
                still.append((buf, event))
        self._busy = still
        free = self._free.get((tuple(shape), dtype))
        return free.pop() if free else torch.empty(shape, dtype=dtype, pin_memory=True)

    def release(self, buf, event) -> None:
        """Back to the pool once ``event`` (a copy from it) has passed."""
        self._busy.append((buf, event))

    def stage(self, rank: RankExchange, strip: torch.Tensor, event) -> torch.Tensor:
        """A pinned host copy of ``strip``, made on the rank's copy stream
        after ``event`` (the compute stream's), complete on return."""
        buf = self.take(strip.shape, strip.dtype, pinned=True)
        _, copy = rank.streams()
        with torch.cuda.stream(copy):
            copy.wait_event(event)
            buf.copy_(strip, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy)
        strip.record_stream(copy)
        done.synchronize()
        return buf

