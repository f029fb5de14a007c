"""One process per rank for the block trainer: spawn, rendezvous, commands,
point-to-point block transfers and failure detection.

The reference runs one process per GPU and reconciles them over
`torch.distributed.rpc` (master_gaussian_trainer.py:201-786,
slave_gaussian_trainer.py:15-263). Here rank 0 is the caller's process and
ranks 1..R-1 are spawned (the `spawn` start method), each bound to its own
device (`cuda:<rank>`, or the CPU) and, when the caller is pinned to one
core, to a core of its own next to it. Every rank joins one
`torch.distributed` process group (NCCL on the card, gloo on the CPU)
through a `FileStore` in a temporary directory, so the rendezvous opens no
port.

Rank 0 drives the workers through one pipe each: a command is a method
name and its arguments, the worker runs the method of its own trainer and
replies with the result (or the traceback of the exception it raised, and
exits). A command may carry further messages on the same pipe while it runs
(the fusion sends each rank its rows). Collectives and tensor transfers use
the process group. A worker that dies, or never reports in, makes rank 0
raise within `timeout_s`: the reply wait watches each worker's process
sentinel as well as its pipe; a collective that waits on a dead rank ends
at the process group's timeout (gloo raises; NCCL's watchdog aborts the
process).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def backend_for(device: str = "cuda") -> str:
    return "nccl" if device == "cuda" else "gloo"


def rank_device(rank: int, device: str = "cuda") -> torch.device:
    return torch.device("cuda", rank) if device == "cuda" else torch.device(device)


def _core_for(rank: int, parent_cores: set[int]) -> int | None:
    """Rank `rank`'s core: the `rank`-th core after the caller's when the
    caller is pinned to one core, else None (the rank keeps the caller's
    affinity)."""
    if len(parent_cores) != 1:
        return None
    return (next(iter(parent_cores)) + rank) % (os.cpu_count() or 1)


def _init_group(backend: str, store_path: str, rank: int, world: int, timeout_s: float) -> None:
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


class RankGroup:
    """Rank 0's side: the spawned workers, their pipes and the process
    group. `start` returns once every rank has joined the group."""

    def __init__(self, world: int, procs: list, conns: list, tmpdir: str, timeout_s: float):
        self.world = world
        self.procs = procs
        self.conns = conns
        self.tmpdir = tmpdir
        self.timeout_s = timeout_s
        self.closed = False

    @classmethod
    def start(cls, world: int, timeout_s: float, target, payloads: list, device: str = "cuda") -> "RankGroup":
        """Spawn ranks 1..world-1 running `target(link, payload)` (a
        module-level function), wait for each to report in, then join the
        process group as rank 0. `payloads[r - 1]` is rank r's."""
        ctx = mp.get_context("spawn")
        if backend_for(device) == "nccl":
            # Every rank runs on this host: NCCL's bootstrap stays on the
            # loopback interface (the data goes over NVLink or PCIe).
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        tmpdir = tempfile.mkdtemp(prefix="dogs_ranks_")
        store_path = os.path.join(tmpdir, "store")
        backend = backend_for(device)
        cores = os.sched_getaffinity(0)
        procs, conns = [], []
        group = cls(world, procs, conns, tmpdir, timeout_s)
        try:
            for r in range(1, world):
                ours, theirs = ctx.Pipe()
                link = dict(rank=r, world=world, device=device, backend=backend, store=store_path,
                            timeout_s=timeout_s, core=_core_for(r, cores), threads=torch.get_num_threads())
                p = ctx.Process(target=_worker_entry, args=(link, theirs, target, payloads[r - 1]),
                                name=f"dogs-rank-{r}", daemon=True)
                p.start()
                theirs.close()
                procs.append(p)
                conns.append(ours)
            for r in range(1, world):
                if group._wait(r) != "ready":
                    raise RuntimeError(f"rank {r} did not report in")
            _init_group(backend, store_path, 0, world, timeout_s)
            group.replies()  # every worker has built its blocks
        except BaseException:
            group.close(force=True)
            raise
        return group

    def _wait(self, r: int):
        """The next message from rank r; raises when the rank dies or stays
        silent for timeout_s, or replied with its exception."""
        conn, proc = self.conns[r - 1], self.procs[r - 1]
        deadline = time.monotonic() + self.timeout_s
        while True:
            ready = mpc.wait([conn, proc.sentinel], timeout=max(deadline - time.monotonic(), 0.0))
            if conn in ready:
                try:
                    status, value = conn.recv()
                except EOFError:
                    status, value = "dead", None
                if status == "error":
                    raise RuntimeError(f"rank {r} raised:\n{value}")
                if status != "dead":
                    return value
            if proc.sentinel in ready or not proc.is_alive():
                proc.join(1.0)
                raise RuntimeError(f"rank {r} exited (code {proc.exitcode}) before replying")
            if not ready:
                raise TimeoutError(f"rank {r} sent nothing for {self.timeout_s:.0f} s")

    def send(self, r: int, obj) -> None:
        try:
            self.conns[r - 1].send(obj)
        except OSError as e:
            proc = self.procs[r - 1]
            proc.join(1.0)
            raise RuntimeError(f"rank {r} is gone (exit code {proc.exitcode})") from e

    def command(self, name: str, args_per_rank: list[tuple]) -> None:
        """Send command `name` to every worker (rank r gets
        `args_per_rank[r - 1]`)."""
        for r in range(1, self.world):
            self.send(r, (name, args_per_rank[r - 1]))

    def replies(self) -> list:
        """Every worker's reply to the last command, in rank order."""
        return [self._wait(r) for r in range(1, self.world)]

    def close(self, force: bool = False) -> None:
        """Stop the workers (a `close` command, then a join; terminate after
        the timeout or with `force`), then leave the process group and
        remove the store."""
        if self.closed:
            return
        self.closed = True
        for conn, proc in zip(self.conns, self.procs):
            if not force and proc.is_alive():
                try:
                    conn.send(("close", ()))
                except (BrokenPipeError, OSError):
                    pass
        deadline = time.monotonic() + (0.0 if force else min(self.timeout_s, 60.0))
        for proc in self.procs:
            proc.join(max(deadline - time.monotonic(), 0.0))
            if proc.is_alive():
                proc.terminate()
                proc.join(5.0)
        for conn in self.conns:
            conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmpdir, ignore_errors=True)


class WorkerLink:
    """A worker's side: its rank and its pipe to rank 0."""

    def __init__(self, link: dict, conn):
        self.rank, self.world = link["rank"], link["world"]
        self.conn = conn

    def recv(self):
        return self.conn.recv()


def _worker_entry(link: dict, conn, target, payload) -> None:
    """A spawned rank: pin, report in, join the group, then `target`. The
    rank leaves with `os._exit`, without tearing its communicators down:
    NCCL's teardown waits for every rank's, and rank 0 tears its own down
    only once the workers have gone."""
    if link["core"] is not None:
        try:
            os.sched_setaffinity(0, {link["core"]})
        except OSError:
            pass
    torch.set_num_threads(link["threads"])
    if link["device"] == "cuda":
        torch.cuda.set_device(link["rank"])
    conn.send(("ok", "ready"))
    code = 0
    try:
        _init_group(link["backend"], link["store"], link["rank"], link["world"], link["timeout_s"])
        target(WorkerLink(link, conn), payload)
    except (EOFError, KeyboardInterrupt):
        pass
    except BaseException:
        code = 1
        try:
            conn.send(("error", traceback.format_exc()))
        except (BrokenPipeError, OSError):
            pass
    try:
        if link["device"] == "cuda":
            torch.cuda.synchronize()  # this rank's last sends have left
    finally:
        conn.close()
        os._exit(code)


def serve(link: WorkerLink, obj) -> None:
    """A worker's command loop: run each command as `obj._<name>(*args)`
    and reply with its result, until `close` (or rank 0's end of the pipe
    closes). An exception is sent back to rank 0 and ends the worker."""
    link.conn.send(("ok", None))  # built
    while True:
        name, args = link.recv()
        if name == "close":
            return
        link.conn.send(("ok", getattr(obj, "_" + name)(*args)))


# ---- collectives and transfers ----------------------------------------------------


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op)
    return t


def send_tensors(tensors: list[torch.Tensor], dst: int) -> None:
    for t in tensors:
        dist.send(_wire(t).contiguous(), dst)


def recv_tensors(templates: list[torch.Tensor], src: int) -> list[torch.Tensor]:
    """Tensors shaped and typed as `templates`, on their devices, from rank
    `src` (which sent them with `send_tensors` in the same order)."""
    out = []
    for t in templates:
        buf = torch.empty(t.shape, dtype=_wire(t).dtype, device=t.device)
        dist.recv(buf, src)
        out.append(buf.view(torch.bool) if t.dtype == torch.bool else buf)
    return out


def _wire(t: torch.Tensor) -> torch.Tensor:
    """Booleans travel as bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t
