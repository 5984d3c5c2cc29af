"""The ranks of one machine: their devices, their backend, and spawning them.

JAX drives every local device from one process; the port runs one process a
device slot. Rank ``r`` takes ``cuda:(LOCAL_RANK % device_count)`` (or the
CPU). NCCL refuses two ranks on one device, so ranks that share a device
(more ranks than cards, as on a machine with one H100) and CPU ranks take
gloo; ranks with a card each take NCCL. :func:`spawn` starts ``n`` ranks
with ``torch.multiprocessing`` (the spawn start method: CUDA does not
survive a fork), joins them into one process group over
``tcp://localhost:<free port>`` and returns each rank's result.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import socket
import tempfile
from pathlib import Path

import torch


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def rank_device(device_type: str, rank: int | None = None) -> torch.device:
    """The device of local rank ``rank`` (this process's by default):
    ``cuda:(rank % device_count)``, or the CPU. Raises for ``cuda`` without
    a card (:func:`..utils.timing.require_device`)."""
    from ..utils.timing import require_device

    if torch.device(device_type).type == "cpu":
        return torch.device("cpu")
    require_device("cuda")
    rank = local_rank() if rank is None else rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device_type: str, local_ranks: int) -> str:
    """``"gloo"`` on the CPU and where ``local_ranks`` ranks share fewer
    cards (NCCL refuses two ranks on one device), else ``"nccl"``."""
    if torch.device(device_type).type == "cpu":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def free_port() -> int:
    """A free TCP port on ``localhost``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def placement(device_type: str, world: int) -> str:
    """``gloo, 2 ranks: cuda:0, cuda:0``: the backend and every rank's
    device, for the CLIs' ``route:`` lines."""
    if torch.device(device_type).type == "cpu":
        devices = ["cpu"] * world
    else:
        devices = [str(rank_device("cuda", r)) for r in range(world)]
    return f"{backend_for(device_type, world)}, {world} ranks: {', '.join(devices)}"


def _entry(rank: int, fn, world: int, port: int, device_type: str, threads: int | None,
           quiet: bool, out_dir: str) -> None:
    from .multihost import initialize

    args = torch.load(Path(out_dir) / "args.pt", weights_only=False)

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if threads is not None:
        torch.set_num_threads(threads)
    if torch.device(device_type).type == "cuda":
        torch.cuda.set_device(rank_device("cuda", rank))
    initialize(f"localhost:{port}", world, rank, device_type)
    sink = contextlib.redirect_stdout(io.StringIO()) if quiet and rank else contextlib.nullcontext()
    try:
        with sink:
            result = fn(*args)
        torch.save(result, Path(out_dir) / f"{rank}.pt")
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Ranks started by :func:`start`; :meth:`join` waits for them."""

    def __init__(self, context, out_dir: str, world: int):
        self._context, self._out_dir, self._world = context, out_dir, world

    def join(self) -> list:
        """Wait for every rank; return their results in rank order (each
        saved with ``torch.save`` and loaded here, on the CPU). A rank that
        raised makes this raise (``torch.multiprocessing.ProcessRaisedException``)."""
        try:
            while not self._context.join():
                pass
            return [torch.load(Path(self._out_dir) / f"{r}.pt", map_location="cpu",
                               weights_only=False) for r in range(self._world)]
        finally:
            shutil.rmtree(self._out_dir, ignore_errors=True)


def start(fn, world: int, args: tuple = (), device_type: str = "cpu",
          threads: int | None = None, quiet: bool = False) -> Ranks:
    """Start ``fn(*args)`` on ``world`` new ranks of one process group and
    return at once (:meth:`Ranks.join` collects their results). ``fn`` must
    be importable by name (the spawn start method pickles it by reference).
    ``threads``: each rank's torch threads; ``quiet``: ranks past 0 print
    nothing."""
    import torch.multiprocessing as mp

    port = free_port()
    out_dir = tempfile.mkdtemp(prefix="rajni-ranks-")
    # the arguments go through a file: through the spawn pipe, large ones would
    # hold each start until the rank before had imported torch and read them
    torch.save(args, Path(out_dir) / "args.pt")
    context = mp.start_processes(_entry, args=(fn, world, port, device_type, threads, quiet,
                                               out_dir),
                                 nprocs=world, join=False, start_method="spawn")
    return Ranks(context, out_dir, world)


def spawn(fn, world: int, args: tuple = (), device_type: str = "cpu",
          threads: int | None = None, quiet: bool = False) -> list:
    """:func:`start`, then :meth:`Ranks.join`: ``fn(*args)`` on ``world``
    ranks, their results in rank order."""
    return start(fn, world, args, device_type, threads, quiet).join()
