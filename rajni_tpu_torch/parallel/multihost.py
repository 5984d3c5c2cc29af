"""Process-sharded data parallelism for evaluation (port of
``rajni_tpu/parallel/multihost.py``).

JAX joins its hosts into one multi-controller runtime and assembles a global
array from each host's local batch. Here every rank is a process of one
``torch.distributed`` group: :func:`initialize` joins it (from
``--coordinator``, ``--num_processes`` and ``--process_id``, or from a
launcher's environment), each rank evaluates its own slice of every global
batch, and the accuracy counters are all-reduced. The accounting is the
reference's: top-1 over the real rows (label ``-1`` marks padding, counted
in neither numerator nor denominator), throughput the global images over the
forward's wall clock. Every rank returns the same numbers.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Any, Iterable

import numpy as np
import torch
import torch.distributed as dist

from ..eval import _pad_to
from ..models.vit import ViTConfig, tree_to
from ..quant import ActScales
from ..utils.schedule import Schedule
from ..utils.timing import fence
from .launch import backend_for, rank_device
from .mesh import Mesh, all_reduce, local_forward, make_mesh, world_rank, world_size


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device_type: str = "cuda",
               backend: str | None = None) -> None:
    """Join this process into the process group (idempotent: a second call
    is a no-op). Pass all three of ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``, or none of them, when a launcher
    such as ``torchrun`` set ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``.
    The backend is :func:`.launch.backend_for` ``device_type`` unless given
    (gloo on the CPU or where ranks share a card, else NCCL)."""
    if dist.is_initialized():
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address requires num_processes and process_id "
                             "(pass all three, or none under a launcher that sets them)")
        init = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    elif num_processes is not None or process_id is not None:
        raise ValueError("num_processes/process_id require coordinator_address "
                         "(pass all three, or none under a launcher that sets them)")
    elif "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        raise ValueError("no process group to join: pass coordinator_address, num_processes "
                         "and process_id, or start under torchrun")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or backend_for(device_type, local)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = rank_device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(minutes=10), **kw)


def global_mesh(data: int | None = None, model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh over every rank (after :func:`initialize`)."""
    return make_mesh(data=data, model=model, device=device)


def host_to_global(batch: Any, mesh: Mesh) -> Any:
    """This process's local rows of a global batch, as tensors on its
    device: its shard of the global batch (the concatenation over the
    ranks). No rank ever holds the whole batch."""
    if isinstance(batch, tuple):
        return tuple(host_to_global(b, mesh) for b in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(mesh.device)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(mesh.device)


def replicate_to_global(tree: Any, mesh: Mesh) -> Any:
    """A host parameter tree on this rank's device; every rank passes the
    same values (the checkpoint-load-then-replicate flow)."""
    return tree_to(tree, device=mesh.device)


def multihost_eval_step(config: ViTConfig, schedule: Schedule | None, mesh: Mesh,
                        impl: str = "torch", act_scales: ActScales | None = None, stage=None):
    """``(params, images, labels) -> (correct, total)`` over the ranks:
    ``images``/``labels`` are this rank's local rows, rows with ``label < 0``
    count in neither counter, and the counters are summed over ``data``
    (JAX's replicated-scalar psum). Each rank is one data slot: a ``model``
    axis would give its ranks different local rows, so it raises, as JAX's
    kernel route does."""
    if mesh.size("model") > 1:
        raise NotImplementedError("process-sharded evaluation over a model axis is not "
                                  "supported: every rank feeds its own rows (model=1)")
    cache: dict = {}

    def step(params, images, labels):
        if cache.get("params") is not params:
            cache["params"] = params
            cache["fwd"] = local_forward(params, config, schedule, mesh, impl, stage, act_scales)
        logits = cache["fwd"](images)
        labels = labels.to(logits.device)
        valid = labels >= 0
        counts = torch.stack([((logits.argmax(dim=-1) == labels) & valid).sum(), valid.sum()])
        return all_reduce(counts.to(torch.int64), mesh, "data")

    return step


def _pad_to_local(images, labels, b_loc: int):
    """Pad a local batch up to the fixed per-rank batch ``b_loc``, the
    padding labelled -1 (:func:`multihost_eval_step` ignores it)."""
    b = labels.shape[0]
    if b > b_loc:
        raise ValueError(f"batch of {b} rows exceeds the steady per-host batch {b_loc} "
                         "(the first batch must be the largest — reference protocol)")
    labels = np.asarray(labels)
    return _pad_to(images, b_loc), np.concatenate([labels, np.full((b_loc - b,), -1,
                                                                   labels.dtype)])


def local_batch_size(global_batch: int, strict_devices: bool = False) -> int:
    """This rank's share of a global batch; raises unless the ranks divide
    it (``strict_devices`` is the same rule here: a rank is one device)."""
    nproc = world_size()
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by the process "
                         f"count {nproc}")
    return global_batch // nproc


def shard_samples(samples):
    """This rank's interleaved shard of a sample list (the distributed
    sampler's split; shard sizes differ by at most one)."""
    return samples[world_rank()::world_size()]


def steps_for(total_rows: int, global_batch: int, processes: int) -> int:
    """The steps EVERY rank runs over a ``total_rows`` dataset split
    interleaved over ``processes`` ranks at ``global_batch`` rows a step:
    the largest shard's batches (a rank that stopped early would leave the
    others waiting in a collective)."""
    if global_batch % processes:
        raise ValueError(f"{global_batch=} not divisible by {processes=}")
    local_b = global_batch // processes
    largest_shard = -(-total_rows // processes)
    return -(-largest_shard // local_b)


def evaluate_model_multihost(
    params: Any,
    config: ViTConfig,
    schedule: Schedule | None,
    dataloader: Iterable,
    mesh: Mesh | None = None,
    impl: str = "torch",
    max_batches: int | None = None,
    warmup: int = 2,
    act_scales: ActScales | None = None,
    stage=None,
    num_batches: int | None = None,
    assume_replicated: bool = False,
    local_batch: int | None = None,
) -> tuple[float, float]:
    """The reference's accounting over the ranks → ``(acc, img/s)``, the
    same on every rank (``rajni_tpu/parallel/multihost.py:
    evaluate_model_multihost``). ``dataloader`` (re-iterable) yields this
    rank's ``(images, labels)`` numpy slices of each global batch. With
    ``num_batches`` (:func:`steps_for`) every rank runs exactly that many
    steps, all-padding batches (label -1) once its shard runs short; every
    batch is padded to ``local_batch`` (the globally agreed per-rank batch)
    or, without it, to this rank's first batch. ``assume_replicated``:
    ``params`` are already on the mesh's device."""
    if iter(dataloader) is iter(dataloader):
        raise ValueError("dataloader must be re-iterable (pass a list, not a generator)")
    if mesh is None:
        mesh = global_mesh()
    step = multihost_eval_step(config, schedule, mesh, impl, act_scales, stage)
    gparams = params if assume_replicated else replicate_to_global(params, mesh)
    b_loc = local_batch
    template = None

    def prepare(x, y):
        nonlocal b_loc, template
        y = np.asarray(y)
        if b_loc is None:
            b_loc = y.shape[0]
        template = _pad_to_local(x, y, b_loc)
        return template

    it = iter(dataloader)
    for _ in range(warmup):
        try:
            x, y = next(it)
        except StopIteration:
            it = iter(dataloader)
            try:
                x, y = next(it)
            except StopIteration:
                raise ValueError("dataloader yielded no batches (empty dataset?)") from None
        step(gparams, *host_to_global(prepare(x, y), mesh))
        fence(mesh.device)
    it = iter(dataloader)

    correct = total = 0
    total_time = 0.0
    blank = None
    i = 0
    while (max_batches is None or i < max_batches) and (num_batches is None or i < num_batches):
        try:
            images, labels = prepare(*next(it))
        except StopIteration:
            if num_batches is None:
                break
            if blank is None:  # keep joining the ranks' collectives with zero weight
                if template is None:
                    raise ValueError("empty dataloader with num_batches set and no batch to "
                                     "infer shapes from") from None
                blank = (np.zeros_like(template[0]), np.full_like(template[1], -1))
            images, labels = blank
        gimages, glabels = host_to_global((images, labels), mesh)
        fence(mesh.device)  # the copy stays outside the timed region
        start = time.perf_counter()
        counts = step(gparams, gimages, glabels)
        fence(mesh.device)
        total_time += time.perf_counter() - start
        correct += int(counts[0])
        total += int(counts[1])
        i += 1
    return 100.0 * correct / max(total, 1), total / max(total_time, 1e-6)

