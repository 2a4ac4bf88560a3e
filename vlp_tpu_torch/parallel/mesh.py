"""The process group and the data mesh (counterpart of
``vlp_tpu/parallel/mesh.py:22-95``).

The JAX package is one process that sees every chip: it jits the step over
a 1-D ``('data',)`` mesh and GSPMD makes every batch-wide reduction global.
The port runs one process per device, started by the launcher::

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m vlp_tpu_torch.train [--device cuda|cpu] experiment=... [overrides]

``create_mesh`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
launcher (or takes an explicit ``init_method`` and ranks, as the tests do),
forms the process group (NCCL on ``cuda:LOCAL_RANK``; gloo only for the CPU)
and returns a ``Mesh``: the rank, the world, the group and the device. The
loaders, tasks and trainer take it where the JAX code takes ``mesh``.
Without the launcher's environment it returns None and nothing changes from
one process on one device. ``data.batch_size`` stays the global batch: each
rank holds ``B / N`` rows, rows ``[r B/N, (r + 1) B/N)`` of it
(``Mesh.rows``). A process group that fails to form raises: a run never
trains alone when it was asked to train with others.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

# seconds a collective may wait for its peers before the run fails: a rank
# that died (a kernel that failed to build or launch) must not hang the rest
DEFAULT_TIMEOUT_S = 600.0
ITEM_14 = "ROADMAP.md Queue 1 item 14"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D data mesh of ``world`` processes, this one ``rank``."""

    rank: int
    world: int
    device: torch.device
    group: Any = None  # the default group
    axis_name: str = "data"

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global``."""
        if n_global % self.world:
            raise ValueError(f"a global batch of {n_global} rows does not "
                             f"divide over {self.world} ranks")
        b = n_global // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def barrier(self) -> None:
        if self.device.type == "cuda":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def axis_size(mesh: Optional[Mesh]) -> int:
    """The data axis's size: the world, 1 without a mesh."""
    return 1 if mesh is None else mesh.world


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This rank's rows of every array or tensor of a global batch (the
    batch itself without a mesh)."""
    if mesh is None:
        return batch
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def launched() -> bool:
    """True under the launcher (``WORLD_SIZE`` in the environment)."""
    return "WORLD_SIZE" in os.environ


def check_mesh_config(m, world: int) -> None:
    """``mesh.*`` against the world the launcher started. ``data_parallel``
    -1 (or 0) is the world; any other value must equal it (the JAX package
    takes the first n devices; here the launcher decides how many processes
    there are). ``param_sharding`` ``replicated`` or ``fsdp``
    (``parallel/fsdp.py``); the JAX driver's two refusals
    (``vlp_tpu/train/driver.py:227-236``) in its words; tensor parallelism
    on the 2-D data x model mesh is not ported and raises, so such a run
    never goes on replicated."""
    dp = int(m.data_parallel)
    if dp not in (-1, 0) and dp != world:
        raise ValueError(
            f"mesh.data_parallel={dp} but {world} rank(s) were launched "
            f"(data parallelism, {ITEM_14}): give -1 (the world) or launch "
            f"{dp} ranks with python -m torch.distributed.run "
            f"--nproc_per_node={dp}")
    mp = int(m.model_parallel)
    if m.param_sharding == "tp" and mp <= 1:
        raise ValueError(
            "mesh.param_sharding='tp' shards weights over the model axis — "
            "set mesh.model_parallel>1 (2-D data x model mesh). The 2-D "
            f"mesh with tensor parallelism is not ported ({ITEM_14}).")
    if m.param_sharding == "fsdp" and mp > 1:
        raise ValueError(
            "mesh.param_sharding='fsdp' shards over the data axis and "
            "never uses the model axis — model_parallel>1 would leave the "
            "model-axis devices as pure replicas. Use param_sharding='tp' "
            "on a 2-D mesh, or fsdp with model_parallel=1. The 2-D mesh is "
            f"not ported ({ITEM_14}).")
    if mp != 1 or m.param_sharding == "tp":
        raise ValueError(
            f"mesh.model_parallel={m.model_parallel}, mesh.param_sharding="
            f"{m.param_sharding!r}: the 2-D data x model mesh with tensor "
            f"parallelism is not ported ({ITEM_14}); the port would train "
            "replicated")
    if m.param_sharding not in ("replicated", "fsdp"):
        raise ValueError(f"mesh.param_sharding={m.param_sharding!r}: "
                         "replicated, fsdp or tp")


def create_mesh(mesh_cfg=None, device: str = "cuda",
                init_method: Optional[str] = None,
                rank: Optional[int] = None,
                world_size: Optional[int] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """The process group and this rank's ``Mesh``, or None without the
    launcher's environment and without ``init_method`` (one process).
    ``device`` is the device type: ``cuda`` takes NCCL on
    ``cuda:LOCAL_RANK``, ``cpu`` gloo. ``mesh_cfg`` (``cfg.mesh``) is
    checked against the world (``check_mesh_config``)."""
    if init_method is None and not launched():
        if mesh_cfg is not None:
            check_mesh_config(mesh_cfg, 1)
        return None
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if mesh_cfg is not None:
        check_mesh_config(mesh_cfg, world)
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda under the launcher, but no "
                               "CUDA device is visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: cuda or cpu")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if kind == "cuda":
        kw["device_id"] = dev
    if init_method is not None:
        kw["init_method"] = init_method
    try:
        if not dist.is_initialized():
            try:
                dist.init_process_group(**kw)
            except TypeError:  # a torch before device_id
                kw.pop("device_id", None)
                dist.init_process_group(**kw)
    except Exception as e:  # never train alone when asked for a group
        raise RuntimeError(
            f"rank {rank} of {world}: the {backend} process group did not "
            f"form ({e}); the run stops rather than train alone") from e
    mesh = Mesh(rank=rank, world=world, device=dev,
                axis_name=getattr(mesh_cfg, "axis_name", "data"))
    mesh.barrier()
    return mesh


def destroy_mesh(mesh: Optional[Mesh]) -> None:
    """Tears the process group down (on exit and on error)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()

