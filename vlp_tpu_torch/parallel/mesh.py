"""The process groups and the data x model mesh (counterpart of
``vlp_tpu/parallel/mesh.py:22-68``).

The JAX package is one process that sees every chip: it jits the step over
a ``('data',)`` mesh, or a 2-D ``('data', 'model')`` one with
``mesh.model_parallel`` M > 1, and GSPMD inserts every collective. The
port runs one process per device, started by the launcher::

    python -m torch.distributed.run --standalone --nproc_per_node=N \\
        -m vlp_tpu_torch.train [--device cuda|cpu] experiment=... [overrides]

``create_mesh`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
launcher (or takes an explicit ``init_method`` and ranks, as the tests do),
forms the process group (NCCL on ``cuda:LOCAL_RANK``; gloo for the CPU,
and on CUDA where a node's ranks outnumber its cards)
and returns a ``Mesh``. The N = D x M ranks lie data-major, as the JAX
package reshapes its devices to ``(D, M)``: global rank ``g`` is data rank
``g // M`` and model rank ``g % M``. ``rank``, ``world`` and ``group`` are
the data axis's (D ranks of one model rank; the default group when M is
1): the loaders, the tasks, the losses, the metrics and the gradient mean
take them where the JAX code takes ``mesh``, since batches shard over the
data axis only (``axis_size``). ``model_rank``, ``model_world`` and
``model_group`` are the model axis's, which only tensor parallelism
(``parallel/tp.py``) reads; ``is_main``, ``barrier`` and the broadcasts
are the whole world's. Without the launcher's environment ``create_mesh``
returns None and nothing changes from one process on one device.
``data.batch_size`` stays the global batch: each data rank holds ``B / D``
rows, rows ``[r B/D, (r + 1) B/D)`` of it (``Mesh.rows``), and the M model
ranks of one data rank hold the same rows. A process group that fails to
form raises: a run never trains alone when it was asked to train with
others.

``create_pipeline_mesh`` and ``create_seq_mesh`` (counterparts of
``vlp_tpu/parallel/pipeline.py:49-62`` and ``sequence.py:44-56``) lay the
launcher's ranks out the same way on a ``(D, n)`` mesh whose second axis is
the pipeline's stages or the sequence's token blocks: global rank ``g`` is
data rank ``g // n`` and stage (or seq) rank ``g % n``. Every second axis
is held in the same fields, ``model_rank``, ``model_world`` and
``model_group``; ``second_axis`` names what they hold, so that a function
of one axis refuses a mesh of another.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# seconds a collective may wait for its peers before the run fails: a rank
# that died (a kernel that failed to build or launch) must not hang the rest
DEFAULT_TIMEOUT_S = 600.0
ITEM_14 = "ROADMAP.md Queue 1 item 14"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place on the D x M mesh: data rank ``rank`` of
    ``world`` (over ``group``) and model rank ``model_rank`` of
    ``model_world`` (over ``model_group``); global rank ``rank *
    model_world + model_rank``."""

    rank: int
    world: int
    device: torch.device
    group: Any = None  # the data axis's group; None: the default group
    axis_name: str = "data"
    model_rank: int = 0
    model_world: int = 1
    model_group: Any = None
    # what the model_* fields hold: "model" (tensor parallelism), "stage"
    # (create_pipeline_mesh) or "seq" (create_seq_mesh)
    second_axis: str = "model"

    def peer(self, second_rank: int) -> int:
        """The global rank of ``second_rank`` on this rank's row of the
        second axis."""
        return self.rank * self.model_world + second_rank % self.model_world

    @property
    def global_rank(self) -> int:
        return self.rank * self.model_world + self.model_rank

    @property
    def is_main(self) -> bool:
        return self.global_rank == 0

    def rows(self, n_global: int) -> slice:
        """This data rank's rows of a global batch of ``n_global``."""
        if n_global % self.world:
            raise ValueError(f"a global batch of {n_global} rows does not "
                             f"divide over {self.world} ranks")
        b = n_global // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def barrier(self) -> None:
        """Every rank of the world."""
        if self.device.type == "cuda":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def axis_size(mesh: Optional[Mesh]) -> int:
    """The data axis's size, 1 without a mesh."""
    return 1 if mesh is None else mesh.world


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This data rank's rows of every array or tensor of a global batch
    (the batch itself without a mesh)."""
    if mesh is None:
        return batch
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def launched() -> bool:
    """True under the launcher (``WORLD_SIZE`` in the environment)."""
    return "WORLD_SIZE" in os.environ


def check_mesh_config(m, world: int) -> None:
    """``mesh.*`` against the world the launcher started: the JAX driver's
    three refusals (``vlp_tpu/train/driver.py:222-236``) in its words, then
    ``model_parallel`` M must divide the world and ``data_parallel`` -1 (or
    0) is the rest of it, D = world / M; any other value must equal that
    (the JAX package takes the first D x M devices; here the launcher
    decides how many processes there are). ``param_sharding``
    ``replicated`` (M > 1 then holds M replicas, as the JAX mesh does),
    ``fsdp`` (``parallel/fsdp.py``) or ``tp`` (``parallel/tp.py``)."""
    mp = int(m.model_parallel)
    if mp > 1 and getattr(m, "infonce_impl", "gspmd") == "shard_map":
        raise ValueError(
            "mesh.infonce_impl='shard_map' is written for a 1-D data mesh; "
            "with mesh.model_parallel>1 use infonce_impl='gspmd' (GSPMD "
            "partitions the contrastive matrix over both axes).")
    if m.param_sharding == "tp" and mp <= 1:
        raise ValueError(
            "mesh.param_sharding='tp' shards weights over the model axis — "
            "set mesh.model_parallel>1 (2-D data x model mesh).")
    if m.param_sharding == "fsdp" and mp > 1:
        raise ValueError(
            "mesh.param_sharding='fsdp' shards over the data axis and "
            "never uses the model axis — model_parallel>1 would leave the "
            "model-axis devices as pure replicas. Use param_sharding='tp' "
            "on a 2-D mesh, or fsdp with model_parallel=1.")
    if m.param_sharding not in ("replicated", "fsdp", "tp"):
        raise ValueError(f"mesh.param_sharding={m.param_sharding!r}: "
                         "replicated, fsdp or tp")
    if mp < 1 or world % mp:
        raise ValueError(
            f"mesh.model_parallel={mp} does not divide the {world} rank(s) "
            "launched: launch D x M ranks with python -m "
            "torch.distributed.run --nproc_per_node=<D*M>")
    dp = int(m.data_parallel)
    if dp not in (-1, 0) and dp * mp != world:
        raise ValueError(
            f"mesh.data_parallel={dp} x mesh.model_parallel={mp} but "
            f"{world} rank(s) were launched (data parallelism, {ITEM_14}): "
            f"give -1 (the rest of the world) or launch {dp * mp} ranks "
            f"with python -m torch.distributed.run --nproc_per_node="
            f"{dp * mp}")


def create_mesh(mesh_cfg=None, device: str = "cuda",
                init_method: Optional[str] = None,
                rank: Optional[int] = None,
                world_size: Optional[int] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S,
                model_parallel: Optional[int] = None) -> Optional[Mesh]:
    """The process group, the data and model groups and this rank's
    ``Mesh``, or None without the launcher's environment and without
    ``init_method`` (one process). ``device`` is the device type: ``cuda``
    takes NCCL on ``cuda:LOCAL_RANK``, ``cpu`` gloo. Where a node's ranks
    (``LOCAL_WORLD_SIZE``) outnumber its visible cards, which NCCL refuses,
    ``cuda`` takes gloo instead, with the ranks on the cards in turn
    (``LOCAL_RANK`` modulo their count), and says so in a log line.
    ``mesh_cfg`` (``cfg.mesh``) is checked against the world
    (``check_mesh_config``) and gives M (``model_parallel`` overrides it;
    1 without either)."""
    if init_method is None and not launched():
        if mesh_cfg is not None:
            check_mesh_config(mesh_cfg, 1)
        return None
    rank, world = _world(rank, world_size)
    if mesh_cfg is not None:
        check_mesh_config(mesh_cfg, world)
    mp = int(model_parallel if model_parallel is not None
             else getattr(mesh_cfg, "model_parallel", 1))
    if mp < 1 or world % mp:
        raise ValueError(f"model_parallel={mp} does not divide the world "
                         f"of {world}")
    dev = _init_group(device, init_method, rank, world, timeout_s)
    return _grid(rank, world, mp, dev,
                 getattr(mesh_cfg, "axis_name", "data"), "model")


def _world(rank: Optional[int], world_size: Optional[int]) -> tuple:
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else int(world_size)
    return rank, world


def _init_group(device: str, init_method: Optional[str], rank: int,
                world: int, timeout_s: float) -> torch.device:
    """Forms the default process group (``create_mesh``'s backend rule);
    returns this rank's device."""
    env = os.environ
    local_rank = int(env.get("LOCAL_RANK", rank))
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda under the launcher, but no "
                               "CUDA device is visible")
        cards = torch.cuda.device_count()
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= cards else "gloo"
        if backend == "gloo" and local_rank == 0:
            logger.info("%d ranks on %d visible CUDA device(s): the process "
                        "group takes gloo, as NCCL refuses two ranks on one "
                        "device", local_world, cards)
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device {device!r}: cuda or cpu")
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available")
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
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
    return dev


def _grid(rank: int, world: int, n: int, dev: torch.device, axis_name: str,
          second_axis: str) -> Mesh:
    """The (world / n, n) mesh, data-major, and this rank's place on it."""
    groups: Dict[str, Any] = {}
    if n > 1:
        # every rank forms every group, in the same order
        dp = world // n
        for d in range(dp):
            g = dist.new_group([d * n + m for m in range(n)])
            if rank // n == d:
                groups["model_group"] = g
        for m in range(n):
            g = dist.new_group([d * n + m for d in range(dp)])
            if rank % n == m:
                groups["group"] = g
    mesh = Mesh(rank=rank // n, world=world // n, device=dev,
                axis_name=axis_name, model_rank=rank % n, model_world=n,
                second_axis=second_axis, **groups)
    mesh.barrier()
    return mesh


def _axis_mesh(what: str, axis: str, n: int, data_parallel: int,
               device: str, init_method: Optional[str],
               rank: Optional[int], world_size: Optional[int],
               timeout_s: float) -> Optional[Mesh]:
    if n < 1 or data_parallel < 1:
        raise ValueError(f"{what} mesh: {axis} {n} and data_parallel "
                         f"{data_parallel} must be at least 1")
    need = n * data_parallel
    if init_method is None and not launched():
        if need == 1:
            return None
        rank, world = 0, 1
    else:
        rank, world = _world(rank, world_size)
    if need > world:
        raise ValueError(f"{what} mesh needs {data_parallel}x{n}={need} "
                         f"devices, have {world}")
    if need < world:
        raise ValueError(
            f"{what} mesh needs {data_parallel}x{n}={need} devices, but "
            f"{world} ranks were launched: launch {need} with python -m "
            f"torch.distributed.run --nproc_per_node={need}")
    dev = _init_group(device, init_method, rank, world, timeout_s)
    mesh = _grid(rank, world, n, dev, "data", axis)
    if n > 1:
        # one collective on the second axis's group before its first
        # point-to-point operation, which NCCL requires of a new group
        one = torch.ones(1, device=dev)
        dist.all_reduce(one, group=mesh.model_group)
    return mesh


def create_pipeline_mesh(n_stages: int, data_parallel: int = 1,
                         device: str = "cuda",
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None,
                         timeout_s: float = DEFAULT_TIMEOUT_S
                         ) -> Optional[Mesh]:
    """The (data_parallel, n_stages) mesh of ``parallel/pipeline.py`` on
    the launcher's ranks (or ``init_method``'s): ``model_rank`` /
    ``model_group`` the stage axis, ``rank`` / ``group`` the data axis.
    Refuses a world of another size than D x n (the JAX text where it is
    too small); None for one process asked for one stage."""
    return _axis_mesh("pipeline", "stage", int(n_stages), int(data_parallel),
                      device, init_method, rank, world_size, timeout_s)


def create_seq_mesh(seq_parallel: int, data_parallel: int = 1,
                    device: str = "cuda", init_method: Optional[str] = None,
                    rank: Optional[int] = None,
                    world_size: Optional[int] = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """The (data_parallel, seq_parallel) mesh of ``parallel/sequence.py``:
    ``model_rank`` / ``model_group`` the token axis, ``rank`` / ``group`` the
    data axis; refusals as ``create_pipeline_mesh``'s."""
    return _axis_mesh("seq", "seq", int(seq_parallel), int(data_parallel),
                      device, init_method, rank, world_size, timeout_s)


def destroy_mesh(mesh: Optional[Mesh]) -> None:
    """Tears the process group down (on exit and on error)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()

