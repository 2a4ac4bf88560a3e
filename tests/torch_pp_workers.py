"""Rank processes of the pipeline and sequence-parallel tests
(``test_torch_port_pipeline.py``, ``test_torch_port_sequence.py``), spawned
by ``torch_parallel_workers.run_ranks`` on a (D, n) mesh of gloo ranks.
They import torch and the port only (no JAX); the parent converts the JAX
blocks' weights into each block's state dict and compares the results with
the JAX functions.

Each case gets the blocks' state dicts (numpy) and its inputs; a rank
returns what it holds: its blocks' gradients and parameters after one SGD
step (keyed by the block's index in the stack), its rows of the output.
The loss of a data rank is the global batch's, summed over the data ranks
with ``collectives.all_reduce`` (the data-parallel convention), so that
``reduce_gradients`` (``reduce_seq_gradients``) gives the stack's gradient.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LR = 0.1


def _block(layout: str, dim: int, heads: int, state: Dict[str, np.ndarray]):
    from vlp_tpu_torch.models.vit import EncoderBlock

    block = EncoderBlock(dim, heads, 4.0, fused_attention=layout == "fused",
                         megakernel=False)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return block


def _named(blocks, index: List[int], what: str) -> Dict[str, np.ndarray]:
    out = {}
    for i, block in zip(index, blocks):
        for k, p in block.named_parameters():
            t = p.grad if what == "grad" else p
            out[f"{i}.{k}"] = t.detach().numpy().copy()
    return out


def _sgd(blocks) -> None:
    with torch.no_grad():
        for block in blocks:
            for p in block.parameters():
                p -= LR * p.grad


def _loss(y, target, kind: str, count: int, mesh):
    """The global batch's loss on every data rank: ``sum`` (y * target)
    or ``mse`` (mean of (y - target)^2 over ``count`` elements), summed in
    fp64 so that the loss reflects y and not the order of the sum."""
    from vlp_tpu_torch.parallel.collectives import all_reduce

    y, target = y.double(), target.double()
    local = (y * target).sum() if kind == "sum" \
        else ((y - target) ** 2).sum() / count
    return all_reduce(local, mesh)


def _sequential_loss(c: Dict, x, target, mesh, tokens=slice(None)
                     ) -> float:
    """The loss of the whole stack run in sequence on the same rows
    (microbatches ``[M, mb, T, D]``), on its ``tokens``."""
    with torch.no_grad():
        h = x.reshape((-1,) + tuple(x.shape[2:]))
        for state in c["blocks"]:
            h = _block(c["layout"], c["dim"], c["heads"], state)(h)
        return float(_loss(h.view(x.shape)[:, :, tokens], target,
                           c["kind"], c["target"].size, mesh))


def pipeline_worker(mesh, cases: Dict[str, Dict]) -> Dict:
    """Each case: the GPipe schedule of its layout's blocks on the rank's
    microbatch rows, forward (``values``) or forward and backward against
    a linear functional (``grads``) or the mean squared error and one SGD
    step (``sgd``)."""
    from vlp_tpu_torch.parallel.collectives import reduce_gradients
    from vlp_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                                 scan_blocks_stage_fn,
                                                 stage_blocks, stage_range)

    n, s = mesh.model_world, mesh.model_rank
    out = {}
    for name, c in cases.items():
        depth = len(c["blocks"])
        stage = stage_blocks(lambda i: _block(c["layout"], c["dim"],
                                              c["heads"], c["blocks"][i]),
                             depth, mesh)
        index = list(stage_range(depth, n, s))
        pipe = make_pipeline_fn(scan_blocks_stage_fn(), mesh, n, c["m"])
        rows = mesh.rows(c["x"].shape[1])
        x = torch.from_numpy(c["x"][:, rows]).requires_grad_(True)
        y = pipe(stage, x)
        res = {"y": y.detach().numpy().copy(), "index": index,
               "held": sum(p.numel() for p in stage.parameters())}
        if c["kind"] != "values":
            target = torch.from_numpy(c["target"][:, rows])
            loss = _loss(y, target, c["kind"], c["target"].size, mesh)
            loss.backward()
            reduce_gradients(stage.parameters(), mesh)
            res.update(loss=float(loss), grads=_named(stage, index, "grad"),
                       dx=x.grad.numpy().copy(),
                       seq_loss=_sequential_loss(c, x, target, mesh))
            if c["kind"] == "mse":
                _sgd(stage)
                res["params"] = _named(stage, index, "param")
        out[name] = res
    out["hops"] = _hops(mesh)
    return out


def _hops(mesh) -> Dict:
    """``collectives.hop`` both ways round the stage ring (stage rank s
    sends s + 1 forward and s + 10 back), and along the schedule's chain
    (stage s < n - 1 sends s + 1, stage s > 0 receives)."""
    from vlp_tpu_torch.parallel.collectives import hop

    s, n = mesh.model_rank, mesh.model_world
    x = torch.full((3,), float(s + 1))
    fwd = hop(x, mesh, 1, like=x)
    back = hop(x + 9, mesh, -1, like=x)
    chain = hop(x if s < n - 1 else None, mesh, 1,
                like=x if s > 0 else None)
    return {"fwd": fwd.tolist(), "back": back.tolist(),
            "chain": None if chain is None else chain.tolist()}


def sequence_worker(mesh, cases: Dict[str, Dict]) -> Dict:
    """Each case: its layout's blocks on the rank's token rows of x; the
    rank's rows of y, and with a target its x gradient and the stack's
    gradients (``reduce_seq_gradients``), the collectives a forward and
    backward ran, and with ``mse`` one SGD step; without one, the same
    blocks called plainly on the whole x afterwards."""
    from vlp_tpu_torch.parallel import collectives
    from vlp_tpu_torch.parallel.sequence import (make_seq_parallel_fn,
                                                 reduce_seq_gradients)

    out = {}
    fn = make_seq_parallel_fn(mesh)
    for name, c in cases.items():
        blocks = torch.nn.ModuleList(
            _block(c["layout"], c["dim"], c["heads"], st)
            for st in c["blocks"])
        index = list(range(len(blocks)))
        x = torch.from_numpy(c["x"]).requires_grad_(True)
        collectives.reset_seq_counts()
        y = fn(blocks, x)
        res = {"y": y.detach().numpy().copy()}
        if c["kind"] == "values":  # the same blocks called plainly after
            counts = dict(collectives.seq_counts)
            with torch.no_grad():
                h = x.detach()
                for block in blocks:
                    h = block(h)
            res.update(plain=h.numpy().copy(), plain_collectives={
                k: v - counts[k] for k, v in collectives.seq_counts.items()})
        if c["kind"] != "values":
            t = y.shape[1]
            r = mesh.model_rank
            target = torch.from_numpy(
                c["target"][mesh.rows(c["x"].shape[0]), r * t:(r + 1) * t])
            loss = _loss(y, target, c["kind"], c["target"].size, mesh)
            loss.backward()
            reduce_seq_gradients(blocks.parameters(), mesh)
            rows = x[mesh.rows(x.shape[0])].detach()
            res.update(loss=float(loss), grads=_named(blocks, index, "grad"),
                       dx=x.grad.numpy().copy(),
                       counts=dict(collectives.seq_counts),
                       seq_loss=_sequential_loss(
                           c, rows[None], target[None], mesh,
                           slice(r * t, (r + 1) * t)))
            if c["kind"] == "mse":
                _sgd(blocks)
                res["params"] = _named(blocks, index, "param")
        out[name] = res
    return out
