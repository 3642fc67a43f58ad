"""GPipe pipeline parallelism over ``torch.distributed`` (port of
``repro.distributed.pipeline``).

Layers are divided into S stages along a "stage" mesh axis and
microbatches stream through with the GPipe schedule: S + M - 1 ticks,
activations handed to the next stage each tick.  JAX runs the schedule
under ``shard_map`` with a ring ``ppermute``; here each rank is one stage
of its "stage" group, runs the same ticks, and hands its activation on
with one ``batch_isend_irecv`` a tick.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.pspec import map_structure


def _stage_row(leaf, stage: int):
    """This stage's row of a stacked parameter leaf: the local shard of a
    DTensor sharded ``Shard(0)`` over the stage axis, or row ``stage`` of a
    plain stacked tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage's shard has {local.shape[0]} rows; "
                             "shard the stacked leaf Shard(0) over the "
                             "stage axis, one row a stage")
        return local[0]
    return leaf[stage]


def pipeline_forward(stage_fn: Callable, mesh, stage_axis: str = "stage"
                     ) -> Callable:
    """Returns ``fn(stacked_stage_params, microbatches) -> outputs``.

    Collective: every rank of ``mesh`` calls ``fn``; each is the stage of
    its coordinate on ``stage_axis``.  ``stacked_stage_params`` is the
    stacked tree (leading dim = the number of stages), its leaves either
    DTensors sharded ``Shard(0)`` over ``stage_axis`` (each rank reads its
    own row from its shard) or plain tensors holding every stage's row
    (each rank reads its own).  ``microbatches`` is (M, mb, ...); all enter
    at stage 0.  Every rank returns the (M, mb, ...) outputs of the last
    stage: an all-reduce SUM over the stage group, as JAX's ``psum``.
    """
    import torch.distributed as dist

    group = mesh.get_group(stage_axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(stage_axis)
    nxt_rank = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv_rank = dist.get_global_rank(group, (stage - 1) % n_stages)

    def fn(params, mbs: torch.Tensor) -> torch.Tensor:
        params = map_structure(lambda a: _stage_row(a, stage), params)
        M = mbs.shape[0]
        buf = torch.zeros_like(mbs[0])            # current activation
        outs = torch.zeros_like(mbs)              # the last stage's results
        for t in range(n_stages + M - 1):
            mb_idx = t - stage
            active = 0 <= mb_idx < M
            # stage 0 ingests a fresh microbatch on ticks [0, M)
            x = mbs[min(max(mb_idx, 0), M - 1)] if stage == 0 else buf
            y = stage_fn(params, x) if active else buf
            if stage == n_stages - 1 and active:
                outs[mb_idx] = y
            if n_stages == 1:
                buf = y
                continue
            # hand activations downstream (a ring; what stage 0 receives
            # is ignored -- it reads from mbs)
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt_rank, group),
                dist.P2POp(dist.irecv, recv, prv_rank, group)])
            for r in reqs:
                r.wait()
            buf = recv
        # only the last stage holds real outputs; sum-broadcast them so
        # every rank returns them
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return fn


def make_stage_mesh(n_stages: int, data: int = 1, *, device: str = "cuda"):
    """A ("stage", "data") runtime mesh of (n_stages, data) over the first
    ranks of the running group.  Collective, as every runtime mesh."""
    from repro_torch.launch.mesh import make_device_mesh
    return make_device_mesh((n_stages, data), ("stage", "data"),
                            device=device)
