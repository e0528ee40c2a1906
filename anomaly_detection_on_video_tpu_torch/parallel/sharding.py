"""Data and tensor-parallel layouts over a ``Mesh`` (counterpart of the
JAX package's ``parallel/sharding.py``).

- ``batch_sharding`` / ``shard_batch``: a rank's contiguous slice of the
  bag (or clip) axis, axis 1 for micro-batched arrays ``(k, bags, ...)``.
- ``DataShard``: what a model's train-mode forward needs to compute the
  single-device function from its slice of the batch: the autograd
  gather and sum over the data axis, and the rank's slice of a tensor
  drawn at the global batch shape (dropout masks).
- ``tensor_parallel_specs``: the JAX rule for which dimension of each
  tensor the model axis splits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class DataShard:
    """Slice ``index`` of ``count`` equal, contiguous slices of the batch
    axis, held by this rank, and the process group of the data axis.

    ``gather`` and ``all_reduce`` are differentiable: their backward sums
    the gradients that every rank's copy of the (identical) global loss
    sends back, so every gradient that reaches a parameter is ``count``
    times the single-device one; the train step divides the summed
    parameter gradients by ``count``."""

    index: int
    count: int
    group: Any = None

    def local(self, x, axis: int = 0):
        """This rank's slice of a global tensor or array along ``axis``."""
        n = x.shape[axis]
        if n % self.count:
            raise ValueError(f"axis {axis} of size {n} does not split over {self.count} ranks")
        step = n // self.count
        if isinstance(x, np.ndarray):
            return np.take(x, range(self.index * step, (self.index + 1) * step), axis=axis)
        return x.narrow(axis, self.index * step, step)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along axis 0 in rank order, with
        autograd (``_Gather``)."""
        return _Gather.apply(x, self)

    def gather_detached(self, x: torch.Tensor) -> torch.Tensor:
        """``gather`` without autograd."""
        parts = [torch.empty_like(x) for _ in range(self.count)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, with autograd (``_Sum``)."""
        return _Sum.apply(x, self.group)


class _Gather(torch.autograd.Function):
    """All-gather along axis 0 whose backward sums the gradient over the
    group and keeps this rank's rows: the adjoint of the gather when every
    rank differentiates its own copy of the loss. (``torch.distributed.nn``'s
    all_gather emulates its reduce-scatter on gloo with scatters that name
    global ranks, which fails on a subgroup.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: DataShard) -> torch.Tensor:
        ctx.shard, ctx.rows = shard, x.shape[0]
        return shard.gather_detached(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad.narrow(0, ctx.shard.index * ctx.rows, ctx.rows), None


class _Sum(torch.autograd.Function):
    """All-reduce (sum) whose backward is the same all-reduce of the
    gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_sharding(mesh: Optional[Mesh], axis: str = "data") -> Optional[DataShard]:
    """The layout of a batch on ``mesh``, axis 0 split over ``axis``: this
    rank's ``DataShard`` (``shard_batch`` applies it); None without a mesh."""
    if mesh is None:
        return None
    return DataShard(mesh.coordinate(axis), mesh.shape[axis], mesh.group(axis))


def shard_batch(mesh: Mesh, batch: Any, axis: str = "data", microbatched: bool = False) -> Any:
    """This rank's slice of every array or tensor in ``batch`` (a mapping,
    a sequence, or one array): axis 0, or axis 1 with ``microbatched``."""
    shard = batch_sharding(mesh, axis)
    dim = 1 if microbatched else 0
    if isinstance(batch, Mapping):
        return {k: shard.local(v, dim) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard.local(v, dim) for v in batch)
    return shard.local(batch, dim)


def tensor_parallel_specs(tree: Mapping[str, Any], mesh: Mesh, axis: str = "model"
                          ) -> dict:
    """Which dimension of each tensor the model axis splits: the JAX rule,
    the largest dimension that the axis size divides (and is at least),
    the later one on a tie; None (replicate) for scalars and tensors with
    no such dimension. ``tree`` maps names to tensors (a state dict)."""
    size = mesh.shape[axis]
    specs = {}
    for name, value in tree.items():
        shape = tuple(getattr(value, "shape", ()))
        best = None
        for d in range(len(shape) - 1, -1, -1):
            if shape[d] % size == 0 and shape[d] >= size:
                if best is None or shape[d] > shape[best]:
                    best = d
        specs[name] = best
    return specs


class ShardedParameters:
    """DP x TP storage of a module's parameters and their optimizer state.

    Every parameter that ``tensor_parallel_specs`` splits is kept as this
    rank's slice along its dimension (``shards``, the tensors the optimizer
    updates, so Adam's moments are slices too); the module's own parameter
    holds no storage outside ``materialized()``, which all-gathers the
    slices over the model axis into full weights for a forward, and drops
    them again after. The ranks of one model-axis group feed the same bags,
    so their full gradients are equal: ``step`` clips them (the global
    norm of the single device), keeps each rank's slice and steps the
    optimizer on the slices. Parameters that the rule replicates are the
    module's own, updated whole on every rank."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, axis: str = "model"):
        self.model = model
        self.group = mesh.group(axis)
        self.index = mesh.coordinate(axis)
        self.count = mesh.shape[axis]
        params = dict(model.named_parameters())
        specs = tensor_parallel_specs(params, mesh, axis)
        self.dims = {name: d for name, d in specs.items() if d is not None}
        self.shards = {name: torch.nn.Parameter(self._slice(params[name].detach(), d))
                       for name, d in self.dims.items()}
        self._depth = 0
        self._release()

    def _slice(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        return full.chunk(self.count, dim)[self.index].clone(memory_format=torch.contiguous_format)

    def parameters(self) -> list:
        """The optimizer's tensors, in the module's parameter order: the
        slice of a split parameter, else the parameter itself."""
        return [self.shards.get(name, p) for name, p in self.model.named_parameters()]

    def _gather(self, piece: torch.Tensor, dim: int) -> torch.Tensor:
        parts = [torch.empty_like(piece) for _ in range(self.count)]
        dist.all_gather(parts, piece.detach().contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def _release(self) -> None:
        for name, p in self.model.named_parameters():
            if name in self.dims:
                p.data = p.data.new_empty(0)
                p.grad = None

    def materialized(self):
        """Context: the module's split parameters hold their full weights
        inside (a collective over the model axis on entry)."""
        import contextlib

        @contextlib.contextmanager
        def scope():
            if self._depth == 0:
                for name, p in self.model.named_parameters():
                    if name in self.dims:
                        p.data = self._gather(self.shards[name], self.dims[name])
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                if self._depth == 0:
                    self._release()

        return scope()

    def step(self, optimizer) -> None:
        """Inside ``materialized()``, after the data-axis gradient sum:
        clip the full gradients to the optimizer's ``grad_clip`` (if any),
        give each slice its part, and step the optimizer (without its own
        clip, which would see only slices)."""
        from ..training.optim import clip_by_global_norm_

        params = dict(self.model.named_parameters())
        clip = getattr(optimizer, "grad_clip", None)
        if clip:
            clip_by_global_norm_([p.grad for p in params.values() if p.grad is not None], clip)
        for name, d in self.dims.items():
            grad = params[name].grad
            self.shards[name].grad = None if grad is None else self._slice(grad, d)
        if clip:
            optimizer.step(clip=False)
        else:
            optimizer.step()

    def _moment_keys(self, optimizer):
        """(optimizer state index, dimension) of every split parameter."""
        names = [name for name, _ in self.model.named_parameters()]
        return [(i, self.dims[name]) for i, name in enumerate(names) if name in self.dims]

    def state_dicts(self, optimizer) -> tuple:
        """(module state dict, optimizer state dict) in the single-device
        layout: full weights and full moments (collectives over the model
        axis; every rank gets them)."""
        with self.materialized():
            model_sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        optim_sd = optimizer.state_dict()
        state = dict(optim_sd["state"])
        for i, dim in self._moment_keys(optimizer):
            if i in state:
                state[i] = {k: self._gather(v, dim) if _is_moment(v) else v
                            for k, v in state[i].items()}
        return model_sd, dict(optim_sd, state=state)

    def load_state_dicts(self, optimizer, model_sd, optim_sd) -> None:
        """Load single-device state dicts: each split parameter and its
        moments keep this rank's slice."""
        with self.materialized():
            self.model.load_state_dict(model_sd)
            params = dict(self.model.named_parameters())
            with torch.no_grad():
                for name, d in self.dims.items():
                    self.shards[name].copy_(self._slice(params[name].detach(), d))
        state = dict(optim_sd["state"])
        for i, dim in self._moment_keys(optimizer):
            if i in state:
                state[i] = {k: self._slice(v, dim) if _is_moment(v) else v
                            for k, v in state[i].items()}
        optimizer.load_state_dict(dict(optim_sd, state=state))

    def adopt(self, optimizer) -> None:
        """Point ``optimizer`` (built over the module's full parameters) at
        the slices, slicing any state it already holds."""
        params = dict(self.model.named_parameters())
        for group in optimizer.param_groups:
            for j, p in enumerate(group["params"]):
                name = next((n for n, q in params.items() if q is p), None)
                if name not in self.dims:
                    continue
                shard = self.shards[name]
                group["params"][j] = shard
                old = optimizer.state.pop(p, None)
                if old:
                    optimizer.state[shard] = {
                        k: self._slice(v, self.dims[name]) if _is_moment(v) else v
                        for k, v in old.items()}


def _is_moment(value) -> bool:
    """An optimizer state entry shaped like its parameter (not a step count)."""
    return isinstance(value, torch.Tensor) and value.dim() > 0
