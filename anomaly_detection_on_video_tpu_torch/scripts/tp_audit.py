"""Tensor-parallel audit: what ``tensor_parallel_specs`` shards in the
port's training state (the port's counterpart of ``scripts/tp_audit.py``).

For each trainable family at tp = 2 and 4: the share of the state's bytes
(parameters, buffers and Adam's state, as the port's optimizer holds them)
that a DP x TP run keeps sliced over the mesh's ``model`` axis, the
per-device bytes, and the largest leaves that stay whole. The port splits
what ``parallel.ShardedParameters`` splits: each parameter by the JAX rule
(``tensor_parallel_specs``) and its two Adam moments with it; buffers
(BatchNorm statistics) and scalars stay whole on every rank. The audit is
shape arithmetic in one process, with no process group.

Then the full-size MGFN train step (the reference scale: 2049-d features,
dims 64/128/1024, 16 + 16 bags) is timed under DP and DP x TP over real
ranks: one per visible card (nccl), or gloo ranks on the CPU with
``--device cpu`` (``N_DEVICES`` of them, the JAX script's mesh). Mesh shapes
need ``data x model`` ranks; shapes that need more are reported as such, not
run::

    python -m anomaly_detection_on_video_tpu_torch.scripts.tp_audit --out tp_audit.json
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import build_model, seeded_init_
from ..parallel import Mesh, initialize_multihost, make_mesh, shard_batch, shutdown
from ..parallel import tensor_parallel_specs
from ..training.optim import adam_with_l2
from ..training.runner import TrainState, make_train_step
from ..utils.device import resolve_device

N_DEVICES = 8  # the JAX script's virtual mesh: gloo ranks under --device cpu

FAMILIES = {
    # family -> (config overrides, input feature dim incl. magnitude)
    "mgfn": ({}, 2049),  # reference defaults: dims (64, 128, 1024)
    "mgfn-4096": ({"channels": 4096}, 4097),  # two-stream concat features
    "rtfm": ({}, 2049),
    "sultani": ({}, 2049),
}


def state_leaves(model: torch.nn.Module) -> list:
    """(name, tensor, parameter name or None) of every tensor of the
    training state: the module's state dict, then the optimizer's state
    after one step (``adam_with_l2``: a step count and two moments per
    parameter), each moment tagged with its parameter."""
    params = dict(model.named_parameters())
    optimizer = adam_with_l2(params.values())
    for p in params.values():
        p.grad = torch.zeros_like(p)
    optimizer.step()  # zero gradients: populates the state the optimizer keeps
    names = {id(p): name for name, p in params.items()}
    leaves = [(f"model/{k}", v, k if k in params else None)
              for k, v in model.state_dict(keep_vars=True).items()]
    for p, entry in optimizer.state.items():
        for key, value in entry.items():
            moment = isinstance(value, torch.Tensor) and value.dim() > 0
            leaves.append((f"optimizer/{names[id(p)]}/{key}", value,
                           names[id(p)] if moment else None))
    return leaves


def audit_family(name: str, tp: int) -> dict:
    overrides, _ = FAMILIES[name]
    _, model = build_model(name.split("-")[0], **overrides)
    specs = tensor_parallel_specs(dict(model.named_parameters()),
                                  Mesh({"data": 1, "model": tp}))  # a layout, no group
    total = sharded = 0
    n_leaves = n_sharded = 0
    replicated = []
    for leaf, value, param in state_leaves(model):
        nbytes = value.numel() * value.element_size()
        total += nbytes
        n_leaves += 1
        if param is not None and specs[param] is not None:
            sharded += nbytes
            n_sharded += 1
        elif nbytes > 0 and value.dim() > 0:
            replicated.append((nbytes, leaf, list(value.shape)))
    replicated.sort(reverse=True)
    per_device = sharded // tp + (total - sharded)
    return {
        "family": name,
        "tp": tp,
        "total_mib": round(total / 2**20, 3),
        "sharded_bytes_frac": round(sharded / total, 4),
        "sharded_leaf_frac": round(n_sharded / n_leaves, 4),
        "per_device_mib": round(per_device / 2**20, 3),
        "memory_vs_replicated": round(per_device / total, 4),
        "largest_replicated": [{"leaf": n, "shape": s, "kib": round(b / 1024, 1)}
                               for b, n, s in replicated[:4]],
    }


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _time_on_rank(rank: int, world: int, mesh_shape, steps: int, device_type: str, port: int,
                  out: str) -> None:
    """One rank of ``time_mgfn_step``: rank 0 writes the record to ``out``."""
    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = initialize_multihost(f"127.0.0.1:{port}", world, rank, device=device_type)
    try:
        mesh = make_mesh(mesh_shape, ("data", "model"))
        model = seeded_init_(build_model("mgfn")[1], 0).to(device)
        state = TrainState.create(model, adam_with_l2(model.parameters()), 2)
        step = make_train_step(mesh=mesh, state=state)
        channels = model.config.channels + 1
        feature = np.random.RandomState(0).randn(32, 10, 32, channels).astype(np.float32)
        batch = shard_batch(mesh, {"feature": feature})
        feature = torch.from_numpy(batch["feature"]).to(device)
        normal, abnormal = torch.zeros(16, device=device), torch.ones(16, device=device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        start = time.perf_counter()
        loss = step(state, feature, normal, abnormal)
        float(loss)
        first_s = time.perf_counter() - start
        start = time.perf_counter()
        for _ in range(steps):
            loss = step(state, feature, normal, abnormal)
        sync()
        dt = (time.perf_counter() - start) / steps
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"mesh": {"data": mesh_shape[0], "model": mesh_shape[1]},
                           "ranks": world, "step_ms": round(dt * 1000, 1),
                           "compile_s": round(first_s, 1), "loss": float(loss)}, f)
    finally:
        shutdown()


def time_mgfn_step(mesh_shape, steps: int = 8, device="cuda", ranks: Optional[int] = None
                   ) -> dict:
    """The full-size MGFN train step over a ``(data, model)`` mesh of real
    ranks, one process each (one per card on CUDA, nccl; gloo on the
    CPU), at the reference batch of 16 normal + 16 abnormal bags: the
    mean ms of ``steps`` steps after a first one (``compile_s``, the key
    the JAX report uses: the port compiles nothing, it is the first step's
    seconds, cuDNN's and cuBLAS's set-up included). One rank runs in this process; more are spawned. A shape
    that needs more than ``ranks`` ranks is returned as skipped."""
    device = resolve_device(device)
    available = ranks or (torch.cuda.device_count() if device.type == "cuda" else N_DEVICES)
    dp, tp = mesh_shape
    world = dp * tp
    record = {"mesh": {"data": dp, "model": tp}}
    if world > available:
        where = "visible cards" if device.type == "cuda" else "ranks"
        return dict(record, skipped=f"needs {world} ranks; {available} {where}")
    args = (world, tuple(mesh_shape), steps, device.type, _free_port())
    with tempfile.TemporaryDirectory(prefix="tp_audit_") as tmp:
        out = os.path.join(tmp, "rank0.json")
        if world == 1:
            _time_on_rank(0, *args, out)
        else:
            torch.multiprocessing.spawn(_time_on_rank, args=(*args, out), nprocs=world)
        with open(out) as f:
            return json.load(f)


def mesh_shapes(ranks: int) -> list:
    """The JAX script's DP, DP x TP 2 and DP x TP 4 meshes over ``ranks``
    ranks ((8, 1), (4, 2), (2, 4) at 8); with fewer ranks than the model
    axis, the data axis is 1 and the shape needs ``tp`` ranks."""
    return [(max(1, ranks // tp), tp) for tp in (1, 2, 4)]


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default=None)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--no-timing", action="store_true", help="audit shardings only (fast)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    report = {"audit": []}
    for family in FAMILIES:
        for tp in (2, 4):
            report["audit"].append(audit_family(family, tp))
            print(json.dumps(report["audit"][-1]), flush=True)
    if not args.no_timing:
        device = resolve_device(args.device)
        ranks = torch.cuda.device_count() if device.type == "cuda" else N_DEVICES
        key = f"mgfn_step_time_{device.type}"
        report[key] = []
        for mesh_shape in mesh_shapes(ranks):
            rec = time_mgfn_step(mesh_shape, args.steps, device, ranks)
            report[key].append(rec)
            print(json.dumps(rec), flush=True)
        report["timing_caveat"] = (
            f"{ranks} gloo ranks sharing this host's cores; relative signal only"
            if device.type == "cpu" else
            f"one rank per card over nccl, {ranks} card(s): {torch.cuda.get_device_name(0)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
