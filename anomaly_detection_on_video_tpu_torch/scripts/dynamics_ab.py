"""Full-scale training-dynamics A/B: the port's train step against a torch
run of the reference's semantics (the port's counterpart of
``scripts/dynamics_ab.py``).

MGFN trained on synthetic features diverges to NaN at the reference's
hyperparameters (Adam lr 1e-3, weight decay 5e-4) in the JAX package. Is
that a property of the objective at that operating point, or of the
implementation? Both sides here start from one initialization (the
oracle's weights, ``tests/torch_oracles.py`` ``OracleMGFN``, mapped to the
port's names), take the same batches in the same order, in float32 with
TF32 off (``full_f32``), at full MGFN width (dims 64/128/1024, channels
2048, ten crops, T = 32), on one device:

- ``port``: the port's ``make_train_step`` and ``AdamWithL2`` on the
  port's MGFN (the side the JAX script calls ``jax``);
- ``torch``: ``OracleMGFN`` + ``oracle_losses`` + ``torch.optim.Adam``,
  the JAX script's ``run_torch``.

Profiles: ``gauss`` (structured unit-scale gaussians) and ``i3dlike``
(relu(gauss) * 10, the all-positive, large-norm statistics of features
from a random-init I3D); ``--features NPZ`` adds ``extracted``, real
segment bags (the port's ``int8_e2e --dump-segments``) trained full-batch.
Each side trains ``--steps`` steps at each lr and records its losses and
its first non-finite step. Verdict: the sides agree when both stay finite
or both turn NaN. Selection dropout is off on both sides: its randomness
cannot be matched, and the oracle does not model it.

    python -m anomaly_detection_on_video_tpu_torch.scripts.dynamics_ab \\
        [--steps 30] [--batch-per-class 8] [--out dynamics_ab.json] [--device cuda]

Writes ``--out`` (default ``dynamics_ab.json`` in the working directory;
``docs/dynamics_ab.json`` is the JAX package's record).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data.features import add_magnitude
from ..models import build_model
from ..training.optim import adam_with_l2
from ..training.runner import TrainState, make_train_step
from ..utils.device import DeviceLike, full_f32, resolve_device
from .parity_check import oracle_to_hf_state_dict, oracles

N_STEPS = 30
# per class; the reference data config uses 16 (configs/data/default.yaml:1);
# the JAX script's 8 + 8 keeps full width and a runnable A/B
BATCH = 8
T = 32
CHANNELS = 2048
LRS = (1e-3, 3e-5)
WEIGHT_DECAY = 5e-4
DEFAULT_OUT = "dynamics_ab.json"


def make_batches(profile: str, seed: int, n_batches: int, batch: int = BATCH):
    """List of (video, nlabels, alabels) float32 batches, normal bags first,
    the magnitude channel appended: the JAX script's batches, bit for bit."""
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(n_batches):
        raw = rng.randn(2 * batch, 10, T, CHANNELS).astype(np.float32)
        if profile == "i3dlike":
            # random-init I3D statistics: post-ReLU, large per-row norms
            raw = np.maximum(raw, 0.0) * 10.0
        else:
            scale = 1.0 + 0.5 * rng.rand(CHANNELS).astype(np.float32)
            raw = raw * scale / np.sqrt(CHANNELS)
        # the abnormal half: one elevated contiguous window per bag
        for b in range(batch, 2 * batch):
            width = max(1, int(T * (0.15 + 0.35 * rng.rand())))
            start = rng.randint(0, T - width + 1)
            raw[b, :, start: start + width, :] *= 1.3
        video = add_magnitude(raw).astype(np.float32)
        batches.append((video, np.zeros(batch, np.float32), np.ones(batch, np.float32)))
    return batches


def randomize_norms(oracle, seed: int) -> None:
    """Adds 0.3 * N(0, 1) to every LayerNorm gain and bias of an
    ``OracleMGFN``. A fresh MGFN's identity norms tie its top-k picks in
    float32, so two implementations' losses part from step 0; random norms
    break the ties and let their losses be held step for step. The A/B
    itself keeps the JAX script's init."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in oracle.named_parameters():
            if "norm" in name or name.endswith((".g", ".b")):
                p.add_(0.3 * torch.randn(p.shape, generator=gen).to(p.device))


def _record(side: str, i: int, val: float) -> None:
    if i % 5 == 0:
        print(f"    {side} step {i}: {val:.4g}", file=sys.stderr, flush=True)


def run_torch(oracle_ctor: Callable, init_sd: dict, batches: list, lr: float, n_steps: int,
              device: DeviceLike = "cuda") -> dict:
    """The oracle trained with ``torch.optim.Adam`` (coupled weight decay),
    the JAX script's ``run_torch`` on ``device``."""
    device = resolve_device(device)
    losses = oracles().oracle_losses
    torch.manual_seed(0)
    oracle = oracle_ctor()
    oracle.load_state_dict(init_sd)
    oracle.to(device).train()
    optimizer = torch.optim.Adam(oracle.parameters(), lr=lr, weight_decay=WEIGHT_DECAY)
    record, nan_step = [], None
    with full_f32():
        for i in range(n_steps):
            video, nlabels, alabels = batches[i % len(batches)]
            optimizer.zero_grad()
            out = oracle(torch.from_numpy(video).to(device), force_split=True)
            loss = losses(*out[:4], torch.from_numpy(alabels).to(device),
                          torch.from_numpy(nlabels).to(device), out[4], video.shape[0])
            val = float(loss.detach())
            record.append(val)
            _record("torch", i, val)
            if not np.isfinite(val):
                nan_step = i
                break
            loss.backward()
            optimizer.step()
    return {"losses": record, "nan_step": nan_step}


def run_port(model_ctor: Callable, init_sd: dict, batches: list, lr: float, n_steps: int,
             device: DeviceLike = "cuda") -> dict:
    """The port's MGFN (from ``init_sd``, the port's names) trained by
    ``make_train_step`` ("32-true": TF32 off) and ``AdamWithL2``."""
    device = resolve_device(device)
    model = model_ctor()
    model.load_state_dict(init_sd)
    model.to(device)
    state = TrainState.create(model, adam_with_l2(model.parameters(), lr, WEIGHT_DECAY))
    step_fn = make_train_step()
    record, nan_step = [], None
    for i in range(n_steps):
        video, nlabels, alabels = batches[i % len(batches)]
        loss = step_fn(state, torch.from_numpy(video).to(device),
                       torch.from_numpy(nlabels).to(device), torch.from_numpy(alabels).to(device))
        val = float(loss)
        record.append(val)
        _record("port", i, val)
        if not np.isfinite(val):
            nan_step = i
            break
    return {"losses": record, "nan_step": nan_step}


def extracted_batches(path: str):
    """Segment bags of an ``.npz`` (name -> (10, T, 2048)) as one full batch,
    normal bags ("Normal" in the name, the reference's rule) first. Returns
    (batches, the config entry)."""
    with np.load(path) as npz:
        segs = {k: npz[k] for k in npz.files}
    normal = [v for k, v in sorted(segs.items()) if "Normal" in k]
    abnormal = [v for k, v in sorted(segs.items()) if "Normal" not in k]
    bags = min(len(normal), len(abnormal))
    video = np.stack([add_magnitude(f) for f in normal[:bags]]
                     + [add_magnitude(f) for f in abnormal[:bags]]).astype(np.float32)
    return ([(video, np.zeros(bags, np.float32), np.ones(bags, np.float32))],
            {"path": path, "bags_per_class": bags, "shape": list(video.shape)})


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=N_STEPS)
    parser.add_argument("--batch-per-class", type=int, default=BATCH)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=DEFAULT_OUT,
                        help=f"output JSON (default {DEFAULT_OUT} in the working directory)")
    parser.add_argument(
        "--profiles", nargs="*", default=["gauss", "i3dlike"], choices=["gauss", "i3dlike"],
        help="synthetic profiles to run (pass none with --features to run only the "
             "extracted-features A/B)")
    parser.add_argument(
        "--features", default=None, metavar="NPZ",
        help="real extracted segment bags (int8_e2e --dump-segments): adds an 'extracted' "
             "profile trained on them full-batch")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    torch_oracles = oracles()

    torch.manual_seed(args.seed)
    init_oracle = torch_oracles.OracleMGFN()
    torch_oracles.randomize_bn_stats(init_oracle, seed=args.seed + 1)
    init_sd = {k: v.detach().clone() for k, v in init_oracle.state_dict().items()}
    port_sd = oracle_to_hf_state_dict(init_sd)

    def port_model():
        return build_model("mgfn", dropout_rate=0.0)[1]

    report = {
        "config": {
            "steps": args.steps,
            "batch_per_class": args.batch_per_class,
            "t": T,
            "channels": CHANNELS,
            "weight_decay": WEIGHT_DECAY,
            "dropout": 0.0,
            "seed": args.seed,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        },
        "runs": {},
    }
    profile_batches = {
        profile: make_batches(profile, args.seed + 100, n_batches=8,
                              batch=args.batch_per_class)
        for profile in args.profiles
    }
    if args.features:
        profile_batches["extracted"], report["config"]["features"] = extracted_batches(
            args.features)
    for profile, batches in profile_batches.items():
        for lr in LRS:
            key = f"{profile}_lr{lr:g}"
            print(f"== {key}", flush=True)
            tr = run_torch(torch_oracles.OracleMGFN, init_sd, batches, lr, args.steps, device)
            print(f"  torch: nan_step={tr['nan_step']} last_loss={tr['losses'][-1]:.4g}",
                  flush=True)
            pr = run_port(port_model, port_sd, batches, lr, args.steps, device)
            print(f"  port:  nan_step={pr['nan_step']} last_loss={pr['losses'][-1]:.4g}",
                  flush=True)
            report["runs"][key] = {
                "torch": tr,
                "port": pr,
                "frameworks_agree": (tr["nan_step"] is None) == (pr["nan_step"] is None),
            }

    agree_all = all(r["frameworks_agree"] for r in report["runs"].values())
    report["verdict"] = (
        "dynamics match: the torch oracle and the port agree on finite-vs-nan at every "
        "(profile, lr) operating point: any lr=1e-3 instability is a property of the "
        "objective/data, not of the port"
        if agree_all
        else "MISMATCH: the torch oracle and the port disagree at some operating point: "
        "investigate before trusting full-scale training"
    )
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v["frameworks_agree"] for k, v in report["runs"].items()}))
    print(report["verdict"])
    return report


if __name__ == "__main__":
    main()
