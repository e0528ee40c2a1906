"""Time one scoring request through two checkouts of this package, in turns.

A request is ``FeatureExtractor.extract_frames`` of a seeded 240x320 video
followed by ``infer.score_features`` with a seeded MGFN, synchronized, as
``chip_smoke.py`` times its main path (4 clips: one group of B = 40 in
bfloat16). This checkout's package is imported as usual, the
other checkout's under another name in the same process, so both share
one card, one warm process and one clock; each builds its own kernels.
The two run in alternating order, pair by pair, after two warm-up passes
each::

    python -m anomaly_detection_on_video_tpu_torch.compare_request \\
        --against <other checkout> [--pairs 20]

Prints each checkout's median, range and launch counts, the median of the
per-pair differences, the card's name and power limit, and a JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .utils.device import set_f32_parity

PACKAGE = __package__
OTHER = "other_checkout_port"


def load_other(root: str):
    """The package of the checkout at ``root``, imported as ``OTHER``."""
    init = os.path.join(root, PACKAGE, "__init__.py")
    spec = importlib.util.spec_from_file_location(
        OTHER, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = module
    spec.loader.exec_module(module)
    return module


def request(package: str):
    """A warmed 4-clip bfloat16 request through ``package``: -> (run,
    launch counts reader, launch counts reset)."""
    extraction = importlib.import_module(f"{package}.data.extraction")
    infer = importlib.import_module(f"{package}.infer")
    models = importlib.import_module(f"{package}.models")
    kernels = importlib.import_module(f"{package}.ops.kernels")
    video = np.random.RandomState(0).randint(0, 256, (64, 240, 320, 3), dtype=np.uint8)
    extractor = extraction.FeatureExtractor(dtype=torch.bfloat16, batch=40,
                                            device="cuda", seed=0)
    scorer = models.seeded_init_(models.MGFN(), seed=1).to("cuda").eval()

    def run() -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        infer.score_features(extractor.extract_frames(video), scorer)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    for _ in range(2):  # cuDNN plans, the allocator
        run()
    return run, kernels.launch_counts, kernels.reset_launch_counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", required=True, help="root of the other checkout")
    parser.add_argument("--pairs", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_request: torch sees no CUDA device", file=sys.stderr)
        return 1
    set_f32_parity()
    load_other(os.path.abspath(args.against))
    trees = {"this checkout": request(PACKAGE), args.against: request(OTHER)}
    times = {name: [] for name in trees}
    for _, _, reset in trees.values():
        reset()
    for i in range(args.pairs):
        for name in list(trees)[::1 if i % 2 else -1]:
            times[name].append(trees[name][0]())
    diffs = [a - b for a, b in zip(*times.values())]
    summary = {name: {"median_ms": float(np.median(v)), "min_ms": min(v), "max_ms": max(v),
                      "launches": trees[name][1]()} for name, v in times.items()}
    for name, s in summary.items():
        print(f"{name}: 4-clip bfloat16 request, {args.pairs} passes: median "
              f"{s['median_ms']:.3f} ms ({s['min_ms']:.3f}-{s['max_ms']:.3f}); launches "
              f"{s['launches']}", flush=True)
    print(f"this checkout minus the other, per pair: median {np.median(diffs):.3f} ms "
          f"({min(diffs):.3f} to {max(diffs):.3f})", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"pairs": args.pairs, "times_ms": times, "diff_median_ms": float(np.median(diffs)),
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
