"""Where ``evaluate``'s time goes on the card: host assembly against device
work (the port's counterpart of ``scripts/eval_probe.py``).

On the JAX probe's workload (24 videos x 30 clips of ten-crop 2049-d
features, the default-width MGFN, ``batch_videos`` 8), each the min of 2
runs on the host clock:

- ``assemble_only_s``: the assembly ``evaluate`` does on the host, run to
  exhaustion with no device work (buckets by ``eval_bucket`` over
  ``eval_batches``, then each group padded into one array);
- ``eval_serial_s``: ``evaluate`` with ``prefetch_assembly=False``;
- ``eval_prefetch_s``: ``evaluate`` with its assembly on the prefetch
  thread (``data/prefetch.py``, depth 2), the default.

The serial time less the assembly approximates launches, device work,
readback and AUC; serial against prefetch is what the overlap buys. One
JSON line in the JAX report's keys.

    python -m anomaly_detection_on_video_tpu_torch.scripts.eval_probe [--device cpu]
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..data.features import FeatureDataset, eval_batches
from ..models import build_model, seeded_init_
from ..training.optim import adam_with_l2
from ..training.runner import TrainState, evaluate, eval_bucket, make_eval_step
from ..utils.measure import guarded, probe_cli

N_VIDEOS = 24
CLIPS = 30
BATCH_VIDEOS = 8


def build_dataset(n_videos: int = N_VIDEOS, clips: int = CLIPS) -> FeatureDataset:
    """The JAX probe's test set, from the same seeded draws: alternating
    ``Abuse_<i>`` (anomalous first half) and ``Normal_<i>`` videos of
    (clips, 10, 2048) float32 features."""
    rng = np.random.RandomState(0)
    filenames, arrays, labels = [], {}, {}
    for i in range(n_videos):
        name = f"{'Normal' if i % 2 else 'Abuse'}_{i}_i3d.npy"
        arrays[name] = rng.randn(clips, 10, 2048).astype(np.float32)
        frame_labels = np.zeros(clips * 16, np.float32)
        if i % 2 == 0:
            frame_labels[: clips * 8] = 1.0
        labels[name] = frame_labels.tolist()
        filenames.append(name)
    return FeatureDataset(filenames=filenames, _arrays=arrays, labels=labels)


def build_state(device: torch.device, **model_overrides) -> TrainState:
    """MGFN (the default config unless ``model_overrides``), seeded, with
    its Adam state, on ``device``."""
    _, model = build_model("mgfn", **model_overrides)
    model = seeded_init_(model, 0).to(device)
    return TrainState.create(model, adam_with_l2(model.parameters()), seed=1)


def assemble_only(ds: FeatureDataset, batch_videos: int = BATCH_VIDEOS) -> int:
    """``evaluate``'s host assembly with no device work: videos bucketed by
    clip count, each group of up to ``batch_videos`` padded into one
    (group, 10, bucket, C) float32 array. Returns the bytes assembled."""
    buckets: Dict[int, list] = {}
    for batch in eval_batches(ds):
        buckets.setdefault(eval_bucket(batch["feature"].shape[2]), []).append(batch)
    total = 0
    for bucket, items in buckets.items():
        for start in range(0, len(items), batch_videos):
            group = items[start: start + batch_videos]
            feats = np.zeros((len(group), 10, bucket, group[0]["feature"].shape[3]), np.float32)
            for k, item in enumerate(group):
                feats[k, :, : item["feature"].shape[2]] = item["feature"][0]
            total += feats.nbytes
    return total


def min_seconds(fn: Callable[[], object], n: int = 2) -> float:
    """The least host seconds of ``n`` calls (the host swings run to run)."""
    best = float("inf")
    for _ in range(n):
        start = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - start)
    return best


def probe_eval(device: torch.device, n_videos: int = N_VIDEOS, clips: int = CLIPS,
               batch_videos: int = BATCH_VIDEOS, repeats: int = 2, **model_overrides) -> dict:
    """The report: one warm-up ``evaluate``, then each timing the min of
    ``repeats``."""
    state, ds = build_state(device, **model_overrides), build_dataset(n_videos, clips)
    kwargs = dict(eval_step=make_eval_step(), batch_videos=batch_videos)
    evaluate(state, ds, **kwargs)  # cuDNN's plans for the bucket
    assemble_s = min_seconds(lambda: assemble_only(ds, batch_videos), repeats)
    serial_s = min_seconds(lambda: evaluate(state, ds, prefetch_assembly=False, **kwargs), repeats)
    prefetch_s = min_seconds(lambda: evaluate(state, ds, prefetch_assembly=True, **kwargs), repeats)
    total = n_videos * clips
    return {
        "workload": f"{n_videos} videos x {clips} clips, batch_videos={batch_videos}, "
                    f"ten-crop 2049-d",
        "assemble_only_s": round(assemble_s, 4),
        "eval_serial_s": round(serial_s, 4),
        "eval_prefetch_s": round(prefetch_s, 4),
        "device_plus_readback_est_s": round(serial_s - assemble_s, 4),
        "host_assembly_fraction_of_serial": round(assemble_s / serial_s, 4),
        "prefetch_speedup": round(serial_s / prefetch_s, 4),
        "eval_clips_per_sec_serial": round(total / serial_s, 1),
        "eval_clips_per_sec_prefetch": round(total / prefetch_s, 1),
        "assembled_bytes": assemble_only(ds, batch_videos),
    }


def run(device: torch.device, repeats: int = 2, **sizes) -> Iterator[dict]:
    """The report, guarded."""
    yield from guarded("eval_probe", lambda: probe_eval(device, repeats=repeats, **sizes))


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
