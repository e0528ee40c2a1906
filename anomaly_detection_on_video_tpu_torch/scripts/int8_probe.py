"""The int8 extraction pipeline against bf16 on the card (the port's
counterpart of ``scripts/int8_probe.py``).

``FeatureExtractor`` in bf16 (K1, K2, K3, cuDNN) and with ``quantize=True``
(K1, K4, K5 and the elementwise passes around them; scales calibrated on
its first call) on the same 94 seeded clips of 240 x 320 frames, already on
the device, with the same weights: ms per call and clips/s of each, and
the int8 features' agreement with the bf16 ones by the JAX probe's
formulas (one cosine over all features, the max |difference| over the max
|bf16 feature|).

    python -m anomaly_detection_on_video_tpu_torch.scripts.int8_probe [--device cpu]
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from ..data.extraction import FeatureExtractor
from ..utils.measure import guarded, mean_ms, probe_cli
from .stage_probe import FRAME_SHAPE

N_CLIPS = 94


def agreement(ref: np.ndarray, out: np.ndarray) -> dict:
    """The JAX probe's agreement of int8 features ``out`` with bf16 ``ref``."""
    cos = float(np.sum(ref * out) / (np.linalg.norm(ref) * np.linalg.norm(out)))
    rel = float(np.max(np.abs(ref - out)) / np.max(np.abs(ref)))
    return {"cosine_vs_bf16": round(cos, 6), "max_rel_vs_bf16": round(rel, 5)}


def probe_pipelines(device: torch.device, n_clips: int = N_CLIPS, reps: int = 10,
                    frame_shape=FRAME_SHAPE) -> List[dict]:
    """The two records."""
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (n_clips * 16, *frame_shape), np.uint8)
    base = FeatureExtractor(dtype=torch.bfloat16, device=device)
    on_device = torch.from_numpy(frames).to(device)
    ref = base.extract_frames(on_device)
    ms = mean_ms(lambda: base.extract_frames(on_device), reps, device, warmup=0)
    records = [{"probe": "pipeline_bf16", "ms_per_chunk": round(ms, 3),
                "clips_per_sec": round(n_clips / ms * 1e3, 2)}]
    weights = {k: v.detach().cpu() for k, v in base.model.state_dict().items()}
    quant = FeatureExtractor(dtype=torch.bfloat16, state_dict=weights, device=device,
                             quantize=True)
    out = quant.extract_frames(on_device)  # calibrates on these frames first
    ms_q = mean_ms(lambda: quant.extract_frames(on_device), reps, device, warmup=0)
    records.append({"probe": "pipeline_int8", "ms_per_chunk": round(ms_q, 3),
                    "clips_per_sec": round(n_clips / ms_q * 1e3, 2), **agreement(ref, out),
                    "speedup": round(ms / ms_q, 3)})
    return records


def run(device: torch.device, n_clips: int = N_CLIPS, reps: Optional[int] = None,
        frame_shape=FRAME_SHAPE) -> Iterator[dict]:
    """The records, guarded; ``reps`` replaces the JAX probe's 10."""
    yield from guarded("pipeline", lambda: probe_pipelines(device, n_clips, reps or 10,
                                                          frame_shape))


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
