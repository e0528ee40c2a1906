"""int8 end to end: the score and AUC cost of ``--dtype int8`` against
bf16, not only the features' cosine (the port's counterpart of
``scripts/int8_e2e.py``).

The same synthetic corpus is extracted in bf16 and in int8, and both are
scored by the same MGFN, trained on the bf16 features: max and mean
clip-score delta, frame-level ROC AUC under each feature set, and the AUC
delta. The serving protocol (one center crop) is measured the same way,
and so is what the center crop alone costs in bf16. The eval protocol is
the reference's validation loop: crop-averaged clip scores, each repeated
for its 16 frames, ROC over the concatenated frames.

Corpus: synthetic videos where ``Abuse*`` clips hold a bright
high-contrast moving block in their second half and ``Normal*`` videos
never do: enough structure for the MIL objective to separate through a
random-weight, calibrated I3D at full i3res50 width, so the trained scorer
is not degenerate. Real weights: ``--i3d-weights`` (a local ``.pt``,
``.pyth`` or ``.msgpack``, or an ``hf://`` spec, ``utils/hub.py``).

    python -m anomaly_detection_on_video_tpu_torch.scripts.int8_e2e \\
        --out int8_e2e.json [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..data.extraction import FeatureExtractor
from ..data.features import add_magnitude
from ..data.segments import segment_features
from ..infer import load_i3d_weights, score_features
from ..models import build_model, seeded_init_
from ..ops.metrics import frame_level_scores, roc_auc
from ..training.optim import adam_with_l2
from ..training.runner import TrainState, make_eval_step, make_train_step
from ..utils.device import DeviceLike, resolve_device
from ..utils.hub import is_hub_spec

VARIANTS = ("tencrop_bf16", "tencrop_int8", "center_bf16", "center_int8")


def synth_video(n_frames: int, anomalous: bool, seed: int) -> np.ndarray:
    """(n_frames, 240, 320, 3) uint8; anomalies occupy the second half."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 90, (n_frames, 240, 320, 3), np.uint8)
    for t in range(n_frames):
        # common structure: a dim drifting square (both classes)
        x = (10 + 2 * t) % 240
        frames[t, 40:90, x: x + 50] = 140
        if anomalous and t >= n_frames // 2:
            # the anomaly: a large bright flickering block, strong contrast
            y = (30 + 5 * t) % 120
            frames[t, y: y + 80, 60:220] = 255 if t % 2 else 10
    return frames


def gt_frames(n_frames: int, n_clips: int, anomalous: bool) -> list:
    """Frame-level GT over the feature timeline (n_clips * 16 frames)."""
    labels = np.zeros(n_clips * 16, np.float32)
    if anomalous:
        labels[min(n_frames // 2, len(labels)):] = 1.0
    return labels.tolist()


def train_scorer(seg_features: dict, steps: int, seed: int = 0,
                 device: DeviceLike = "cuda") -> TrainState:
    """MGFN at its default width, trained on the bf16 segment bags."""
    device = resolve_device(device)
    normal = [v for k, v in sorted(seg_features.items()) if "Normal" in k]
    abnormal = [v for k, v in sorted(seg_features.items()) if "Normal" not in k]
    bags = min(len(normal), len(abnormal))
    # normal bags first, the magnitude channel appended (the training contract)
    feature = torch.from_numpy(np.stack(
        [add_magnitude(f) for f in normal[:bags]] + [add_magnitude(f) for f in abnormal[:bags]]
    ).astype(np.float32)).to(device)
    _, model = build_model("mgfn", channels=feature.shape[-1] - 1)  # 2048: the default
    model = seeded_init_(model, seed).to(device)
    # lr 3e-5 and clip 1.0: the reference's 1e-3 (and 3e-4) diverges to NaN within
    # steps on random-weight I3D features (the margin-200 magnitude term explodes)
    state = TrainState.create(model, adam_with_l2(model.parameters(), 3e-5, grad_clip=1.0),
                              seed + 2)
    step = make_train_step()
    normal_l = torch.zeros(bags, device=device)
    abnormal_l = torch.ones(bags, device=device)
    loss = None
    for _ in range(steps):
        loss = step(state, feature, normal_l, abnormal_l)
    final = float(loss)
    print(f"trained {steps} steps, final loss {final:.4f}", file=sys.stderr)
    if not np.isfinite(final):
        raise SystemExit("scorer training diverged (NaN loss): score deltas would be "
                         "meaningless; lower the lr in train_scorer")
    state.model.eval()
    return state


def score_corpus(state: TrainState, clip_features: dict) -> dict:
    """filename -> (n_clips,) crop-averaged clip scores."""
    eval_step = make_eval_step()
    return {name: score_features(feats, state.model, eval_step)
            for name, feats in sorted(clip_features.items())}


def auc_over(scores: dict, gt: dict) -> float:
    preds, labels = [], []
    for name in sorted(scores):
        preds.append(frame_level_scores(scores[name], 16))
        labels.append(np.asarray(gt[name], np.float32))
    return float(roc_auc(np.concatenate(labels), np.concatenate(preds)))


def compare(a: dict, b: dict, gt: dict, label: str) -> dict:
    deltas = np.concatenate([np.abs(a[name] - b[name]) for name in sorted(a)])
    rep = {
        "protocol": label,
        "max_abs_score_delta": round(float(deltas.max()), 6),
        "mean_abs_score_delta": round(float(deltas.mean()), 6),
        "auc_bf16": round(auc_over(a, gt), 6),
        "auc_int8": round(auc_over(b, gt), 6),
    }
    rep["auc_delta"] = round(abs(rep["auc_bf16"] - rep["auc_int8"]), 6)
    return rep


def build_extractors(state_dict: Optional[dict], device: DeviceLike,
                     calibration_dir: str) -> dict:
    """The four extraction variants at full i3res50 width, built once,
    sharing one set of weights (``state_dict``, else the seeded random
    ones) and reused across seeds. Each int8 variant pins its scales to
    ``calibration_dir/<variant>`` (``FeatureExtractor.pin_calibration``,
    as the CLIs pin theirs to the output directory): they calibrate on
    the first video they see and stay fixed for every later corpus, or
    load from there when a run left them."""
    bf16 = FeatureExtractor(dtype=torch.bfloat16, state_dict=state_dict, device=device)
    weights = {k: v.detach().cpu() for k, v in bf16.model.state_dict().items()}
    extractors = {"tencrop_bf16": bf16}
    for name in VARIANTS[1:]:
        extractors[name] = FeatureExtractor(dtype=torch.bfloat16, state_dict=weights,
                                            device=device, quantize=name.endswith("int8"),
                                            crops="center" if name.startswith("center") else "ten")
    for name, extractor in extractors.items():
        extractor.pin_calibration(os.path.join(calibration_dir, name))
    return extractors


def run_seed(args: argparse.Namespace, extractors: dict, seed: int) -> dict:
    """One full corpus -> extract (4 variants) -> train -> score -> report."""
    features = {k: {} for k in extractors}
    segs, gt = {}, {}
    n_clips = args.frames // 16
    for i in range(args.n_videos):
        anomalous = i % 2 == 1
        name = f"{'Abuse' if anomalous else 'Normal_Videos'}{i:03d}_x264"
        frames = synth_video(args.frames, anomalous, seed=1000 * seed + 10 + i)
        gt[name] = gt_frames(args.frames, n_clips, anomalous)
        for key, ex in extractors.items():
            # decoded once per video (frames in memory), extracted per variant:
            # quantization and crop effects apart from any decode variance
            features[key][name] = ex.extract_frames(frames)
        segs[name] = segment_features(features["tencrop_bf16"][name])
        print(f"seed {seed}: extracted {name} ({n_clips} clips x {len(extractors)} variants)",
              file=sys.stderr)

    if args.dump_segments and seed == args.seeds[0]:
        # the first seed's bf16 ten-crop segment bags, as extracted
        np.savez_compressed(args.dump_segments, **segs)
        print(f"segments -> {args.dump_segments}", file=sys.stderr)

    state = train_scorer(segs, args.steps, seed=seed, device=args.device)
    scores = {k: score_corpus(state, v) for k, v in features.items()}
    report = {
        "seed": seed,
        "tencrop": compare(scores["tencrop_bf16"], scores["tencrop_int8"], gt, "tencrop"),
        "center_serving": compare(scores["center_bf16"], scores["center_int8"], gt, "center"),
    }
    # the serving protocol's own cost, same scorer and corpus, bf16 both
    report["protocol_cost_bf16"] = {
        "auc_tencrop": report["tencrop"]["auc_bf16"],
        "auc_center": report["center_serving"]["auc_bf16"],
        "auc_delta_ten_minus_center": round(
            report["tencrop"]["auc_bf16"] - report["center_serving"]["auc_bf16"], 6),
    }
    return report


def _agg(values) -> dict:
    arr = np.asarray(values, np.float64)
    return {
        "mean": round(float(arr.mean()), 6),
        "min": round(float(arr.min()), 6),
        "max": round(float(arr.max()), 6),
        "per_seed": [round(float(v), 6) for v in arr],
    }


def aggregate(runs: list) -> dict:
    def over(part: str, key: str) -> dict:
        return _agg([r[part][key] for r in runs])

    return {
        "int8_auc_delta_tencrop": over("tencrop", "auc_delta"),
        "int8_auc_delta_center": over("center_serving", "auc_delta"),
        "int8_max_score_delta_tencrop": over("tencrop", "max_abs_score_delta"),
        "int8_max_score_delta_center": over("center_serving", "max_abs_score_delta"),
        "protocol_auc_cost_center_vs_tencrop_bf16": over("protocol_cost_bf16",
                                                         "auc_delta_ten_minus_center"),
        "auc_bf16_tencrop": over("tencrop", "auc_bf16"),
        "auc_bf16_center": over("center_serving", "auc_bf16"),
    }


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n-videos", type=int, default=12, help="total (half Normal, half Abuse)")
    parser.add_argument("--frames", type=int, default=256)
    parser.add_argument("--steps", type=int, default=150,
                        help="scorer training steps on the bf16 bags")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2],
                        help="one full corpus and scorer per seed: the int8 and center-crop AUC "
                             "deltas are reported as mean/min/max across seeds, not one draw")
    parser.add_argument("--i3d-weights", default=None,
                        help="optional real i3res50 weights: a local .pt, .pyth or .msgpack, or "
                             "an hf://org/repo/file spec from the HF hub")
    parser.add_argument("--dump-segments", default=None, metavar="NPZ",
                        help="save the first seed's bf16 segment bags")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None,
                        help="the JSON report; the int8 scales are pinned beside it, in "
                             "<out stem>_scales/<variant>/ (a rerun into the same --out reuses "
                             "them, as the CLIs' output directories do)")
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.i3d_weights and not is_hub_spec(args.i3d_weights) and not os.path.isfile(
            args.i3d_weights):
        parser.error(f"--i3d-weights {args.i3d_weights!r}: no such file (or use "
                     "hf://org/repo/file)")
    try:
        state_dict = (load_i3d_weights(args.i3d_weights, "tushar-n-baseline") if args.i3d_weights
                      else None)
    except FileNotFoundError as exc:  # an hf:// spec that cannot be had
        raise SystemExit(str(exc))
    with tempfile.TemporaryDirectory(prefix="int8_e2e_scales_") as tmp:
        scales = os.path.splitext(args.out)[0] + "_scales" if args.out else tmp
        extractors = build_extractors(state_dict, args.device, scales)
        runs = []
        for seed in args.seeds:
            runs.append(run_seed(args, extractors, seed))
            if args.out:
                # per-seed partial dump: an interrupted run keeps its finished seeds
                with open(args.out + ".partial", "w") as f:
                    json.dump(runs, f, indent=1)
    report = {
        "n_videos": args.n_videos,
        "clips_per_video": args.frames // 16,
        "scorer_train_steps": args.steps,
        "seeds": args.seeds,
        "i3d_weights": args.i3d_weights or "random-init (calibrated int8)",
        "device": (torch.cuda.get_device_name(args.device) if args.device.type == "cuda"
                   else "cpu"),
        "aggregate": aggregate(runs),
        "per_seed": runs,
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
