"""Parity of the port against the reference topologies, on real artifacts
when they exist (the port's counterpart of ``scripts/parity_check.py``).

The reference's real artifacts are the I3D weights of the HF model
``jinmang2/test_video_fe`` and MGFN checkpoints trained on
``jinmang2/ucf_crime_tencrop_i3d_seg32``. This tool holds the port to the
reference's behaviour on them in one command:

    python -m anomaly_detection_on_video_tpu_torch.scripts.parity_check \\
        --videos /data/ucf_crime_sample \\
        --i3d-weights hf://jinmang2/test_video_fe/converted_ref_i3d.pt \\
        --mgfn-weights mgfn_hf.pt \\
        --test-features /data/features/test --gt ground_truth.json \\
        --out parity_report.json [--device cuda]

``--i3d-weights`` / ``--mgfn-weights`` take local paths or ``hf://`` specs
(``utils/hub.py``: downloaded by ``huggingface_hub`` where it is installed,
else read from the local Hugging Face cache). The comparison side is ``tests/torch_oracles.py``
(``TorchI3Res50``, ``OracleMGFN``): torch-primitive rebuilds of the
reference topologies, loaded from the repository's ``tests/`` by path. No
other module of the port imports them, and the port is not built from them.

The JSON report holds, as the JAX script's does:
- ``i3d``: per video, the max |difference| of the I3D forward per stage
  (``stem`` before its ReLU and pool, the last block of ``stage1``-``stage4``,
  the pooled ``features``) between the oracle and the port's plain chain
  (``I3DResNet.forward_unfused``) on the same preprocessed clips, in
  ``--dtype``; and under ``pipeline``, the port's production extractor
  (``FeatureExtractor`` in float32, ``batch=10``: on the card kernels K1-K3)
  against the oracle's features;
- ``mgfn_scores``: per video, the clip-score max |difference| of the
  oracle and the port's MGFN on the extractor's features;
- ``auc``: frame-level ROC / PR AUC over ``--test-features`` + ``--gt``
  by both (``port`` and ``torch``; the JAX script's ``jax`` key is the
  port's here), with ``weights`` saying whether MGFN had
  ``--mgfn-weights`` or the port's seeded random init (then the oracle is
  not run);
- ``decode``: a decode fingerprint per video (``data/video.py``
  ``decode_provenance``); ``--decode-backend both`` fingerprints OpenCV and
  decord (the reference's decoder) and names the first chunk that differs.
  Without decord the report carries an ``error`` entry for it.

Every float32 comparison runs both sides with TF32 off (``full_f32``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..data.extraction import FeatureExtractor
from ..data.features import add_magnitude, build_feature_dataset
from ..data.video import decode_provenance, decode_video_frames, find_videos
from ..models import build_model, seeded_init_
from ..models.i3d import I3RES50_STAGES, I3DResNet, conv_bn
from ..ops.gtransforms import preprocess_frames
from ..ops.metrics import frame_level_scores, pr_auc, roc_auc
from ..training.optim import adam_with_l2
from ..training.runner import TrainState, evaluate
from ..utils.convert import load_known_keys, mgfn_key_refused
from ..utils.device import DeviceLike, full_f32, resolve_device
from ..utils.hub import resolve_weights

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ORACLES = os.path.join(REPO, "tests", "torch_oracles.py")
MGFN_ORACLE_KEYS = ("dims", "depths", "types", "channels", "dim_head", "mag_ratio", "k")


def oracles():
    """``tests/torch_oracles.py``, loaded by path once per process."""
    if "torch_oracles" not in sys.modules:
        if not os.path.isfile(ORACLES):
            raise FileNotFoundError(f"the reference topologies are not there: {ORACLES}")
        spec = importlib.util.spec_from_file_location("torch_oracles", ORACLES)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["torch_oracles"] = module
    return sys.modules["torch_oracles"]


def decode_frames(path: str, max_frames: int, backend: str = "cv2") -> np.ndarray:
    """The first ``max_frames`` RGB frames by OpenCV or decord (sequential
    ``vr[i]``, as the reference reads)."""
    return decode_video_frames(path, count=max_frames, backend=backend)


def decode_provenance_report(path: str, max_frames: int, backend: str = "cv2") -> dict:
    """Decode fingerprint(s), so that a feature difference on real video is
    attributed to the decode or to the model; ``both`` names the first
    chunk where OpenCV and decord differ."""
    backends = ["cv2", "decord"] if backend == "both" else [backend]
    report = {}
    for b in backends:
        try:
            report[b] = decode_provenance(path, backend=b, max_frames=max_frames)
        except ImportError:
            report[b] = {
                "error": "decord is not installed — install it to "
                "fingerprint the reference's decoder"
            }
    if backend == "both" and all("chunk_sha256" in r for r in report.values()):
        a, b = report["cv2"]["chunk_sha256"], report["decord"]["chunk_sha256"]
        report["match"] = a == b and (
            report["cv2"]["decoded_frame_count"]
            == report["decord"]["decoded_frame_count"]
        )
        if not report["match"]:
            diverge = next(
                (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)),
            )
            report["first_divergent_chunk"] = diverge
    return report


def oracle_to_hf_state_dict(oracle) -> dict:
    """The oracle's MGFN names -> the reference's HF names, which are the
    port's (``backbone.amplifier.*``, ``backbone.layers.{s}.{b}.*``,
    ``layer_norm``, ``fc``). Takes a module or a ``{name: tensor}`` dict."""
    sd = oracle if isinstance(oracle, dict) else oracle.state_dict()
    out = {}
    for key, val in sd.items():
        if key.startswith(("to_tokens", "to_mag")):
            out["backbone.amplifier." + key] = val
        elif key.startswith("layers."):
            out["backbone." + key] = val
        else:
            out[key] = val
    return out


def hf_to_oracle_state_dict(hf_state_dict: dict) -> dict:
    """The inverse of ``oracle_to_hf_state_dict``."""
    out = {}
    for key, val in hf_state_dict.items():
        if key.startswith("backbone.amplifier."):
            out[key[len("backbone.amplifier."):]] = val
        elif key.startswith("backbone.layers."):
            out[key[len("backbone."):]] = val
        else:
            out[key] = val
    return out


def i3d_stage_parity(frames: np.ndarray, state_dict: dict, dtype_name: str = "float32",
                     max_clips: int = 2, device: DeviceLike = "cuda", stages=I3RES50_STAGES,
                     port_state_dict: Optional[dict] = None):
    """Per-stage max |difference|: the oracle ``TorchI3Res50`` against the
    port's plain chain, on the same clips in ``dtype_name``.

    ``frames``: uint8 ``(n_frames, H, W, 3)``, preprocessed by the port
    (exact resize, ten crops, standardization) for both sides. ``stages``
    narrows both models' depth (the oracle takes each stage's block count).
    ``port_state_dict`` gives the port other weights than the oracle's:
    a perturbed copy shows that the report discriminates. Returns (report,
    the oracle's pooled features ``(n, 10, 2048)`` as numpy)."""
    device = resolve_device(device)
    use_f64 = dtype_name == "float64"
    tdtype = torch.float64 if use_f64 else torch.float32
    frames = frames[: max_clips * 16]  # the first clips depend on their own frames only
    clips = preprocess_frames(torch.from_numpy(np.ascontiguousarray(frames)).to(device))
    clips = clips[:max_clips]  # (n, 10, 16, 224, 224, 3) float32
    n, ncrops = clips.shape[:2]
    batch = clips.reshape((n * ncrops,) + tuple(clips.shape[2:])).to(tdtype)

    oracle = oracles().TorchI3Res50(layers=tuple(stage[1] for stage in stages))
    missing, unexpected = oracle.load_state_dict(state_dict, strict=False)
    oracle = oracle.to(device, tdtype).eval()
    model = I3DResNet(stages, dtype=tdtype)
    load_known_keys(model, port_state_dict if port_state_dict is not None else state_dict,
                    "I3D weights")
    model = model.to(device).eval()

    def hook(store, name):
        def record(_module, _inputs, out):
            store[name] = out.detach()
        return record

    # the hooks live as long as these two models, which no one else holds
    oracle_taps, port_taps = {}, {}
    oracle.bn1.register_forward_hook(hook(oracle_taps, "stem"))
    for s in range(1, len(stages) + 1):
        getattr(oracle, f"layer{s}")[-1].register_forward_hook(hook(oracle_taps, f"stage{s}"))
        getattr(model, f"layer{s}")[-1].register_forward_hook(hook(port_taps, f"stage{s}"))
    with torch.no_grad(), full_f32():
        torch_feats = oracle(batch.permute(0, 4, 1, 2, 3)).flatten(1)
        # the stem's conv + BN before ReLU and pool, as the JAX model's tap
        port_taps["stem"] = conv_bn(batch.permute(0, 4, 1, 2, 3), model.conv1, model.bn1)
        ours = model.head(model.forward_unfused(batch))

    def diff(a: torch.Tensor, b: torch.Tensor) -> float:
        return float((a.to(tdtype) - b.to(tdtype)).abs().max())

    stage_diffs = {"stem": diff(port_taps["stem"], oracle_taps["stem"])}
    for s in range(1, len(stages) + 1):
        stage_diffs[f"stage{s}"] = diff(port_taps[f"stage{s}"], oracle_taps[f"stage{s}"])
    stage_diffs["features"] = diff(ours, torch_feats)
    report = {
        "dtype": dtype_name,
        "n_clips": int(n),
        "missing_keys": sorted(missing),
        "unexpected_keys": sorted(unexpected),
        "max_abs_diff": stage_diffs,
    }
    return report, torch_feats.float().cpu().numpy().reshape(n, ncrops, -1)


def pipeline_feature_parity(frames: np.ndarray, state_dict: dict, torch_feats: np.ndarray,
                            max_clips: int = 2, device: DeviceLike = "cuda"):
    """The port's production extractor (float32, ``batch=10``: device
    resize, ten crops and standardization, then the model; on the card
    kernels K1, K2 and K3) against the oracle's pooled features, which the
    stage check cannot cover. Returns (report, the features)."""
    extractor = FeatureExtractor(model_name="tushar-n-baseline", state_dict=state_dict,
                                 dtype=torch.float32, batch=10, device=device)
    ours = extractor.extract_frames(frames[: max_clips * 16])[:max_clips]
    return {
        "max_abs_diff": float(np.abs(ours - torch_feats[: len(ours)]).max()),
        "n_clips": int(len(ours)),
    }, ours


def _mgfn_pair(hf_state_dict: Optional[dict], config_overrides: Optional[dict],
               device: torch.device, k_cap: Optional[int] = None):
    """(the oracle or None, the port's MGFN) on ``device`` in eval mode:
    both with ``hf_state_dict`` when given, else the port's seeded init
    alone. ``k_cap`` clamps top-k on both sides, as the JAX script does."""
    overrides = dict(config_overrides or {})
    if k_cap is not None:
        overrides["k"] = min(overrides.get("k", 3), k_cap)
    oracle = None
    if hf_state_dict is not None:
        oracle = oracles().OracleMGFN(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in overrides.items() if k in MGFN_ORACLE_KEYS})
        oracle.load_state_dict(hf_to_oracle_state_dict(hf_state_dict))
        oracle = oracle.to(device).eval()
    port_over = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in overrides.items() if k != "types"}
    if "types" in overrides:
        port_over["mgfn_types"] = tuple(overrides["types"])
    _, model = build_model("mgfn", **port_over)
    if hf_state_dict is not None:
        load_known_keys(model, hf_state_dict, "--mgfn-weights", refuse=mgfn_key_refused)
    else:
        seeded_init_(model, 0)
    return oracle, model.to(device).eval()


def mgfn_score_parity(features: np.ndarray, hf_state_dict: dict,
                      config_overrides: Optional[dict] = None, device: DeviceLike = "cuda"
                      ) -> dict:
    """Clip-score max |difference|: the oracle MGFN against the port's on
    the same ``(n_clips, 10, 2048)`` float32 features, inference path (the
    reference's validation step)."""
    device = resolve_device(device)
    oracle, model = _mgfn_pair(hf_state_dict, config_overrides, device,
                               k_cap=features.shape[0])
    video = torch.from_numpy(
        np.transpose(add_magnitude(features), (1, 0, 2))[None].astype(np.float32)).to(device)
    with torch.no_grad(), full_f32():
        *_, torch_scores = oracle(video)
        ours = model(video)
    torch_scores = torch_scores.cpu().numpy()[0, :, 0]
    ours = ours.cpu().numpy()[0, :, 0]
    return {
        "max_abs_diff": float(np.abs(ours - torch_scores).max()),
        "n_clips": int(len(ours)),
    }


def auc_summary(test_features_dir: str, gt_path: str, hf_state_dict: Optional[dict] = None,
                config_overrides: Optional[dict] = None, device: DeviceLike = "cuda") -> dict:
    """Frame-level ROC / PR AUC over a feature directory and its ground
    truth, by the port's ``evaluate`` and, with ``hf_state_dict``, by the
    oracle (each clip score repeated for its 16 frames, as the reference's
    validation loop)."""
    device = resolve_device(device)
    dataset = build_feature_dataset("test", local_path=test_features_dir,
                                    ground_truth_path=gt_path)
    oracle, model = _mgfn_pair(hf_state_dict, config_overrides, device)
    ours = evaluate(TrainState.create(model, adam_with_l2(model.parameters())), dataset)
    report = {
        "weights": "--mgfn-weights" if hf_state_dict is not None
        else "the port's seeded random init (models.seeded_init_, seed 0)",
        "port": {"rec_auc": float(ours.rec_auc), "pr_auc": float(ours.pr_auc)},
    }
    if oracle is not None:
        preds, labels = [], []
        for i in range(len(dataset)):
            item = dataset[i]
            # the dataset's features already carry the magnitude channel
            video = torch.from_numpy(np.transpose(item["feature"], (1, 0, 2))[None]).to(device)
            with torch.no_grad(), full_f32():
                *_, scores = oracle(video)
            preds.append(frame_level_scores(scores.cpu().numpy()[0, :, 0], 16))
            labels.append(np.asarray(item["label"], np.float32).ravel())
        preds, labels = np.concatenate(preds), np.concatenate(labels)
        report["torch"] = {"rec_auc": float(roc_auc(labels, preds)),
                           "pr_auc": float(pr_auc(labels, preds))}
        report["rec_auc_diff"] = abs(report["port"]["rec_auc"] - report["torch"]["rec_auc"])
    return report


def _load_torch(path: str, unwrap: str):
    state_dict = torch.load(resolve_weights(path), map_location="cpu", weights_only=True)
    if isinstance(state_dict, dict) and unwrap in state_dict:
        state_dict = state_dict[unwrap]
    return state_dict


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--videos", help="video file/dir/glob for I3D parity")
    parser.add_argument("--i3d-weights",
                        help="torch I3Res50 state dict, reference layout "
                             "(converted_ref_i3d.pt from jinmang2/test_video_fe), or an hf:// "
                             "spec from the HF hub")
    parser.add_argument("--mgfn-weights",
                        help="torch MGFN state dict, HF layout (convert the official release's "
                             "with the convert_checkpoint tool first)")
    parser.add_argument("--mgfn-config", default=None,
                        help="JSON dict of MGFN config overrides "
                             '(e.g. \'{"dims": [64, 128, 1024]}\')')
    parser.add_argument("--test-features", help="feature dir for AUC summary")
    parser.add_argument("--gt", help="ground-truth json for AUC summary")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"],
                        help="float64 runs the stage check in float64 (the pipeline stays "
                             "float32)")
    parser.add_argument("--decode-backend", default="cv2", choices=["cv2", "decord", "both"],
                        help="decoder for the I3D parity frames; 'both' fingerprints OpenCV "
                             "and decord (the reference's decoder) per chunk (decord must be "
                             "installed)")
    parser.add_argument("--max-videos", type=int, default=2)
    parser.add_argument("--max-frames", type=int, default=128)
    parser.add_argument("--max-clips", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--out", default=None, help="write the report JSON here")
    args = parser.parse_args(argv)

    # every flag must reach a check that runs: a half-given pair would
    # print an empty report and exit 0, which reads as "parity passed"
    if bool(args.videos) != bool(args.i3d_weights):
        parser.error(
            "--videos and --i3d-weights go together (I3D feature parity "
            "needs both)"
        )
    if bool(args.test_features) != bool(args.gt):
        parser.error(
            "--test-features and --gt go together (the AUC summary needs "
            "both)"
        )
    if not (args.videos and args.i3d_weights) and not (
        args.test_features and args.gt
    ):
        hint = (
            " (--mgfn-weights alone checks nothing: MGFN scores ride the "
            "I3D features or the AUC summary)"
            if args.mgfn_weights
            else ""
        )
        parser.error(
            "nothing to check: pass --videos + --i3d-weights and/or "
            "--test-features + --gt" + hint
        )
    device = resolve_device(args.device)

    report = {}
    try:
        mgfn_sd = _load_torch(args.mgfn_weights, "state_dict") if args.mgfn_weights else None
        i3d_sd = (_load_torch(args.i3d_weights, "model_state")
                  if args.videos and args.i3d_weights else None)
    except FileNotFoundError as exc:  # an hf:// spec that cannot be had, or a missing file
        raise SystemExit(str(exc))
    mgfn_over = json.loads(args.mgfn_config) if args.mgfn_config else None

    if i3d_sd is not None:
        # the extraction CLI's finder: a sample directory resolves to the
        # videos it did at extraction
        videos = find_videos(args.videos)[: args.max_videos]
        if not videos:
            raise SystemExit(f"no videos match {args.videos!r}")
        report["i3d"] = {}
        # the model probes decode with the production decoder unless
        # --decode-backend=decord asks for the reference's
        probe_backend = "decord" if args.decode_backend == "decord" else "cv2"
        for path in videos:
            name = os.path.basename(path)
            report.setdefault("decode", {})[name] = decode_provenance_report(
                path, args.max_frames, args.decode_backend)
            frames = decode_frames(path, args.max_frames, probe_backend)
            stage_rep, torch_feats = i3d_stage_parity(frames, i3d_sd, args.dtype,
                                                      args.max_clips, device)
            pipe_rep, ours_feats = pipeline_feature_parity(frames, i3d_sd, torch_feats,
                                                           args.max_clips, device)
            stage_rep["pipeline"] = pipe_rep
            report["i3d"][name] = stage_rep
            if mgfn_sd is not None:
                report.setdefault("mgfn_scores", {})[name] = mgfn_score_parity(
                    ours_feats, mgfn_sd, mgfn_over, device)

    if args.test_features and args.gt:
        report["auc"] = auc_summary(args.test_features, args.gt, mgfn_sd, mgfn_over, device)

    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report -> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
