"""One-command, air-gapped demo of the whole pipeline through the port's
CLIs (the port's counterpart of ``scripts/demo.py``), on the card unless
``--device cpu``:

  1. extraction   a generated MJPG video -> ``extract_features`` ->
                  (n_clips, 10, 2048) clip features at full i3res50 width,
                  random weights, bf16 (the reference's on-disk contract;
                  pass real weights to ``extract_features --weights`` for
                  real features)
  2. training     structured synthetic MIL bags (``data/synthetic.py``, the
                  magnitude signal the MIL objectives key on) in the same
                  on-disk layout -> ``run`` -> frame-level AUC
  3. deployment   the trained checkpoint -> ``infer --export`` -> the
                  scorer's ``torch.export`` programs (``utils/aot.py``)

Run: python -m anomaly_detection_on_video_tpu_torch.scripts.demo
[--workdir demo_run] [--epochs 16] [--skip-extract] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from typing import List, Optional

import numpy as np

from ..data.synthetic import write_synthetic_dataset

PACKAGE = __package__.rsplit(".", 1)[0]  # the port, whatever it is installed as
# the directory that holds the package: the CLIs' working directory
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_cli(module: str, *args) -> str:
    """``python -m <package>.<module> args`` in a process of its own, its
    standard output echoed and returned; a failure exits the demo."""
    cmd = [sys.executable, "-m", f"{PACKAGE}.{module}", *map(str, args)]
    print(f"\n$ python -m {PACKAGE}.{module} {' '.join(map(str, args))}", flush=True)
    result = subprocess.run(cmd, cwd=ROOT, text=True, capture_output=True)
    sys.stdout.write(result.stdout)
    if result.returncode:
        sys.stderr.write(result.stderr)
        raise SystemExit(f"demo step failed: {module} exited {result.returncode}")
    return result.stdout


def write_demo_video(path: str, n_frames: int = 48, size=(320, 240), seed: int = 0) -> None:
    import cv2

    rng = np.random.RandomState(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, size)
    if not writer.isOpened():
        raise SystemExit(f"cv2 cannot write {path}")
    for t in range(n_frames):
        frame = rng.randint(0, 100, (size[1], size[0], 3), np.uint8)
        x = 20 + 4 * t  # a moving bright square, so the video has structure
        frame[60:120, x: x + 60] = 230
        writer.write(frame)
    writer.release()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workdir", default="demo_run")
    parser.add_argument("--epochs", type=int, default=16,
                        help="training epochs for step 2 (16 reaches AUC > 0.8 on the "
                             "structured bags)")
    parser.add_argument("--skip-extract", action="store_true",
                        help="skip step 1 (the I3D forward; slow on the CPU)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.epochs < 1:
        parser.error(f"--epochs must be >= 1 (got {args.epochs})")

    work = os.path.abspath(args.workdir)
    os.makedirs(work, exist_ok=True)
    print(f"demo workdir: {work}")

    # ------------------------------------------------- 1. extraction
    if not args.skip_extract:
        videos = os.path.join(work, "videos")
        os.makedirs(videos, exist_ok=True)
        write_demo_video(os.path.join(videos, "Demo001_x264.avi"))
        run_cli("extract_features", "--videos", videos, "--outdir",
                os.path.join(work, "features"), "--split", "test", "--batch", "30",
                "--device", args.device)
        feats = np.load(os.path.join(work, "features", "test", "Demo001_x264_i3d.npy"))
        print(f"extracted features: shape {feats.shape} "
              "(the reference's (n_clips, 10, 2048) contract)")

    # ------------------------------------------------- 2. training
    bags = os.path.join(work, "synthetic_bags")
    train_dir, test_dir, gt_path = write_synthetic_dataset(bags, seed=0)
    print(f"\nwrote structured synthetic bags under {bags}")

    ckpt_dir = os.path.join(work, "checkpoints")
    out = run_cli(
        "run",
        "runner=mgfn",
        "seed=0",
        f"device={args.device}",
        f"data.train_path={train_dir}",
        f"data.test_path={test_dir}",
        f"data.ground_truth_path={gt_path}",
        "data.batch_size=4",
        "data.shuffle=true",
        f"trainer.max_epochs={args.epochs}",
        f"trainer.log_path={os.path.join(work, 'metrics.jsonl')}",
        f"trainer.checkpoint.dirpath={ckpt_dir}",
        "runner.optimizer.learning_rate=5e-4",
        # the convergence bench's scaled config (scripts.convergence_bench)
        "runner.model_config.channels=64",
        "runner.model_config.dims=[32,64,128]",
        "runner.model_config.depths=[2,2,1]",
        "runner.model_config.dim_head=16",
    )
    match = re.search(r"final valid/rec_auc=([0-9.]+)", out)
    auc = float(match.group(1)) if match else float("nan")
    print(f"trained MGFN frame-level AUC: {auc:.3f} (chance = 0.5)")

    # ------------------------------------------------- 3. deployment
    export_dir = os.path.join(work, "scorer_export")
    run_cli("infer", "--checkpoint", ckpt_dir, "--outdir", os.path.join(work, "scores"),
            "--export", export_dir, "--export-max-clips", "64", "--device", args.device)

    cli = f"python -m {PACKAGE}"
    print(
        "\ndemo complete. What just ran, with real data equivalents:\n"
        f"  1. {cli}.extract_features --videos <UCF-Crime dir> --weights i3res50.pt\n"
        f"  2. {cli}.run runner=mgfn (against extracted segment features + "
        f"{cli}.make_gt_ucf output)\n"
        f"  3. {cli}.infer --videos <new videos> --checkpoint ... (or --from-export "
        f"{export_dir})\n"
        f"  then {cli}.scripts.operating_point --scores <infer outdir> --gt <gt.json> picks a "
        "--threshold.\n"
        "docs/MIGRATION.md maps every reference command onto the JAX CLIs; the port's take the "
        "same flags plus --device."
    )
    # at --epochs >= 8 the structured bags are reliably learnable
    # (scripts.convergence_bench); a bad AUC then means something is broken
    if args.epochs >= 8 and not np.isnan(auc) and auc < 0.7:
        raise SystemExit(f"demo AUC {auc:.3f} is below the expected >= 0.7 at --epochs "
                         f"{args.epochs}: the pipeline ran but training quality regressed")


if __name__ == "__main__":
    main()
