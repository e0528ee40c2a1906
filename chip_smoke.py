#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. build the CUDA kernels from ``anomaly_detection_on_video_tpu_torch/csrc``
   with nvcc for sm_90a, and print the card's name and power limit and K2's
   bf16 tile and occupancy (shared bytes, CTAs per SM);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes, and time the kernel, the plain version and, where one exists, a
   single PyTorch library call with CUDA events:
   K1 ten-crop + standardize bit-equal in float32 and bfloat16 at
   (24, 16, 256, 341, 3), at gc = 1 for 341x256, 256x455, 224x224 and
   257x301 frames, and at an odd crop size (its scalar-store path), with
   its launch plan (band height, shared bytes) printed; K1 timed at the
   bulk shape in both types beside its bound and achieved TB/s, and in
   bfloat16 across shared-memory budgets of its plan;
   K2 stem and K3 for the three stage-1 blocks at B = 40,
   float32 with TF32 off to atol = rtol = 1e-4, bfloat16 to cosine >= 0.9999
   against the float32 plain version; K2 and K3 again, checked and timed, at
   B = 240, the bulk-extraction batch. Every BatchNorm of the model gets
   seeded random affines and running statistics first, so the kernels'
   per-channel epilogues are checked with distinct scales and shifts;
3. the main path: a seeded 64-frame 240x320 uint8 video (4 clips, 40
   crops) -> full-width i3res50 in bfloat16 -> (4, 10, 2048) features ->
   default-config MGFN -> clip and frame scores, with seeded random weights.
   Launch counts reset just before this run and are read just after it:
   K1 >= 1, K2 >= 1, K3 >= 3. The features must agree with the same
   forward through the plain versions in float32 (cosine >= 0.999 per row)
   and the scores must be finite and in [0, 1]. The path is timed over
   five passes (median and range), and one more pass runs under
   torch.profiler for the device-time breakdown;
4. the int8 path: K4 (int8 matrix product) and K5 (int8 conv) at the TPU
   probe's own shapes, and K4 at two edge shapes (M not a multiple of 128;
   N = 128 with K = 64) in all three epilogues, bit-equal to their plain
   versions, timed against their bound and, for K4, ``torch._int_mm`` on
   the same packed (N, K) weights as its column-major operand; then the
   int8 main path,
   ``FeatureExtractor(quantize=True)`` in bfloat16 on the same video,
   weights and scorer, calibrating in its warm-up pass. Launch counts are
   reset just before its timed pass and read just after: K1 >= 1,
   K4 >= 27, K5 >= 26, K2 = K3 = 0. Every K4 and K5 call of one more
   int8 forward is held at its own shape and input against the plain
   version, bit-equal, and timed (CUDA events over 10 launches for the
   JSON line, and the profiler's device time beside them, for K4 and for
   ``torch._int_mm``): at B = 40 (the JSON line) and again at B = 240, the
   bulk-extraction batch. K5's calls are also summed by geometry class
   (stem, k(1,3,3) s1 and s2, k(3,1,1)) with their bound, beside a bf16
   cuDNN ``F.conv3d`` of the same geometries as a yardstick the port never
   calls. The features must equal the same int8
   forward through the plain versions (gate: cosine >= 0.99999 per row;
   the count of unequal elements is printed), reach cosine >= 0.99
   against the plain float32 forward, and the scores must lie in [0, 1];
5. both main paths end to end at the bulk batch: a seeded 384-frame
   240x320 video (24 clips, one group of B = 240) through
   ``FeatureExtractor(batch=240)`` and ``score_features``, bfloat16 and
   int8, each with a warm-up pass (the int8 one calibrates), five timed
   passes (median, range, clips/s, peak memory) and one profiled pass
   (busy time, idle share, K1's device time), under the same gates as the
   4-clip paths;
6. the float32 extractor at 8 frames per clip (``FeatureExtractor(
   frames_per_clip=8)`` on the same video and weights): the clip shape K2
   and K3 do not take, so the model runs the plain torch chain, as the JAX
   model runs such clips through XLA. Gates: K1 launched, K2 and K3 not;
   features against the plain float32 forward at atol = rtol = 1e-4;
7. K5's int8 stem conv at B = 480, whose (480, 8, 112, 112, 64) output
   holds 3.1e9 values, past 2^31: bit-equal to its plain version,
   computed in slices of 40 clips, and timed;
8. MGFN training through the port's ``run`` (``main``, or ``train`` with
   ``RUN_CONFIGS`` where PyYAML is missing) at the full
   ``runner=mgfn`` width: the committed ``docs/i3d_segments_seed0.npz``
   bags (six normal, six abnormal) as train features and, transposed to
   (32, 10, 2048), as test features with a ground truth built by the
   port's ``make_gt_ucf`` from an annotation file written here; batch 3,
   10 epochs, ``max_steps`` 20, eval every 5 epochs, learning rate 1e-4
   (at the config's 1e-3 the JAX trainer diverges on these 12 bags, and
   the port with it). Gates: every loss finite, the mean of the last 5
   below the mean of the first 5, AUCs finite and in [0, 1], and
   ``eval_only`` from the step-20 checkpoint printing the same AUCs.
   Then the train step at the reference batch
   (16 normal + 16 abnormal bags of (10, 32, 2049), made from a seed) in
   ``32-true`` and ``bf16-mixed``: median ms per step, steps/s, peak
   memory and one profiled step's device time;
9. the three scorer families served through the scoring CLI: RTFM (20
   steps) and Sultani (100 steps: its hinge loss is noisy under dropout
   0.6) trained at the full ``runner=rtfm`` / ``runner=sultani`` width
   through ``run`` on the same bags at lr 1e-4 (the rate at which the JAX
   trainer's loss falls on them), under phase 8's gates (Sultani's over
   windows of 10 losses), and their train steps at 16 + 16 bags in
   ``32-true``; the 4-clip video extracted in bfloat16 (launches K1 / K2 /
   K3 = 1 / 1 / 3) and cached as ``<stem>_i3d.npy``; ``infer.main`` on the
   card from that ``--features-dir`` with ``--checkpoint`` of the RTFM,
   the Sultani and phase 8's MGFN run (MGFN with ``--threshold 0.5
   --min-event-frames 16 --warmup 4``). Gates: scores finite and in [0, 1],
   clip scores equal to the same checkpoint scored on the CPU (float32,
   TF32 off) at atol 1e-5, ``events`` equal to ``anomaly_events`` of the
   written frame scores. Each scorer's median scoring time is printed;
10. extraction breadth: the 4-clip request's ``extract_frames`` (on the
   calling thread) against the same work through the dispatch thread
   (``dispatch_frames`` + ``materialize_features``), in turns;
   (a) K2 and K3 at B = 1 and B = 60 (center crops of
   a seeded 960-frame 240x320 video) and every K4 and K5 call of one int8
   forward at the same batches, under phase 2's and phase 4's gates, with
   times; (b) ``FeatureExtractor(crops="center", batch=240)`` in bf16 and
   int8 on that video (60 clips, one group of 60 crops): launches K1 = 0,
   K2 = 1, K3 = 3 (bf16) and K1 = K2 = K3 = 0, K4 >= 27, K5 >= 26 (int8);
   bf16 features against the plain float32 forward of the center crops and,
   on the first 24 clips, against row 4 of the ten-crop extractor (cosine
   >= 0.999 per row); int8 against the plain int8 forward (cosine >=
   0.99999, the unequal count printed); five timed passes, one profiled
   pass, and the frames' copy to the card timed alone and profiled alone;
   (c) decode replaced
   by ``StandInDecoder`` (seeded frames in memory, 320-frame chunks; this
   script's, not the package's): ``extract_features.main --split train``
   over videos of 24, 40 and 70 clips, pooled (``--decode-workers 3``) and
   serial (``--decode-workers 1 --profile``), one of them treated as over
   1 GB. Gates: both runs' features equal at atol 1e-5, (10, 32, 2048)
   segment files, a second pooled run extracting 0 videos, and the large
   video's file rebuilt from its chunk caches with no kernel launch; the
   extraction loop alone timed pooled and serial; then, where OpenCV is
   importable, the same contents as MJPG files decoded for real, pooled and
   serial (features equal at atol 1e-5, clips/s); (d) ``infer.main --crops
   center`` on the 24-clip video with phase 8's MGFN checkpoint: scores
   finite, in [0, 1] and equal at 1e-5 to ``score_features`` of a center
   extractor's features of the same video;
11. the optical-flow stream: a seeded 384-frame 240x320 scene translated by
   (1.3, -0.7) px per frame (exactly, by a Fourier phase ramp); (a) device
   Farneback and TV-L1 on its 383 pairs in sub-batches of 64 and 128 pairs,
   ``FLOW_PAIRS`` and all at once: ms per frame and peak memory, sub-batched
   flows equal to one batch, the translation recovered (median inside the
   frame within 0.3 and 0.03 px, the JAX tests' tolerances), the card
   against the port's CPU flow on frames 0-8 (max within 1e-3 px, the
   99.9th percentile printed), and the host OpenCV backend's frames/s;
   (b) K5's int8 stem over two channels at B = 40 and 240, bit-equal to its
   plain version, timed beside its bound, and refusing a stem it does not
   take; (c) ``FeatureExtractor(stream="flow", batch=240)`` on the scene's
   flow in bf16 and int8 (launches: no K1, K2 or K3; int8 K4 >= 27, K5 >=
   26), bf16 against the plain float32 forward (cosine >= 0.999), int8
   against the plain int8 forward (cosine >= 0.99999, unequal values
   printed) with every K4 and K5 call of one int8 flow forward bit-equal,
   and the flow stream end to end from RGB frames; (d) ``extract_features
   --stream both --flow-backend device --split train`` over two stand-in
   videos, pooled and serial: features equal, ``flow_backend.json``
   pinned, a rebuild from chunk caches with no launch and no flow; (e)
   MGFN trained through ``run`` with ``data.stream=both`` and 4096
   channels, served by ``infer --checkpoint`` with no ``--stream``: the
   stream resolves to ``both``, scores in [0, 1] and equal to the CPU's
   within 1e-5;
12. the other backbones at full width on the 24-clip video (B = 240),
   seeded weights with random BatchNorm: (a) ``i3d_8x8_r50`` in bf16
   (``FeatureExtractor(model_name="i3d_8x8_r50")``; launches K1 and, by the
   JAX rule, neither K2 nor K3), features against its plain float32
   forward (cosine >= 0.999); (b) the same in int8 (K4 >= 27, K5 >= 26, the
   stem at stride (1,2,2) and never at 2), features against the plain int8
   forward (cosine >= 0.99999, unequal values printed) and every K4 and K5
   call of one forward at B = 40 bit-equal; (c) its flow stream in int8 on
   device Farneback of the same frames (K5's stem over 2 channels at
   stride (1,2,2)), features against the plain int8 forward; (d) K5's stem
   at stride (1,2,2) over 3 and 2 channels at B = 40 and 240, bit-equal,
   timed beside its bound, its plain version and a bf16 cuDNN conv,
   refusing stride (1,1,1); (e) the non-local i3res50 in bf16 (K1, K2 and
   K3 launched; its non-local blocks in stages 2-3 as torch ops), cosine
   >= 0.999; (f) the S2D stem: the float32 features with it equal to those
   with the plain stem at atol 1e-5 (the JAX test's gate), and its bf16
   path at B = 240 with neither K2 nor K3; (g) ``extract_features --model i3d_8x8_r50
   --weights`` a ``.pyth`` written by ``i3d_state_dict_to_pytorchvideo``
   (stand-in decode), features equal to the model's extractor at 1e-5, and
   (h) ``infer --i3d-model i3d_8x8_r50`` with phase 8's MGFN checkpoint, scores
   in [0, 1] and equal to ``score_features`` of those features at 1e-5;
   an unknown backbone name exits. Each path prints its median, clips/s,
   peak memory and one profiled pass's idle share.

13. serving on the card, on phase 8's MGFN checkpoint and the weights of
   phase 10, bf16 and ten crops, every video a stand-in (phase 10's
   ``StandInDecoder``): the one-shot ``infer`` CLI over all of them is the
   reference. (a) ``infer.main --serve 0 --warmup 24`` on a thread of this
   process: 8 POSTs of 24-clip videos (latency p50 and max, clips/s; the
   K1 / K2 / K3 launches of one request >= 1 / 1 / 3), a repeat POST
   answered from its JSON (``/stats`` does not count it), ``/healthz``
   answering within 1 s while a 70-clip request scores, and a burst of 4
   concurrent POSTs of 5, 11, 19 and 31 clips, each answered with its own
   ``n_clips`` and 0 errors; every reply's clip scores within 1e-5 of the
   one-shot CLI's; (b) one request through a ``--dtype int8`` server: K4
   >= 27 and K5 >= 26 launches, scores in [0, 1]; (c) ``--watch
   --poll-interval 0.2 --idle-exit 3`` over two videos with a third dropped
   in: scores within 1e-5 of the one-shot CLI's, ``_serving_stats.json``
   counting 3 videos and 0 errors; (d) ``--export`` of the scorer on the
   card and on the CPU, each artifact scored on the card against the live
   scorer (gate 1e-5, bit-equality printed) on the 4-clip request and a
   24-clip video, the exported and live scoring calls timed in turns (20
   each), and ``--from-export`` of the CPU's artifact on the card against
   the one-shot CLI; (e) ``infer --serve 0 --warmup 24 --compile-cache DIR``
   as a process, cold (DIR empty: nvcc builds) and warm (DIR holds the
   build): seconds from launch to ``serving on`` and to the first reply,
   then SIGTERM: exit code 0 and ``shutting down`` in its log. Phase 1
   prints whether its build was cold.
14. training and weights on the card: (a) phase 10's i3res50 weights
   written as flax variables (``i3d_state_dict_to_flax`` +
   ``save_variables``), then ``extract_features --weights`` and ``infer
   --i3d-weights --checkpoint`` (phase 8's MGFN) on the 24-clip stand-in
   video in bf16 and int8: features and scores bit-equal to the same runs
   on the ``.pt`` file, K1-K3 (int8: K1, K4, K5) launched, both files' load
   times; (b) ``fit`` with ``data.num_workers`` 0 and 8 at full MGFN width
   on seeded in-memory bags (96 + 96 of (10, 32, 2048), 16 + 16 a step, 20
   steps, lr 1e-5) in 32-true and bf16-mixed: steps/s, the host's assembly
   and the loop's wait per step, the idle share of a profiled 4-step fit;
   losses and parameters bit-equal across the two settings (32-true under
   cuDNN's deterministic algorithms, which are timed too); one bf16-mixed
   fit at lr 1e-4 for the record (its losses, the first NaN step, no
   gate); ``evaluate`` with ``prefetch_assembly`` on and off over 48 seeded
   test videos of 32-1024 clips: equal AUCs and scores, times;
   (c) ``runner.model_config.dropout=0.1`` through ``run`` under phase 8's
   gates, its eval-mode scores equal to dropout 0's on the same weights;
   (d) ``run -m seed=1,2`` (bf16-mixed, 5 steps a job): both jobs exit 0,
   ``multirun.jsonl`` holds 2 lines, job 0's losses equal a direct
   ``seed=1`` run's; each job's start-up and wall time; (e) ``trace``
   around one bf16 pass: its Chrome trace names K1, K2 and K3.
15. scale-out on the card: (a) ``extract_features --multihost`` as two
   processes sharing the card over a store on 127.0.0.1 (``--batch 120``,
   ten crops, stand-in decode over phase 10's three videos), bf16 then
   int8: every feature file bit-equal to a one-process run, int8's
   ``act_scales_rgb.json`` equal to the one-process scales and older than
   every feature file, ``segmented`` printed by process 0 only, each
   process's K1-K5 launches printed; (b) ``FeatureExtractor(devices=
   ["cuda:0", "cuda:0"])`` on a 48-clip video (two shards of B = 240 per
   group) bit-equal to one device in bf16 and int8 (the same scales),
   timed against it; (c) ``run trainer.multihost=true`` with a coordinator
   on 127.0.0.1, world size 1, over nccl (the distributed step, the BN
   sums, the gathers, the stop flag's all-reduce: their collective calls
   counted, each > 0), 3 steps of full-width MGFN against the plain run:
   bf16-mixed losses equal, 32-true within 1e-6 relative (both under
   cuDNN's deterministic algorithms); (d) the visible card count, and with
   more than one card ``run`` with ``data_parallel`` over all of them (one
   rank per card, nccl, two bags a rank): finite losses, printed beside
   (c)'s plain run; with one, a line saying multi-card NCCL was not run.

Prints a JSON line of per-kernel numbers, the nvidia-smi name and power
limit line, and last ``{"ok": true, "device": {...}}``. It needs the
repository beside it and a CUDA card; without either it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12,  # dense tensor bf16; fp32 non-tensor
              "int8": 1979e12}  # dense tensor int8 (operations per second)


# The JAX package's name, as the repository's configs spell their classes
REFERENCE = "anomaly_detection_on_video_tpu"
# configs/ composed with runner=mgfn (tests/test_torch_runner.py holds it to
# the port's composition): the training phase's config where PyYAML is missing
MGFN_RUN_CONFIG = {
    "data": {"batch_size": 16, "frames_per_clip": 16, "num_workers": 8, "dynamic_load": False,
             "revision": "tushar-n", "cache_dir": None, "local_path": None, "train_path": None,
             "test_path": None, "ground_truth_path": None, "shuffle": False, "stream": "rgb"},
    "runner": {"cls": f"{REFERENCE}.training.VideoAnomalyDetectionRunner",
               "model_class": f"{REFERENCE}.models.MGFNForVideoAnomalyDetection",
               "model_config": {"_target_": f"{REFERENCE}.models.MGFNConfig", "classes": 0,
                                "dims": [64, 128, 1024], "depths": [3, 3, 2],
                                "mgfn_types": ["gb", "fb", "fb"], "lokernel": 5, "channels": 2048,
                                "ff_repe": 4, "dim_head": 64, "local_aggr_kernel": 5,
                                "dropout": 0.0, "attention_dropout": 0.0, "dropout_rate": 0.7,
                                "mag_ratio": 0.1, "k": 3},
               "optimizer": {"learning_rate": 0.001, "weight_decay": 0.0005}},
    "trainer": {"max_epochs": 1000, "max_steps": -1, "gradient_clip_val": None,
                "accumulate_grad_batches": 1, "log_every_n_steps": None, "precision": "32-true",
                "eval_every": 1, "eval_batch_videos": 8, "resume": False,
                "checkpoint_step": "latest", "eval_only": False, "eval_report": False,
                "data_parallel": True, "tensor_parallel": 1, "multihost": False,
                "coordinator": None, "num_processes": None, "process_id": None,
                "preempt_signals": ["SIGTERM"], "compile_cache": None,
                "log_path": "logs/metrics.jsonl", "figure_dir": None,
                "checkpoint": {"dirpath": "checkpoints", "save_top_k": 10,
                               "monitor": "valid/rec_auc", "mode": "max", "every_n_epochs": 1}},
    "seed": 0,
    "wandb_key": None,
    "_choices_": {"data": "default", "runner": "mgfn", "trainer": "default"},
}
# runner=rtfm and runner=sultani: the same config with their runner group
RUN_CONFIGS = {"mgfn": MGFN_RUN_CONFIG}
for _name, _model, _config, _optimizer in (
        ("rtfm", "RTFM", {"channels": 2048, "hidden_dims": [512, 128], "dropout_rate": 0.7, "k": 3,
                          "margin": 100.0, "alpha": 0.0001},
         {"learning_rate": 0.001, "weight_decay": 0.005}),
        ("sultani", "Sultani", {"channels": 2048, "hidden_dims": [512, 32], "dropout_rate": 0.6,
                                "smoothness_lambda": 8e-05, "sparsity_lambda": 8e-05},
         {"learning_rate": 0.001, "weight_decay": 0.001})):
    RUN_CONFIGS[_name] = dict(
        MGFN_RUN_CONFIG,
        runner={"cls": f"{REFERENCE}.training.VideoAnomalyDetectionRunner",
                "model_class": f"{REFERENCE}.models.{_model}ForVideoAnomalyDetection",
                "model_config": {"_target_": f"{REFERENCE}.models.{_model}Config", **_config},
                "optimizer": _optimizer},
        _choices_={"data": "default", "runner": _name, "trainer": "default"})


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs: the kernels' own
    durations by torch.profiler, without the host's launch time (a launch
    of tens of microseconds is host-bound under event timing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    return us / iters / 1e3


def host_us(fn, calls: int = 500) -> float:
    """Host time of one ``fn()`` call in microseconds: the time to enqueue
    ``calls`` launches whose device work is shorter than their launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def cosine_rows(a, b):
    import torch

    a = a.reshape(a.shape[0], -1).double()
    b = b.reshape(b.shape[0], -1).double()
    return torch.nn.functional.cosine_similarity(a, b, dim=1)


def check_close(name, got, ref, atol, rtol):
    import torch

    err = (got.double() - ref.double()).abs()
    limit = atol + rtol * ref.double().abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} exceeds atol {atol} rtol {rtol}")
    return err.max().item()


def check_cosine(name, got, ref, floor):
    cos = cosine_rows(got, ref).min().item()
    if cos < floor:
        raise AssertionError(f"{name}: min row cosine {cos:.6f} < {floor}")
    return cos


def bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def randomize_batchnorm_(torch, model, seed: int) -> None:
    """Seeded random affines and running statistics for every BatchNorm of
    ``model``. At their identity initialization every channel folds to the
    same scale and a zero shift, which would hide a kernel epilogue that
    drops the shift or reads the wrong channel."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                n = bn.num_features
                bn.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                bn.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                bn.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                bn.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


def taps_inside(size_in: int, positions: int, kernel: int, stride: int, pad: int) -> int:
    """Taps of a strided, zero-padded conv along one axis that read the
    input rather than its padding, summed over output positions
    ``0 .. positions - 1``."""
    return sum(1 for o in range(positions) for k in range(kernel)
               if 0 <= o * stride - pad + k < size_in)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_crop_norm(torch, rng, bulk):
    """K1 bit-equal to its plain version in float32 and bfloat16 at the
    bulk-extraction group shape and at gc = 1 for portrait, wide, square and
    odd frames (and at an odd crop size, its scalar-store path); times at
    the bulk shape in both types beside their bounds, and bfloat16 across
    shared-memory budgets of the launch plan."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.ops.gtransforms import MEAN, STD
    from anomaly_detection_on_video_tpu_torch.ops.kernels import (
        ten_crop_standardize, ten_crop_standardize_plain)
    from anomaly_detection_on_video_tpu_torch.ops.kernels._build import build, current_stream
    from anomaly_detection_on_video_tpu_torch.ops.kernels.crop_norm import crop_norm_plan

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(bulk, 224)] + [
        (torch.from_numpy(rng.randint(0, 256, shape, dtype=np.uint8)).cuda(), size)
        for shape, size in (((1, 16, 341, 256, 3), 224), ((1, 16, 256, 455, 3), 224),
                            ((1, 16, 224, 224, 3), 224), ((1, 16, 257, 301, 3), 224),
                            ((2, 3, 41, 50, 3), 36))]
    max_err = 0.0
    for frames, size in cases:
        for dtype in (f32, bf16):
            max_err = max(max_err, check_equal(f"K1 {tuple(frames.shape)} S={size} {dtype}",
                                               ten_crop_standardize(frames, size, dtype),
                                               ten_crop_standardize_plain(frames, size, dtype)))
        plan = crop_norm_plan(frames.shape[2], frames.shape[3], size, bf16)
        print(f"K1 crop_norm {tuple(frames.shape)} S={size}: bit-equal f32/bf16; bf16 plan: band "
              f"{plan.band} rows x {plan.n_bands}, {len(plan.segments)} staged segment(s), "
              f"{plan.shared_bytes} shared bytes, {'16-byte' if plan.vector else 'scalar'} "
              f"stores", flush=True)
    gc, fpc, height, width, _ = bulk.shape
    out_elems = gc * 10 * fpc * 224 * 224 * 3
    entry = {}
    for dtype in (bf16, f32):
        out_bytes = out_elems * torch.empty((), dtype=dtype).element_size()
        ms = cuda_ms(lambda: ten_crop_standardize(bulk, 224, dtype), 10)
        plain_ms = cuda_ms(lambda: ten_crop_standardize_plain(bulk, 224, dtype), 5)
        bound_ms, bound_by = bound(bulk.numel() + out_bytes, 2 * out_elems, "float32")
        plan = crop_norm_plan(height, width, 224, dtype)
        print(f"K1 crop_norm {tuple(bulk.shape)} {dtype}: {ms:.3f} ms kernel, {plain_ms:.3f} ms "
              f"plain, bound {bound_ms:.3f} ms ({bound_by}; {(bulk.numel() + out_bytes) / 1e9:.3f} "
              f"GB), {(bulk.numel() + out_bytes) / ms / 1e9:.3f} TB/s, {bound_ms / ms:.0%} of the "
              f"bound; plan: band {plan.band} x {plan.n_bands}, {plan.shared_bytes} shared bytes",
              flush=True)
        if dtype == bf16:
            entry = {"name": "ten_crop_standardize", "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "max_abs_err": max_err}
    # the band height against the shared memory a CTA may take (bf16, bulk shape)
    lib = build()
    out = torch.empty((gc * 10, fpc, 224, 224, 3), dtype=bf16, device=bulk.device)
    sweep = []
    for budget in (24_576, 40_960, 65_536, 98_304, 131_072, 232_448):
        plan = crop_norm_plan(height, width, 224, bf16, budget)
        ints = (ctypes.c_int * 30)(*plan.ints())
        ms = cuda_ms(lambda: lib.call("adv_crop_norm", bulk.data_ptr(), out.data_ptr(), 1, gc, fpc,
                                      height, width, 224, ints, MEAN, 1.0 / STD,
                                      current_stream(bulk)), 10)
        check_equal(f"K1 band {plan.band}", out, ten_crop_standardize_plain(bulk, 224, bf16))
        sweep.append(f"band {plan.band} ({plan.shared_bytes} B) {ms:.3f} ms")
    print("K1 bf16 at the bulk shape by band height: " + ", ".join(sweep), flush=True)
    return entry


def check_stem(torch, model, x32):
    """K2 against its plain version: float32 to 1e-4, bfloat16 by cosine."""
    import torch.nn.functional as F

    from anomaly_detection_on_video_tpu_torch.ops.kernels.stem import fold_bn
    from anomaly_detection_on_video_tpu_torch.ops.kernels import stem_conv_pool, stem_plain

    conv, bn = model.conv1, model.bn1
    w = conv.weight
    scale, shift = fold_bn(bn)
    ref = stem_plain(x32, w, scale, shift)
    got = stem_conv_pool(x32, conv, bn)
    torch.cuda.synchronize()
    err = check_close("K2 float32", got, ref, 1e-4, 1e-4)
    x16 = x32.to(torch.bfloat16)
    got16 = stem_conv_pool(x16, conv, bn)
    cos = check_cosine("K2 bfloat16", got16.float(), ref, 0.9999)
    ms = cuda_ms(lambda: stem_conv_pool(x16, conv, bn), 5)
    plain_ms = cuda_ms(lambda: stem_plain(x16, w, scale, shift), 5)
    xc = x16.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
    w16 = w.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: F.conv3d(xc, w16, None, 2, (2, 3, 3)), 5)
    b = x32.shape[0]
    # the conv work the pool needs: stem frames 0..7 and rows/columns 0..110
    # (55 windows of 3 at stride 2), counting only taps that read pixels
    taps = taps_inside(16, 8, 5, 2, 2) * taps_inside(224, 111, 7, 2, 3) ** 2
    flops = 2.0 * b * 64 * 3 * taps
    bytes_moved = x16.numel() * 2 + b * 4 * 55 * 55 * 64 * 2 + (w.numel() + 2 * 64) * 4
    bound_ms, bound_by = bound(bytes_moved, flops, "bfloat16")
    print(f"K2 stem B={b}: f32 max |err| {err:.2e}, bf16 cosine {cos:.6f}; {ms:.3f} ms kernel, "
          f"{plain_ms:.3f} ms plain, {library_ms:.3f} ms cuDNN conv3d alone, "
          f"bound {bound_ms:.3f} ms", flush=True)
    return ref, {"name": "stem_conv_pool", "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms, "max_abs_err": err}


def check_bottlenecks(torch, model, x32):
    """K3 for the three stage-1 blocks, chained on the stem's output."""
    from anomaly_detection_on_video_tpu_torch.ops.kernels import bottleneck_block, bottleneck_plain

    total = {"ms": 0.0, "plain_ms": 0.0, "flops": 0.0, "bytes": 0.0}
    max_err = 0.0
    for i, block in enumerate(model.layer1):
        ref = bottleneck_plain(x32, block)
        got = bottleneck_block(x32, block)
        torch.cuda.synchronize()
        err = check_close(f"K3 block {i} float32", got, ref, 1e-4, 1e-4)
        x16 = x32.to(torch.bfloat16)
        cos = check_cosine(f"K3 block {i} bfloat16", bottleneck_block(x16, block).float(), ref, 0.9999)
        ms = cuda_ms(lambda: bottleneck_block(x16, block), 5)
        plain_ms = cuda_ms(lambda: bottleneck_plain(x16, block), 5)
        b, t, h, w, cin = x32.shape
        taps = sum(1 for tt in range(t) for dt in (-1, 0, 1) if 0 <= tt + dt < t)  # conv_a taps on real frames
        proj = cin * 256 if block.downsample is not None else 0
        flops = 2.0 * b * h * w * (taps * cin * 64 + t * (9 * 64 * 64 + 64 * 256 + proj))
        params = sum(p.numel() for p in block.parameters())
        bytes_moved = x16.numel() * 2 + b * t * h * w * 256 * 2 + params * 4
        bound_ms, _ = bound(bytes_moved, flops, "bfloat16")
        print(f"K3 block {i} {tuple(x32.shape)}: f32 max |err| {err:.2e}, bf16 cosine {cos:.6f}; "
              f"{ms:.3f} ms kernel, {plain_ms:.3f} ms plain, bound {bound_ms:.3f} ms", flush=True)
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["flops"] += flops
        total["bytes"] += bytes_moved
        max_err = max(max_err, err)
        x32 = ref
    bound_ms, bound_by = bound(total["bytes"], total["flops"], "bfloat16")
    return {"name": "bottleneck_block", "ms": total["ms"], "plain_ms": total["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "max_abs_err": max_err}


def int8_operands(torch, gen, m, k, n):
    """Seeded int8 activations (m, k), K4's packed weights (n, k) and a
    per-column float32 scale on the card."""
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
    scale = torch.rand(n, generator=gen) * 1e-5 + 1e-6
    return a.cuda(), w.cuda(), scale.cuda()


def int_mm_ms(torch, a, w, iters: int, timer=cuda_ms):
    """Time of ``torch._int_mm`` on the same operands as K4, the library
    yardstick (the port never calls it): the packed (N, K) weights go in
    as the column-major (K, N) operand cuBLASLt prefers. None where it
    refuses the shape."""
    rhs = w.t()
    try:
        torch._int_mm(a, rhs)
    except RuntimeError:
        return None
    return timer(lambda: torch._int_mm(a, rhs), iters)


def check_equal(name, got, ref) -> float:
    """Raise unless ``got`` equals ``ref`` bit for bit; returns max |got -
    ref|, computed in float64 over slices of 2^26 values."""
    import torch

    torch.cuda.synchronize()
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                             f"{ref.dtype} {tuple(ref.shape)}")
    flat_got, flat_ref, diff = got.reshape(-1), ref.reshape(-1), 0.0
    for i in range(0, flat_got.numel(), 1 << 26):
        part = flat_got[i:i + (1 << 26)].double() - flat_ref[i:i + (1 << 26)].double()
        diff = max(diff, part.abs().max().item())
    if not torch.equal(got, ref):
        bad = (got != ref).sum().item()
        raise AssertionError(f"{name}: {bad} of {ref.numel()} elements differ, max |err| {diff}")
    return diff


def check_int8_probe_shapes(torch):
    """K4 and K5 at the TPU probe's own shapes, bit-equal, with times."""
    import torch.nn.functional as F

    from anomaly_detection_on_video_tpu_torch.ops.kernels import (
        int8_conv, int8_conv_plain, int8_matmul, int8_matmul_plain)

    gen = torch.Generator().manual_seed(4)
    # K4 at two edge shapes: a ragged last row tile, and the narrowest tile
    for m, k, n in ((12_345, 512, 256), (65_536, 64, 128)):
        a, w, scale = int8_operands(torch, gen, m, k, n)
        check_equal(f"K4 ({m}, {k}) x ({n}, {k}) int32", int8_matmul(a, w), int8_matmul_plain(a, w))
        for out_dtype in (torch.float32, torch.bfloat16):
            check_equal(f"K4 ({m}, {k}) x ({n}, {k}) {out_dtype}",
                        int8_matmul(a, w, scale, out_dtype),
                        int8_matmul_plain(a, w, scale, out_dtype))
        print(f"K4 int8_matmul edge shape ({m}, {k}) x ({n}, {k}): bit-equal (int32, float32 and "
              f"bf16 epilogues)", flush=True)
    # K4: probe_raw_matmul's (B*T*784, 512) x (512, 256) -> int32, B*T = 480
    a, w, scale = int8_operands(torch, gen, 480 * 784, 512, 256)
    check_equal("K4 probe int32", int8_matmul(a, w), int8_matmul_plain(a, w))
    check_equal("K4 probe bf16", int8_matmul(a, w, scale, torch.bfloat16),
                int8_matmul_plain(a, w, scale, torch.bfloat16))
    ms = cuda_ms(lambda: int8_matmul(a, w), 10)
    plain_ms = cuda_ms(lambda: int8_matmul_plain(a, w), 3)
    library_ms = int_mm_ms(torch, a, w, 10)
    m, k = a.shape
    n = w.shape[0]
    bound_ms, bound_by = bound(m * k + k * n + 4 * m * n, 2.0 * m * k * n, "int8")
    library = "refused" if library_ms is None else f"{library_ms:.3f} ms"
    print(f"K4 int8_matmul probe shape ({m}, {k}) x ({n}, {k}) -> int32: bit-equal (int32 and "
          f"bf16 epilogue); {ms:.3f} ms kernel, {plain_ms:.3f} ms plain (float64), torch._int_mm "
          f"{library}, bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    # host time per launch at a stage-4 shape, whose device work takes microseconds
    a, w, scale = int8_operands(torch, gen, 3920, 1024, 512)
    rhs = w.t()
    k4_us = host_us(lambda: int8_matmul(a, w, scale, torch.bfloat16))
    lib_us = host_us(lambda: torch._int_mm(a, rhs))
    print(f"host time per launch at (3920, 1024) x (512, 1024): K4 {k4_us:.1f} us, torch._int_mm "
          f"{lib_us:.1f} us", flush=True)
    del a, w
    # K5: make_conv3x3's (B*T, 128, 28*28) planes, channels last, pad 1
    x = torch.randint(-127, 128, (240, 2, 28, 28, 128), generator=gen, dtype=torch.int8).cuda()
    w = torch.randint(-5, 6, (128, 9 * 128), generator=gen, dtype=torch.int8).cuda()  # (Cout, K)
    scale = (torch.rand(128, generator=gen) * 2e-3 + 1e-4).cuda()
    geo = ((1, 3, 3), (1, 1, 1), (0, 1, 1))
    for out_dtype in (torch.int8, torch.bfloat16):
        got = int8_conv(x, w, scale, *geo, out_dtype)
        check_equal(f"K5 probe {out_dtype}", got, int8_conv_plain(x, w, scale, *geo, out_dtype))
    saturated = (got.float().abs() >= 127).float().mean().item()
    ms = cuda_ms(lambda: int8_conv(x, w, scale, *geo, torch.int8), 10)
    plain_ms = cuda_ms(lambda: int8_conv_plain(x, w, scale, *geo, torch.int8), 3)
    xb = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
    wb = w.to(torch.bfloat16).reshape(128, 1, 3, 3, 128).permute(0, 4, 1, 2, 3)
    bf16_conv_ms = cuda_ms(lambda: F.conv3d(xb, wb, None, 1, (0, 1, 1)), 10)
    taps = taps_inside(28, 28, 3, 1, 1) ** 2
    bound_ms, bound_by = bound(2 * x.numel() + w.numel() + 4 * 128,
                               2.0 * 240 * 2 * taps * 128 * 128, "int8")
    print(f"K5 int8_conv probe shape {tuple(x.shape)} k(1,3,3): bit-equal (int8 and bf16 "
          f"epilogues; bf16 share >= 127: {saturated:.3f}); {ms:.3f} ms kernel (int8 out), "
          f"{plain_ms:.3f} ms plain (float64), no library call (torch has no int8 conv on CUDA; "
          f"bf16 F.conv3d at this shape {bf16_conv_ms:.3f} ms), bound {bound_ms:.3f} ms "
          f"({bound_by})", flush=True)


def int8_forward_with(torch, model, crops, matmul, conv):
    """One int8 forward of ``model`` with its K4 and K5 calls routed to
    ``matmul`` and ``conv`` (the plain versions, or recorders)."""
    import anomaly_detection_on_video_tpu_torch.models.i3d as ti3d

    originals = ti3d.int8_matmul, ti3d.int8_conv
    ti3d.int8_matmul, ti3d.int8_conv = matmul, conv
    try:
        with torch.no_grad():
            return model(crops)
    finally:
        ti3d.int8_matmul, ti3d.int8_conv = originals


def k5_class(cin, kernel, stride) -> str:
    """K5's geometry classes on the int8 path: the stem (over 3 channels,
    or the flow stream's 2; at stride 2, or (1,2,2) for i3d_8x8_r50),
    k(1,3,3) s1 / s2, k(3,1,1)."""
    if tuple(kernel) == (5, 7, 7):
        return (f"stem k(5,7,7) s{'2' if stride[0] == 2 else '(1,2,2)'}"
                + (" over 2 channels" if cin == 2 else ""))
    return f"k({kernel[0]},{kernel[1]},{kernel[2]}) s{stride[1]}"


def check_int8_path_calls(torch, model, crops):
    """One int8 forward of ``model`` on ``crops`` in which every K4 and K5
    call is held, at its own shape and input, against its plain version
    (bit-equal) and timed, by CUDA events over 10 launches (host launch
    time included) and by the profiler's device time; returns the two JSON
    entries with event times and bounds summed over the forward's
    launches. K5's calls are also summed by geometry class, each beside a
    bf16 cuDNN ``F.conv3d`` of the same geometry, a yardstick the port
    never calls."""
    import torch.nn.functional as F

    from anomaly_detection_on_video_tpu_torch.ops.kernels import (
        int8_conv, int8_conv_plain, int8_matmul, int8_matmul_plain)
    from anomaly_detection_on_video_tpu_torch.ops.kernels.int8_conv import (
        conv_output_shape, unpack_int8_conv_weight)

    fns = {"int8_matmul": (int8_matmul, int8_matmul_plain),
           "int8_conv": (int8_conv, int8_conv_plain)}
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "library_refused": 0,
                     "device_ms": 0.0, "library_device_ms": 0.0, "bytes": 0.0, "ops": 0.0,
                     "n": 0, "max_abs_err": 0.0} for name in fns}
    geometries = {}
    classes = {}

    def checker(name):
        kernel_fn, plain_fn = fns[name]

        def check(*args):
            got = kernel_fn(*args)
            err = check_equal(f"{name} {tuple(args[0].shape)}", got, plain_fn(*args))
            out_bytes = got.numel() * got.element_size()
            entry = totals[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            ms = cuda_ms(lambda: kernel_fn(*args), 10)
            dev_ms = device_ms(lambda: kernel_fn(*args), 5)
            entry["ms"] += ms
            entry["device_ms"] += dev_ms
            entry["plain_ms"] += cuda_ms(lambda: plain_fn(*args), 1)
            if name == "int8_matmul":
                a, w = args[0], args[1]
                (m, k), n = a.shape, w.shape[0]
                lib_ms = int_mm_ms(torch, a, w, 10)
                if lib_ms is None:
                    entry["library_refused"] += 1
                else:
                    entry["library_ms"] += lib_ms
                    entry["library_device_ms"] += int_mm_ms(torch, a, w, 5, device_ms)
                ops = 2.0 * m * k * n
                bytes_moved = a.numel() + w.numel() + 4 * n + out_bytes
                key = f"K4 ({m}, {k}) x ({n}, {k})"
            else:
                x, w, _, kernel, stride, padding, _ = args
                bsz, t, h, wd, cin = x.shape
                cout = w.shape[0]
                out = conv_output_shape((t, h, wd), kernel, stride, padding)
                taps = 1
                for size, positions, kk, ss, pp in zip((t, h, wd), out, kernel, stride, padding):
                    taps *= taps_inside(size, positions, kk, ss, pp)
                ops = 2.0 * bsz * taps * cin * cout
                bytes_moved = x.numel() + w.numel() + 4 * cout + out_bytes
                key = f"K5 {tuple(x.shape)} k{kernel} s{stride} -> {cout}"
                xb = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)  # channels-last strides
                wb = unpack_int8_conv_weight(w, cin, kernel).to(torch.bfloat16)
                conv = lambda: F.conv3d(xb, wb, None, stride, padding)  # noqa: E731
                c = classes.setdefault(k5_class(cin, kernel, stride), dict.fromkeys(
                    ("n", "ms", "device_ms", "bytes", "ops", "conv_ms", "conv_device_ms"), 0.0))
                for field, value in (("n", 1), ("ms", ms), ("device_ms", dev_ms),
                                     ("bytes", bytes_moved), ("ops", ops),
                                     ("conv_ms", cuda_ms(conv, 10)),
                                     ("conv_device_ms", device_ms(conv, 5))):
                    c[field] += value
                del xb, wb
            entry["ops"] += ops
            entry["bytes"] += bytes_moved
            entry["n"] += 1
            count, total_ms = geometries.get(key, (0, 0.0))
            geometries[key] = (count + 1, total_ms + ms)
            return got

        return check

    int8_forward_with(torch, model, crops, checker("int8_matmul"), checker("int8_conv"))
    b = crops.shape[0]
    for key, (count, total_ms) in geometries.items():
        print(f"  bit-equal at B = {b}: {key} x{count}, {total_ms:.3f} ms kernel", flush=True)
    for cls, c in classes.items():
        bound_ms, bound_by = bound(c["bytes"], c["ops"], "int8")
        c["bound_ms"] = bound_ms
        print(f"K5 {cls}, {int(c['n'])} launches at B = {b}: {c['ms']:.3f} ms by events "
              f"({c['device_ms']:.3f} device), bound {bound_ms:.3f} ms ({bound_by}); bf16 "
              f"F.conv3d of the same geometry (yardstick) {c['conv_ms']:.3f} ms by events "
              f"({c['conv_device_ms']:.3f} device)", flush=True)
    c16 = [c for cls, c in classes.items() if not cls.startswith("stem")]
    k5_ms, conv_ms = sum(c["ms"] for c in c16), sum(c["conv_ms"] for c in c16)
    print(f"K5 Cin % 16 geometries at B = {b}: {k5_ms:.3f} ms by events "
          f"({sum(c['device_ms'] for c in c16):.3f} device) against bf16 F.conv3d "
          f"{conv_ms:.3f} ms ({sum(c['conv_device_ms'] for c in c16):.3f} device): "
          f"{conv_ms / k5_ms:.2f}x", flush=True)
    results = []
    for name, entry in totals.items():
        bound_ms, bound_by = bound(entry["bytes"], entry["ops"], "int8")
        print(f"{name} over the int8 path's {entry['n']} launches at B = {b}: bit-equal; "
              f"{entry['ms']:.3f} ms kernel by events ({entry['device_ms']:.3f} ms device), "
              f"{entry['plain_ms']:.3f} ms plain (float64), bound {bound_ms:.3f} ms ({bound_by})"
              + (f", torch._int_mm {entry['library_ms']:.3f} ms by events "
                 f"({entry['library_device_ms']:.3f} ms device; {entry['library_refused']} "
                 f"shapes refused)" if name == "int8_matmul" else ""), flush=True)
        # a library sum that misses refused shapes is no time for the same work
        library = None
        if name == "int8_matmul" and not entry["library_refused"]:
            library = entry["library_ms"]
        results.append({"name": name, "ms": entry["ms"], "plain_ms": entry["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library,
                        "max_abs_err": entry["max_abs_err"], "device_ms": entry["device_ms"],
                        "library_device_ms": entry["library_device_ms"]})
    return results


def plain_features(torch, model, crops32):
    """The i3res50 forward with every kernel replaced by its plain version,
    float32: the reference the main path's features are held against."""
    from anomaly_detection_on_video_tpu_torch.ops.kernels.stem import fold_bn
    from anomaly_detection_on_video_tpu_torch.ops.kernels import bottleneck_plain, stem_plain

    scale, shift = fold_bn(model.bn1)
    x = stem_plain(crops32, model.conv1.weight, scale, shift)
    for block in model.layer1:
        x = bottleneck_plain(x, block)
    t = x.shape[1] // 2 * 2
    x = torch.maximum(x[:, 0:t:2], x[:, 1:t:2]).permute(0, 4, 1, 2, 3)
    for layer in (model.layer2, model.layer3, model.layer4):
        x = layer(x)
    return x.mean(dim=(2, 3, 4))


def drive_path(torch, name, extractor, video, scorer):
    """One main path through the entry points a user calls:
    ``extractor.extract_frames`` -> ``score_features``. A warm-up pass
    (cuDNN plans, the allocator, and the calibration of an int8 extractor),
    then five timed passes (median and range); launch counts are reset just
    before the first timed pass and read just after it, and peak memory is
    taken over it. Gates: every kernel of the path launched (K1, K2, K3 on
    the bf16 path; K1, K4, K5 and neither K2 nor K3 on the int8 path; for
    center crops no K1, and in bf16 exactly one K2 and three K3 launches;
    for the flow stream neither K1, K2 nor K3, and K4 and K5 only under
    int8; under int8, K5's stem over the stream's channels, 3 or 2, and
    never over the other's, at the model's temporal stem stride and never
    the other; a bf16 ten-crop RGB model whose geometry the JAX rule keeps
    off K2 and K3 (``I3DResNet.kernel_paths``: i3d_8x8_r50, the S2D stem)
    launches neither), features of shape (clips, n_crops, 2048), scores
    finite and in [0, 1]. The counts returned hold the stem's by input
    channels under ``"int8_conv stem by Cin"`` and by temporal stride under
    ``"int8_conv stem by stride"``."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.infer import score_features
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    score_features(extractor.extract_frames(video), scorer)  # warm-up
    # the S2D stem is never quantized (the JAX S2DConvBN has no scale)
    n_scales = 52 if extractor.model.s2d_stem else 53
    if extractor.quantize and len(extractor.model.act_scales) != n_scales:
        raise AssertionError(f"{name}: calibration gave {len(extractor.model.act_scales)} "
                             f"scales, expected {n_scales}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    features = extractor.extract_frames(video)
    scores = score_features(features, scorer)
    torch.cuda.synchronize()
    seconds = [time.perf_counter() - start]
    counts = kernels.launch_counts()
    # K5's stem launches by input channels: 3 on the RGB int8 path, 2 on the flow one
    counts["int8_conv stem by Cin"] = stems = kernels.stem_launch_counts()
    # and by temporal stride: 2 for i3res50's stem, 1 for i3d_8x8_r50's
    counts["int8_conv stem by stride"] = strides = kernels.stem_stride_launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    for _ in range(4):  # four more timed passes for the median and range
        start = time.perf_counter()
        score_features(extractor.extract_frames(video), scorer)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
    print(f"launches on the {name}: {counts}", flush=True)
    # K1 crops ten; the center crop is torch ops, as the JAX package's XLA
    k1 = counts["ten_crop_standardize"]
    k1_wrong = k1 < 1 if extractor.n_crops == 10 else k1 != 0
    int8_wrong = counts["int8_matmul"] < 27 or counts["int8_conv"] < 26
    if extractor.quantize:
        # K5's stem over the stream's channels, never over the other's
        own, other = (2, 3) if extractor.stream == "flow" else (3, 2)
        stride = extractor.model.conv1.stride[0]
        int8_wrong = (int8_wrong or stems[own] < 1 or stems[other] > 0
                      or strides[stride] < 1 or strides[3 - stride] > 0)
    if extractor.stream == "flow":
        # two channels: no K1 (the JAX package's Pallas crop takes three),
        # no K2 or K3 (not their clip shape); int8 runs K4 and K5
        skipped = (k1 or counts["stem_conv_pool"] or counts["bottleneck_block"]
                   or (int8_wrong if extractor.quantize
                       else counts["int8_matmul"] or counts["int8_conv"]))
    elif extractor.quantize:
        skipped = (k1_wrong or int8_wrong or counts["stem_conv_pool"]
                   or counts["bottleneck_block"])
    elif extractor.n_crops == 10:
        # K2 / K3 where the JAX rule takes them for this model, else neither
        fused_stem, fused_stage1 = extractor.model.kernel_paths(
            (extractor.frames_per_clip, extractor.cropsize, extractor.cropsize, 3))
        skipped = (k1_wrong
                   or (counts["stem_conv_pool"] < 1 if fused_stem else counts["stem_conv_pool"])
                   or (counts["bottleneck_block"] < 3 if fused_stage1
                       else counts["bottleneck_block"]))
    else:  # one group of center crops: one stem launch and three blocks
        skipped = k1_wrong or counts["stem_conv_pool"] != 1 or counts["bottleneck_block"] != 3
    if skipped:
        raise AssertionError(f"{name}: wrong kernels launched: {counts}")
    clips = (video.shape[0] - 1) // extractor.frames_per_clip + 1
    if features.shape != (clips, extractor.n_crops, 2048):
        raise AssertionError(f"{name}: features {features.shape}, expected ({clips}, "
                             f"{extractor.n_crops}, 2048)")
    if not (np.isfinite(scores).all() and (scores >= 0).all() and (scores <= 1).all()):
        raise AssertionError(f"{name}: clip scores out of [0, 1]: {scores}")
    print(f"{name} clip scores: {np.round(scores, 6).tolist()}", flush=True)
    median = float(np.median(seconds))
    print(f"{name}: {clips} clips, {len(seconds)} passes of {min(seconds) * 1e3:.2f}-"
          f"{max(seconds) * 1e3:.2f} ms, median {median * 1e3:.2f} ms = {clips / median:.2f} "
          f"clips/s end to end; peak memory {peak_gib:.2f} GiB", flush=True)
    return features, scores, counts


def check_int8_features(torch, name, model, crops16, features, ref, chunk=None):
    """int8 path features against the same int8 forward of ``model`` on
    K1's output ``crops16`` through the plain versions (gate: cosine >=
    0.99999 per row; the count of unequal elements is printed) and against
    the plain float32 forward ``ref`` (cosine >= 0.99). ``chunk`` crops at a
    time, where the plain version's float64 products of a whole batch would
    not fit beside the rest."""
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    got = torch.from_numpy(features).to(ref.device)
    step = chunk or crops16.shape[0]
    qref = torch.cat([int8_forward_with(torch, model, crops16[i:i + step],
                                        kernels.int8_matmul_plain, kernels.int8_conv_plain)
                      for i in range(0, crops16.shape[0], step)]).reshape(got.shape)
    unequal = int((got != qref).sum().item())
    qcos = check_cosine(f"{name} vs plain int8 forward", got, qref, 0.99999)
    fcos = check_cosine(f"{name} vs plain float32 forward", got, ref, 0.99)
    print(f"{name} vs the same int8 forward through the plain versions: {unequal} of "
          f"{qref.numel()} elements unequal, min row cosine {qcos:.8f}; vs the plain float32 "
          f"forward: min row cosine {fcos:.6f}", flush=True)


def device_breakdown(torch, run) -> dict:
    """Device time of one ``run()`` by kernel, from torch.profiler, and the
    device's busy share of the wall time (the profiler's own overhead is in
    that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    groups = {"K1 crop_norm_kernel": 0.0, "K2 stem_kernel": 0.0, "K3 bottleneck_kernel": 0.0,
              "K4 int8_matmul_kernel": 0.0, "K5 int8_conv_kernel": 0.0}
    other = {}
    h2d_ms = 0.0
    copies = {}  # every copy the profiler recorded, by name
    for evt in prof.events():
        # device-side events only: kernels and copies, not the ranges a
        # record_function (such as Optimizer.step) spans over them
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        us = evt.time_range.elapsed_us()
        if "HtoD" in evt.key:
            h2d_ms += us / 1e3
        if "emcpy" in evt.key:
            copies[evt.key[:60]] = copies.get(evt.key[:60], 0.0) + us / 1e3
        for group in groups:
            if group.split()[1] in evt.key:
                groups[group] += us / 1e3
                break
        else:
            other[evt.key[:60]] = other.get(evt.key[:60], 0.0) + us / 1e3
    busy_ms = sum(groups.values()) + sum(other.values())
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "kernels_ms": groups, "other_kernels_ms": sum(other.values()), "top_other_ms": top,
            "h2d_copy_ms": h2d_ms, "copies_ms": copies}


def check_eight_frame_extractor(torch, model, video):
    """Fault 1: the float32 extractor at 8 frames per clip. The clip shape
    sends the model down the plain torch chain (K1 still crops); its
    features are held against the plain float32 forward."""
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.ops import kernels
    from anomaly_detection_on_video_tpu_torch.ops.kernels.crop_norm import ten_crop_standardize_plain
    from anomaly_detection_on_video_tpu_torch.ops.resize import (
        resize_bilinear_exact, short_side_size)

    extractor = FeatureExtractor(state_dict=model.state_dict(), dtype=torch.float32, batch=40,
                                 frames_per_clip=8, device="cuda")
    extractor.extract_frames(video)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    features = extractor.extract_frames(video)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = kernels.launch_counts()
    clips = video.shape[0] // 8
    if (counts["ten_crop_standardize"] < 1 or counts["stem_conv_pool"]
            or counts["bottleneck_block"] or features.shape != (clips, 10, 2048)):
        raise AssertionError(f"8-frame extractor: launches {counts}, features {features.shape}")
    frames = torch.from_numpy(video[: clips * 8]).cuda()
    h, w = short_side_size(video.shape[1], video.shape[2], extractor.resize)
    resized = resize_bilinear_exact(frames, h, w).reshape(clips, 8, h, w, 3)
    with torch.no_grad():
        ref = plain_features(torch, extractor.model, ten_crop_standardize_plain(
            resized, 224, torch.float32)).reshape(clips, 10, 2048)
    err = check_close("8-frame float32 features", torch.from_numpy(features).cuda(), ref,
                      1e-4, 1e-4)
    print(f"float32 extractor at 8 frames per clip: {clips} clips in {seconds * 1e3:.2f} ms, "
          f"launches {counts}; features vs the plain float32 forward: max |err| {err:.2e}",
          flush=True)


def check_int8_stem_past_2g(torch):
    """Fault 2: K5's int8 stem at B = 480, whose output holds more than
    2^31 values, bit-equal to its plain version in slices of 40 clips."""
    from anomaly_detection_on_video_tpu_torch.ops.kernels import (
        int8_conv, int8_conv_plain, pack_int8_conv_weight)

    gen = torch.Generator(device="cuda").manual_seed(7)
    b, slab = 480, 40
    x = torch.randint(-127, 128, (b, 16, 224, 224, 3), generator=gen, dtype=torch.int8,
                      device="cuda")
    w = pack_int8_conv_weight(torch.randint(-20, 21, (64, 3, 5, 7, 7), generator=gen,
                                            dtype=torch.int8, device="cuda"))
    scale = torch.rand(64, generator=gen, device="cuda") * 1e-4 + 1e-5
    geo = ((5, 7, 7), (2, 2, 2), (2, 3, 3))
    out = int8_conv(x, w, scale, *geo, torch.bfloat16)
    torch.cuda.synchronize()
    for i in range(0, b, slab):
        check_equal(f"K5 stem at B = {b}, clips {i}-{i + slab - 1}", out[i:i + slab],
                    int8_conv_plain(x[i:i + slab], w, scale, *geo, torch.bfloat16))
    ms = cuda_ms(lambda: int8_conv(x, w, scale, *geo, torch.bfloat16), 3)
    out_bytes = out.numel() * out.element_size()
    bound_ms, bound_by = bound(x.numel() + w.numel() + out_bytes,
                               2.0 * b * 64 * 3 * taps_inside(16, 8, 5, 2, 2)
                               * taps_inside(224, 112, 7, 2, 3) ** 2, "int8")
    print(f"K5 int8 stem at B = {b}: output {tuple(out.shape)} = {out.numel():,} values "
          f"(2^31 = {2 ** 31:,}), bit-equal to the plain version in {b // slab} slices; "
          f"{ms:.3f} ms kernel, bound {bound_ms:.3f} ms ({bound_by})", flush=True)
    del x, out


def write_training_data(root: str):
    """The committed segment bags as train features, the same bags as
    (32, 10, 2048) test features, an annotation file (abnormal videos: one
    event over frames 160-320 of 512; normal videos: none) and the ground
    truth the port's make_gt_ucf builds from it."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import make_gt_ucf

    bags = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                                "i3d_segments_seed0.npz"))
    train, test = os.path.join(root, "train"), os.path.join(root, "test")
    os.makedirs(train)
    os.makedirs(test)
    lines = []
    for name in bags.files:
        np.save(os.path.join(train, f"{name}_i3d.npy"), bags[name])
        np.save(os.path.join(test, f"{name}_i3d.npy"), bags[name].transpose(1, 0, 2))
        normal = "Normal" in name
        events = "-1  -1" if normal else "160  320"
        lines.append(f"{name}.mp4  {'Normal' if normal else 'Abuse'}  {events}  -1  -1")
    annotations = os.path.join(root, "annotations.txt")
    with open(annotations, "w") as f:
        f.write("\n".join(lines) + "\n")
    gt = os.path.join(root, "ground_truth.json")
    make_gt_ucf.main(["--annotations", annotations, "--features", test, "--out", gt])
    return train, test, gt, len(bags.files)


def run_training(overrides: dict, runner: str = "mgfn"):
    """The port's run entry for ``runner=<runner>``: ``main`` with
    ``key=value`` overrides where PyYAML is installed, else ``train`` on
    ``RUN_CONFIGS[runner]`` with the same overrides set. Returns what it
    printed."""
    from anomaly_detection_on_video_tpu_torch import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            import yaml  # noqa: F401
        except ImportError:
            cfg = copy.deepcopy(RUN_CONFIGS[runner])
            for key, value in overrides.items():
                node = cfg
                *path, last = key.split(".")
                for part in path:
                    node = node[part]
                node[last] = value
            run.train(cfg, "cuda")
        else:
            # key= is null; booleans are YAML's true / false
            run.main([f"runner={runner}"] + [
                f"{k}={'' if v is None else json.dumps(v) if isinstance(v, bool) else v}"
                for k, v in overrides.items()])
    sys.stdout.write(out.getvalue())
    return out.getvalue()


# runner -> (learning rate, steps, epochs, eval every n epochs, loss window):
# the rates at which the JAX trainer's loss falls on the committed bags
# (PERF.md, section 6); Sultani's hinge loss is noisy under its 0.6 dropout
# and falls over 100 steps, not 20
TRAINING = {"mgfn": (1e-4, 20, 10, 5, 5), "rtfm": (1e-4, 20, 10, 5, 5),
            "sultani": (1e-4, 100, 50, 25, 10)}


def training_overrides(root: str, runner: str = "mgfn", tag: str = None) -> dict:
    """check_training's ``run`` overrides for ``runner`` on the committed
    bags under ``root`` (written at first use), its writers under ``tag``."""
    lr, steps, epochs, every, _ = TRAINING[runner]
    data = os.path.join(root, "data")
    if not os.path.isdir(data):
        write_training_data(data)
    tag = tag or runner
    # at the configs' 1e-3 the JAX trainer, and the port with it, diverge
    # on these bags (PERF.md, section 6)
    return {"data.train_path": os.path.join(data, "train"),
            "data.test_path": os.path.join(data, "test"),
            "data.ground_truth_path": os.path.join(data, "ground_truth.json"),
            "data.batch_size": 3, "runner.optimizer.learning_rate": lr,
            "trainer.max_epochs": epochs, "trainer.max_steps": steps,
            "trainer.eval_every": every,
            "trainer.log_path": os.path.join(root, f"metrics_{tag}.jsonl"),
            "trainer.checkpoint.dirpath": os.path.join(root, f"checkpoints_{tag}")}


def check_training(torch, root: str, runner: str = "mgfn", eval_only: bool = False,
                   extra: dict = None, tag: str = None):
    """Training at the full ``runner=<runner>`` width through the port's
    run entry on the committed bags under ``root``, batch 3 + 3, two
    evals, with ``extra`` overrides and writers under ``tag``; with
    ``eval_only`` the run's last checkpoint is evaluated again. Gates: every
    loss finite, the mean of the last window of losses below the first, AUCs
    in [0, 1], eval_only repeating the last AUCs. Returns the checkpoint
    directory and the wall time."""
    import numpy as np

    start = time.perf_counter()
    lr, steps, _, _, window = TRAINING[runner]
    overrides = dict(training_overrides(root, runner, tag), **(extra or {}))
    ckpt = overrides["trainer.checkpoint.dirpath"]
    run_training(overrides, runner)
    with open(overrides["trainer.log_path"]) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    evals = [r for r in records if "valid/rec_auc" in r]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{runner} training: {len(losses)} losses, expected {steps} finite: "
                             f"{losses}")
    first, last = np.mean(losses[:window]), np.mean(losses[-window:])
    if not last < first:
        raise AssertionError(f"{runner} training: the loss did not fall: {losses}")
    aucs = [(r["valid/rec_auc"], r["valid/pr_auc"]) for r in evals]
    if len(evals) != 2 or not all(np.isfinite(a) and 0.0 <= a <= 1.0 for pair in aucs
                                  for a in pair):
        raise AssertionError(f"{runner} training: eval AUCs {aucs}")
    wall = time.perf_counter() - start
    print(f"{runner} training{'' if not extra else ' with ' + json.dumps(extra)}: {steps} steps "
          f"at batch 3 + 3, lr {lr:g}, losses "
          f"{np.round(losses, 5).tolist()}; first {window} mean {first:.5f}, last {window} "
          f"mean {last:.5f}; eval at steps {[r['step'] for r in evals]}: rec_auc / pr_auc "
          f"{aucs}; {wall:.1f} s", flush=True)
    if eval_only:
        printed = run_training(dict(overrides, **{"trainer.eval_only": True,
                                                  "trainer.log_path": None}), runner)
        line = json.loads(printed.strip().splitlines()[-1])
        if line["step"] != steps or abs(line["valid/rec_auc"] - aucs[-1][0]) > 1e-6 or abs(
                line["valid/pr_auc"] - aucs[-1][1]) > 1e-6:
            raise AssertionError(f"eval_only from the step-{steps} checkpoint gave {line}, "
                                 f"training's last eval {aucs[-1]}")
        print(f"eval_only from the checkpoint at step {line['step']}: rec_auc "
              f"{line['valid/rec_auc']:.6f}, pr_auc {line['valid/pr_auc']:.6f} (training's last "
              f"eval {aucs[-1][0]:.6f}, {aucs[-1][1]:.6f})", flush=True)
    return ckpt, time.perf_counter() - start


def time_train_step(torch, precision: str, runner: str = "mgfn", steps: int = 20):
    """The train step at the reference batch, 16 normal + 16 abnormal bags
    of (10, 32, 2049) made from a seed, at the full width of ``runner``'s
    default config: median ms per step (host clock around a synchronized
    step), steps/s, peak memory, and one profiled step's device time. lr
    1e-4, as in check_training: at 1e-3 these inputs drive MGFN's losses to
    NaN within a few steps. Returns the median ms."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.models import build_model, seeded_init_
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState, make_train_step

    rng = np.random.RandomState(3)
    feature = torch.from_numpy(np.abs(rng.randn(32, 10, 32, 2049)).astype(np.float32)).cuda()
    n_labels, a_labels = torch.zeros(16, device="cuda"), torch.ones(16, device="cuda")
    model = seeded_init_(build_model(runner)[1], seed=0).cuda()
    state = TrainState.create(model, adam_with_l2(model.parameters(), learning_rate=1e-4), seed=2)
    step = make_train_step(precision)
    for _ in range(3):
        step(state, feature, n_labels, a_labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(steps):
        start = time.perf_counter()
        loss = step(state, feature, n_labels, a_labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        losses.append(float(loss))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if not np.isfinite(losses).all():
        raise AssertionError(f"train step {precision}: losses {losses}")
    breakdown = device_breakdown(torch, lambda: step(state, feature, n_labels, a_labels))
    median = float(np.median(times)) * 1e3
    print(f"{runner} train step {precision} at 16 + 16 bags of (10, 32, 2049): median "
          f"{median:.3f} ms "
          f"({min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}) over {steps} steps = "
          f"{1e3 / median:.2f} steps/s; peak memory {peak_gib:.2f} GiB; one profiled step: busy "
          f"{breakdown['device_busy_ms']:.2f} ms of {breakdown['wall_ms']:.2f} ms wall, idle share "
          f"{breakdown['idle_share']:.1%}; {json.dumps(breakdown['top_other_ms'])}", flush=True)
    del state, model, feature
    torch.cuda.empty_cache()
    return median


def window(event: dict) -> tuple:
    return event["start_frame"], event["end_frame"], event["frames"]


def check_serving(torch, root: str, extractor, video, checkpoints: dict) -> None:
    """Phase 9: the three scorer families served from the port's own
    checkpoints through ``infer.main``. The 4-clip video is extracted in
    bfloat16 (launches K1 / K2 / K3 = 1 / 1 / 3) and cached as
    ``<stem>_i3d.npy``; ``infer.main`` then scores it from that
    ``--features-dir`` on the card once per checkpoint (MGFN's with
    ``--threshold 0.5 --min-event-frames 16 --warmup 4``). Gates: scores
    finite and in [0, 1]; clip scores equal to the same checkpoint scored
    on the CPU (float32, TF32 off) at atol 1e-5, the written ones and the
    card's unrounded ones; ``events`` equal to ``anomaly_events`` of the
    written frame scores (windows; peak and mean within the JSON's
    rounding). Prints each scorer's median scoring time."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.data.extraction import feature_filename
    from anomaly_detection_on_video_tpu_torch.ops import kernels
    from anomaly_detection_on_video_tpu_torch.ops.metrics import anomaly_events
    from anomaly_detection_on_video_tpu_torch.utils.npyio import atomic_save

    kernels.reset_launch_counts()
    features = extractor.extract_frames(video)
    counts = kernels.launch_counts()
    launches = (counts["ten_crop_standardize"], counts["stem_conv_pool"],
                counts["bottleneck_block"])
    print(f"serving: the 4-clip video extracted in bfloat16, launches K1 / K2 / K3 = "
          f"{launches[0]} / {launches[1]} / {launches[2]}", flush=True)
    if launches != (1, 1, 3) or features.shape != (4, 10, 2048):
        raise AssertionError(f"serving extraction: launches {counts}, features {features.shape}")
    stem = "Abuse028_x264"
    videos, feats = os.path.join(root, "videos"), os.path.join(root, "features")
    os.makedirs(os.path.join(videos, "Abuse"))
    open(os.path.join(videos, "Abuse", f"{stem}.mp4"), "wb").close()  # never decoded: cached
    atomic_save(os.path.join(feats, feature_filename(stem)), features)
    for runner in ("rtfm", "sultani", "mgfn"):
        outdir = os.path.join(root, f"scores_{runner}")
        extra = (["--threshold", "0.5", "--min-event-frames", "16", "--warmup", "4"]
                 if runner == "mgfn" else [])
        argv = ["--videos", videos, "--outdir", outdir, "--checkpoint", checkpoints[runner],
                "--features-dir", feats] + extra
        start = time.perf_counter()
        infer.main(argv + ["--device", "cuda"])
        wall = time.perf_counter() - start
        with open(os.path.join(outdir, f"{stem}_scores.json")) as f:
            out = json.load(f)
        clip, frame = np.asarray(out["clip_scores"]), np.asarray(out["frame_scores"])
        if out["model"] != runner or clip.shape != (4,) or frame.shape != (64,) or not (
                np.isfinite(frame).all() and (frame >= 0).all() and (frame <= 1).all()):
            raise AssertionError(f"{runner} served: {out}")
        args = infer.build_parser().parse_args(argv)
        cpu_scorer, _ = infer.build_scorer(argparse.Namespace(**dict(vars(args), device="cpu")))
        card_scorer, _ = infer.build_scorer(argparse.Namespace(**dict(vars(args), device="cuda")))
        ref = infer.score_features(features, cpu_scorer)
        on_card = infer.score_features(features, card_scorer)
        err = max(float(np.abs(clip - ref).max()), float(np.abs(on_card - ref).max()))
        if err > 1e-5:
            raise AssertionError(f"{runner} served scores {clip} (card {on_card}) against the "
                                 f"CPU's {ref}: max |err| {err:.2e}")
        if runner == "mgfn":
            want = anomaly_events(frame, 0.5, 16)
            # the JSON rounds scores to 6 decimals, so peaks and means
            # recomputed from them may differ by a rounding step
            if out["threshold"] != 0.5 or [window(e) for e in out["events"]] != [
                    window(e) for e in want] or any(
                    abs(g[k] - w[k]) > 1.5e-6 for g, w in zip(out["events"], want)
                    for k in ("peak", "mean")):
                raise AssertionError(f"events {out['events']} against {want}")
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            infer.score_features(features, card_scorer)  # ends in a copy to the host
            times.append(time.perf_counter() - t0)
        print(f"{runner} served from its checkpoint: clip scores {clip.tolist()}, max |err| "
              f"against the CPU {err:.2e}"
              + (f", {len(out['events'])} events at 0.5: {out['events']}" if runner == "mgfn"
                 else "")
              + f"; infer.main {wall:.2f} s; scoring median {np.median(times) * 1e3:.3f} ms "
              f"({min(times) * 1e3:.3f}-{max(times) * 1e3:.3f}) over 20 calls", flush=True)


class StandInDecoder:
    """Phase 10's stand-in for ``data/video.py``'s ``VideoFrameSource``:
    seeded uint8 240x320 frames made in memory once per video, then handed
    out in chunks of ``STAND_IN_CHUNK`` frames (so every video spans several
    chunks) at the cost of no decode: ``STAND_IN_VIDEOS[name]`` clips of 16
    frames per file name. This script swaps it in (``stand_in_decode``) for
    the extraction module's decoder, to drive the host pipeline without the
    decoder's cost; the package has no such decoder."""

    chunks: dict = {}  # file name -> its chunks, made at first use

    def __init__(self, path: str, chunk_frames: int = 0, depth: int = 2, native=None):
        self.name = os.path.basename(path)

    def __iter__(self):
        import numpy as np

        if self.name not in self.chunks:
            n_frames = STAND_IN_VIDEOS[self.name] * 16
            gen = np.random.default_rng(sum(map(ord, self.name)))
            self.chunks[self.name] = [
                gen.integers(0, 256, (min(STAND_IN_CHUNK, n_frames - start), 240, 320, 3),
                             dtype=np.uint8)
                for start in range(0, n_frames, STAND_IN_CHUNK)]
        yield from self.chunks[self.name]

    def close(self) -> None:
        pass


STAND_IN_CHUNK = 320  # 20 clips
FEATURE_DIM = 2048  # i3res50's features per crop
STAND_IN_VIDEOS = {"Abuse030_x264.mp4": 24, "Arson011_x264.mp4": 40,
                   "Normal_Videos_015_x264.mp4": 70}
LARGE_STAND_IN = "Normal_Videos_015_x264.mp4"


@contextlib.contextmanager
def stand_in_decode():
    """Decode through ``StandInDecoder``, with ``LARGE_STAND_IN`` treated
    as a video over 1 GB (per-chunk caches), inside the block."""
    from anomaly_detection_on_video_tpu_torch.data import extraction

    saved = extraction.VideoFrameSource, extraction.is_large_video
    extraction.VideoFrameSource = StandInDecoder
    extraction.is_large_video = lambda path, *a: os.path.basename(path) == LARGE_STAND_IN
    try:
        yield
    finally:
        extraction.VideoFrameSource, extraction.is_large_video = saved


def center_crops(torch, resized, dtype):
    """(clips, 16, H', W', 3) resized uint8 -> standardized center crops."""
    from anomaly_detection_on_video_tpu_torch.ops.gtransforms import center_crop, standardize

    return standardize(center_crop(resized, 224)).to(dtype).contiguous()


def check_small_and_center_batches(torch, model, qmodel, crops32):
    """Phase 10 (a): K2 and K3 at B = 1 and B = 60 (``crops32``: 60 center
    crops), and every K4 and K5 call of one int8 forward of ``qmodel`` at
    the same batches, against their plain versions under phase 2's and
    phase 4's gates, with times."""
    for b in (1, 60):
        x32 = crops32[:b].contiguous()
        print(f"K2 and K3 at B = {b}:", flush=True)
        stem_out, k2 = check_stem(torch, model, x32)
        k3 = check_bottlenecks(torch, model, stem_out)
        del stem_out
        print(f"int8 forward at B = {b}:", flush=True)
        k45 = check_int8_path_calls(torch, qmodel, x32.to(torch.bfloat16))
        print(f"B={b} summary: K2 {k2['ms']:.3f} ms (bound {k2['bound_ms']:.3f}), K3 "
              f"{k3['ms']:.3f} ms for 3 blocks (bound {k3['bound_ms']:.3f}), " + ", ".join(
                  f"{e['name']} {e['ms']:.3f} ms ({e['device_ms']:.3f} device; bound "
                  f"{e['bound_ms']:.3f})" for e in k45), flush=True)
        torch.cuda.empty_cache()


def check_center_paths(torch, model, ten_extractor, frames, scorer):
    """Phase 10 (b): ``FeatureExtractor(crops="center", batch=240)`` in
    bf16 and int8 on ``frames`` (60 clips, one group of 60 crops) through
    ``drive_path`` (launch gates, five timed passes, peak memory), one
    profiled pass each (busy, idle share, host-to-device copy). Gates:
    bf16 against the plain float32 forward of the same center crops
    (cosine >= 0.999 per row) and, on the first 24 clips, against row 4 of
    ``ten_extractor``'s features (cosine >= 0.999); int8 against the plain
    int8 forward (cosine >= 0.99999, unequal values printed)."""
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.infer import score_features
    from anomaly_detection_on_video_tpu_torch.ops.resize import resize_bilinear_fast, short_side_size

    clips = frames.shape[0] // 16
    h, w = short_side_size(frames.shape[1], frames.shape[2], 256)
    resized = resize_bilinear_fast(torch.from_numpy(frames).cuda(), h, w).reshape(clips, 16, h, w, 3)
    with torch.no_grad():
        ref = plain_features(torch, model, center_crops(torch, resized, torch.float32))
    ten = ten_extractor.extract_frames(frames[: 24 * 16])
    copy_ms = cuda_ms(lambda: torch.from_numpy(frames).to("cuda"), 3)
    print(f"the 60 clips' frames ({frames.nbytes / 1e6:.0f} MB, pageable) copied to the card "
          f"alone: {copy_ms:.3f} ms by CUDA events", flush=True)
    for n in (384, 960):  # the ten-crop B = 240 group's frames, then this group's
        seen = device_breakdown(torch, lambda: torch.from_numpy(frames[:n]).to("cuda"))
        print(f"the profiler on the copy alone of {n} frames ({frames[:n].nbytes / 1e6:.0f} MB): "
              f"wall {seen['wall_ms']:.3f} ms, copies recorded {seen['copies_ms']}", flush=True)
    for quantize in (False, True):
        name = f"center-crop {'int8 ' if quantize else ''}path at B = 240"
        extractor = FeatureExtractor(state_dict=model.state_dict(), dtype=torch.bfloat16,
                                     batch=240, device="cuda", quantize=quantize, crops="center")
        if extractor.group_clips != 60:
            raise AssertionError(f"{name}: {extractor.group_clips}-clip groups, expected 60")
        features, _, _ = drive_path(torch, name, extractor, frames, scorer)
        got = torch.from_numpy(features[:, 0]).cuda()
        if quantize:
            check_int8_features(torch, f"{name} features", extractor.model,
                                center_crops(torch, resized, torch.bfloat16), features, ref)
        else:
            cos = check_cosine(f"{name} features vs plain float32", got, ref, 0.999)
            row4 = check_cosine(f"{name} vs ten-crop row 4", got[:24],
                                torch.from_numpy(ten[:, 4]).cuda(), 0.999)
            print(f"{name} features vs plain float32 forward: min row cosine {cos:.6f}; first 24 "
                  f"clips vs the ten-crop extractor's row 4: min row cosine {row4:.6f}", flush=True)
        run = device_breakdown(torch, lambda: score_features(extractor.extract_frames(frames),
                                                             scorer))
        print(f"{name}, one profiled pass: busy {run['device_busy_ms']:.2f} ms of "
              f"{run['wall_ms']:.2f} ms wall, idle share {run['idle_share']:.1%}, host-to-device "
              f"copy {run['h2d_copy_ms']:.3f} ms; {json.dumps(run)}", flush=True)
        del extractor
        torch.cuda.empty_cache()


def run_cli(module, argv):
    """``module.main(argv)``, its standard output echoed and returned."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    sys.stdout.write(out.getvalue())
    return out.getvalue()


def time_extraction_loops(torch, videos: str, weights: str, root: str, label: str) -> None:
    """The extraction loop alone, without the CLI's model build and
    segments: ``extract_videos_pooled`` (3 decode workers) and
    ``extract_videos`` (serial) over ``videos`` with one warmed bf16
    extractor at B = 240, into fresh directories; clips/s of each."""
    from anomaly_detection_on_video_tpu_torch.data import extraction
    from anomaly_detection_on_video_tpu_torch.data.video import find_videos
    from anomaly_detection_on_video_tpu_torch.infer import load_state_dict

    paths = find_videos(videos)
    extractor = extraction.FeatureExtractor(state_dict=load_state_dict(weights),
                                            dtype=torch.bfloat16, batch=240, device="cuda")
    extractor.extract_video(paths[0])  # warm-up: cuDNN plans, the allocator
    total = sum(STAND_IN_VIDEOS.values())
    rates = []
    for name, run in (("pooled, 3 decode workers", lambda out: extraction.extract_videos_pooled(
            paths, out, extractor, decode_workers=3, progress=False)),
                      ("serial", lambda out: extraction.extract_videos(
                          paths, out, extractor, progress=False))):
        out = os.path.join(root, f"{label}_{len(rates)}")
        torch.cuda.synchronize()
        start = time.perf_counter()
        run(out)
        torch.cuda.synchronize()
        rates.append(f"{name} {total / (time.perf_counter() - start):.2f}")
    print(f"{label}, the extraction loop alone (a warmed bf16 extractor at B = 240): clips/s "
          f"{'; '.join(rates)}", flush=True)


def check_bulk_cli(torch, root: str, weights: str) -> None:
    """Phase 10 (c): ``extract_features.main --split train`` over the
    stand-in videos with ``--decode-workers 3`` (pooled) and, into another
    outdir, ``--decode-workers 1 --profile`` (serial). Gates: both runs'
    features equal at atol 1e-5; (10, 32, 2048) segment files; a second
    pooled run extracts 0 videos; with the large video's file deleted, a
    re-run rebuilds it from its chunk caches with zero kernel launches."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    videos = os.path.join(root, "stand_in_videos")
    os.makedirs(videos)
    for name in STAND_IN_VIDEOS:
        open(os.path.join(videos, name), "wb").close()  # decoded by the stand-in
    total = sum(STAND_IN_VIDEOS.values())
    outs = {}
    for label, extra in (("pooled", ["--decode-workers", "3"]),
                         ("serial", ["--decode-workers", "1", "--profile"])):
        outs[label] = os.path.join(root, f"bulk_{label}")
        argv = ["--videos", videos, "--outdir", outs[label], "--split", "train", "--weights",
                weights, "--device", "cuda"] + extra
        start = time.perf_counter()
        printed = run_cli(extract_features, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        if "extracted 3 new videos (3 total)" not in printed:
            raise AssertionError(f"bulk CLI {label}: {printed}")
        print(f"bulk CLI {label}: {total} clips of 3 videos in {seconds:.2f} s = "
              f"{total / seconds:.2f} clips/s end to end (stand-in decode, segments included)",
              flush=True)
    diff = 0.0
    for name, clips in STAND_IN_VIDEOS.items():
        feature = f"{os.path.splitext(name)[0]}_i3d.npy"
        a, b = (np.load(os.path.join(outs[k], "train", feature)) for k in ("pooled", "serial"))
        if a.shape != (clips, 10, FEATURE_DIM) or b.shape != a.shape:
            raise AssertionError(f"bulk CLI {feature}: shapes {a.shape}, {b.shape}")
        diff = max(diff, float(np.abs(a - b).max()))
        seg = np.load(os.path.join(outs["pooled"], "segment_features_32", feature))
        if seg.shape != (10, 32, FEATURE_DIM) or not np.isfinite(seg).all():
            raise AssertionError(f"bulk CLI segments {feature}: {seg.shape}")
    print(f"bulk CLI pooled vs serial features: max |diff| {diff:.3e}; segment files (10, 32, "
          f"{FEATURE_DIM}) written", flush=True)
    if diff > 1e-5:
        raise AssertionError(f"bulk CLI pooled vs serial: max |diff| {diff:.3e} > 1e-5")
    argv = ["--videos", videos, "--outdir", outs["pooled"], "--split", "train", "--weights",
            weights, "--device", "cuda", "--decode-workers", "3"]
    if "extracted 0 new videos (3 total)" not in run_cli(extract_features, argv):
        raise AssertionError("a second pooled run extracted videos again")
    large = os.path.join(outs["pooled"], "train", f"{os.path.splitext(LARGE_STAND_IN)[0]}_i3d.npy")
    before = np.load(large)
    caches = os.path.join(outs["pooled"], "train", os.path.splitext(LARGE_STAND_IN)[0])
    n_caches = len(os.listdir(caches))
    os.remove(large)
    kernels.reset_launch_counts()
    printed = run_cli(extract_features, argv)
    counts = kernels.launch_counts()
    if "extracted 1 new videos (3 total)" not in printed or any(counts.values()):
        raise AssertionError(f"rebuild from chunk caches: launches {counts}, {printed}")
    if not np.array_equal(np.load(large), before):
        raise AssertionError("the rebuilt file differs from the first one")
    print(f"bulk CLI: a second pooled run extracted 0 videos; {LARGE_STAND_IN}'s file rebuilt "
          f"from its {n_caches} chunk caches with launches {counts}", flush=True)
    time_extraction_loops(torch, videos, weights, root, "stand-in decode")


def check_real_decode(torch, root: str, weights: str) -> None:
    """Phase 10 (c'): where OpenCV is importable, the stand-in videos'
    contents (coarse 8x8-pixel blocks, so JPEG compresses them as it does
    real scenes) are written as MJPG files and extracted by
    ``extract_features.main`` with real decode, pooled (3 workers) and
    serial with ``--profile``: clips/s end to end, and both runs' features
    equal at atol 1e-5. Without OpenCV this is not measured."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features
    from anomaly_detection_on_video_tpu_torch.data import framepipe

    try:
        import cv2
    except ImportError:
        print("real decode: not measured (OpenCV is not importable on this machine)", flush=True)
        return
    videos = os.path.join(root, "mjpg_videos")
    os.makedirs(videos)
    mb = 0.0
    for name, clips in STAND_IN_VIDEOS.items():
        gen = np.random.default_rng(sum(map(ord, name)))
        coarse = gen.integers(0, 256, (clips * 16, 30, 40, 3), dtype=np.uint8)
        path = os.path.join(videos, f"{os.path.splitext(name)[0]}.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (320, 240))
        for frame in coarse.repeat(8, axis=1).repeat(8, axis=2):
            writer.write(np.ascontiguousarray(frame[..., ::-1]))
        writer.release()
        mb += os.path.getsize(path) / 1e6
    total = sum(STAND_IN_VIDEOS.values())
    engine = ("the native decoder" if framepipe.available()
              else f"OpenCV {cv2.__version__}")
    outs = {}
    for label, extra in (("pooled", ["--decode-workers", "3"]),
                         ("serial", ["--decode-workers", "1", "--profile"])):
        outs[label] = os.path.join(root, f"decoded_{label}")
        start = time.perf_counter()
        run_cli(extract_features, ["--videos", videos, "--outdir", outs[label], "--weights",
                                   weights, "--device", "cuda", "--no-segments"] + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        print(f"real decode ({engine}, {mb:.1f} MB of MJPG), extract_features {label}: {total} "
              f"clips in {seconds:.2f} s = {total / seconds:.2f} clips/s end to end", flush=True)
    diff = max(float(np.abs(np.load(os.path.join(outs["pooled"], f)) - np.load(
        os.path.join(outs["serial"], f))).max()) for f in os.listdir(outs["serial"])
        if f.endswith("_i3d.npy"))
    if diff > 1e-5:
        raise AssertionError(f"real decode: pooled vs serial features differ by {diff:.3e}")
    print(f"real decode: pooled vs serial features max |diff| {diff:.3e}", flush=True)
    time_extraction_loops(torch, videos, weights, root, f"real decode ({engine})")


def check_center_serving(torch, root: str, weights: str, checkpoint: str) -> None:
    """Phase 10 (d): ``infer.main --crops center`` on the 24-clip stand-in
    video with phase 8's MGFN checkpoint. Gates: scores finite and in
    [0, 1], equal at 1e-5 to ``score_features`` of a center extractor's
    features of the same video."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor

    name = "Abuse030_x264.mp4"
    request = os.path.join(root, "request")
    os.makedirs(request)
    open(os.path.join(request, name), "wb").close()
    outdir, feats = os.path.join(root, "scores_center"), os.path.join(root, "features_center")
    argv = ["--videos", request, "--outdir", outdir, "--checkpoint", checkpoint, "--crops",
            "center", "--i3d-weights", weights, "--features-dir", feats, "--device", "cuda"]
    start = time.perf_counter()
    infer.main(argv)
    wall = time.perf_counter() - start
    stem = os.path.splitext(name)[0]
    with open(os.path.join(outdir, f"{stem}_scores.json")) as f:
        out = json.load(f)
    clip = np.asarray(out["clip_scores"])
    cached = np.load(os.path.join(feats, f"{stem}_i3d_center.npy"))
    if clip.shape != (24,) or cached.shape != (24, 1, FEATURE_DIM) or not (
            np.isfinite(clip).all() and (clip >= 0).all() and (clip <= 1).all()):
        raise AssertionError(f"center serving: scores {clip.shape}, features {cached.shape}")
    extractor = FeatureExtractor(state_dict=infer.load_state_dict(weights), dtype=torch.bfloat16,
                                 adaptive_groups=True, device="cuda", crops="center")
    features = extractor.extract_video(os.path.join(request, name))
    scorer, _ = infer.build_scorer(infer.build_parser().parse_args(argv))
    ref = infer.score_features(features, scorer)
    err = float(np.abs(clip - ref).max())
    if err > 1e-5:
        raise AssertionError(f"center serving scores {clip} against {ref}: max |err| {err:.2e}")
    print(f"infer --crops center with the MGFN checkpoint: 24 clips scored in {wall:.2f} s "
          f"(infer.main); clip scores vs score_features of the center extractor's features: "
          f"max |err| {err:.2e}; features cached as {stem}_i3d_center.npy", flush=True)


def time_dispatch_hop(torch, extractor, video, passes: int = 10) -> None:
    """The cost of the hop to the extractor's dispatch thread on a
    request: ``dispatch_frames`` + ``materialize_features`` against
    ``extract_frames`` (the same work on this thread), in turns (each
    first in every other pass), median ms each."""
    import numpy as np

    n_clips = (video.shape[0] - 1) // extractor.frames_per_clip + 1
    gc = extractor._group_for(n_clips)
    runs = [("dispatched", lambda: extractor.materialize_features(extractor.dispatch_frames(video))),
            ("extract_frames, on this thread", lambda: extractor.extract_frames(video))]
    times = {name: [] for name, _ in runs}
    for i in range(passes):
        for name, run in runs[::1 if i % 2 else -1]:
            torch.cuda.synchronize()
            start = time.perf_counter()
            run()
            times[name].append((time.perf_counter() - start) * 1e3)
    print(f"dispatch thread hop on the {n_clips}-clip video ({str(extractor.dtype)[6:]}, B = "
          f"{gc * extractor.n_crops}), {passes} passes "
          f"in turns: " + "; ".join(f"{k} median {np.median(v):.3f} ms ({min(v):.3f}-"
                                    f"{max(v):.3f})" for k, v in times.items()), flush=True)


def check_extraction_breadth(torch, root, model, qmodel, ten_extractor, scorer, checkpoint,
                             extractor, video):
    """Phase 10: extraction breadth. (a) K2-K5 at B = 1 and B = 60,
    (b) center-crop extraction at full width in bf16 and int8, (c) the bulk
    CLI pooled and serial over stand-in videos, (d) center-crop serving;
    first the dispatch thread's cost on the 4-clip request."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.data import framepipe
    from anomaly_detection_on_video_tpu_torch.ops.resize import resize_bilinear_fast

    start = time.perf_counter()
    try:
        import cv2  # noqa: F401
        have_cv2 = "yes"
    except ImportError:
        have_cv2 = "no"
    time_dispatch_hop(torch, extractor, video)
    print(f"phase 10 decodes with a stand-in (seeded frames in memory, not a package decoder); "
          f"on this machine OpenCV importable: {have_cv2}, libframepipe usable: "
          f"{'yes' if framepipe.available() else 'no'}", flush=True)
    frames = np.random.RandomState(10).randint(0, 256, (960, 240, 320, 3), dtype=np.uint8)
    resized = resize_bilinear_fast(torch.from_numpy(frames).cuda(), 256, 341).reshape(
        60, 16, 256, 341, 3)
    crops32 = center_crops(torch, resized, torch.float32)
    del resized
    check_small_and_center_batches(torch, model, qmodel, crops32)
    del crops32
    torch.cuda.empty_cache()
    check_center_paths(torch, model, ten_extractor, frames, scorer)
    weights = os.path.join(root, "i3res50.pt")
    torch.save(model.state_dict(), weights)
    with stand_in_decode():
        check_bulk_cli(torch, root, weights)
        check_center_serving(torch, root, weights, checkpoint)
    check_real_decode(torch, root, weights)
    print(f"extraction breadth phase: {time.perf_counter() - start:.1f} s", flush=True)


# ------------------------------------------------------------- phase 11: flow

FLOW_SHIFT = (1.3, -0.7)  # (dx, dy) px per frame of phase 11's scene
FLOW_GATES = {"Farneback": 0.3, "TV-L1": 0.03}  # px: tests/test_flow.py, tests/test_tvl1.py
FLOW_CARD_VS_CPU_PX = 1e-3  # the port-vs-JAX gate of tests/test_torch_flow.py
TWO_STREAM_VIDEOS = ("Abuse030_x264.mp4", LARGE_STAND_IN)  # 24 and 70 clips


def moving_scene(n: int, h: int = 240, w: int = 320, shift=FLOW_SHIFT, seed: int = 11):
    """uint8 RGB ``(n, h, w, 3)``: a smooth periodic random texture
    translated by ``shift`` px per frame, exactly (a phase ramp on its
    Fourier transform), with three different channels so the luma weights
    matter. Noise has no meaningful flow; this has a known one."""
    import numpy as np

    rng = np.random.RandomState(seed)
    spectrum = np.fft.fft2(rng.rand(h, w))
    ky, kx = np.fft.fftfreq(h)[:, None], np.fft.fftfreq(w)[None, :]
    spectrum *= np.exp(-2 * (np.pi * 2.0) ** 2 * (ky ** 2 + kx ** 2))  # a Gaussian blur, sigma 2
    frames = np.empty((n, h, w, 3), np.uint8)
    lo = hi = None
    for i in range(n):
        phase = np.exp(-2j * np.pi * (ky * shift[1] * i + kx * shift[0] * i))
        f = np.fft.ifft2(spectrum * phase).real
        if lo is None:
            lo, hi = f.min(), f.max()
        f = np.clip((f - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)
        frames[i] = np.stack([f, np.roll(f, 3, 1), f // 2 + 60], -1)
    return frames


def check_flows(torch, frames):
    """Phase 11 (a): device Farneback and TV-L1 on every pair of ``frames``
    (the moving scene): ms per frame and peak memory at sub-batches of 64
    and 128 pairs, ``FLOW_PAIRS`` and all pairs at once, each sub-batched
    flow equal to the one-batch flow; the translation recovered (median
    flow 30 px inside the frame, gated at the JAX tests' tolerance); the
    card against the port's CPU flow on a 9-frame slice (max and 99.9th
    percentile in px, gated at 1e-3 px; unequal uint8 values printed).
    Then the round trip a device flow no longer makes: a 3,008-frame
    chunk's uint8 flow copied to pageable host memory and back, timed; and
    the host OpenCV backend's frames/s. Returns the Farneback flow as uint8
    on the host, the flow stream's input."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.data.flow import (
        FLOW_BOUND, compute_flow, flow_to_uint8)
    from anomaly_detection_on_video_tpu_torch.data.video import CHUNK_FRAMES
    from anomaly_detection_on_video_tpu_torch.ops import flow as tflow
    from anomaly_detection_on_video_tpu_torch.ops import tvl1 as ttvl1

    dev = torch.from_numpy(frames).cuda()
    n = frames.shape[0]
    out = None
    for name, fn in (("Farneback", tflow.compute_flow_device), ("TV-L1", ttvl1.compute_flow_tvl1)):
        fn(dev[:17])  # warm-up: cuDNN plans, the allocator
        flows = {}
        for pairs in sorted({64, 128, tflow.FLOW_PAIRS, n - 1}):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            flows[pairs] = fn(dev, pairs=pairs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            print(f"{name} flow, {n - 1} pairs of {frames.shape[1]}x{frames.shape[2]} in "
                  f"sub-batches of {pairs}: {seconds * 1e3 / (n - 1):.3f} ms per frame "
                  f"({(n - 1) / seconds:.1f} frames/s), peak {peak:.2f} GiB above the "
                  f"{base / 2 ** 30:.2f} GiB held", flush=True)
        flow = flows[tflow.FLOW_PAIRS]
        unequal = {p: int((f != flows[n - 1]).sum()) for p, f in flows.items()}
        if any(unequal.values()):
            raise AssertionError(f"{name}: sub-batched flow differs from one batch: {unequal}")
        est = (flow[1:, 30:-30, 30:-30].reshape(-1, 2) * FLOW_BOUND).median(dim=0).values
        err = float((est.cpu() - torch.tensor(FLOW_SHIFT)).abs().max())
        print(f"{name}: sub-batched flows equal the one-batch flow; median flow {est.tolist()} "
              f"px per frame against the scene's {list(FLOW_SHIFT)}: |err| {err:.4f} px (gate "
              f"{FLOW_GATES[name]})", flush=True)
        if err > FLOW_GATES[name]:
            raise AssertionError(f"{name}: translation {est.tolist()} against {FLOW_SHIFT}")
        cpu = fn(torch.from_numpy(frames[:9]))
        diff = (flow[:9].cpu() - cpu).abs().flatten() * FLOW_BOUND
        worst, p999 = float(diff.max()), float(torch.quantile(diff, 0.999))
        flips = int((flow_to_uint8(flow[:9]).cpu() != flow_to_uint8(cpu)).sum())
        print(f"{name}, the card against the port's CPU flow on frames 0-8: max {worst:.3e} px, "
              f"99.9th percentile {p999:.3e} px (gate {FLOW_CARD_VS_CPU_PX} px); uint8 flow "
              f"unequal in {flips} of {cpu.numel()} values", flush=True)
        if worst > FLOW_CARD_VS_CPU_PX:
            raise AssertionError(f"{name}: card vs CPU max {worst:.3e} px")
        if out is None:
            out = flow_to_uint8(flow).cpu().numpy()
        del flows, flow
        torch.cuda.empty_cache()
    chunk = torch.randint(0, 256, (CHUNK_FRAMES, *frames.shape[1:3], 2), dtype=torch.uint8,
                          device="cuda")
    for _ in range(2):  # the second round trip is timed
        torch.cuda.synchronize()
        start = time.perf_counter()
        host = chunk.cpu().numpy()
        mid = time.perf_counter()
        back = torch.from_numpy(host).cuda()
        torch.cuda.synchronize()
        end = time.perf_counter()
    if not torch.equal(back, chunk):
        raise AssertionError("the flow chunk's round trip changed it")
    print(f"a {CHUNK_FRAMES}-frame chunk's uint8 flow ({chunk.numel() / 1e6:.1f} MB), the round "
          f"trip device flows no longer make: to pageable host memory {(mid - start) * 1e3:.2f} "
          f"ms, back {(end - mid) * 1e3:.2f} ms (against {CHUNK_FRAMES} frames of Farneback at "
          f"the ms per frame above)", flush=True)
    del chunk, host, back
    torch.cuda.empty_cache()
    try:
        import cv2  # noqa: F401
    except ImportError:
        print("host flow (OpenCV): not measured, OpenCV is not importable", flush=True)
    else:
        start = time.perf_counter()
        compute_flow(frames[:33])
        seconds = time.perf_counter() - start
        print(f"host flow (OpenCV Farneback on the host CPU): 32 pairs in {seconds:.2f} s "
              f"= {32 / seconds:.1f} frames/s", flush=True)
    return out


def check_k5_stem(torch, gen, cin: int, stride: int, plain_batches=(40, 240)) -> dict:
    """K5's int8 stem k(5,7,7) s(``stride``,2,2) p(2,3,3) over ``cin``
    channels on seeded input at B = 40 and 240: bit-equal to its plain
    version (in slices of 40 clips), timed beside its bound, its plain
    version (float64, at ``plain_batches``) and a bf16 cuDNN ``F.conv3d`` of
    the same geometry (a yardstick the port never calls). Returns the
    largest difference and, per batch, the times and bounds."""
    import torch.nn.functional as F

    from anomaly_detection_on_video_tpu_torch.ops.kernels import (
        int8_conv, int8_conv_plain, pack_int8_conv_weight)
    from anomaly_detection_on_video_tpu_torch.ops.kernels.int8_conv import unpack_int8_conv_weight

    w = pack_int8_conv_weight(torch.randint(-20, 21, (64, cin, 5, 7, 7), generator=gen,
                                            dtype=torch.int8, device="cuda"))
    scale = torch.rand(64, generator=gen, device="cuda") * 1e-4 + 1e-5
    geo = ((5, 7, 7), (stride, 2, 2), (2, 3, 3))
    label = f"K5 int8 stem s({stride},2,2) over {cin} channels"
    record = {"max_abs_err": 0.0}
    for b in (40, 240):
        x = torch.randint(-127, 128, (b, 16, 224, 224, cin), generator=gen, dtype=torch.int8,
                          device="cuda")
        out = int8_conv(x, w, scale, *geo, torch.bfloat16)
        for i in range(0, b, 40):
            err = check_equal(f"{label} at B = {b}, clips {i}-{i + 39}", out[i:i + 40],
                              int8_conv_plain(x[i:i + 40], w, scale, *geo, torch.bfloat16))
            record["max_abs_err"] = max(record["max_abs_err"], err)
        ms = cuda_ms(lambda: int8_conv(x, w, scale, *geo, torch.bfloat16), 10)
        plain_ms = (cuda_ms(lambda: int8_conv_plain(x, w, scale, *geo, torch.bfloat16), 1)
                    if b in plain_batches else None)
        xb = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        wb = unpack_int8_conv_weight(w, cin, geo[0]).to(torch.bfloat16)
        conv_ms = cuda_ms(lambda: F.conv3d(xb, wb, None, geo[1], geo[2]), 5)
        del xb
        taps = (taps_inside(16, out.shape[1], 5, stride, 2)
                * taps_inside(224, 112, 7, 2, 3) ** 2)
        bound_ms, bound_by = bound(x.numel() + w.numel() + 4 * 64
                                   + out.numel() * out.element_size(),
                                   2.0 * b * 64 * cin * taps, "int8")
        plain = "not run" if plain_ms is None else f"{plain_ms:.3f} ms"
        print(f"{label} at B = {b}: output {tuple(out.shape)}, bit-equal; {ms:.3f} ms kernel, "
              f"bound {bound_ms:.3f} ms ({bound_by}), plain (float64) {plain}, bf16 F.conv3d of "
              f"the same geometry (yardstick) {conv_ms:.3f} ms", flush=True)
        record.update({f"ms_b{b}": ms, f"bound_ms_b{b}": bound_ms, f"plain_ms_b{b}": plain_ms,
                       f"conv_bf16_ms_b{b}": conv_ms, "bound_by": bound_by})
        del x, out
        torch.cuda.empty_cache()
    return record


def check_flow_stem(torch, launches: int):
    """Phase 11 (c): K5's int8 stem over two channels (the flow stream's)
    at B = 40 and B = 240 (``check_k5_stem``); a stem the kernel does not
    take raises. Returns the JSON line's K5 ``stem_cin2`` entry:
    ``launches``, the stem's launches over 2 channels counted in one int8
    flow forward at B = 240 (``check_flow_extractor``), and the largest
    difference of these comparisons."""
    from anomaly_detection_on_video_tpu_torch.ops.kernels import int8_conv, pack_int8_conv_weight

    gen = torch.Generator(device="cuda").manual_seed(12)
    entry = {"cin": 2, "launches_per_flow_forward": launches, **check_k5_stem(torch, gen, 2, 2)}
    geo = ((5, 7, 7), (2, 2, 2), (2, 3, 3))
    scale = torch.ones(64, device="cuda")
    for label, shape in (("one channel", (1, 16, 224, 224, 1)),
                         ("a width not a multiple of 4", (1, 16, 224, 222, 2))):
        x = torch.zeros(shape, dtype=torch.int8, device="cuda")
        wx = pack_int8_conv_weight(torch.zeros((64, shape[-1], 5, 7, 7), dtype=torch.int8,
                                               device="cuda"))
        try:
            int8_conv(x, wx, scale, *geo, torch.bfloat16)
        except ValueError as exc:
            print(f"K5 refuses a stem over {label}: {str(exc)[:100]}", flush=True)
        else:
            raise AssertionError(f"K5 took a stem over {label}")
    return entry


def flow_crops(torch, extractor, flow_u8, dtype):
    """The flow extractor's input batch for ``flow_u8``, made from the
    package's building blocks: loop-pad, the float resize, ten crops,
    dequantized to [-1, 1] in ``dtype``."""
    from anomaly_detection_on_video_tpu_torch.ops.gtransforms import ten_crop
    from anomaly_detection_on_video_tpu_torch.ops.resize import resize_bilinear_fast, short_side_size

    clips = (flow_u8.shape[0] - 1) // 16 + 1
    padded = extractor.pad_frames(flow_u8, clips)
    h, w = short_side_size(padded.shape[1], padded.shape[2], 256)
    resized = resize_bilinear_fast(torch.from_numpy(padded).cuda(), h, w)
    crops = ten_crop(resized.reshape(clips, 16, h, w, 2), 224).transpose(0, 1)
    return (crops.reshape(-1, 16, 224, 224, 2).to(torch.float32) / 127.5 - 1.0).to(dtype)


def check_flow_extractor(torch, model, frames, flow_u8, scorer):
    """Phase 11 (b): the flow stream's ``FeatureExtractor(stream="flow",
    batch=240)`` in bf16 and int8 on the scene's uint8 flow (24 clips, one
    group of 240 crops) through ``drive_path`` (launches: no K1, K2 or K3;
    int8 K4 >= 27, K5 >= 26, K5's stem over 2 channels), one profiled pass
    each; the flow stream end to end from RGB frames (device flow, kept on
    the card, + forward), clips/s. Gates: bf16 features against the plain
    float32 forward (cosine >= 0.999); int8 against the plain int8 forward
    (cosine >= 0.99999, unequal count printed), and every K4 and K5 call of
    one int8 flow forward bit-equal. Returns K5's stem launches over 2
    channels in the int8 path's counted pass (one forward)."""
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.infer import score_features

    clips = (flow_u8.shape[0] - 1) // 16 + 1
    extractors = {}
    for quantize in (False, True):
        name = f"flow {'int8 ' if quantize else ''}path at B = 240"
        ex = FeatureExtractor(state_dict=model.state_dict(), dtype=torch.bfloat16, batch=240,
                              device="cuda", quantize=quantize, stream="flow")
        if ex.flow_backend != "device" or ex.model.conv1.in_channels != 2:
            raise AssertionError(f"{name}: backend {ex.flow_backend}, stem over "
                                 f"{ex.model.conv1.in_channels} channels")
        features, _, counts = drive_path(torch, name, ex, flow_u8, scorer)
        if quantize:
            stem_launches = counts["int8_conv stem by Cin"][2]
        crops = flow_crops(torch, ex, flow_u8, torch.float32)
        with torch.no_grad():
            ref = ex.model.forward_unfused(crops).mean(dim=(2, 3, 4)).reshape(clips, 10, -1)
        if quantize:
            crops16 = crops.to(torch.bfloat16)
            del crops
            check_int8_features(torch, f"{name} features", ex.model, crops16, features, ref)
            print(f"every K4 and K5 call of one int8 flow forward at B = 240:", flush=True)
            calls = check_int8_path_calls(torch, ex.model, crops16)
            print("flow int8 B=240 summary: " + ", ".join(
                f"{e['name']} {e['ms']:.3f} ms ({e['device_ms']:.3f} device; bound "
                f"{e['bound_ms']:.3f}, plain {e['plain_ms']:.3f})" for e in calls), flush=True)
            del crops16
        else:
            del crops
            cos = check_cosine(f"{name} features vs plain float32",
                               torch.from_numpy(features).cuda(), ref, 0.999)
            print(f"{name} features vs plain float32 forward: min row cosine {cos:.6f}",
                  flush=True)
        run = device_breakdown(torch, lambda: score_features(ex.extract_frames(flow_u8), scorer))
        print(f"{name}, one profiled pass: busy {run['device_busy_ms']:.2f} ms of "
              f"{run['wall_ms']:.2f} ms wall, idle share {run['idle_share']:.1%}; "
              f"{json.dumps(run)}", flush=True)
        extractors[quantize] = ex
        del ref
        torch.cuda.empty_cache()
    ex = extractors[False]
    transform = ex._host_transform()
    for _ in range(2):  # the second pass is timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        ex.extract_frames(transform(frames))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    print(f"flow stream end to end from RGB frames (device Farneback + the bf16 forward), "
          f"{clips} clips: {seconds * 1e3:.2f} ms = {clips / seconds:.2f} clips/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    del extractors
    torch.cuda.empty_cache()
    return stem_launches


def check_two_stream_cli(torch, root: str, weights: str) -> None:
    """Phase 11 (d): ``extract_features.main --stream both --flow-backend
    device --split train`` over two stand-in videos (24 and 70 clips, the
    second treated as over 1 GB), pooled (``--decode-workers 3``) and
    serial (``--decode-workers 1 --profile``). Gates: both runs' features
    equal, both streams; ``flow_backend.json`` pins ``device``; segment
    files of both streams; with the large video's two files deleted, a
    re-run rebuilds them from their chunk caches with no kernel launch and
    no flow computed."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features
    from anomaly_detection_on_video_tpu_torch.data import extraction
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    videos = os.path.join(root, "two_stream_videos")
    os.makedirs(videos)
    for name in TWO_STREAM_VIDEOS:
        open(os.path.join(videos, name), "wb").close()  # decoded by the stand-in
    total = sum(STAND_IN_VIDEOS[name] for name in TWO_STREAM_VIDEOS)
    outs = {}
    for label, extra in (("pooled", ["--decode-workers", "3"]),
                         ("serial", ["--decode-workers", "1", "--profile"])):
        outs[label] = os.path.join(root, f"two_stream_{label}")
        argv = ["--videos", videos, "--outdir", outs[label], "--split", "train", "--weights",
                weights, "--stream", "both", "--flow-backend", "device", "--device",
                "cuda"] + extra
        start = time.perf_counter()
        printed = run_cli(extract_features, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        if "extracted 2 new videos (2 total)" not in printed:
            raise AssertionError(f"two-stream CLI {label}: {printed}")
        print(f"two-stream CLI {label}: {total} clips of 2 videos, both streams, in {seconds:.2f} "
              f"s = {total / seconds:.2f} clips/s end to end (stand-in decode, device flow, "
              f"segments included)", flush=True)
    unequal = 0
    for name in TWO_STREAM_VIDEOS:
        stem = os.path.splitext(name)[0]
        for stream in ("rgb", "flow"):
            feature = extraction.feature_filename(stem, stream)
            a, b = (np.load(os.path.join(outs[k], "train", feature)) for k in outs)
            if a.shape != (STAND_IN_VIDEOS[name], 10, FEATURE_DIM) or b.shape != a.shape:
                raise AssertionError(f"two-stream CLI {feature}: shapes {a.shape}, {b.shape}")
            unequal += int((a != b).sum())
            seg = np.load(os.path.join(outs["pooled"], "segment_features_32", feature))
            if seg.shape != (10, 32, FEATURE_DIM) or not np.isfinite(seg).all():
                raise AssertionError(f"two-stream CLI segments {feature}: {seg.shape}")
    with open(os.path.join(outs["pooled"], "train", "flow_backend.json")) as f:
        pin = json.load(f)
    print(f"two-stream CLI pooled vs serial: {unequal} unequal feature values over both streams; "
          f"flow_backend.json {pin}; segment files of both streams written", flush=True)
    if unequal or pin != {"flow_backend": "device"}:
        raise AssertionError(f"two-stream CLI: {unequal} unequal values, pin {pin}")
    argv = ["--videos", videos, "--outdir", outs["pooled"], "--split", "train", "--weights",
            weights, "--stream", "both", "--flow-backend", "device", "--device", "cuda",
            "--decode-workers", "3"]
    stem = os.path.splitext(LARGE_STAND_IN)[0]
    before = {}
    for stream in ("rgb", "flow"):
        path = os.path.join(outs["pooled"], "train", extraction.feature_filename(stem, stream))
        before[path] = np.load(path)
        os.remove(path)
    flows = []
    device_flow = extraction.compute_flow_device
    extraction.compute_flow_device = lambda *a, **k: flows.append(1) or device_flow(*a, **k)
    kernels.reset_launch_counts()
    try:
        printed = run_cli(extract_features, argv)
    finally:
        extraction.compute_flow_device = device_flow
    counts = kernels.launch_counts()
    if "extracted 1 new videos (2 total)" not in printed or any(counts.values()) or flows:
        raise AssertionError(f"two-stream rebuild from chunk caches: launches {counts}, "
                             f"{len(flows)} flows, {printed}")
    if not all(np.array_equal(np.load(p), a) for p, a in before.items()):
        raise AssertionError("the rebuilt two-stream files differ from the first ones")
    print(f"two-stream CLI: {LARGE_STAND_IN}'s two files rebuilt from their chunk caches with "
          f"launches {counts} and {len(flows)} flows computed", flush=True)


def check_two_stream_float32(torch, root: str, weights: str) -> None:
    """Phase 11 (e): ``extract_features.main --dtype float32 --stream both
    --flow-backend device`` over the 24-clip stand-in video, pooled
    (``--decode-workers 3``: a chunk's RGB forward runs on its dispatch
    worker while this thread computes the chunk's flow) and serial, with
    the TF32 flags at torch's defaults (cuDNN's on), as a user's process
    has them. Gate: both streams' features equal, so no float32 forward
    depends on the flags another thread's flow sets."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features
    from anomaly_detection_on_video_tpu_torch.data import extraction
    from anomaly_detection_on_video_tpu_torch.utils.device import set_f32_parity

    videos = os.path.join(root, "float32_videos")
    os.makedirs(videos)
    name = TWO_STREAM_VIDEOS[0]
    open(os.path.join(videos, name), "wb").close()  # decoded by the stand-in
    outs = {}
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        for label, workers in (("pooled", "3"), ("serial", "1")):
            outs[label] = os.path.join(root, f"float32_{label}")
            start = time.perf_counter()
            printed = run_cli(extract_features, [
                "--videos", videos, "--outdir", outs[label], "--weights", weights, "--dtype",
                "float32", "--stream", "both", "--flow-backend", "device", "--device", "cuda",
                "--decode-workers", workers, "--no-segments"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            if "extracted 1 new videos (1 total)" not in printed:
                raise AssertionError(f"float32 two-stream CLI {label}: {printed}")
            print(f"float32 two-stream CLI {label}: {STAND_IN_VIDEOS[name]} clips, both streams, "
                  f"in {seconds:.2f} s", flush=True)
    finally:
        set_f32_parity()
    stem = os.path.splitext(name)[0]
    unequal = {}
    for stream in ("rgb", "flow"):
        feature = extraction.feature_filename(stem, stream)
        a, b = (np.load(os.path.join(outs[k], feature)) for k in ("pooled", "serial"))
        if a.shape != (STAND_IN_VIDEOS[name], 10, FEATURE_DIM) or b.shape != a.shape:
            raise AssertionError(f"float32 two-stream CLI {feature}: shapes {a.shape}, {b.shape}")
        unequal[stream] = int((a != b).sum())
    print(f"float32 two-stream CLI pooled vs serial, TF32 flags at torch's defaults: unequal "
          f"feature values {unequal}", flush=True)
    if any(unequal.values()):
        raise AssertionError(f"float32 two-stream CLI: pooled differs from serial: {unequal}")


def check_two_stream_serving(torch, root: str, weights: str) -> None:
    """Phase 11 (f): MGFN trained on two-stream features through the port's
    ``run`` (``data.stream=both``, ``runner.model_config.channels=4096``,
    the committed bags as RGB and their feature-reversed copies as flow,
    6 steps), then ``infer.main --checkpoint`` with no ``--stream`` on the
    24-clip stand-in video, extracting both streams on the card into a
    fresh ``--features-dir``. Gates: losses finite; the score JSON's
    stream is ``both``; scores in [0, 1] and equal at 1e-5 to the CPU's
    scoring of the cached RGB || flow features."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer

    data = os.path.join(root, "data_both")
    train, test, gt, _ = write_training_data(data)
    for split in (train, test):
        for name in os.listdir(split):
            if name.endswith("_i3d.npy"):
                bags = np.load(os.path.join(split, name))
                np.save(os.path.join(split, name[: -len("_i3d.npy")] + "_flow.npy"),
                        np.ascontiguousarray(bags[..., ::-1]))
    ckpt = os.path.join(root, "checkpoints_both")
    log = os.path.join(root, "metrics_both.jsonl")
    run_training({"data.train_path": train, "data.test_path": test,
                  "data.ground_truth_path": gt, "data.batch_size": 3, "data.stream": "both",
                  "runner.model_config.channels": 4096, "runner.optimizer.learning_rate": 1e-4,
                  "trainer.max_epochs": 3, "trainer.max_steps": 6, "trainer.eval_every": 3,
                  "trainer.log_path": log, "trainer.checkpoint.dirpath": ckpt})
    with open(log) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    aucs = [r["valid/rec_auc"] for r in records if "valid/rec_auc" in r]
    if len(losses) != 6 or not np.isfinite(losses).all() or not aucs:
        raise AssertionError(f"two-stream training: losses {losses}, AUCs {aucs}")
    print(f"two-stream MGFN (4096 channels) trained 6 steps: losses "
          f"{np.round(losses, 5).tolist()}, rec_auc {aucs}", flush=True)
    name = TWO_STREAM_VIDEOS[0]
    request = os.path.join(root, "request_both")
    os.makedirs(request)
    open(os.path.join(request, name), "wb").close()
    outdir, feats = os.path.join(root, "scores_both"), os.path.join(root, "features_both")
    argv = ["--videos", request, "--outdir", outdir, "--checkpoint", ckpt, "--i3d-weights",
            weights, "--features-dir", feats, "--device", "cuda"]
    start = time.perf_counter()
    with stand_in_decode():
        infer.main(argv)
    wall = time.perf_counter() - start
    stem = os.path.splitext(name)[0]
    with open(os.path.join(outdir, f"{stem}_scores.json")) as f:
        out = json.load(f)
    clip = np.asarray(out["clip_scores"])
    features = np.concatenate([np.load(os.path.join(feats, f"{stem}_{s}.npy"))
                               for s in ("i3d", "flow")], axis=-1)
    if out["stream"] != "both" or features.shape != (24, 10, 2 * FEATURE_DIM) or not (
            np.isfinite(clip).all() and (clip >= 0).all() and (clip <= 1).all()):
        raise AssertionError(f"two-stream serving: stream {out['stream']}, features "
                             f"{features.shape}, scores {clip}")
    args = infer.build_parser().parse_args(argv)
    cpu_scorer, _ = infer.build_scorer(argparse.Namespace(**dict(vars(args), device="cpu")))
    err = float(np.abs(clip - infer.score_features(features, cpu_scorer)).max())
    print(f"two-stream serving: infer --checkpoint with no --stream resolved stream "
          f"{out['stream']!r}; 24 clips extracted in both streams and scored in {wall:.2f} s "
          f"(infer.main); clip scores vs the CPU's on the cached RGB || flow features: max |err| "
          f"{err:.2e}", flush=True)
    if err > 1e-5:
        raise AssertionError(f"two-stream serving: scores differ from the CPU's by {err:.2e}")


def check_flow_stream(torch, root, model, scorer):
    """Phase 11: the optical-flow stream and two-stream extraction and
    serving; returns K5's ``stem_cin2`` entry of the JSON line."""
    start = time.perf_counter()
    frames = moving_scene(384)
    print(f"phase 11: a seeded 384-frame 240x320 scene moving by {list(FLOW_SHIFT)} px per frame "
          f"made in {time.perf_counter() - start:.2f} s", flush=True)
    flow_u8 = check_flows(torch, frames)
    stem_launches = check_flow_extractor(torch, model, frames, flow_u8, scorer)
    stem_entry = check_flow_stem(torch, stem_launches)
    weights = os.path.join(root, "i3res50.pt")
    with stand_in_decode():
        check_two_stream_cli(torch, root, weights)
        check_two_stream_float32(torch, root, weights)
    check_two_stream_serving(torch, root, weights)
    print(f"flow stream phase: {time.perf_counter() - start:.1f} s", flush=True)
    return stem_entry


# ------------------------------------------------- phase 12: other backbones

def check_stem_s1(torch, rgb_launches: int, flow_launches: int):
    """Phase 12 (d): K5's int8 stem at stride (1,2,2), i3d_8x8_r50's, over 3
    channels and the flow stream's 2 (``check_k5_stem``; its float64 plain
    version timed at B = 40 only: at B = 240 its float64 output alone would
    hold 24.7 GB); a stride it does not take raises. Returns the JSON
    line's K5 ``stem_s1`` entry: the stride-1 stem's launches in one
    counted i3d_8x8_r50 int8 forward at B = 240 of each stream, and a
    record per channel count."""
    from anomaly_detection_on_video_tpu_torch.ops.kernels import int8_conv, pack_int8_conv_weight

    gen = torch.Generator(device="cuda").manual_seed(13)
    entry = {"launches_per_rgb_forward": rgb_launches, "launches_per_flow_forward": flow_launches}
    for cin in (3, 2):
        entry[f"cin{cin}"] = check_k5_stem(torch, gen, cin, 1, plain_batches=(40,))
    x = torch.zeros((1, 16, 224, 224, 3), dtype=torch.int8, device="cuda")
    w = pack_int8_conv_weight(torch.zeros((64, 3, 5, 7, 7), dtype=torch.int8, device="cuda"))
    try:
        int8_conv(x, w, torch.ones(64, device="cuda"), (5, 7, 7), (1, 1, 1), (2, 3, 3),
                  torch.bfloat16)
    except ValueError as exc:
        print(f"K5 refuses a stem at stride (1,1,1): {str(exc)[:100]}", flush=True)
    else:
        raise AssertionError("K5 took a stem at stride (1,1,1)")
    return entry


def plain_model_features(torch, model, crops32, chunk: int = 40):
    """``model``'s plain chain (no K2 or K3: ``forward_unfused`` + ``head``)
    in float32 on ``crops32``, ``chunk`` crops at a time: the reference of a
    backbone whose activations at B = 240 in float32 would crowd the card."""
    with torch.no_grad():
        return torch.cat([model.head(model.forward_unfused(crops32[i:i + chunk]))
                          for i in range(0, crops32.shape[0], chunk)])


def run_backbone(torch, name, extractor, frames, scorer, ref):
    """One backbone's path at B = 240 through ``drive_path`` (its gates;
    five timed passes, peak memory), its features against ``ref`` (cosine
    >= 0.999 for a float path; an int8 path's are held by the caller), and
    one profiled pass (busy, idle share). Returns (features, counts)."""
    from anomaly_detection_on_video_tpu_torch.infer import score_features

    features, _, counts = drive_path(torch, name, extractor, frames, scorer)
    if not extractor.quantize:
        cos = check_cosine(f"{name} features vs plain float32", torch.from_numpy(features).cuda(),
                           ref, 0.999)
        print(f"{name} features vs plain float32 forward: min row cosine {cos:.6f}", flush=True)
    run = device_breakdown(torch, lambda: score_features(extractor.extract_frames(frames), scorer))
    print(f"{name}, one profiled pass: busy {run['device_busy_ms']:.2f} ms of "
          f"{run['wall_ms']:.2f} ms wall, idle share {run['idle_share']:.1%}; {json.dumps(run)}",
          flush=True)
    return features, counts


def check_s2d_stem(torch, model, crops32):
    """Phase 12 (f): the S2D stem against the plain stem in float32 (TF32
    off) on 40 standardized crops. Gate, as the JAX package's
    ``test_s2d_stem_bit_exact`` holds its S2D stem: the model's features
    with the S2D stem equal to those with the plain stem at atol 1e-5. The
    stem outputs' largest difference (float32 sums in another order) is
    printed beside their largest value."""
    import anomaly_detection_on_video_tpu_torch.models.i3d as ti3d

    x = crops32.permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        s2d = ti3d._affine(ti3d.s2d_conv3d(x, model.conv1.weight, model.conv1.stride,
                                           model.conv1.padding), model.bn1)
        plain = ti3d.conv_bn(x, model.conv1, model.bn1)
    stem_err = (s2d - plain).abs().max().item()
    top = plain.abs().max().item()
    del s2d, plain
    got = plain_model_features(torch, model, crops32)
    model.s2d_stem = False
    try:
        ref = plain_model_features(torch, model, crops32)
    finally:
        model.s2d_stem = True
    err = check_close("S2D-stem features vs plain-stem features (float32)", got, ref, 1e-5, 0.0)
    print(f"S2D stem at B = {x.shape[0]}, float32: stem outputs max |err| {stem_err:.2e} against "
          f"the plain stem (max |value| {top:.2f}, ratio {stem_err / top:.1e}); the model's "
          f"features max |err| {err:.2e} (gate 1e-5)", flush=True)


def check_backbone_clis(torch, root: str, model, checkpoint: str) -> None:
    """Phase 12 (g, h): ``extract_features --model i3d_8x8_r50 --weights
    I3D_8x8_R50.pyth`` over the 24-clip stand-in video, the ``.pyth`` written
    from ``model`` by ``i3d_state_dict_to_pytorchvideo`` under
    ``model_state``, on the card by default; its features equal at 1e-5 to
    the extractor built from ``model``'s state dict. Then ``infer
    --i3d-model i3d_8x8_r50 --i3d-weights`` the same file with phase 8's MGFN
    checkpoint: scores finite, in [0, 1] and equal at 1e-5 to
    ``score_features`` of those features; an unknown name exits."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features, infer
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_to_pytorchvideo

    pyth = os.path.join(root, "I3D_8x8_R50.pyth")
    torch.save({"model_state": i3d_state_dict_to_pytorchvideo(model.state_dict())}, pyth)
    name = "Abuse030_x264.mp4"
    stem = os.path.splitext(name)[0]
    videos = os.path.join(root, "backbone_videos")
    os.makedirs(videos)
    open(os.path.join(videos, name), "wb").close()  # decoded by the stand-in
    out = os.path.join(root, "backbone_features")
    start = time.perf_counter()
    printed = run_cli(extract_features, ["--videos", videos, "--outdir", out, "--model",
                                         "i3d_8x8_r50", "--weights", pyth, "--no-segments",
                                         "--decode-workers", "1"])
    seconds = time.perf_counter() - start
    features = np.load(os.path.join(out, f"{stem}_i3d.npy"))
    direct = FeatureExtractor(model_name="i3d_8x8_r50", state_dict=model.state_dict(),
                              dtype=torch.bfloat16, batch=240, device="cuda")
    ref = direct.extract_video(os.path.join(videos, name))
    err = float(np.abs(features - ref).max())
    if "extracted 1 new videos" not in printed or features.shape != (24, 10, FEATURE_DIM) or err > 1e-5:
        raise AssertionError(f"extract_features --model i3d_8x8_r50: {features.shape}, max |err| "
                             f"{err:.2e} against the model's extractor; {printed}")
    print(f"extract_features --model i3d_8x8_r50 --weights {os.path.basename(pyth)}: 24 clips in "
          f"{seconds:.2f} s (the CLI: model build, stand-in decode, ten crops at B = 240); "
          f"features vs the extractor of the state dict written: max |err| {err:.2e}", flush=True)
    scores_dir = os.path.join(root, "backbone_scores")
    argv = ["--videos", videos, "--outdir", scores_dir, "--checkpoint", checkpoint,
            "--i3d-model", "i3d_8x8_r50", "--i3d-weights", pyth, "--features-dir",
            os.path.join(root, "backbone_cache")]
    start = time.perf_counter()
    infer.main(argv)
    wall = time.perf_counter() - start
    with open(os.path.join(scores_dir, f"{stem}_scores.json")) as f:
        clip = np.asarray(json.load(f)["clip_scores"])
    scorer, _ = infer.build_scorer(infer.build_parser().parse_args(argv))
    err = float(np.abs(clip - infer.score_features(ref, scorer)).max())
    if clip.shape != (24,) or not (np.isfinite(clip).all() and (clip >= 0).all()
                                   and (clip <= 1).all()) or err > 1e-5:
        raise AssertionError(f"infer --i3d-model i3d_8x8_r50: scores {clip}, max |err| {err:.2e}")
    print(f"infer --i3d-model i3d_8x8_r50 with the MGFN checkpoint: 24 clips scored in {wall:.2f} "
          f"s (infer.main), scores in [{clip.min():.6f}, {clip.max():.6f}], against "
          f"score_features of the model's features: max |err| {err:.2e}", flush=True)
    for module, flag in ((extract_features, "--model"), (infer, "--i3d-model")):
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                module.main(["--videos", videos, "--outdir", out, flag, "nope"])
        except SystemExit as exc:
            print(f"{module.__name__.rsplit('.', 1)[1]} {flag} nope: exits {exc.code}", flush=True)
        else:
            raise AssertionError(f"{module.__name__} took {flag} nope")


def check_other_backbones(torch, root, scorer, checkpoint, frames, resize_clips):
    """Phase 12: i3d_8x8_r50 (bf16 and int8, and its flow stream in int8),
    the non-local i3res50 and the S2D stem at full width on the 24-clip
    video at B = 240, K5's stem at stride (1,2,2), and both CLIs with
    i3d_8x8_r50 ``.pyth`` weights. Returns K5's ``stem_s1`` entry of the
    JSON line."""
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.models.i3d import i3res50
    from anomaly_detection_on_video_tpu_torch.ops.kernels.crop_norm import ten_crop_standardize_plain

    start = time.perf_counter()
    resized = resize_clips(frames, 24)
    crops32 = ten_crop_standardize_plain(resized, 224, torch.float32)
    # (a) i3d_8x8_r50 in bf16: K1, no K2 or K3 (the JAX rule), cuDNN
    name = "i3d_8x8_r50 bf16 path at B = 240"
    ex = FeatureExtractor(model_name="i3d_8x8_r50", dtype=torch.bfloat16, batch=240,
                          device="cuda", seed=3)
    randomize_batchnorm_(torch, ex.model, seed=4)
    ref = plain_model_features(torch, ex.model, crops32).reshape(24, 10, FEATURE_DIM)
    torch.cuda.empty_cache()
    run_backbone(torch, name, ex, frames, scorer, ref)
    model = ex.model
    del ex
    torch.cuda.empty_cache()
    # (b) the same in int8: K1, K4, K5 with the stem at stride (1,2,2)
    name = "i3d_8x8_r50 int8 path at B = 240"
    qex = FeatureExtractor(model_name="i3d_8x8_r50", state_dict=model.state_dict(),
                           dtype=torch.bfloat16, batch=240, device="cuda", quantize=True)
    features, counts = run_backbone(torch, name, qex, frames, scorer, ref)
    torch.cuda.empty_cache()
    crops16 = ten_crop_standardize_plain(resized, 224, torch.bfloat16)  # K1's output
    check_int8_features(torch, f"{name} features", qex.model, crops16, features, ref, chunk=40)
    print("every K4 and K5 call of one i3d_8x8_r50 int8 forward at B = 40:", flush=True)
    calls = check_int8_path_calls(torch, qex.model, crops16[:40])
    print("i3d_8x8_r50 int8 B=40 summary: " + ", ".join(
        f"{e['name']} {e['ms']:.3f} ms ({e['device_ms']:.3f} device; bound {e['bound_ms']:.3f}, "
        f"plain {e['plain_ms']:.3f})" for e in calls), flush=True)
    del qex, crops16, features
    torch.cuda.empty_cache()
    # (c) the flow stream of i3d_8x8_r50 in int8: K5's stem over 2 channels
    # at stride (1,2,2) on a main path (device Farneback of the same frames)
    name = "i3d_8x8_r50 flow int8 path at B = 240"
    fex = FeatureExtractor(model_name="i3d_8x8_r50", state_dict=model.state_dict(),
                           dtype=torch.bfloat16, batch=240, device="cuda", quantize=True,
                           stream="flow")
    flow_u8 = fex._host_transform()(frames).cpu().numpy()
    crops = flow_crops(torch, fex, flow_u8, torch.float32)
    flow_ref = plain_model_features(torch, fex.model, crops).reshape(24, 10, FEATURE_DIM)
    features, flow_counts = run_backbone(torch, name, fex, flow_u8, scorer, flow_ref)
    check_int8_features(torch, f"{name} features", fex.model, crops.to(torch.bfloat16), features,
                        flow_ref, chunk=40)
    del fex, crops, flow_ref, features, flow_u8
    torch.cuda.empty_cache()
    # (d) K5's stem at stride (1,2,2) alone, over both channel counts
    stem_s1 = check_stem_s1(torch, counts["int8_conv stem by stride"][1],
                            flow_counts["int8_conv stem by stride"][1])
    # (e) the non-local i3res50 in bf16: K1, K2, K3, then stages 2-4 with
    # their non-local blocks
    name = "non-local i3res50 bf16 path at B = 240"
    nl = FeatureExtractor(model=i3res50(torch.bfloat16, use_nl=True), dtype=torch.bfloat16,
                          batch=240, device="cuda", seed=5)
    randomize_batchnorm_(torch, nl.model, seed=6)
    with torch.no_grad():
        ref = plain_features(torch, nl.model, crops32).reshape(24, 10, FEATURE_DIM)
    run_backbone(torch, name, nl, frames, scorer, ref)
    del nl
    torch.cuda.empty_cache()
    # (f) the S2D stem: equal to the plain stem in float32; its bf16 path
    # takes neither K2 nor K3
    name = "S2D-stem i3res50 bf16 path at B = 240"
    s2d = FeatureExtractor(model=i3res50(torch.bfloat16, s2d_stem=True), state_dict=model.state_dict(),
                           dtype=torch.bfloat16, batch=240, device="cuda")
    check_s2d_stem(torch, s2d.model, crops32[:40])
    ref = plain_model_features(torch, s2d.model, crops32).reshape(24, 10, FEATURE_DIM)
    run_backbone(torch, name, s2d, frames, scorer, ref)
    del s2d, crops32, ref, resized
    torch.cuda.empty_cache()
    # (g, h) both CLIs with i3d_8x8_r50 from a .pyth
    with stand_in_decode():
        check_backbone_clis(torch, root, model, checkpoint)
    print(f"other backbones phase: {time.perf_counter() - start:.1f} s", flush=True)
    return stem_s1


# ---------------------------------------------------------- phase 13: serving

# phase 13's requests: stand-in videos (seeded frames, see StandInDecoder)
# of 24 clips, a longer one, and a burst of four lengths
SERVE_VIDEOS = {**{f"Serve{i:03d}_x264.mp4": 24 for i in range(8)}, "ServeLong_x264.mp4": 70,
                **{f"Burst{n:03d}_x264.mp4": n for n in (5, 11, 19, 31)}}
HTTP_TIMEOUT = 300  # seconds, for every request of phase 13
SERVE_DEVICE = "cuda"  # phase 13's --device
# the body of phase 13 (e)'s server processes
RESTART_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.serve_stand_in(sys.argv[1:]))"


def http_request(port: int, method: str, path: str, body: bytes = None):
    """(status, parsed JSON answer, seconds) of one request to 127.0.0.1."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=HTTP_TIMEOUT)
    try:
        start = time.perf_counter()
        conn.request(method, path, body=body)
        response = conn.getresponse()
        answer = json.loads(response.read())
        return response.status, answer, time.perf_counter() - start
    finally:
        conn.close()


def post_video(port: int, name: str):
    return http_request(port, "POST", f"/score?name={name}", b"stand-in video bytes")


@contextlib.contextmanager
def serving(argv):
    """``infer.main(argv + --serve 0)`` on a thread of this process; yields
    the bound port, and shuts the server down on the way out."""
    import threading

    from anomaly_detection_on_video_tpu_torch import infer

    ready, state = threading.Event(), {}

    def run():
        try:
            infer.main(argv + ["--serve", "0"], on_ready=lambda server: (
                state.update(server=server), ready.set()))
        except BaseException as exc:  # reported below
            state["error"] = exc
            ready.set()

    thread = threading.Thread(target=run, name="phase13-server", daemon=True)
    thread.start()
    try:
        if not ready.wait(600) or "error" in state:
            raise AssertionError(f"the server did not start: {state.get('error')!r}")
        yield state["server"].server_port
    finally:
        if "server" in state:
            state["server"].shutdown()
        thread.join(60)
        if thread.is_alive():
            raise AssertionError("the server thread did not end after shutdown")


def score_error(got, want) -> float:
    import numpy as np

    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) if len(got) == len(
        want) else float("inf")


def check_served(name: str, answer: dict, want: dict) -> float:
    """A served score JSON against the one-shot CLI's of the same video:
    same clip count, clip scores within 1e-5; returns the max |diff|."""
    err = score_error(answer["clip_scores"], want["clip_scores"])
    if answer["n_clips"] != want["n_clips"] or not err <= 1e-5:
        raise AssertionError(f"{name}: served {answer['n_clips']} clips, max |diff| {err:.2e} "
                             f"against the one-shot CLI's {want['n_clips']}")
    return err


def check_http_serving(torch, root: str, argv: list, one_shot: dict) -> None:
    """Phase 13 (a): the bf16 ten-crop server in this process: 8 requests
    of 24 clips (latency p50 and max, clips/s; K1-K3 launched by one of
    them), a repeat POST, /healthz during a 70-clip request, a burst of 4
    concurrent POSTs; every reply's clip scores within 1e-5 of the one-shot
    CLI's."""
    import threading

    import numpy as np

    from anomaly_detection_on_video_tpu_torch.ops import kernels

    names = [n for n in SERVE_VIDEOS if n.startswith("Serve0")]
    outdir = os.path.join(root, "served")
    start = time.perf_counter()
    with serving(argv + ["--outdir", outdir, "--warmup", "24"]) as port:
        print(f"serve: up in {time.perf_counter() - start:.2f} s (scorer, extractor, --warmup 24)",
              flush=True)
        latencies, errors = [], []
        for i, name in enumerate(names):
            if i == 1:
                kernels.reset_launch_counts()
            status, answer, seconds = post_video(port, name)
            if i == 1:
                counts = kernels.launch_counts()
                launches = (counts["ten_crop_standardize"], counts["stem_conv_pool"],
                            counts["bottleneck_block"])
                print(f"serve: one request launched K1 / K2 / K3 = {launches[0]} / "
                      f"{launches[1]} / {launches[2]}; all counts {counts}", flush=True)
                if launches[0] < 1 or launches[1] < 1 or launches[2] < 3:
                    raise AssertionError(f"a served request did not run K1-K3: {counts}")
            if status != 200:
                raise AssertionError(f"POST {name}: {status} {answer}")
            errors.append(check_served(name, answer, one_shot[name]))
            latencies.append(seconds)
        clips = sum(SERVE_VIDEOS[n] for n in names)
        print(f"serve: {len(names)} sequential requests of 24 clips (bf16, ten crops): latency "
              f"p50 {np.median(latencies) * 1e3:.1f} ms, max {max(latencies) * 1e3:.1f} ms "
              f"(first {latencies[0] * 1e3:.1f}), {clips / sum(latencies):.2f} clips/s; clip "
              f"scores vs the one-shot CLI max |diff| {max(errors):.2e}", flush=True)

        status, again, _ = post_video(port, names[0])
        stats = http_request(port, "GET", "/stats")[1]
        with open(os.path.join(outdir, f"{os.path.splitext(names[0])[0]}_scores.json")) as f:
            if status != 200 or again != json.load(f) or stats["videos_scored"] != len(names):
                raise AssertionError(f"a repeat POST: {status}, stats {stats}")
        print(f"serve: a repeat POST answered from its JSON; /stats videos_scored "
              f"{stats['videos_scored']}, errors {stats['errors']}", flush=True)

        # /healthz while a 70-clip request scores
        long_name, done = "ServeLong_x264.mp4", threading.Event()
        result = {}

        def post_long():
            result["answer"] = post_video(port, long_name)
            done.set()

        thread = threading.Thread(target=post_long, daemon=True)
        thread.start()
        health = []
        while not done.is_set():
            status, answer, seconds = http_request(port, "GET", "/healthz")
            if status != 200 or answer["device"] != SERVE_DEVICE:
                raise AssertionError(f"/healthz: {status} {answer}")
            if answer["scoring"]:
                health.append(seconds)
            time.sleep(0.02)
        thread.join(HTTP_TIMEOUT)
        check_served(long_name, result["answer"][1], one_shot[long_name])
        if not health or max(health) > 1.0:
            raise AssertionError(f"/healthz during a request: {health}")
        print(f"serve: /healthz answered {len(health)} times while the 70-clip request scored "
              f"({result['answer'][2] * 1e3:.1f} ms), max {max(health) * 1e3:.1f} ms", flush=True)

        burst = [n for n in SERVE_VIDEOS if n.startswith("Burst")]
        replies = {}

        def post(name):
            replies[name] = post_video(port, name)

        threads = [threading.Thread(target=post, args=(n,), daemon=True) for n in burst]
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(HTTP_TIMEOUT)
        wall = time.perf_counter() - start
        for name in burst:
            status, answer, _ = replies[name]
            if status != 200 or answer["n_clips"] != SERVE_VIDEOS[name]:
                raise AssertionError(f"burst {name}: {status} {answer}")
            check_served(name, answer, one_shot[name])
        stats = http_request(port, "GET", "/stats")[1]
        if stats["errors"] != 0:
            raise AssertionError(f"burst: /stats {stats}")
        clips = sum(SERVE_VIDEOS[n] for n in burst)
        print(f"serve: a burst of {len(burst)} concurrent POSTs ({clips} clips: "
              f"{[SERVE_VIDEOS[n] for n in burst]}) answered in {wall * 1e3:.1f} ms, "
              f"{clips / wall:.2f} clips/s, each its own n_clips, /stats errors 0", flush=True)


def check_int8_serving(torch, root: str, argv: list) -> None:
    """Phase 13 (b): one request through a ``--dtype int8`` server: K4 >=
    27 and K5 >= 26 launches, scores in [0, 1]."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.ops import kernels

    with serving(argv + ["--outdir", os.path.join(root, "served_int8"), "--dtype", "int8"]) as port:
        kernels.reset_launch_counts()
        status, answer, seconds = post_video(port, "Serve000_x264.mp4")
        counts = kernels.launch_counts()
    clip = np.asarray(answer.get("clip_scores", []))
    if status != 200 or counts["int8_matmul"] < 27 or counts["int8_conv"] < 26 or not (
            clip.size == 24 and np.isfinite(clip).all() and (clip >= 0).all()
            and (clip <= 1).all()):
        raise AssertionError(f"int8 serving: {status}, launches {counts}, scores {clip}")
    print(f"serve int8: one 24-clip request (calibrating) in {seconds * 1e3:.1f} ms, launches "
          f"K4 {counts['int8_matmul']}, K5 {counts['int8_conv']}, K1 "
          f"{counts['ten_crop_standardize']}; scores in [0, 1]", flush=True)


def check_watch(torch, root: str, argv: list, one_shot: dict) -> None:
    """Phase 13 (c): ``infer --watch`` over two videos, a third dropped in."""
    import threading

    from anomaly_detection_on_video_tpu_torch import infer

    names = [f"Serve00{i}_x264.mp4" for i in range(3)]
    watched, outdir = os.path.join(root, "watched"), os.path.join(root, "watch_scores")
    os.makedirs(watched)
    for name in names[:2]:
        open(os.path.join(watched, name), "wb").close()
    drop = threading.Timer(1.0, lambda: open(os.path.join(watched, names[2]), "wb").close())
    drop.start()
    start = time.perf_counter()
    try:
        infer.main(argv + ["--videos", watched, "--outdir", outdir, "--watch",
                           "--poll-interval", "0.2", "--idle-exit", "3"])
    finally:
        drop.cancel()
    wall = time.perf_counter() - start
    errors = []
    for name in names:
        with open(os.path.join(outdir, f"{os.path.splitext(name)[0]}_scores.json")) as f:
            errors.append(check_served(name, json.load(f), one_shot[name]))
    with open(os.path.join(outdir, "_serving_stats.json")) as f:
        stats = json.load(f)
    if (stats["videos_scored"], stats["errors"], stats["watching"]) != (3, 0, 3):
        raise AssertionError(f"watch: _serving_stats.json {stats}")
    print(f"watch: 2 videos, a third dropped in after 1 s, --poll-interval 0.2 --idle-exit 3: "
          f"3 scored, 0 errors, {wall:.2f} s; clip scores vs the one-shot CLI max |diff| "
          f"{max(errors):.2e}", flush=True)


def check_export(torch, root: str, checkpoint: str, features: dict, one_shot: dict) -> None:
    """Phase 13 (d): ``--export`` on the card and on the CPU; each
    artifact scored on the card against the live scorer (gate 1e-5); the
    exported and live scoring calls timed in turns; the CPU's artifact
    served by ``infer --from-export`` on the card."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.utils.aot import ExportedScorer

    live, _ = infer.build_scorer(infer.build_parser().parse_args(
        ["--outdir", root, "--checkpoint", checkpoint, "--device", SERVE_DEVICE]))
    exports = {}
    for device in (SERVE_DEVICE, "cpu"):
        exports[device] = os.path.join(root, f"export_{device}")
        start = time.perf_counter()
        printed = run_cli(infer, ["--outdir", root, "--checkpoint", checkpoint, "--export",
                                  exports[device], "--export-max-clips", "32", "--device", device])
        print(f"export on {device}: {time.perf_counter() - start:.2f} s for 1 bucket (32)",
              flush=True)
        if f"exported mgfn scorer for buckets [32] (10 crops, {FEATURE_DIM}-d" not in printed:
            raise AssertionError(f"--export on {device}: {printed}")
    for device, directory in exports.items():
        exported = ExportedScorer(directory, SERVE_DEVICE)
        for name, feats in features.items():
            got, want = exported.score(feats), infer.score_features(feats, live)
            err = score_error(got, want)
            print(f"exported on {device}, scored on the card, {name}: max |diff| from the live "
                  f"scorer {err:.2e} ({'bit-equal' if np.array_equal(got, want) else 'not bit-equal'})",
                  flush=True)
            if not err <= 1e-5:
                raise AssertionError(f"exported ({device}) vs live scores: {err:.2e}")
    request = features["the 4-clip request"]
    times = {"exported": [], "live": []}
    exported = ExportedScorer(exports[SERVE_DEVICE], SERVE_DEVICE)
    runs = (("exported", lambda: exported.score(request)),
            ("live", lambda: infer.score_features(request, live)))
    for i in range(20):
        for label, run in runs[::1 if i % 2 else -1]:
            t0 = time.perf_counter()
            run()  # ends in a copy to the host
            times[label].append((time.perf_counter() - t0) * 1e3)
    print("scoring the 4-clip request, 20 calls in turns: " + "; ".join(
        f"{k} median {np.median(v):.3f} ms ({min(v):.3f}-{max(v):.3f})" for k, v in times.items()),
        flush=True)
    # the CLI path: one-shot --from-export of the CPU's artifact on the card
    outdir = os.path.join(root, "from_export")
    names = [n for n in one_shot if n.startswith("Serve0")][:2]
    request_dir = os.path.join(root, "from_export_videos")
    os.makedirs(request_dir)
    for name in names:
        open(os.path.join(request_dir, name), "wb").close()
    run_cli(infer, ["--videos", request_dir, "--from-export", exports["cpu"], "--outdir", outdir,
                    "--features-dir", os.path.join(root, "one_shot_features"), "--device",
                    SERVE_DEVICE])
    for name in names:
        with open(os.path.join(outdir, f"{os.path.splitext(name)[0]}_scores.json")) as f:
            err = check_served(name, json.load(f), one_shot[name])
    print(f"infer --from-export (the CPU's artifact) on the card: {len(names)} videos, clip scores "
          f"vs the live one-shot CLI max |diff| {err:.2e}", flush=True)


def serve_stand_in(argv) -> int:
    """``infer.main(argv)`` with phase 13's stand-in decode: the body of
    the restart-cost subprocesses."""
    from anomaly_detection_on_video_tpu_torch import infer

    print("restart child: torch and the port imported", flush=True)
    STAND_IN_VIDEOS.update(SERVE_VIDEOS)
    with stand_in_decode():
        return infer.main(argv)


def time_restart(root: str, argv: list, cache: str, tag: str, label: str) -> None:
    """Phase 13 (e): launch ``infer --serve 0 --warmup 24 --compile-cache
    cache`` as a process; time launch to ``serving on`` and to the first
    reply; then SIGTERM: exit code 0 and ``shutting down`` in its log."""
    import re
    import signal
    import threading

    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-c", RESTART_CHILD] + argv + [
        "--outdir", os.path.join(root, f"restart_{tag}"), "--serve", "0", "--warmup", "24",
        "--compile-cache", cache]
    lines, arrived, ready = [], {}, threading.Event()
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, bufsize=1, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    try:
        def read():
            for line in proc.stdout:
                lines.append(line)
                for mark in ("restart child", "warmup done", "serving on"):
                    if line.startswith(mark):
                        arrived.setdefault(mark, time.perf_counter() - start)
                if line.startswith("serving on "):
                    ready.set()
            ready.set()

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        if not ready.wait(600) or proc.poll() is not None:
            raise AssertionError(f"restart ({label}): no server: {''.join(lines)[-4000:]}")
        up = time.perf_counter() - start
        port = int(re.search(r"serving on .*:(\d+)", "".join(lines)).group(1))
        status, answer, _ = post_video(port, "Serve000_x264.mp4")
        first = time.perf_counter() - start
        if status != 200 or answer["n_clips"] != 24:
            raise AssertionError(f"restart ({label}): first reply {status} {answer}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(120)
        reader.join(30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    log = "".join(lines)
    if code != 0 or "shutting down" not in log:
        raise AssertionError(f"restart ({label}): exit code {code}, log {log[-4000:]}")
    warmup = re.search(r"warmup done in ([0-9.]+)s", log)
    print(f"restart, {label} --compile-cache: launch to 'serving on' {up:.2f} s, to the first "
          f"reply (24 clips) {first:.2f} s; SIGTERM: exit code 0, 'shutting down' logged; "
          f"launch to torch and the port imported {arrived.get('restart child', float('nan')):.2f}"
          f" s, to 'warmup done' {arrived.get('warmup done', float('nan')):.2f} s (the warm-up, "
          f"kernel build included, {warmup.group(1) if warmup else '?'} s)", flush=True)


def check_serving_on_card(torch, root: str, checkpoint: str, weights: str, request) -> None:
    """Phase 13: serving on the card through ``infer``'s serving surface,
    on phase 8's MGFN checkpoint and stand-in videos (bf16, ten crops):
    (a)-(c) with the one-shot CLI's scores as the reference, (d) the
    exported scorer, (e) restart costs."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer

    start = time.perf_counter()
    STAND_IN_VIDEOS.update(SERVE_VIDEOS)
    argv = ["--checkpoint", checkpoint, "--i3d-weights", weights, "--device", SERVE_DEVICE]
    try:
        with stand_in_decode():
            # the reference: the one-shot CLI over every phase-13 video
            videos, cached = os.path.join(root, "one_shot_videos"), os.path.join(
                root, "one_shot_features")
            os.makedirs(videos)
            for name in SERVE_VIDEOS:
                open(os.path.join(videos, name), "wb").close()
            t0 = time.perf_counter()
            run_cli(infer, argv + ["--videos", videos, "--outdir", os.path.join(root, "one_shot"),
                                   "--features-dir", cached])
            print(f"one-shot infer over the {len(SERVE_VIDEOS)} phase-13 videos: "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            one_shot = {}
            for name in SERVE_VIDEOS:
                with open(os.path.join(root, "one_shot",
                                       f"{os.path.splitext(name)[0]}_scores.json")) as f:
                    one_shot[name] = json.load(f)
            check_http_serving(torch, root, argv, one_shot)
            torch.cuda.empty_cache()
            check_int8_serving(torch, root, argv)
            torch.cuda.empty_cache()
            check_watch(torch, root, argv, one_shot)
        features = {"the 4-clip request": request, "a 24-clip video": np.load(
            os.path.join(cached, "Serve000_x264_i3d.npy"))}
        check_export(torch, root, checkpoint, features, one_shot)
    finally:
        for name in SERVE_VIDEOS:
            STAND_IN_VIDEOS.pop(name, None)
            StandInDecoder.chunks.pop(name, None)
    torch.cuda.empty_cache()
    cache = os.path.join(root, "kernel_cache")
    time_restart(root, argv, cache, "cold", "cold (an empty directory: nvcc builds)")
    time_restart(root, argv, cache, "warm", "warm (the directory holds the build)")
    print(f"serving phase (13): {time.perf_counter() - start:.1f} s", flush=True)


# ------------------------------------------------------ phase 15: scale-out

# phase 15 (a)'s processes: extract_features.main with the stand-in decode
MULTIHOST_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.extract_stand_in(sys.argv[1]))"


def extract_stand_in(spec: str) -> int:
    """Phase 15 (a)'s process body: ``extract_features.main`` under the
    stand-in decode for each argv of the JSON list in ``spec``, each run's
    kernel launches and seconds printed."""
    from anomaly_detection_on_video_tpu_torch import extract_features
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    print("multihost child: torch and the port imported", flush=True)
    with open(spec) as f:
        runs = json.load(f)
    for argv in runs:
        kernels.reset_launch_counts()
        start = time.perf_counter()
        with stand_in_decode():
            code = extract_features.main(argv)
        print(f"child run {argv[argv.index('--dtype') + 1]}: {time.perf_counter() - start:.2f} s, "
              f"launches {json.dumps(kernels.launch_counts())}", flush=True)
        if code:
            return code
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_multihost_extraction(torch, root: str, weights: str) -> None:
    """Phase 15 (a): two processes of ``extract_features --multihost`` on
    the card against one process, bf16 and int8."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features

    videos = os.path.join(root, "stand_in_videos")
    os.makedirs(videos, exist_ok=True)
    for name in ("Abuse030_x264.mp4", "Arson011_x264.mp4", "Normal_Videos_015_x264.mp4"):
        open(os.path.join(videos, name), "wb").close()  # decoded by the stand-in

    def argv(dtype, out):
        return ["--videos", videos, "--outdir", out, "--split", "train", "--weights", weights,
                "--dtype", dtype, "--batch", "120", "--decode-workers", "1", "--device", "cuda"]

    dtypes = ("bfloat16", "int8")
    single = {}
    for dtype in dtypes:
        single[dtype] = os.path.join(root, f"p15_single_{dtype}")
        start = time.perf_counter()
        with stand_in_decode():
            run_cli(extract_features, argv(dtype, single[dtype]))
        torch.cuda.synchronize()
        single[dtype + "_s"] = time.perf_counter() - start
    torch.cuda.empty_cache()
    ports = {dtype: free_port() for dtype in dtypes}
    procs, logs = [], []
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    for pid in range(2):
        spec = os.path.join(root, f"p15_spec{pid}.json")
        with open(spec, "w") as f:
            json.dump([argv(dtype, os.path.join(root, f"p15_multi_{dtype}")) + [
                "--multihost", "--coordinator", f"127.0.0.1:{ports[dtype]}", "--num-processes",
                "2", "--process-id", str(pid)] for dtype in dtypes], f)
        logs.append(open(os.path.join(root, f"p15_child{pid}.log"), "w+"))
        procs.append(subprocess.Popen([sys.executable, "-c", MULTIHOST_CHILD, spec], cwd=here,
                                      stdout=logs[-1], stderr=subprocess.STDOUT,
                                      env=dict(os.environ, PYTHONUNBUFFERED="1")))
    try:
        codes = [proc.wait(600) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    wall = time.perf_counter() - start
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    if codes != [0, 0]:
        raise AssertionError(f"multihost extraction: exit codes {codes}: {texts[0][-3000:]} "
                             f"{texts[1][-3000:]}")
    for pid, text in enumerate(texts):
        runs = [line for line in text.splitlines() if line.startswith(("child run", "[process"))]
        print(f"phase 15 (a) process {pid}: " + " | ".join(runs), flush=True)
        if text.count(f"[process {pid}/2] extracted") != 2:
            raise AssertionError(f"multihost extraction process {pid}: {text[-3000:]}")
    if texts[0].count("segmented 3 feature files") != 2 or "segmented" in texts[1]:
        raise AssertionError("multihost extraction: segments not written by process 0 alone")
    for dtype in dtypes:
        multi = os.path.join(root, f"p15_multi_{dtype}", "train")
        ref = os.path.join(single[dtype], "train")
        names = sorted(n for n in os.listdir(ref) if n.endswith("_i3d.npy"))
        if len(names) != 3:
            raise AssertionError(f"multihost extraction {dtype}: reference files {names}")
        for name in names:
            if not np.array_equal(np.load(os.path.join(multi, name)),
                                  np.load(os.path.join(ref, name))):
                raise AssertionError(f"multihost extraction {dtype}: {name} differs from one "
                                     "process's")
        if dtype == "int8":
            scales = os.path.join(multi, "act_scales_rgb.json")
            with open(scales) as f, open(os.path.join(ref, "act_scales_rgb.json")) as g:
                if json.load(f) != json.load(g):
                    raise AssertionError("multihost int8 scales differ from one process's")
            if os.path.getmtime(scales) > min(os.path.getmtime(os.path.join(multi, n))
                                              for n in names):
                raise AssertionError("multihost int8 scales were written after a feature file")
    clips = sum(STAND_IN_VIDEOS[n] for n in ("Abuse030_x264.mp4", "Arson011_x264.mp4",
                                              "Normal_Videos_015_x264.mp4"))
    print(f"phase 15 (a): extract_features --multihost, 2 processes on one card, {clips} clips of "
          f"3 stand-in videos, bf16 then int8: every feature file bit-equal to one process, int8 "
          f"scales pinned by process 0 before any feature file and equal to one process's, "
          f"segments by process 0 alone; wall from launch to both exits {wall:.2f} s (each "
          f"process imports torch and loads the weights); one process in this one, bf16 "
          f"{single['bfloat16_s']:.2f} s, int8 {single['int8_s']:.2f} s", flush=True)


def check_split_extractor(torch, model) -> None:
    """Phase 15 (b): ``FeatureExtractor(devices=["cuda:0", "cuda:0"])``
    against one device on a 48-clip video at B = 240 per shard."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    frames = np.random.RandomState(15).randint(0, 256, (48 * 16, 240, 320, 3), dtype=np.uint8)
    state_dict = model.state_dict()
    for quantize in (False, True):
        label = "int8" if quantize else "bf16"
        one = FeatureExtractor(state_dict=state_dict, dtype=torch.bfloat16, batch=240,
                               device="cuda", quantize=quantize)
        two = FeatureExtractor(state_dict=state_dict, dtype=torch.bfloat16, batch=240,
                               devices=["cuda:0", "cuda:0"], quantize=quantize)
        want = one.extract_frames(frames)  # int8: calibrates on the first clips
        kernels.reset_launch_counts()
        got = two.extract_frames(frames)  # int8: the leader calibrates on the same clips
        counts = kernels.launch_counts()
        if quantize and not (two.model.act_scales == two._models[1].act_scales
                             == one.model.act_scales):
            raise AssertionError("split extractor: the replica's int8 scales differ")
        if two.group_clips != 48 or got.shape != (48, 10, FEATURE_DIM) or not np.array_equal(
                got, want):
            raise AssertionError(f"split extractor {label}: group {two.group_clips}, shape "
                                 f"{got.shape}, max |diff| {float(np.abs(got - want).max())}")
        times = {}
        for name, extractor in (("one device", one), ("split", two)):
            runs = []
            for _ in range(3):
                torch.cuda.synchronize()
                start = time.perf_counter()
                extractor.extract_frames(frames)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - start)
            times[name] = sorted(runs)[1]
        print(f"phase 15 (b) {label}: FeatureExtractor(devices=['cuda:0', 'cuda:0']) on 48 clips "
              f"(one group of 48, two shards of B = 240) bit-equal to one device (two groups of "
              f"24); launches of the split pass {json.dumps(counts)}; median of 3: one device "
              f"{times['one device'] * 1e3:.1f} ms, split {times['split'] * 1e3:.1f} ms "
              f"({48 / times['one device']:.1f} and {48 / times['split']:.1f} clips/s)",
              flush=True)
        del one, two
        torch.cuda.empty_cache()


def check_multihost_run(torch, root: str):
    """Phase 15 (c): ``run trainer.multihost=true``, world size 1 over
    nccl, against the plain run. Returns the plain 32-true run's losses."""
    import numpy as np
    import torch.distributed as dist

    calls = {"all_reduce": 0, "all_gather": 0}
    real = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return call

    plain_losses = {}
    for precision in ("bf16-mixed", "32-true"):
        losses = {}
        for mode in ("plain", "multihost"):
            overrides = dict(training_overrides(root, "mgfn", f"p15_{mode}_{precision}"),
                             **{"trainer.max_steps": 3, "trainer.max_epochs": 2,
                                "trainer.eval_every": 2, "trainer.precision": precision,
                                "trainer.checkpoint.dirpath": None,
                                "trainer.data_parallel": mode == "multihost"})
            if mode == "multihost":
                overrides.update({"trainer.multihost": True,
                                  "trainer.coordinator": f"127.0.0.1:{free_port()}",
                                  "trainer.num_processes": 1, "trainer.process_id": 0})
            saved = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            for name in calls:
                setattr(dist, name, counted(name))
            before = dict(calls)
            try:
                run_training(overrides)
            finally:
                torch.backends.cudnn.deterministic = saved
                for name in calls:
                    setattr(dist, name, real[name])
            with open(overrides["trainer.log_path"]) as f:
                losses[mode] = [r["train_loss"] for r in map(json.loads, f) if "train_loss" in r]
            made = {name: calls[name] - before[name] for name in calls}
            if mode == "multihost" and (min(made.values()) == 0 or dist.is_initialized()):
                raise AssertionError(f"multihost run: collectives {made}, group still up: "
                                     f"{dist.is_initialized()}")
            if mode == "plain" and any(made.values()):
                raise AssertionError(f"plain run: collectives {made}")
            if mode == "multihost":
                print(f"phase 15 (c) {precision}: the multihost run (world size 1, nccl) made "
                      f"{made['all_reduce']} all_reduce and {made['all_gather']} all_gather "
                      "calls", flush=True)
        plain, multi = (np.asarray(losses[m]) for m in ("plain", "multihost"))
        gap = float(np.max(np.abs(multi - plain) / np.abs(plain)))
        if len(plain) != 3 or len(multi) != 3 or (
                gap != 0.0 if precision == "bf16-mixed" else gap > 1e-6):
            raise AssertionError(f"multihost run {precision}: losses {multi.tolist()} against the "
                                 f"plain run's {plain.tolist()}")
        print(f"phase 15 (c) {precision}: 3 steps of full-width MGFN, multihost losses "
              f"{multi.tolist()}, plain {plain.tolist()}, max relative gap {gap:.3e}", flush=True)
        plain_losses[precision] = plain
    return plain_losses["32-true"]


def check_multi_card(torch, root: str, plain) -> None:
    """Phase 15 (d): the card count; with several, ``run`` with
    ``data_parallel`` over all of them against the one-card run."""
    import numpy as np

    n = torch.cuda.device_count()
    print(f"phase 15 (d): torch.cuda.device_count() = {n}", flush=True)
    if n < 2:
        print("phase 15 (d): multi-card NCCL was not run (one card visible)", flush=True)
        return
    overrides = dict(training_overrides(root, "mgfn", "p15_cards"),
                     **{"trainer.max_steps": 3, "trainer.max_epochs": 3, "trainer.eval_every": 3,
                        "trainer.checkpoint.dirpath": None, "trainer.data_parallel": True,
                        "data.batch_size": n})  # two bags a rank of the 6 + 6
    run_training(overrides)
    with open(overrides["trainer.log_path"]) as f:
        losses = [r["train_loss"] for r in map(json.loads, f) if "train_loss" in r]
    if len(losses) != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"data_parallel over {n} cards: losses {losses}")
    print(f"phase 15 (d): data_parallel over {n} cards (one rank each, nccl), batch {n} + {n}: "
          f"losses {losses}; one card at batch 3 + 3: {plain.tolist()}", flush=True)


def check_scale_out(torch, root: str, model, weights: str) -> None:
    """Phase 15: (a) multi-process extraction, (b) the clip-axis split,
    (c) the multihost run, (d) the card count."""
    start = time.perf_counter()
    torch.cuda.empty_cache()
    check_multihost_extraction(torch, root, weights)
    torch.cuda.empty_cache()
    check_split_extractor(torch, model)
    plain = check_multihost_run(torch, root)
    check_multi_card(torch, root, plain)
    print(f"scale-out phase (15): {time.perf_counter() - start:.1f} s", flush=True)


# ------------------------------------------- phase 14: training and weights

def timed(iterator, totals: dict, key: str):
    """``iterator``'s items, the seconds spent in its ``next`` added to
    ``totals[key]``; closing this closes ``iterator``."""
    try:
        while True:
            start = time.perf_counter()
            try:
                item = next(iterator)
            except StopIteration:
                return
            finally:
                totals[key] += time.perf_counter() - start
            yield item
    finally:
        iterator.close()


@contextlib.contextmanager
def loader_timers(totals: dict):
    """Inside the block, the runner's step assembly (``_step_batches``, on
    whichever thread runs it) adds its seconds to ``totals["assembly"]`` and
    the loop's wait on its prefetch queue to ``totals["wait"]``."""
    from anomaly_detection_on_video_tpu_torch.training import runner

    saved = runner._step_batches, runner.prefetch
    runner._step_batches = lambda *a: timed(saved[0](*a), totals, "assembly")
    runner.prefetch = lambda it, depth: timed(saved[1](it, depth), totals, "wait")
    try:
        yield
    finally:
        runner._step_batches, runner.prefetch = saved


def counted_cli_run(torch, module, argv: list, out: str):
    """One CLI run on the card with launch counts reset just before it and
    read just after. Returns (counts, seconds)."""
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        run_cli(module, argv + ["--outdir", out, "--device", "cuda"])
    torch.cuda.synchronize()
    return kernels.launch_counts(), time.perf_counter() - start


def check_msgpack_weights(torch, root: str, weights: str, checkpoint: str) -> None:
    """Phase 14 (a): phase 10's i3res50 weights written as flax variables
    (``i3d_state_dict_to_flax`` + ``save_variables``), then ``extract_features
    --weights`` and ``infer --i3d-weights --checkpoint`` (phase 8's MGFN) on
    the 24-clip stand-in video, in bf16 and int8, once on the ``.msgpack``
    file and once on the ``.pt`` file. Gates: features and scores bit-equal
    between the two files; the ``.msgpack`` runs launch K1-K3 (bf16) or K1,
    K4 and K5 (int8). Prints the load times of both files."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features, infer
    from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_to_flax
    from anomaly_detection_on_video_tpu_torch.utils.serialization import (
        load_variables,
        save_variables,
    )

    start = time.perf_counter()
    msgpack = os.path.join(root, "i3res50.msgpack")
    save_variables(msgpack, i3d_state_dict_to_flax(infer.load_state_dict(weights)))
    loads = {}
    for label, load in (("load_variables(.msgpack)", lambda: load_variables(msgpack)),
                        ("torch.load(.pt)", lambda: infer.load_state_dict(weights)),
                        ("load_i3d_weights(.msgpack)", lambda: infer.load_i3d_weights(
                            msgpack, "tushar-n-baseline")),
                        ("load_i3d_weights(.pt)", lambda: infer.load_i3d_weights(
                            weights, "tushar-n-baseline"))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            load()
            times.append(time.perf_counter() - t0)
        loads[label] = min(times) * 1e3
    a, b = (infer.load_i3d_weights(path, "tushar-n-baseline") for path in (msgpack, weights))
    if list(a) != list(b) or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError(".msgpack and .pt weights give different state dicts")
    print(f"phase 14 (a): {os.path.getsize(msgpack) / 1e6:.1f} MB .msgpack "
          f"({os.path.getsize(weights) / 1e6:.1f} MB .pt), state dicts equal; load ms, best of "
          f"3: " + ", ".join(f"{k} {v:.1f}" for k, v in loads.items()), flush=True)
    name = "Abuse030_x264.mp4"
    stem = os.path.splitext(name)[0]
    videos = os.path.join(root, "msgpack_videos")
    os.makedirs(videos)
    open(os.path.join(videos, name), "wb").close()  # decoded by the stand-in
    want = {"bfloat16": {"ten_crop_standardize": 1, "stem_conv_pool": 1, "bottleneck_block": 3},
            "int8": {"ten_crop_standardize": 1, "int8_matmul": 27, "int8_conv": 26}}
    with stand_in_decode():
        for dtype in ("bfloat16", "int8"):
            got = {}
            for kind, path in (("pt", weights), ("msgpack", msgpack)):
                out = os.path.join(root, f"weights_{dtype}_{kind}")
                counts, seconds = counted_cli_run(torch, extract_features, [
                    "--videos", videos, "--weights", path, "--dtype", dtype, "--no-segments",
                    "--decode-workers", "1"], out)
                features = np.load(os.path.join(out, f"{stem}_i3d.npy"))
                s_counts, s_seconds = counted_cli_run(torch, infer, [
                    "--videos", videos, "--checkpoint", checkpoint, "--i3d-weights", path,
                    "--dtype", dtype], out + "_scores")
                with open(os.path.join(out + "_scores", f"{stem}_scores.json")) as f:
                    scores = json.load(f)
                got[kind] = (features, scores, counts, s_counts, seconds, s_seconds)
            (f_pt, s_pt, *_), (f_mp, s_mp, counts, s_counts, seconds, s_seconds) = (
                got["pt"], got["msgpack"])
            short = {k: v for k, v in counts.items() if v}
            if (f_mp.shape != (STAND_IN_VIDEOS[name], 10, FEATURE_DIM)
                    or not np.array_equal(f_mp, f_pt)
                    or s_mp["clip_scores"] != s_pt["clip_scores"]
                    or s_mp["frame_scores"] != s_pt["frame_scores"]
                    or any(c[k] < n for c in (counts, s_counts) for k, n in want[dtype].items())):
                raise AssertionError(
                    f"{dtype} on .msgpack weights: features {f_mp.shape}, max |difference| from "
                    f"the .pt run {float(np.abs(f_mp - f_pt).max()):.3e}, scores equal "
                    f"{s_mp['clip_scores'] == s_pt['clip_scores']}; launches {counts} / {s_counts}")
            print(f"{dtype}: extract_features --weights .msgpack {seconds:.2f} s (the .pt run "
                  f"{got['pt'][4]:.2f} s), launches {short}; infer --i3d-weights .msgpack "
                  f"{s_seconds:.2f} s ({got['pt'][5]:.2f} s); features and scores bit-equal to "
                  f"the .pt runs' ({f_mp.shape[0]} clips, scores in "
                  f"[{min(s_mp['clip_scores']):.6f}, {max(s_mp['clip_scores']):.6f}])", flush=True)
    print(f"phase 14 (a): {time.perf_counter() - start:.1f} s", flush=True)


class ListLogger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append(dict(metrics, step=step))

    def losses(self):
        return [r["train_loss"] for r in self.records if "train_loss" in r]


def seeded_bags(n: int, seed: int):
    """``n`` normal and ``n`` abnormal seeded (10, 32, 2048) bags in memory
    (2049 channels with the magnitude), as the train datasets of ``fit``."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.data.features import FeatureDataset

    rng = np.random.RandomState(seed)
    out = {}
    for split, stem, shift in (("normal", "Normal_Videos_{:03d}_x264", 0.0),
                               ("abnormal", "Abuse{:03d}_x264", 0.5)):
        names = [stem.format(i) + "_i3d.npy" for i in range(n)]
        out[split] = FeatureDataset(filenames=names, _arrays={
            name: (np.abs(rng.randn(10, 32, FEATURE_DIM)) + shift * (rng.rand(1, 32, 1) > 0.7)
                   ).astype(np.float32) for name in names})
    return out


def seeded_test_set(n: int, seed: int, low: int = 32, high: int = 1024):
    """``n`` seeded test videos of ``low``-``high`` clips (log-uniform, as
    surveillance test sets run from seconds to tens of minutes) with frame
    labels; each video's features are a view into one seeded pool."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.data.features import FeatureDataset

    rng = np.random.RandomState(seed)
    pool = np.abs(rng.randn(2 * high, 10, FEATURE_DIM)).astype(np.float32)
    arrays, labels = {}, {}
    for i in range(n):
        stem = f"Normal_Videos_{i:03d}_x264" if i % 2 == 0 else f"Abuse{i:03d}_x264"
        clips = int(np.exp(rng.uniform(np.log(low), np.log(high))))
        offset = int(rng.randint(0, high))
        arrays[f"{stem}_i3d.npy"] = pool[offset: offset + clips]
        frame = np.zeros(clips * 16, np.float32)
        if i % 2:
            start = int(rng.randint(0, clips * 16 // 2))
            frame[start: start + clips * 4] = 1.0
        labels[stem] = frame.tolist()
    return FeatureDataset(filenames=sorted(arrays), _arrays=arrays, labels=labels)


def fit_once(torch, precision: str, workers: int, bags, steps: int, profiled: bool = False,
             lr: float = 1e-5):
    """MGFN at full width from seed 0 through ``VideoAnomalyDetectionRunner.fit``
    on ``bags`` at 16 + 16 per step for ``steps`` steps, with ``data.num_workers
    = workers``, at ``lr`` (1e-5: at 1e-4 bf16-mixed's loss on these bags turns
    NaN, which ``check_fit_prefetch`` records). Returns (runner, losses, seconds,
    loader seconds, and with ``profiled`` the fit's ``device_breakdown``)."""
    from anomaly_detection_on_video_tpu_torch.models import MGFN
    from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner

    logger = ListLogger()
    runner = VideoAnomalyDetectionRunner(MGFN(), optimizer_cfg={"learning_rate": lr},
                                         data_cfg={"num_workers": workers}, loggers=[logger],
                                         precision=precision, device="cuda")
    runner.init_state()
    totals = {"assembly": 0.0, "wait": 0.0}

    def fit():
        with loader_timers(totals), contextlib.redirect_stdout(io.StringIO()):
            runner.fit(bags, max_epochs=1000, max_steps=steps, batch_size=16)

    torch.cuda.synchronize()
    start = time.perf_counter()
    breakdown = device_breakdown(torch, fit) if profiled else fit()
    torch.cuda.synchronize()
    return runner, logger.losses(), time.perf_counter() - start, totals, breakdown


def check_fit_prefetch(torch, steps: int = 20, window_steps: int = 4, bags: int = 96):
    """Phase 14 (b): ``fit`` with ``data.num_workers`` 0 and 8 (the
    prefetch thread) at full MGFN width on seeded in-memory bags, 16 + 16
    per step, ``steps`` steps, in ``32-true`` and ``bf16-mixed``, first
    under cuDNN's default algorithms (what a run uses), then with
    ``torch.backends.cudnn.deterministic`` in 32-true: its float32 weight
    gradients are not bit-reproducible under the default algorithms (two
    runs part from the second step), bf16-mixed's are. Gates: losses
    finite; losses and final parameters bit-equal between num_workers 0 and
    8, in 32-true under the deterministic algorithms. Prints steps/s of the whole loop,
    the host's assembly and the loop's wait for batches per step, and the
    device's idle share over a profiled ``fit`` of ``window_steps``; then a
    bf16-mixed fit at lr 1e-4 for the record (its losses and the first NaN
    step, no gate). Returns the first 32-true run's runner."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.training.runner import PRECISIONS

    start = time.perf_counter()
    bags = seeded_bags(bags, seed=14)  # 96 + 96: 6 steps an epoch, so 20 stop mid-epoch
    saved = torch.backends.cudnn.deterministic
    trained = None
    try:
        for precision in PRECISIONS:
            for deterministic in (False, True) if precision == "32-true" else (False,):
                torch.backends.cudnn.deterministic = deterministic
                pair = {}
                for workers in (0, 8):
                    runner, losses, seconds, totals, _ = fit_once(torch, precision, workers, bags,
                                                                  steps)
                    params = {k: v.detach().clone()
                              for k, v in runner.state.model.state_dict().items()}
                    pair[workers] = (losses, params, seconds, totals)
                    if trained is None:
                        trained = runner  # 32-true, default algorithms: evaluated below
                    del runner
                (l0, p0, *_), (l8, p8, *_) = pair[0], pair[8]
                equal = l0 == l8 and all(torch.equal(p0[k], p8[k]) for k in p0)
                if (len(l0) != steps or not np.isfinite(l0 + l8).all()
                        or (not equal and (deterministic or precision == "bf16-mixed"))):
                    raise AssertionError(f"fit {precision}, deterministic={deterministic}: "
                                         f"num_workers=0 losses {l0}, 8 {l8}; equal {equal}")
                rates = "; ".join(
                    f"num_workers={w} {steps / seconds:.2f} steps/s ({seconds / steps * 1e3:.2f} "
                    f"ms a step; assembly {totals['assembly'] / steps * 1e3:.2f} ms, the loop "
                    f"waiting {totals['wait' if w else 'assembly'] / steps * 1e3:.2f} ms)"
                    for w, (_, _, seconds, totals) in pair.items())
                print(f"fit {precision}, cuDNN {'deterministic' if deterministic else 'default'} "
                      f"algorithms, {steps} steps: {rates}; x{pair[0][2] / pair[8][2]:.2f} with "
                      f"prefetch; losses {l0[0]:.6f} -> {l0[-1]:.6f}, losses and parameters "
                      f"bit-equal across num_workers: {equal}", flush=True)
            torch.backends.cudnn.deterministic = saved
            for workers in (0, 8):
                window = fit_once(torch, precision, workers, bags, window_steps, profiled=True)[4]
                print(f"fit {precision}, num_workers={workers}, a profiled fit of {window_steps} "
                      f"steps: busy {window['device_busy_ms']:.1f} ms of {window['wall_ms']:.1f} "
                      f"ms wall, idle share {window['idle_share']:.1%}, host-to-device copies "
                      f"{window['h2d_copy_ms']:.2f} ms", flush=True)
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = saved
    losses = fit_once(torch, "bf16-mixed", 8, bags, steps, lr=1e-4)[1]
    nan = next((i for i, x in enumerate(losses) if not np.isfinite(x)), None)
    print(f"fit bf16-mixed at lr 1e-4 (the record; the runs above train at 1e-5), {steps} "
          f"steps: losses {[round(x, 6) for x in losses]}; first non-finite loss at step "
          f"{nan}", flush=True)
    print(f"phase 14 (b), fit: {time.perf_counter() - start:.1f} s", flush=True)
    return trained


def check_evaluate_prefetch(torch, trained, videos: int = 48, repeats: int = 2) -> None:
    """Phase 14 (b), evaluation: ``evaluate`` with ``prefetch_assembly`` on
    and off on ``videos`` seeded test videos of 32-1024 clips, batch_videos
    8, after one warm-up call, ``repeats`` times each in turns. Gates: AUCs
    and scores equal, AUCs in [0, 1]. Prints each setting's seconds and, for
    the prefetched calls, the worker's assembly (padding) and the loop's wait
    for it."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.training import runner as runner_module

    start = time.perf_counter()
    test = seeded_test_set(videos, seed=15)
    evaluate = runner_module.evaluate
    evaluate(trained.state, test, batch_videos=8)  # cuDNN's plans for every bucket
    results, times, totals = {}, {True: [], False: []}, {"assembly": 0.0, "wait": 0.0}
    saved = runner_module.prefetch
    runner_module.prefetch = lambda it, depth: timed(saved(timed(it, totals, "assembly"), depth),
                                                     totals, "wait")
    try:
        for on in (True, False) * repeats:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[on] = evaluate(trained.state, test, batch_videos=8, prefetch_assembly=on)
            times[on].append(time.perf_counter() - t0)
    finally:
        runner_module.prefetch = saved
    a, b = results[True], results[False]
    if (a.rec_auc, a.pr_auc) != (b.rec_auc, b.pr_auc) or not np.array_equal(a.preds, b.preds) or (
            not 0.0 <= a.rec_auc <= 1.0):
        raise AssertionError(f"evaluate: prefetch_assembly on {a.rec_auc, a.pr_auc}, off "
                             f"{b.rec_auc, b.pr_auc}")
    clips = sum(test[i]["feature"].shape[0] for i in range(len(test)))
    print(f"evaluate over {len(test)} seeded test videos ({clips} clips, batch_videos 8): "
          f"rec_auc {a.rec_auc:.6f}, pr_auc {a.pr_auc:.6f}, equal with prefetch_assembly on and "
          f"off; seconds on {[round(t, 4) for t in times[True]]}, off "
          f"{[round(t, 4) for t in times[False]]}; with it on, a call's assembly "
          f"{totals['assembly'] / repeats:.4f} s on the worker and the loop's wait "
          f"{totals['wait'] / repeats:.4f} s; {time.perf_counter() - start:.1f} s", flush=True)


def check_dropout(torch, root: str) -> None:
    """Phase 14 (c): ``runner=mgfn`` with ``runner.model_config.dropout=0.1``
    through ``run`` on the committed bags under check_training's gates;
    then its checkpoint served by ``build_scorer`` as trained and with
    ``--model-config dropout=0.0``: eval-mode scores equal."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer

    start = time.perf_counter()
    ckpt, _ = check_training(torch, root, "mgfn", extra={"runner.model_config.dropout": 0.1},
                             tag="mgfn_dropout")
    bags = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                                "i3d_segments_seed0.npz"))
    scores = []
    for extra in ([], ["--model-config", "dropout=0.0"]):
        args = infer.build_parser().parse_args(["--checkpoint", ckpt, "--outdir", root,
                                                "--device", "cuda"] + extra)
        scorer, _ = infer.build_scorer(args)
        scores.append(np.stack([infer.score_features(bags[name].transpose(1, 0, 2), scorer)
                                for name in bags.files]))
    if scorer.config.dropout != 0.0 or not np.array_equal(*scores):
        raise AssertionError(f"dropout 0.1 in eval mode: scores differ from dropout 0's by "
                             f"{float(np.abs(scores[0] - scores[1]).max()):.3e}")
    print(f"dropout 0.1 checkpoint in eval mode: {scores[0].size} clip scores equal to those at "
          f"dropout 0 on the same weights; phase 14 (c): {time.perf_counter() - start:.1f} s",
          flush=True)


def check_multirun(torch, root: str) -> None:
    """Phase 14 (d): ``run -m seed=1,2`` on the card, 5 bf16-mixed steps a
    job on the committed bags. Gates: both jobs exit 0, ``multirun.jsonl`` holds 2
    lines, job 0's losses equal a direct run's with ``seed=1``. Prints the
    sweep's wall time and each job's start-up (launch to its first logged
    step) and wall time."""
    from anomaly_detection_on_video_tpu_torch import run

    # bf16-mixed: its cuDNN algorithms are bit-reproducible run to run, 32-true's are not
    overrides = dict(training_overrides(root, "mgfn", "multirun_direct"),
                     **{"trainer.max_steps": 5, "trainer.max_epochs": 3, "trainer.eval_every": 3,
                        "trainer.precision": "bf16-mixed"})
    sweep = os.path.join(root, "sweep")
    argv = ["-m", "--multirun-dir", sweep, "runner=mgfn", "seed=1,2", "device=cuda"] + [
        f"{k}={v}" for k, v in overrides.items()
        if k not in ("trainer.log_path", "trainer.checkpoint.dirpath")]
    launches = []
    real_run = run.subprocess.run

    class Recorder:  # run_multirun's subprocess module, timing each job
        @staticmethod
        def run(cmd, **kwargs):
            launches.append([time.time()])
            proc = real_run(cmd, **kwargs)
            launches[-1].append(time.time())
            return proc

    start = time.perf_counter()
    saved, run.subprocess = run.subprocess, Recorder
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            run.main(argv)
    finally:
        run.subprocess = saved
    wall = time.perf_counter() - start
    with open(os.path.join(sweep, "multirun.jsonl")) as f:
        jobs = [json.loads(line) for line in f]
    if [j["returncode"] for j in jobs] != [0, 0] or "[multirun] job 1/2" not in printed.getvalue():
        raise AssertionError(f"run -m: {jobs}; {printed.getvalue()}")
    logs = []
    for job in jobs:
        with open(os.path.join(job["dir"], "metrics.jsonl")) as f:
            logs.append([json.loads(line) for line in f])
    run_training(dict(overrides, seed=1))
    with open(overrides["trainer.log_path"]) as f:
        direct = [r["train_loss"] for r in map(json.loads, f) if "train_loss" in r]
    job0 = [r["train_loss"] for r in logs[0] if "train_loss" in r]
    if job0 != direct or len(direct) != 5:
        raise AssertionError(f"run -m job 0's losses {job0} against a direct seed=1 run's {direct}")
    timing = "; ".join(
        f"job {i}: launch to its first logged step "
        f"{next(r['time'] for r in log if 'train_loss' in r) - begin:.2f} s, wall "
        f"{end - begin:.2f} s" for i, (log, (begin, end)) in enumerate(zip(logs, launches)))
    print(f"run -m seed=1,2 on the card: 2 jobs exit 0, multirun.jsonl 2 lines, job 0's 5 losses "
          f"equal a direct seed=1 run's; sweep wall {wall:.2f} s; {timing}", flush=True)


def check_trace(torch, root: str, extractor, video) -> None:
    """Phase 14 (e): one bf16 extraction pass of the 4-clip video inside
    ``utils.profiling.trace``. Gates: one Chrome trace written, naming the
    K1, K2 and K3 kernels."""
    import glob

    from anomaly_detection_on_video_tpu_torch.utils.profiling import trace

    logdir = os.path.join(root, "trace")
    start = time.perf_counter()
    with trace(logdir):
        extractor.extract_frames(video)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    text = open(files[0]).read() if len(files) == 1 else ""
    names = ("crop_norm_kernel", "stem_kernel", "bottleneck_kernel")
    if not all(name in text for name in names):
        raise AssertionError(f"trace: files {files}, kernels named "
                             f"{[name for name in names if name in text]}")
    print(f"trace: one bf16 pass of the 4-clip video in {seconds:.2f} s wrote "
          f"{os.path.basename(files[0])} ({len(text) / 1e6:.1f} MB) naming {', '.join(names)}",
          flush=True)


def check_training_and_weights(torch, root: str, extractor, video, checkpoint: str,
                               weights: str) -> None:
    """Phase 14: (a) ``.msgpack`` weights, (b) ``fit`` and ``evaluate`` with
    and without prefetch, (c) feed-forward dropout, (d) ``run -m``, (e)
    ``trace``."""
    start = time.perf_counter()
    check_msgpack_weights(torch, root, weights, checkpoint)
    torch.cuda.empty_cache()
    trained = check_fit_prefetch(torch)
    check_evaluate_prefetch(torch, trained)
    del trained
    torch.cuda.empty_cache()
    check_dropout(torch, root)
    check_multirun(torch, root)
    check_trace(torch, root, extractor, video)
    print(f"training and weights phase (14): {time.perf_counter() - start:.1f} s", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.infer import score_features
    from anomaly_detection_on_video_tpu_torch.models import MGFN, seeded_init_
    from anomaly_detection_on_video_tpu_torch.ops import kernels
    from anomaly_detection_on_video_tpu_torch.ops.kernels._build import build, library_path
    from anomaly_detection_on_video_tpu_torch.ops.kernels.crop_norm import ten_crop_standardize_plain
    from anomaly_detection_on_video_tpu_torch.ops.kernels.stem import stem_kernel_info
    from anomaly_detection_on_video_tpu_torch.ops.metrics import frame_level_scores
    from anomaly_detection_on_video_tpu_torch.ops.resize import resize_bilinear_fast, short_side_size
    from anomaly_detection_on_video_tpu_torch.utils.device import set_f32_parity

    set_f32_parity()
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}",
          flush=True)

    # 1. build
    cold = not library_path().exists()
    t0 = time.perf_counter()
    lib = build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib.path}; "
          f"{'cold: nvcc ran' if cold else 'warm: a library of these sources was there'})",
          flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "==" in line or "error" in line.lower():
            print("  " + line.strip(), flush=True)
    smi = smi_line()
    print(f"card: {smi}", flush=True)
    tile = stem_kernel_info()
    print(f"K2 bf16 tile: {tile['tile_rows']}x{tile['tile_cols']} pooled positions of one pooled "
          f"frame per CTA, {tile['threads']} threads, {tile['shared_bytes']} bytes of shared "
          f"memory, {tile['ctas_per_sm']} CTAs per SM", flush=True)

    # 2. kernels against their plain versions, on main-path data
    rng = np.random.RandomState(0)
    video = rng.randint(0, 256, (64, 240, 320, 3), dtype=np.uint8)  # 4 clips of 16 frames
    extractor = FeatureExtractor(dtype=torch.bfloat16, batch=40, device=dev, seed=0)
    model = extractor.model
    randomize_batchnorm_(torch, model, seed=2)
    out_h, out_w = short_side_size(240, 320, extractor.resize)

    def resize_clips(frames, clips):
        group = torch.from_numpy(frames).to(dev)
        return resize_bilinear_fast(group, out_h, out_w).reshape(clips, 16, out_h, out_w, 3)

    resized = resize_clips(extractor.pad_frames(video, 4), 4)
    # (24, 16, 256, 341, 3): the batch-240 group of bulk extraction, 24 distinct clips; made
    # again from the host frames where needed, so it is not resident during the main paths
    bulk_frames = rng.randint(0, 256, (24 * 16, 240, 320, 3), dtype=np.uint8)
    bulk = resize_clips(bulk_frames, 24).contiguous()
    results = [check_crop_norm(torch, rng, bulk)]
    crops32 = ten_crop_standardize_plain(resized, 224, torch.float32)  # (40, 16, 224, 224, 3)
    stem_out, k2 = check_stem(torch, model, crops32)
    results.append(k2)
    results.append(check_bottlenecks(torch, model, stem_out))
    del stem_out

    # K2 and K3 at the bulk batch, B = 240 (checked and timed; not in the JSON line)
    print("at B = 240, the bulk-extraction batch:", flush=True)
    stem_240, k2_240 = check_stem(torch, model, ten_crop_standardize_plain(bulk, 224, torch.float32))
    k3_240 = check_bottlenecks(torch, model, stem_240)
    print(f"B=240 summary: K2 {k2_240['ms']:.3f} ms (bound {k2_240['bound_ms']:.3f}), "
          f"K3 {k3_240['ms']:.3f} ms for 3 blocks (bound {k3_240['bound_ms']:.3f})", flush=True)
    del bulk, stem_240
    torch.cuda.empty_cache()

    # 3. the main path, through the entry points a user calls
    scorer = seeded_init_(MGFN(), seed=1).to(dev).eval()
    features, clip_scores, counts = drive_path(torch, "main path", extractor, video, scorer)
    frame_scores = frame_level_scores(clip_scores, extractor.frames_per_clip)
    print(f"frame scores ({frame_scores.size}): {np.round(frame_scores[::16], 6).tolist()} (every 16th)",
          flush=True)
    with torch.no_grad():
        ref = plain_features(torch, model, crops32).reshape(4, 10, 2048)
    cos = check_cosine("main-path features vs plain float32", torch.from_numpy(features).to(dev), ref, 0.999)
    print(f"features vs plain float32 forward: min row cosine {cos:.6f}", flush=True)
    breakdown = device_breakdown(torch, lambda: score_features(extractor.extract_frames(video), scorer))
    print(f"main path device breakdown (torch.profiler): {json.dumps(breakdown)}", flush=True)

    for entry in results:
        entry["launches"] = counts[entry["name"]]

    # 4. the int8 path: K4 and K5 at the TPU probe's shapes, then the int8
    # main path (FeatureExtractor(quantize=True), bfloat16 around int8 convs)
    # on the same video, weights and scorer
    check_int8_probe_shapes(torch)
    torch.cuda.empty_cache()
    qextractor = FeatureExtractor(state_dict=model.state_dict(), dtype=torch.bfloat16, batch=40,
                                  device=dev, quantize=True)
    qfeatures, _, qcounts = drive_path(torch, "int8 main path", qextractor, video, scorer)

    crops16 = ten_crop_standardize_plain(resized, 224, torch.bfloat16)  # K1's output, bit for bit
    results += check_int8_path_calls(torch, qextractor.model, crops16)
    check_int8_features(torch, "int8 features", qextractor.model, crops16, qfeatures, ref)
    del crops16
    qbreakdown = device_breakdown(
        torch, lambda: score_features(qextractor.extract_frames(video), scorer))
    print(f"int8 main path device breakdown (torch.profiler): {json.dumps(qbreakdown)}", flush=True)
    for entry in results[-2:]:
        entry["launches"] = qcounts[entry["name"]]

    # K4 and K5 on every call of one int8 forward at B = 240, the
    # bulk-extraction batch (checked and timed; not in the JSON line)
    print("int8 forward at B = 240, the bulk-extraction batch:", flush=True)
    k45_240 = check_int8_path_calls(torch, qextractor.model, ten_crop_standardize_plain(
        resize_clips(bulk_frames, 24), 224, torch.bfloat16))
    print("B=240 int8 summary: " + ", ".join(
        f"{e['name']} {e['ms']:.3f} ms ({e['device_ms']:.3f} device; bound {e['bound_ms']:.3f}, "
        f"plain {e['plain_ms']:.3f}, library "
        f"{'none' if e['library_ms'] is None else format(e['library_ms'], '.3f')})"
        for e in k45_240), flush=True)
    torch.cuda.empty_cache()

    # 5. both main paths end to end at the bulk batch, B = 240: the 24-clip
    # video in one group, through the same entry points, weights and scorer
    print("main paths at B = 240 (a 24-clip video, one group of 240 crops):", flush=True)
    bulk_resized = resize_clips(bulk_frames, 24)
    with torch.no_grad():
        bulk_ref = plain_features(torch, model, ten_crop_standardize_plain(
            bulk_resized, 224, torch.float32)).reshape(24, 10, 2048)
    torch.cuda.empty_cache()
    for quantize in (False, True):
        name = f"{'int8 ' if quantize else ''}main path at B = 240"
        bulk_extractor = FeatureExtractor(state_dict=model.state_dict(), dtype=torch.bfloat16,
                                          batch=240, device=dev, quantize=quantize)
        bulk_features, _, _ = drive_path(torch, name, bulk_extractor, bulk_frames, scorer)
        bulk_breakdown = device_breakdown(
            torch, lambda: score_features(bulk_extractor.extract_frames(bulk_frames), scorer))
        print(f"{name}, one profiled pass: busy {bulk_breakdown['device_busy_ms']:.2f} ms of "
              f"{bulk_breakdown['wall_ms']:.2f} ms wall, idle share "
              f"{bulk_breakdown['idle_share']:.1%}, K1 "
              f"{bulk_breakdown['kernels_ms']['K1 crop_norm_kernel']:.3f} ms device; "
              f"{json.dumps(bulk_breakdown)}", flush=True)
        if quantize:
            crops16 = ten_crop_standardize_plain(bulk_resized, 224, torch.bfloat16)
            check_int8_features(torch, f"{name} features", bulk_extractor.model, crops16,
                                bulk_features, bulk_ref)
            del crops16
        else:
            cos = check_cosine(f"{name} features vs plain float32",
                               torch.from_numpy(bulk_features).to(dev), bulk_ref, 0.999)
            print(f"{name} features vs plain float32 forward: min row cosine {cos:.6f}", flush=True)
        del bulk_extractor, bulk_features
        torch.cuda.empty_cache()
    del bulk_resized, bulk_ref
    torch.cuda.empty_cache()

    # 6. fault 1: clips other than 16x224x224 run the plain torch chain
    check_eight_frame_extractor(torch, model, video)
    torch.cuda.empty_cache()

    # 7. fault 2: K5 past 2^31 output values
    check_int8_stem_past_2g(torch)
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # 8. MGFN training through the run entry, then the reference batch's step
        t_train = time.perf_counter()
        checkpoints = {}
        checkpoints["mgfn"], run_s = check_training(torch, work, "mgfn", eval_only=True)
        for precision in ("32-true", "bf16-mixed"):
            time_train_step(torch, precision)
        print(f"training phase: {time.perf_counter() - t_train:.1f} s ({run_s:.1f} s for the run "
              f"and its eval_only)", flush=True)

        # 9. RTFM and Sultani trained through the run entry; all three families
        # served from their checkpoints through infer.main
        t_serve = time.perf_counter()
        for runner in ("rtfm", "sultani"):
            checkpoints[runner], _ = check_training(torch, work, runner)
            time_train_step(torch, "32-true", runner)
        check_serving(torch, work, extractor, video, checkpoints)
        print(f"serving phase: {time.perf_counter() - t_serve:.1f} s", flush=True)

        # 10. extraction breadth: K2-K5 at B = 1 and 60, center crops at
        # full width, the bulk CLI pooled and serial, center-crop serving
        bulk_ten = FeatureExtractor(state_dict=model.state_dict(), dtype=torch.bfloat16,
                                    batch=240, device=dev)
        check_extraction_breadth(torch, work, model, qextractor.model, bulk_ten, scorer,
                                 checkpoints["mgfn"], extractor, video)
        del bulk_ten
        torch.cuda.empty_cache()

        # 11. the optical-flow stream: device flows, K5's stem over two
        # channels, the flow extractor, two-stream extraction and serving
        stem_cin2 = check_flow_stream(torch, work, model, scorer)
        torch.cuda.empty_cache()

        # 12. the other backbones: i3d_8x8_r50 (K5's stem at stride
        # (1,2,2)), the non-local i3res50, the S2D stem, and the CLIs
        stem_s1 = check_other_backbones(torch, work, scorer, checkpoints["mgfn"], bulk_frames,
                                        resize_clips)
        torch.cuda.empty_cache()

        # 13. serving on the card: --serve, --dtype int8, --watch, --export /
        # --from-export, and restarts with --compile-cache
        check_serving_on_card(torch, work, checkpoints["mgfn"], os.path.join(work, "i3res50.pt"),
                              features)
        torch.cuda.empty_cache()

        # 14. training and weights: .msgpack I3D weights, fit and evaluate
        # with and without prefetch, feed-forward dropout, run -m, trace
        check_training_and_weights(torch, work, extractor, video, checkpoints["mgfn"],
                                   os.path.join(work, "i3res50.pt"))
        torch.cuda.empty_cache()

        # 15. scale-out: extract_features --multihost as two processes, the
        # clip-axis split over two replicas, run trainer.multihost=true
        check_scale_out(torch, work, model, os.path.join(work, "i3res50.pt"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    pallas = "anomaly_detection_on_video_tpu/ops/pallas"
    sources = {"ten_crop_standardize": ("crop_norm.cu", f"{pallas}/crop_norm.py:49"),
               "stem_conv_pool": ("stem.cu", f"{pallas}/stem.py:150"),
               "bottleneck_block": ("bottleneck.cu", f"{pallas}/bottleneck.py:176"),
               "int8_matmul": ("int8_matmul.cu", "scripts/int8_pallas_probe.py:75"),
               "int8_conv": ("int8_conv.cu", "scripts/int8_pallas_probe.py:159")}
    line = {"kernels": [
        {"name": e["name"], "route": "cuda",
         "source": f"anomaly_detection_on_video_tpu_torch/csrc/{sources[e['name']][0]}",
         "replaces": sources[e["name"]][1],
         "launches": e["launches"], "max_abs_err": e["max_abs_err"], "ms": e["ms"],
         "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
         "library_ms": e["library_ms"],
         # K5's stem over the flow stream's two channels (phase 11), and at
         # stride (1,2,2) for i3d_8x8_r50 (phase 12)
         **({"stem_cin2": stem_cin2, "stem_s1": stem_s1} if e["name"] == "int8_conv" else {})}
        for e in results]}
    print(json.dumps(line), flush=True)
    print(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
