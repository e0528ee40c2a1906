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
   257x301 frames, at an odd crop size (its scalar-store path), and at
   (1, 2, 256, 24576, 3), frames whose crops leave columns unread and
   whose three input rows pass a CTA's shared memory (segments of column
   spans), with its launch plan (band height, shared bytes) printed; K1
   timed at the bulk shape in both types beside its bound and achieved
   TB/s, at the 24576-wide shape beside its bound, and in bfloat16 across
   shared-memory budgets of its plan;
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
   process's launches (read from the launch log,
   ``ANOMALY_TORCH_LAUNCH_LOG``) K1-K5 each > 0; (b) ``FeatureExtractor(devices=
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
16. the user tools of ``scripts/``, ported to
   ``anomaly_detection_on_video_tpu_torch/scripts/``, each run as a user
   runs it (``python -m``, its own process, on the card), every process
   of each appending its kernel launches at exit to a log
   (``ANOMALY_TORCH_LAUNCH_LOG``), at once (their gates are outcomes, not
   times): (a) ``demo --epochs 16``: features (n_clips, 10, 2048), K1, K2
   and K3 launched by its ``extract_features`` process, AUC >= 0.7 (the
   script's own gate), the export's ``manifest.json``; (c)
   ``convert_checkpoint`` round trips of phase 8's MGFN weights (``mgfn-hf``, its orbax step restored and saved as a ``.pt``)
   and phase 10's ``i3res50.pt`` (``i3d``) to
   ``.msgpack`` and back, every tensor bit-equal (``num_batches_tracked``
   back as 0), and ``infer.load_i3d_weights`` of the ``.msgpack`` equal to
   the ``.pt``, then (b) ``infer`` on four ``int8_e2e`` corpus videos saved
   as MJPG (phase 8's checkpoint, phase 10's weights) and
   ``operating_point`` over its score JSONs and a ground truth of their
   anomalous halves: AUCs and the best-F1 threshold in [0, 1]; (d)
   ``convergence_bench`` at its defaults: every family's best AUC > 0.8 on
   every seed, the full-scale MGFN's divergence printed, not gated; (e)
   ``int8_e2e`` at its defaults (12 videos of 256 frames, 150 steps, seeds
   0 1 2): every AUC finite and in [0, 1], K1-K5 launched (K4 and K5 by its
   int8 variants alone), the report written; then (f) ``tp_audit``:
   Sultani's split ideal (sharded bytes >= 0.999, memory within 1e-3 of
   1/tp), the full-size MGFN step timed at every mesh shape the card count
   allows and the others reported as skipped.
17. the last of the JAX package: (a) a Hugging Face cache in the work
   directory (``HF_HUB_CACHE``) holding phase 10's ``i3res50.pt`` as the
   reference's model repo file and phase 8's bags as its feature repo
   (zips at ``refs/tushar-n``, the ground truth at ``refs/main``), under
   cuDNN's deterministic algorithms: ``extract_features --weights hf://...``
   bit-equal to the file by path (stand-in decode, K1-K3 launched), an
   uncached spec exiting with one line, and a 3-step ``run runner=mgfn``
   with no data path equal to the run by path, record for record; (b)
   ``parity_check`` on two MJPG videos with phase 10's weights and phase
   8's MGFN in float32 and float64 against ``tests/torch_oracles.py``:
   every stage and the features within 1e-3 (float32) and 1e-8 (float64),
   the float32 pipeline (K1-K3, launch counts reset before each run and
   read after) within 1e-3, MGFN scores within 1e-4, AUCs in [0, 1], and a
   perturbed ``layer4`` conv on the oracle's side raising the features'
   difference over 10x; (c) ``dynamics_ab`` at its defaults: the port's
   step and the oracle's agree on finite-or-NaN at every (profile, lr);
   from random LayerNorms at full width in float64 their first 3 losses
   agree within 1e-10 relative (the step returns a float64 model's loss
   unrounded);
18. eval figures and ``infer --figure``: (a) the 4-clip video saved as
   MJPG, scored by ``python -m ...infer --threshold 0.5`` with phase 8's
   MGFN and phase 10's weights as two processes at once, with and
   without ``--figure`` (K1 / K2 / K3 1 / 1 / 3 in each, from
   ``ANOMALY_TORCH_LAUNCH_LOG``; the score JSONs equal but
   ``latency_s``), and ``--watch --figure`` in this process (launch
   counts reset before and read after): with matplotlib the PNGs hold the
   frame scores and the threshold's line; without it (the card's machine)
   the one-shot process exits non-zero with the ImportError naming
   matplotlib and its JSON written, as the JAX CLI does, and the watch
   loop counts one error and writes no ``.error.json``; (b) a 2-epoch
   ``run runner=mgfn`` with ``trainer.figure_dir`` against the same run
   without it under deterministic cuDNN: the figures or two warnings,
   equal metrics records, bit-equal checkpoints;
19. the JAX package's orbax checkpoints, on a copy of the committed run
   directory ``tests/data/orbax_mgfn/run`` (``tests/make_orbax_fixture.py``:
   MGFN at 2048 channels, narrow dims, steps 2 and 4; the card has no JAX):
   (a) ``python -m ...infer --checkpoint <copy>`` on phase 18's MJPG with
   phase 10's weights as a process, K1 / K2 / K3 1 / 1 / 3, its score JSON
   equal to ``infer --torch-weights`` of the fixture's ``mgfn_step4.pt``
   (the JAX exporter's) but ``latency_s``; (b) the restored scorer's state
   dict bit-equal to that file, with the read's time; (c) ``run
   trainer.resume=true`` on the copy for two more epochs with TF32 off:
   ``resumed from step 4``, the JAX resumed run's steps, its losses within
   1e-4 relative (the largest gap printed), both JAX steps kept beside
   the port's new ones; (d) ``eval_only`` of orbax step 4 twice: equal
   AUCs in [0, 1], within 1e-4 of the JAX run's eval of that step. The
   committed fixture's bytes are checked unchanged at the end.
20. a run trained on the card, written as orbax by the port's
   ``TopKCheckpointer.save``: (a) ``run runner=mgfn`` at full width
   (the default ``MGFNConfig``) for 2 epochs on phase 8's bags with
   ``save_top_k`` 2: every step directory orbax, none holding
   ``state.pt``; the last step through ``read_orbax_step`` +
   ``train_state_from_orbax`` bit-equal to the live state recorded at
   its save (weights, Adam moments, step); each save's host ms and bytes
   on disk beside ``torch.save`` of the same payload, with the card's
   name and power limit; (b) ``python -m ...infer --checkpoint <that
   directory>`` on phase 18's MJPG with phase 10's weights as a process,
   K1 / K2 / K3 1 / 1 / 3, its score JSON equal to ``--torch-weights`` of
   the restored scorer's state dict but ``latency_s``; (c) ``run
   trainer.resume=true`` on a copy for 2 more epochs: ``resumed from step
   <last>``, later steps, only orbax steps, those the JAX policy keeps
   (the latest and the top 2 by metric); (d) after phase 19 (c), the JAX
   run's directory holds steps 2, 4, 6 and 8, all orbax and none with
   ``state.pt``, and steps 2 and 4 keep their bytes.
21. the JAX package's network mode, with no network: the tests' stand-in
   ``huggingface_hub``, ``datasets`` and ``wandb``
   (``tests/torch_network_fixtures.py``) put in ``sys.modules`` of the
   processes that need them, four processes at once: (a) ``extract_features --hf-dataset`` with no
   ``--weights`` (the default spec served as phase 10's weights) over three
   MJPG videos in two splits, against ``--videos`` of the train split with
   that file: K1 / K2 / K3 1 / 1 / 3 per video, features and segments
   byte-equal; (b) ``run runner=mgfn`` at full width with no data path
   (phase 8's bags as the stand-in hub's zips), ``wandb_key``,
   ``log_model`` and ``figure_dir``, 2 epochs: the JAX package's hub calls,
   every JSONL record logged to W&B, one ``checkpoint-step{step}`` artifact
   per save; (c) without the packages (blocked): ``--hf-dataset`` exits
   non-zero naming ``datasets``; then in this process the cache reader
   serves phase 17's cache and a 2-epoch run warns as the JAX logger does
   and saves its steps.
22. the JAX package's probes, ported (``anomaly_detection_on_video_tpu_torch/
   scripts/``): ``int8_pallas_probe`` (K4 and K5 at the TPU probe's
   shapes, the bf16 cuDNN yardstick, its verify), ``stage_probe`` (stages
   1-4 in bf16 at B = 240 with MFU and HBM rate, ``FeatureExtractor`` at
   batch 240 and 480, the int8 microprobes), ``int8_stage_probe`` (conv
   microprobes, stages 1-2 in int8 with launches and a profiled split),
   ``conv2d_probe``, ``stem2d_probe``, ``int8_probe``, ``eval_probe`` and
   ``overlap_ab``, at the JAX shapes with 3 repetitions (2 for
   ``overlap_ab``), their records printed, under the gates of
   ``check_probes``.

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
import re
import shutil
import subprocess
import sys
import tempfile
import time

from anomaly_detection_on_video_tpu_torch.scripts.int8_pallas_probe import (
    check_int8_probe_shapes, int_mm_ms)
from anomaly_detection_on_video_tpu_torch.utils.measure import (
    HBM_BYTES_PER_S, bound, check_equal, cuda_ms, taps_inside)

# The JAX package's name, as the repository's configs spell their classes
REFERENCE = "anomaly_detection_on_video_tpu"
# configs/ composed with runner=mgfn (tests/test_torch_runner_data.py holds it
# to the port's composition): the training phase's config where PyYAML is missing
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def crop_read_bytes(gc: int, fpc: int, height: int, width: int, size: int) -> int:
    """The input bytes the ten crops read: the pixels inside any crop or
    flipped crop, 3 bytes each, of every (clip, frame)."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.ops.gtransforms import ten_crop_positions

    read = np.zeros((height, width), bool)
    for top, left in ten_crop_positions(height, width, size):
        for lo in (left, width - left - size):
            read[top: top + size, lo: lo + size] = True
    return int(read.sum()) * 3 * gc * fpc


def check_crop_norm(torch, rng, bulk):
    """K1 bit-equal to its plain version in float32 and bfloat16 at the
    bulk-extraction group shape and at gc = 1 for portrait, wide, square and
    odd frames (and at an odd crop size, its scalar-store path), and at
    (1, 2, 256, 24576, 3), frames whose crops leave columns unread and
    whose three input rows do not fit a CTA: segments of column spans;
    times at the bulk shape in both types beside their bounds, the
    24576-wide frames likewise (bound: the bytes the crops read), and
    bfloat16 across shared-memory budgets of the launch plan."""
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
                            ((2, 3, 41, 50, 3), 36), ((1, 2, 256, 24576, 3), 224))]
    max_err = 0.0
    for frames, size in cases:
        for dtype in (f32, bf16):
            max_err = max(max_err, check_equal(f"K1 {tuple(frames.shape)} S={size} {dtype}",
                                               ten_crop_standardize(frames, size, dtype),
                                               ten_crop_standardize_plain(frames, size, dtype)))
        plan = crop_norm_plan(frames.shape[2], frames.shape[3], size, bf16)
        print(f"K1 crop_norm {tuple(frames.shape)} S={size}: bit-equal f32/bf16; bf16 plan: band "
              f"{plan.band} rows x {plan.n_bands}, {len(plan.segments)} staged segment(s) "
              f"({'whole rows' if plan.whole_rows else 'column spans ' + str(list(plan.columns))}"
              f"), {plan.shared_bytes} shared bytes, {'16-byte' if plan.vector else 'scalar'} "
              f"stores", flush=True)
    wide = cases[-1][0]
    for dtype in (bf16, f32):
        out_elems = wide.shape[0] * 10 * wide.shape[1] * 224 * 224 * 3
        moved = crop_read_bytes(*wide.shape[:4], 224) + out_elems * torch.empty(
            (), dtype=dtype).element_size()
        ms = cuda_ms(lambda: ten_crop_standardize(wide, 224, dtype), 20)
        plain_ms = cuda_ms(lambda: ten_crop_standardize_plain(wide, 224, dtype), 5)
        bound_ms, bound_by = bound(moved, 2 * out_elems, "float32")
        plan = crop_norm_plan(*wide.shape[2:4], 224, dtype)
        print(f"K1 crop_norm {tuple(wide.shape)} {dtype}: {ms:.4f} ms kernel, {plain_ms:.4f} ms "
              f"plain, bound {bound_ms:.4f} ms ({bound_by}; {moved / 1e6:.3f} MB: the crops' "
              f"pixels read, the output written); plan: band {plan.band} x {plan.n_bands}, "
              f"segments {list(plan.segments)} over columns {list(plan.columns)}, pitch "
              f"{list(plan.pitch)}, {plan.shared_bytes} shared bytes", flush=True)
    del cases, wide
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
        ints = (ctypes.c_int * len(plan.ints()))(*plan.ints())
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
                lib_ms = int_mm_ms(a, w, 10)
                if lib_ms is None:
                    entry["library_refused"] += 1
                else:
                    entry["library_ms"] += lib_ms
                    entry["library_device_ms"] += int_mm_ms(a, w, 5, device_ms)
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
    # the configs' 1e-3 drove the JAX trainer and the port to NaN on these
    # bags, measured before fault 6 was repaired (PERF.md, section 6)
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
    1e-4, as in check_training: at 1e-3 these inputs drove MGFN's losses to
    NaN within a few steps (before the BCE gradient's repair, fault 6 in
    ROADMAP.md). Returns the median ms."""
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
    seconds printed (the process's launches go to the launch log)."""
    from anomaly_detection_on_video_tpu_torch import extract_features

    print("multihost child: torch and the port imported", flush=True)
    with open(spec) as f:
        runs = json.load(f)
    for argv in runs:
        start = time.perf_counter()
        with stand_in_decode():
            code = extract_features.main(argv)
        print(f"child run {argv[argv.index('--dtype') + 1]}: {time.perf_counter() - start:.2f} s",
              flush=True)
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
    from anomaly_detection_on_video_tpu_torch.ops import kernels

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
    launch_log = os.path.join(root, "p15_launches.jsonl")
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
                                      env=dict(os.environ, PYTHONUNBUFFERED="1",
                                               **{kernels.LAUNCH_LOG_ENV: launch_log})))
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
    with open(launch_log) as f:
        records = {record["argv"][-1]: record["launches"] for record in map(json.loads, f)}
    for pid, text in enumerate(texts):
        runs = [line for line in text.splitlines() if line.startswith(("child run", "[process"))]
        counts = records.get(os.path.join(root, f"p15_spec{pid}.json"), {})
        print(f"phase 15 (a) process {pid}: " + " | ".join(runs) + f" | launches of bf16 and int8 "
              f"{json.dumps(counts)}", flush=True)
        if text.count(f"[process {pid}/2] extracted") != 2:
            raise AssertionError(f"multihost extraction process {pid}: {text[-3000:]}")
        if sorted(counts) != sorted(w.__name__ for w in kernels.WRAPPERS) or not all(
                counts.values()):
            raise AssertionError(f"multihost extraction process {pid}: launches {counts}")
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
    = workers``, at ``lr`` (1e-5: at 1e-4 bf16-mixed's loss on these bags turned
    NaN before the BCE gradient's repair, fault 6; ``check_fit_prefetch`` records
    the 1e-4 fit). Returns (runner, losses, seconds,
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


TRACE_KERNELS = ("crop_norm_kernel", "stem_kernel", "bottleneck_kernel")


def check_trace(torch, root: str, extractor, video) -> None:
    """Phase 14 (e): one bf16 extraction pass of the 4-clip video inside
    ``utils.profiling.trace``. Gates: one Chrome trace written, naming the
    K1, K2 and K3 kernels. Prints how many of ``trace``'s warm-up kernels
    the profiler kept (the rest it dropped in place of the pass's)."""
    import glob

    from anomaly_detection_on_video_tpu_torch.utils.profiling import (SACRIFICE_KERNELS, trace,
                                                                     warmup_kernels_kept)

    logdir = os.path.join(root, "trace")
    start = time.perf_counter()
    with trace(logdir) as prof:
        extractor.extract_frames(video)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    text = open(files[0]).read() if len(files) == 1 else ""
    missing = [name for name in TRACE_KERNELS if name not in text]
    kept = warmup_kernels_kept(prof)
    if missing:
        raise AssertionError(f"trace: files {files}, kernels missing {missing}, warm-up "
                             f"kernels kept {kept} of {SACRIFICE_KERNELS}")
    print(f"trace: one bf16 pass of the 4-clip video in {seconds:.2f} s wrote "
          f"{os.path.basename(files[0])} ({len(text) / 1e6:.1f} MB) naming "
          f"{', '.join(TRACE_KERNELS)}; the profiler kept {kept} of the "
          f"{SACRIFICE_KERNELS} warm-up kernels", flush=True)


def trace_record_loss(path: str, warm_up: bool) -> dict:
    """Of one Chrome trace: the kernel launches whose kernel record is
    missing (with ``warm_up``, those of ``trace``'s warm-up kernels apart),
    which of K1, K2 and K3 it lacks, and the least kernel start minus its
    launch's (µs)."""
    from anomaly_detection_on_video_tpu_torch.utils.profiling import (SACRIFICE_KERNEL_NAME,
                                                                     SACRIFICE_KERNELS)

    with open(path) as f:
        text = f.read()
    events = json.loads(text)["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})
                and "LaunchKernel" in e["name"]}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = {e.get("args", {}).get("correlation") for e in kernels}
    gaps = [e["ts"] - launched[e["args"]["correlation"]] for e in kernels
            if e.get("args", {}).get("correlation") in launched]
    warm_lost = (SACRIFICE_KERNELS - sum(SACRIFICE_KERNEL_NAME in e["name"] for e in kernels)
                 if warm_up else 0)
    return {"lost": sum(c not in recorded for c in launched) - warm_lost,
            "warm_up_lost": warm_lost, "lacking": [n for n in TRACE_KERNELS if n not in text],
            "least_gap_us": round(min(gaps), 1) if gaps else None}


def probe_trace(passes: int, age_s: float = 15.0) -> int:
    """``python3 chip_smoke.py --trace-probe N`` (not part of the smoke's
    run): N rounds in one process, each a CUDA-only profiler session of
    three passes (as the smoke's kernel timing), one bf16 extraction pass
    of a 4-clip video under a profiler that starts recording at once
    (``trace`` without its warm-up kernels and margins), one under
    ``utils.profiling.trace``, then ``age_s`` seconds of passes outside any
    profiler, so the process ages as the smoke's does. Per round and way:
    the launches whose kernel record is missing (for ``trace``, those of
    its warm-up kernels and those of the pass apart), which of K1, K2 and
    K3 the trace lacks, and the least start of a kernel minus its launch's
    (correlated runtime call, µs on the trace's host clock; below 0 the
    device-to-host clock mapping put a kernel before its own launch).
    Prints one JSON line a round and a summary line."""
    import glob

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
    from anomaly_detection_on_video_tpu_torch.ops.kernels._build import build
    from anomaly_detection_on_video_tpu_torch.utils.profiling import trace

    def one_pass():
        extractor.extract_frames(video)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    build()
    video = np.random.RandomState(0).randint(0, 256, (64, 240, 320, 3), dtype=np.uint8)
    extractor = FeatureExtractor(dtype=torch.bfloat16, batch=40, device="cuda", seed=0)
    one_pass()
    work = tempfile.mkdtemp(prefix="trace_probe_")
    rounds = []
    try:
        for i in range(passes):
            with profile(activities=[ProfilerActivity.CUDA]):
                for _ in range(3):
                    one_pass()
            path = os.path.join(work, f"at_once{i}.json")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                one_pass()
            prof.export_chrome_trace(path)
            at_once = trace_record_loss(path, warm_up=False)
            with trace(os.path.join(work, f"trace{i}")):
                one_pass()
            traced = trace_record_loss(
                glob.glob(os.path.join(work, f"trace{i}", "*.pt.trace.json"))[0], warm_up=True)
            rounds.append({"round": i, "age_s": round(time.perf_counter() - t0, 1),
                           "at once": at_once, "trace": traced})
            print(json.dumps(rounds[-1]), flush=True)
            until = time.perf_counter() + age_s
            while time.perf_counter() < until:
                extractor.extract_frames(video)
            torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"{smi_line()}", flush=True)
    print(json.dumps({
        "rounds": passes, "age_s": round(time.perf_counter() - t0, 1),
        "at once: most kernel records lost": max(r["at once"]["lost"] for r in rounds),
        "at once: rounds lacking K1, K2 or K3": sum(bool(r["at once"]["lacking"]) for r in rounds),
        "trace: most kernel records of the pass lost": max(r["trace"]["lost"] for r in rounds),
        "trace: most warm-up records lost": max(r["trace"]["warm_up_lost"] for r in rounds),
        "trace: rounds lacking K1, K2 or K3": sum(bool(r["trace"]["lacking"]) for r in rounds),
        "least kernel start minus its launch, us": min(
            r[w]["least_gap_us"] for r in rounds for w in ("at once", "trace")
            if r[w]["least_gap_us"] is not None)}), flush=True)
    return 0


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


# --------------------------------------------------- phase 16: the user tools

TOOLS = "anomaly_detection_on_video_tpu_torch.scripts"


def run_tool(root: str, name: str, argv: list, tag: str = None, timeout: float = 900):
    """``python -m <TOOLS>.<name> argv`` as a process of its own, from the
    repository root, each process of it (the tool's CLI children and
    spawned ranks too) appending its kernel launches at exit to
    ``<root>/<tag>_launches.jsonl`` (``ANOMALY_TORCH_LAUNCH_LOG``). Raises
    on a nonzero exit. Returns (stdout, launch records, seconds)."""
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    tag = tag or name
    log = os.path.join(root, f"{tag}_launches.jsonl")
    if os.path.exists(log):
        os.remove(log)
    env = dict(os.environ, PYTHONUNBUFFERED="1", **{kernels.LAUNCH_LOG_ENV: log})
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    with open(os.path.join(root, f"{tag}.log"), "w+") as err:
        result = subprocess.run([sys.executable, "-m", f"{TOOLS}.{name}", *map(str, argv)],
                                cwd=here, env=env, stdout=subprocess.PIPE, stderr=err, text=True,
                                timeout=timeout)
        seconds = time.perf_counter() - start
        if result.returncode:
            err.seek(0)
            raise AssertionError(f"{TOOLS}.{name} exited {result.returncode}: "
                                 f"{result.stdout[-3000:]} {err.read()[-3000:]}")
    records = []
    if os.path.exists(log):
        with open(log) as f:
            records = [json.loads(line) for line in f]
    return result.stdout, records, seconds


def launches_of(records: list, module: str) -> dict:
    """The kernel launches summed over the processes whose program is
    ``module`` (a ``python -m`` process's ``argv[0]`` is the module's file)."""
    total = {}
    for record in records:
        if record["argv"] and record["argv"][0].endswith(module.replace(".", os.sep) + ".py"):
            for name, count in record["launches"].items():
                total[name] = total.get(name, 0) + count
    return total


def check_demo(root: str) -> None:
    """Phase 16 (a): ``demo --epochs 16`` on the card."""
    import numpy as np

    work = os.path.join(root, "demo")
    out, records, seconds = run_tool(root, "demo", ["--workdir", work, "--epochs", "16",
                                                    "--device", "cuda"])
    feats = np.load(os.path.join(work, "features", "test", "Demo001_x264_i3d.npy"))
    if feats.ndim != 3 or feats.shape[1:] != (10, 2048) or not np.isfinite(feats).all():
        raise AssertionError(f"demo features: shape {feats.shape}")
    match = re.search(r"trained MGFN frame-level AUC: ([0-9.]+)", out)
    auc = float(match.group(1)) if match else float("nan")
    if not auc >= 0.7:
        raise AssertionError(f"demo AUC {auc} below 0.7: {out[-2000:]}")
    if not os.path.isfile(os.path.join(work, "scorer_export", "manifest.json")):
        raise AssertionError("demo: no manifest.json in the export")
    if "demo complete" not in out:
        raise AssertionError(f"demo did not complete: {out[-2000:]}")
    counts = launches_of(records, "anomaly_detection_on_video_tpu_torch.extract_features")
    if not all(counts.get(k, 0) >= 1 for k in ("ten_crop_standardize", "stem_conv_pool",
                                                "bottleneck_block")):
        raise AssertionError(f"demo extraction: K1-K3 launches {counts}")
    print(f"phase 16 (a) demo --epochs 16: features {tuple(feats.shape)}, MGFN frame AUC "
          f"{auc:.3f} (gate >= 0.7), export manifest written; extract_features launches "
          f"{json.dumps(counts)}; {len(records)} processes logged; wall {seconds:.1f} s",
          flush=True)


def write_mjpg(path: str, frames) -> None:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (frames.shape[2], frames.shape[1]))
    if not writer.isOpened():
        raise AssertionError(f"cv2 cannot write {path}")
    for frame in frames:
        writer.write(frame)
    writer.release()


def check_operating_point(root: str, checkpoint: str, weights: str) -> None:
    """Phase 16 (b): ``infer`` on the card over four ``int8_e2e`` corpus
    videos saved as MJPG, with phase 8's MGFN and phase 10's weights, then
    ``operating_point`` over its score JSONs and a ground truth that marks
    the anomalous halves."""
    from anomaly_detection_on_video_tpu_torch.scripts.int8_e2e import gt_frames, synth_video

    videos = os.path.join(root, "op_videos")
    os.makedirs(videos, exist_ok=True)
    gt, n_frames = {}, 64
    for i in range(4):
        anomalous = i % 2 == 1
        stem = f"{'Abuse' if anomalous else 'Normal_Videos'}{i:03d}_x264"
        write_mjpg(os.path.join(videos, f"{stem}.avi"), synth_video(n_frames, anomalous, 10 + i))
        gt[stem] = gt_frames(n_frames, n_frames // 16, anomalous)
    with open(os.path.join(root, "op_gt.json"), "w") as f:
        json.dump(gt, f)
    scores = os.path.join(root, "op_scores")
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, "-m", "anomaly_detection_on_video_tpu_torch.infer", "--videos", videos,
         "--outdir", scores, "--checkpoint", checkpoint, "--i3d-weights", weights, "--device",
         "cuda"], cwd=here, capture_output=True, text=True, timeout=600)
    if result.returncode:
        raise AssertionError(f"infer exited {result.returncode}: {result.stderr[-3000:]}")
    infer_s = time.perf_counter() - start
    out, _, seconds = run_tool(root, "operating_point", [
        "--scores", scores, "--gt", os.path.join(root, "op_gt.json"), "--per-video",
        "--per-class"])
    report = json.loads(out.strip().splitlines()[-1])
    best = report["best_f1"]
    if report["videos"] != 4 or not (0.0 <= report["roc_auc"] <= 1.0 and 0.0 <= report["pr_auc"]
                                     <= 1.0) or not 0.0 <= best["threshold"] <= 1.0:
        raise AssertionError(f"operating_point: {report}")
    print(f"phase 16 (b) operating_point over infer's scores of 4 MJPG corpus videos (infer "
          f"{infer_s:.1f} s, the tool {seconds:.1f} s): frames {report['frames']}, positive "
          f"{report['positive_frames']}, roc_auc {report['roc_auc']}, pr_auc {report['pr_auc']}, "
          f"best F1 {best['f1']} at threshold {best['threshold']:.6f} (precision "
          f"{best['precision']}, recall {best['recall']}), at_target_fpr "
          f"{json.dumps(report['at_target_fpr'])}, far {report['far']}", flush=True)


def check_round_trip(root: str, kind: str, src: str, want: dict) -> tuple:
    """``convert_checkpoint --kind kind src`` to ``.msgpack`` and back with
    ``--reverse``: every tensor of ``want`` bit-equal (dtype, shape,
    values) but BatchNorm's ``num_batches_tracked``, which comes back 0.
    Returns (the .msgpack path, tensors compared, seconds)."""
    import torch

    msgpack = os.path.join(root, f"{kind}.msgpack")
    back = os.path.join(root, f"{kind}_back.pt")
    _, _, forward_s = run_tool(root, "convert_checkpoint", ["--kind", kind, src, msgpack],
                               tag=f"convert_{kind}")
    _, _, reverse_s = run_tool(root, "convert_checkpoint", ["--kind", kind, "--reverse", msgpack,
                                                            back], tag=f"reverse_{kind}")
    got = torch.load(back, map_location="cpu", weights_only=True)
    compared = 0
    for key, value in want.items():
        value = value.detach().cpu()
        if key.endswith("num_batches_tracked"):
            if int(got[key]) != 0:
                raise AssertionError(f"{kind} round trip: {key} = {got[key]}")
            continue
        if got[key].dtype != value.dtype or not torch.equal(got[key], value):
            raise AssertionError(f"{kind} round trip: {key} differs")
        compared += 1
    if set(got) != set(want):
        raise AssertionError(f"{kind} round trip keys: {sorted(set(got) ^ set(want))}")
    return msgpack, compared, forward_s + reverse_s


def check_conversions(root: str, checkpoint: str, weights: str) -> None:
    """Phase 16 (c): phase 8's MGFN checkpoint and phase 10's i3res50
    ``.pt`` to ``.msgpack`` and back on a machine without JAX (the two
    chains at once), and ``infer.load_i3d_weights`` of the ``.msgpack``
    against the ``.pt``."""
    import threading

    import torch

    from anomaly_detection_on_video_tpu_torch.infer import load_i3d_weights
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer

    step = TopKCheckpointer(checkpoint).latest_step()
    state = os.path.join(root, "mgfn_checkpoint.pt")  # the weights of the run's orbax step
    torch.save(checkpoint_weights(checkpoint, step), state)
    chains = {"mgfn-hf": (state, torch.load(state, map_location="cpu", weights_only=True)),
              "i3d": (weights, torch.load(weights, map_location="cpu", weights_only=True))}
    results, errors = {}, []

    def chain(kind):
        try:
            results[kind] = check_round_trip(root, kind, *chains[kind])
        except BaseException as exc:  # re-raised below, on the main thread
            errors.append(exc)

    threads = [threading.Thread(target=chain, args=(kind,)) for kind in chains]
    start = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    wall = time.perf_counter() - start
    loaded = load_i3d_weights(results["i3d"][0], "tushar-n-baseline")
    pt = chains["i3d"][1]
    for key, value in pt.items():
        if not key.endswith("num_batches_tracked") and not torch.equal(loaded[key],
                                                                       value.detach().cpu()):
            raise AssertionError(f"load_i3d_weights(.msgpack): {key} differs from the .pt")
    print(f"phase 16 (c) convert_checkpoint round trips, bit-equal: mgfn-hf (phase 8's orbax "
          f"step {step}, restored) {results['mgfn-hf'][1]} tensors, i3d (phase 10's i3res50.pt, "
          f"{os.path.getsize(results['i3d'][0]) / 1e6:.1f} MB .msgpack) {results['i3d'][1]} "
          f"tensors; num_batches_tracked back as 0; load_i3d_weights(.msgpack) equals the .pt; "
          f"wall {wall:.1f} s for both chains at once (four processes)", flush=True)


def check_convergence(root: str) -> dict:
    """Phase 16 (d): ``convergence_bench`` at its defaults."""
    out = os.path.join(root, "convergence.json")
    stdout, _, seconds = run_tool(root, "convergence_bench", ["--out", out, "--device", "cuda"])
    with open(out) as f:
        report = json.load(f)
    failed = {m: s["best_auc_per_seed"] for m, s in report["summary"].items()
              if not all(a > 0.8 for a in s["best_auc_per_seed"])}
    if failed or len(report["summary"]) != 3:
        raise AssertionError(f"convergence: best AUC not > 0.8: {failed}")
    for model, summary in report["summary"].items():
        print(f"phase 16 (d) convergence {model}: best AUC per seed "
              f"{[round(a, 4) for a in summary['best_auc_per_seed']]}, final "
              f"{[round(a, 4) for a in summary['final_auc_per_seed']]}", flush=True)
    for seed, run in report["reference_hparams_full_scale"]["per_seed"].items():
        if run["error"] is not None and run["diverged_at_epoch"] is None:
            raise AssertionError(f"convergence full-scale seed {seed}: {run['error']} without a "
                                 "recorded divergence")
        print(f"phase 16 (d) full-scale MGFN (lr 1e-3, batch 16, 8 epochs, 2048-d) seed {seed}: "
              f"finite {run['finite']}, diverged at epoch {run['diverged_at_epoch']}, error "
              f"{run['error']}, AUCs {[round(a, 4) for a in run['rec_auc']]}, losses "
              f"{[round(v, 4) for v in run['train_loss_epoch']]} (a divergence recorded, not gated)",
              flush=True)
    print(f"phase 16 (d) convergence_bench: {seconds:.1f} s; "
          f"{'figure' if 'no figure' not in stdout else 'no figure (no matplotlib)'}", flush=True)
    return report


def check_int8_e2e(root: str) -> dict:
    """Phase 16 (e): ``int8_e2e`` at its defaults (12 videos of 256 frames,
    150 steps, seeds 0 1 2)."""
    import numpy as np

    out = os.path.join(root, "int8_e2e.json")
    _, records, seconds = run_tool(root, "int8_e2e", ["--out", out, "--device", "cuda"])
    with open(out) as f:
        report = json.load(f)
    aucs = [r[part][key] for r in report["per_seed"] for part in ("tencrop", "center_serving")
            for key in ("auc_bf16", "auc_int8")]
    if len(report["per_seed"]) != 3 or not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"int8_e2e AUCs: {aucs}")
    counts = launches_of(records, f"{TOOLS}.int8_e2e")
    if not all(counts.get(k, 0) >= 1 for k in ("ten_crop_standardize", "stem_conv_pool",
                                                "bottleneck_block", "int8_matmul", "int8_conv")):
        raise AssertionError(f"int8_e2e launches: {counts}")
    agg = report["aggregate"]
    for key in ("int8_auc_delta_tencrop", "int8_auc_delta_center", "int8_max_score_delta_tencrop",
                "int8_max_score_delta_center", "protocol_auc_cost_center_vs_tencrop_bf16",
                "auc_bf16_tencrop", "auc_bf16_center"):
        print(f"phase 16 (e) int8_e2e {key}: per seed {agg[key]['per_seed']}, mean "
              f"{agg[key]['mean']}", flush=True)
    print(f"phase 16 (e) int8_e2e: 3 seeds x 12 videos x 16 clips x 4 variants on "
          f"{report['device']}; launches {json.dumps(counts)} (K4 and K5 by the int8 variants "
          f"alone); {seconds:.1f} s", flush=True)
    return report


def check_tp_audit(root: str) -> None:
    """Phase 16 (f): ``tp_audit`` (the step timed at the mesh shapes the
    card count allows)."""
    import numpy as np
    import torch

    out = os.path.join(root, "tp_audit.json")
    _, _, seconds = run_tool(root, "tp_audit", ["--out", out, "--device", "cuda"])
    with open(out) as f:
        report = json.load(f)
    for row in report["audit"]:
        if row["family"] == "sultani" and (row["sharded_bytes_frac"] < 0.999 or abs(
                row["memory_vs_replicated"] - 1.0 / row["tp"]) >= 1e-3):
            raise AssertionError(f"tp_audit sultani: {row}")
        print(f"phase 16 (f) tp_audit {row['family']} tp {row['tp']}: total "
              f"{row['total_mib']} MiB, sharded bytes {row['sharded_bytes_frac']}, leaves "
              f"{row['sharded_leaf_frac']}, per device {row['per_device_mib']} MiB "
              f"({row['memory_vs_replicated']} of replicated)", flush=True)
    timed = report["mgfn_step_time_cuda"]
    ran = [r for r in timed if "skipped" not in r]
    if len(ran) < 1 or not all(np.isfinite(r["loss"]) for r in ran):
        raise AssertionError(f"tp_audit timing: {timed}")
    n = torch.cuda.device_count()
    if any("skipped" in r and r["mesh"]["data"] * r["mesh"]["model"] <= n for r in timed):
        raise AssertionError(f"tp_audit skipped a mesh that {n} card(s) allow: {timed}")
    print(f"phase 16 (f) tp_audit full-size MGFN step, {n} card(s): {json.dumps(timed)}; "
          f"{seconds:.1f} s", flush=True)


def check_user_tools(torch, root: str, checkpoint: str, weights: str) -> None:
    """Phase 16: the repository's user tools of ``scripts/``, ported, run
    as a user runs them (``python -m``) on the card: (a), (b)-(c), (d) and
    (e) at once (their gates are outcomes, not times; the demo ran alone
    until the script grew past phase 21); then (f), whose step times want
    the card to itself."""
    import threading

    start = time.perf_counter()
    torch.cuda.empty_cache()
    errors = []

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as exc:  # re-raised below, on the main thread
            errors.append(exc)

    def tools_over_checkpoints():
        check_conversions(root, checkpoint, weights)
        check_operating_point(root, checkpoint, weights)

    threads = [threading.Thread(target=guarded, args=(fn, *args)) for fn, args in (
        (check_demo, (root,)), (tools_over_checkpoints, ()), (check_convergence, (root,)),
        (check_int8_e2e, (root,)))]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    if errors:
        raise errors[0]
    print(f"phase 16 (a)-(e) at once: {time.perf_counter() - t0:.1f} s", flush=True)
    check_tp_audit(root)
    print(f"user tools phase (16): {time.perf_counter() - start:.1f} s", flush=True)


# ------------- phase 17: the HF cache, parity_check and dynamics_ab

HUB_WEIGHTS = "hf://jinmang2/test_video_fe/converted_ref_i3d.pt"
FEATURE_REPO = "jinmang2/ucf_crime_tencrop_i3d_seg32"
K123 = ("ten_crop_standardize", "stem_conv_pool", "bottleneck_block")
PARITY_BOUNDS = {"float32": 1e-3, "float64": 1e-8}  # the JAX tests' 1e-3; float64's regime


def hub_put(cache: str, repo_id: str, revision: str, relpath: str, src: str,
            repo_type: str = "model") -> str:
    """The file ``src`` as ``relpath`` of ``repo_id`` at ``revision`` in the
    Hugging Face cache layout under ``cache``: a blob named by its sha256, a
    snapshot symlink to it, a ref naming the snapshot's commit."""
    import hashlib

    storage = os.path.join(cache, "--".join([f"{repo_type}s", *repo_id.split("/")]))
    digest = hashlib.sha256()
    with open(src, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    blob = os.path.join(storage, "blobs", digest.hexdigest())
    os.makedirs(os.path.dirname(blob), exist_ok=True)
    shutil.copyfile(src, blob)
    commit = hashlib.sha1(f"{repo_id}@{revision}".encode()).hexdigest()
    link = os.path.join(storage, "snapshots", commit, *relpath.split("/"))
    os.makedirs(os.path.dirname(link), exist_ok=True)
    os.symlink(os.path.relpath(blob, os.path.dirname(link)), link)
    os.makedirs(os.path.join(storage, "refs"), exist_ok=True)
    with open(os.path.join(storage, "refs", revision), "w") as f:
        f.write(commit)
    return link


def write_hub_cache(root: str, weights: str) -> str:
    """Phase 17 (a)'s cache under ``root``: phase 10's i3res50 weights as
    the reference's model repo file, and phase 8's bags (``root/data``) as
    the reference's feature repo: ``train.zip`` and ``test.zip`` at
    ``refs/tushar-n``, ``ground_truth.json`` at ``refs/main``."""
    cache = os.path.join(root, "hf_cache")
    hub_put(cache, "jinmang2/test_video_fe", "main", "converted_ref_i3d.pt", weights)
    for split, path in feature_repo_files(root).items():
        if split == "ground_truth":
            hub_put(cache, FEATURE_REPO, "main", "ground_truth.json", path, "dataset")
        else:
            hub_put(cache, FEATURE_REPO, "tushar-n", f"{split}.zip", path, "dataset")
    return cache


def feature_repo_files(root: str) -> dict:
    """Phase 8's bags (``root/data``, written at first use) as the feature
    repo's files: ``root/train.zip``, ``root/test.zip`` (written once) and
    the ground truth."""
    import zipfile

    data = os.path.join(root, "data")
    if not os.path.isdir(data):
        write_training_data(data)
    files = {}
    for split in ("train", "test"):
        archive = files[split] = os.path.join(root, f"{split}.zip")
        if not os.path.exists(archive):
            with zipfile.ZipFile(archive, "w") as z:
                for name in sorted(os.listdir(os.path.join(data, split))):
                    z.write(os.path.join(data, split, name), f"{split}/{name}")
    files["ground_truth"] = os.path.join(data, "ground_truth.json")
    return files


def untimed(record: dict) -> dict:
    return {k: v for k, v in record.items() if k != "time" and not k.endswith("_time_s")}


def check_hub(torch, root: str, weights: str) -> None:
    """Phase 17 (a), with ``HF_HUB_CACHE`` at the cache and cuDNN's
    deterministic algorithms: ``extract_features --weights hf://...``
    (stand-in decode, one 24-clip video) bit-equal to the same file by
    path, K1-K3 launched in each; an uncached spec exits with one line;
    a 3-step ``run runner=mgfn`` with no data path (the config's
    ``revision: tushar-n``) equal to the run on the same bags by path."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import extract_features
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    start = time.perf_counter()
    cache = write_hub_cache(root, weights)
    saved = os.environ.get("HF_HUB_CACHE"), torch.backends.cudnn.deterministic
    os.environ["HF_HUB_CACHE"] = cache
    torch.backends.cudnn.deterministic = True
    try:
        videos = os.path.join(root, "hub_videos")
        os.makedirs(videos)
        open(os.path.join(videos, "Abuse030_x264.mp4"), "wb").close()  # the stand-in decodes it
        common = ["--videos", videos, "--device", "cuda", "--decode-workers", "1",
                  "--no-segments"]
        feats, launches = {}, {}
        for label, spec in (("path", weights), ("hf", HUB_WEIGHTS)):
            out = os.path.join(root, f"hub_{label}")
            kernels.reset_launch_counts()
            with stand_in_decode():
                run_cli(extract_features, common + ["--outdir", out, "--weights", spec])
            launches[label] = kernels.launch_counts()
            feats[label] = np.load(os.path.join(out, "Abuse030_x264_i3d.npy"))
            if feats[label].shape != (24, 10, FEATURE_DIM) or min(
                    launches[label][k] for k in K123) < 1:
                raise AssertionError(f"extract_features --weights {spec}: features "
                                     f"{feats[label].shape}, launches {launches[label]}")
        if not np.array_equal(feats["hf"], feats["path"]):
            raise AssertionError("extract_features: hf:// weights' features differ from the "
                                 "same file's by path")
        missing = HUB_WEIGHTS.replace("test_video_fe/", "test_video_fe@nope/")
        try:
            run_cli(extract_features, common + ["--outdir", os.path.join(root, "hub_x"),
                                                "--weights", missing])
        except SystemExit as exc:
            message = exc.code
        else:
            raise AssertionError(f"extract_features --weights {missing} did not exit")
        if not isinstance(message, str) or missing not in message or "\n" in message:
            raise AssertionError(f"an uncached spec's exit: {message!r}")
        print(f"phase 17 (a) extract_features --weights {HUB_WEIGHTS}: (24, 10, 2048) features "
              f"bit-equal to the file by path; launches {launches['hf']} (path: "
              f"{launches['path']}); an uncached spec exits 1: {message}", flush=True)

        records = {}
        for mode in ("path", "cache"):
            overrides = dict(training_overrides(root, "mgfn", f"p17_{mode}"),
                             **{"trainer.max_steps": 3, "trainer.max_epochs": 2,
                                "trainer.eval_every": 2, "trainer.checkpoint.dirpath": None})
            if mode == "cache":
                overrides.update({"data.train_path": None, "data.test_path": None,
                                  "data.ground_truth_path": None})
            run_training(overrides)
            with open(overrides["trainer.log_path"]) as f:
                records[mode] = [untimed(json.loads(line)) for line in f]
        losses = [r["train_loss"] for r in records["cache"] if "train_loss" in r]
        aucs = [r["valid/rec_auc"] for r in records["cache"] if "valid/rec_auc" in r]
        if records["cache"] != records["path"] or len(losses) != 3 or not aucs:
            raise AssertionError(f"run from the cache: {records['cache']} against the run by "
                                 f"path: {records['path']}")
        print(f"phase 17 (a) run runner=mgfn from the cache (no data path, revision tushar-n): "
              f"losses {losses}, rec_auc {aucs}, records equal to the run by path; "
              f"{time.perf_counter() - start:.1f} s", flush=True)
    finally:
        if saved[0] is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved[0]
        torch.backends.cudnn.deterministic = saved[1]


def check_parity(torch, root: str, weights: str, checkpoint: str) -> None:
    """Phase 17 (b): ``parity_check`` on two MJPG videos (32 seeded 240x320
    frames each) with phase 10's weights and phase 8's MGFN, in float32 and
    float64, and the AUC summary over phase 8's test features. Gates:
    stages and features within ``PARITY_BOUNDS``, the float32 pipeline
    within 1e-3 in both runs, MGFN scores within 1e-4, K1-K3 launched by the
    pipeline, AUCs in [0, 1]; a perturbed ``layer4`` conv on the oracle's
    side raises the features' difference over 10x."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.ops import kernels
    from anomaly_detection_on_video_tpu_torch.scripts import parity_check
    start = time.perf_counter()
    videos = os.path.join(root, "parity_videos")
    os.makedirs(videos)
    gen = np.random.default_rng(17)
    for name in ("Abuse031_x264.avi", "Normal_Videos_016_x264.avi"):
        write_mjpg(os.path.join(videos, name),
                   gen.integers(0, 256, (32, 240, 320, 3), dtype=np.uint8))
    mgfn = os.path.join(root, "mgfn_hf.pt")
    torch.save(checkpoint_weights(checkpoint), mgfn)
    data = os.path.join(root, "data")
    reports = {}
    for dtype, bound in PARITY_BOUNDS.items():
        out = os.path.join(root, f"parity_{dtype}.json")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = parity_check.main([
                "--videos", videos, "--i3d-weights", weights, "--mgfn-weights", mgfn,
                "--test-features", os.path.join(data, "test"),
                "--gt", os.path.join(data, "ground_truth.json"), "--dtype", dtype,
                "--max-frames", "32", "--device", "cuda", "--out", out])
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        reports[dtype] = report
        auc = report["auc"]
        lines = []
        for name, rep in report["i3d"].items():
            diffs = rep["max_abs_diff"]
            score = report["mgfn_scores"][name]["max_abs_diff"]
            pipe = rep["pipeline"]["max_abs_diff"]
            if (rep["missing_keys"] or rep["n_clips"] != 2 or max(diffs.values()) >= bound
                    or pipe >= 1e-3 or score >= 1e-4):
                raise AssertionError(f"parity_check {dtype} {name}: {json.dumps(rep)}, MGFN "
                                     f"scores {score}")
            lines.append(f"{name}: " + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
                         + f", pipeline {pipe:.3e}, MGFN scores {score:.3e}")
        if min(counts[k] for k in K123) < 1 or not all(
                0.0 <= auc[side][key] <= 1.0 for side in ("port", "torch")
                for key in ("rec_auc", "pr_auc")):
            raise AssertionError(f"parity_check {dtype}: launches {counts}, auc {auc}")
        print(f"phase 17 (b) parity_check --dtype {dtype} (max |diff| against the oracle): "
              + "; ".join(lines) + f"; AUC port {auc['port']} torch {auc['torch']} (rec_auc diff "
              f"{auc['rec_auc_diff']:.3e}); pipeline launches {counts}; {seconds:.1f} s",
              flush=True)
    path = sorted(os.listdir(videos))[0]
    frames = parity_check.decode_frames(os.path.join(videos, path), 32)
    clean = torch.load(weights, map_location="cpu", weights_only=True)
    perturbed = {k: v.clone() for k, v in clean.items()}
    key = "layer4.0.conv2.weight"
    perturbed[key] += 0.1 * torch.randn(perturbed[key].shape,
                                        generator=torch.Generator().manual_seed(2))
    report, _ = parity_check.i3d_stage_parity(frames, perturbed, "float32", 2, "cuda",
                                              port_state_dict=clean)
    base = reports["float32"]["i3d"][path]["max_abs_diff"]["features"]
    moved = report["max_abs_diff"]["features"]
    if not moved > 10 * max(base, 1e-6):
        raise AssertionError(f"a perturbed layer4 conv: features diff {moved} against {base}")
    print(f"phase 17 (b) a perturbed layer4.0.conv2 on the oracle's side: features diff "
          f"{moved:.3e} against {base:.3e} clean ({moved / max(base, 1e-12):.3g}x); "
          f"{time.perf_counter() - start:.1f} s", flush=True)


NORM_STEPS = 3  # float64 steps held from random norms
NORM_RTOL = 1e-10  # relative loss gap allowed on each of them (float64 losses, unrounded)


def check_dynamics(torch, root: str) -> None:
    """Phase 17 (c): ``dynamics_ab`` at its defaults (full-width MGFN, 8 + 8
    bags, 30 steps, lr 1e-3 and 3e-5, both profiles), both sides on the
    card. Gate: the sides agree on finite-or-NaN at every point. Then both
    sides again at full width, in float64, from the oracle's init with
    random LayerNorm gains and biases, which untie the top-k picks: at each
    (profile, lr) the first ``NORM_STEPS`` losses within ``NORM_RTOL``
    relative. In float32 the sides' rounding alone parts Adam's first
    steps by up to about as much as a wrong gradient term does; float64
    leaves only a wrong step to show."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch.models import build_model
    from anomaly_detection_on_video_tpu_torch.scripts import dynamics_ab
    from anomaly_detection_on_video_tpu_torch.scripts.parity_check import (
        oracle_to_hf_state_dict, oracles)

    start = time.perf_counter()
    out = os.path.join(root, "dynamics_ab.json")
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        report = dynamics_ab.main(["--out", out, "--device", "cuda"])
    for key, run in report["runs"].items():
        port, ref = run["port"]["losses"], run["torch"]["losses"]
        gap = max(abs(a - b) for a, b in zip(port, ref))
        print(f"phase 17 (c) {key}: nan_step port {run['port']['nan_step']} torch "
              f"{run['torch']['nan_step']}; last losses port {port[-1]:.6g} torch "
              f"{ref[-1]:.6g}; first {port[0]:.6g} / {ref[0]:.6g}; largest per-step gap "
              f"{gap:.3e}; agree {run['frameworks_agree']}", flush=True)
    if not all(run["frameworks_agree"] for run in report["runs"].values()):
        raise AssertionError(f"dynamics_ab: {report['verdict']}")
    print(f"phase 17 (c) dynamics_ab: {report['verdict']}; {time.perf_counter() - start:.1f} s",
          flush=True)

    start = time.perf_counter()
    torch_oracles = oracles()
    torch.manual_seed(0)
    oracle = torch_oracles.OracleMGFN()
    torch_oracles.randomize_bn_stats(oracle, seed=1)
    dynamics_ab.randomize_norms(oracle, seed=2)
    init = {k: v.detach().clone() for k, v in oracle.state_dict().items()}
    worst = 0.0
    for profile in ("gauss", "i3dlike"):
        batches = [tuple(a.astype(np.float64) for a in batch)
                   for batch in dynamics_ab.make_batches(profile, 100, NORM_STEPS)]
        for lr in dynamics_ab.LRS:
            with contextlib.redirect_stderr(io.StringIO()):
                ref = dynamics_ab.run_torch(lambda: torch_oracles.OracleMGFN().double(), init,
                                            batches, lr, NORM_STEPS, "cuda")["losses"]
                port = dynamics_ab.run_port(
                    lambda: build_model("mgfn", dropout_rate=0.0)[1].double(),
                    oracle_to_hf_state_dict(init), batches, lr, NORM_STEPS, "cuda")["losses"]
            rel = [abs(a - b) / abs(b) for a, b in zip(port, ref)]
            print(f"phase 17 (c) random norms, float64, {profile} lr {lr:g}: losses port "
                  f"{[float(f'{v:.7g}') for v in port]} torch {[float(f'{v:.7g}') for v in ref]}; "
                  f"largest relative gap {max(rel):.3e}", flush=True)
            if len(port) != NORM_STEPS or len(ref) != NORM_STEPS or not max(rel) < NORM_RTOL:
                raise AssertionError(f"random norms, {profile} lr {lr:g}: losses part "
                                     f"(port {port}, torch {ref})")
            worst = max(worst, max(rel))
    print(f"phase 17 (c) random norms, float64: {NORM_STEPS} steps held at every (profile, lr), largest "
          f"relative gap {worst:.3e} (bound {NORM_RTOL:g}); "
          f"{time.perf_counter() - start:.1f} s", flush=True)


def check_reference_tools(torch, root: str, checkpoint: str, weights: str) -> None:
    """Phase 17: weights and features from a local Hugging Face cache,
    ``parity_check`` and ``dynamics_ab`` on the card."""
    start = time.perf_counter()
    torch.cuda.empty_cache()
    check_hub(torch, root, weights)
    check_parity(torch, root, weights, checkpoint)
    torch.cuda.empty_cache()
    check_dynamics(torch, root)
    print(f"reference tools phase (17): {time.perf_counter() - start:.1f} s", flush=True)


# ------------------------------------------ phase 18: eval figures, --figure

FIGURE_STEM = "Fig001_x264"
FIGURE_THRESHOLD = 0.5
# the body of phase 18 (a)'s --figure process: ``python -m ...infer`` as it
# is, where matplotlib imports also writing each saved figure's line data
# beside its PNG (``<png>.lines.json``)
FIGURE_CHILD = (
    "import importlib.util, json, runpy, sys\n"
    "if importlib.util.find_spec('matplotlib'):\n"
    "    from matplotlib.figure import Figure\n"
    "    save = Figure.savefig\n"
    "    def record(self, fname, *args, **kwargs):\n"
    "        with open(str(fname) + '.lines.json', 'w') as f:\n"
    "            json.dump([[list(map(float, line.get_ydata())) for line in ax.get_lines()]\n"
    "                       for ax in self.axes], f)\n"
    "        return save(self, fname, *args, **kwargs)\n"
    "    Figure.savefig = record\n"
    "runpy.run_module('anomaly_detection_on_video_tpu_torch.infer', run_name='__main__',\n"
    "                 alter_sys=True)\n")


def has_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def start_infer(root: str, tag: str, argv: list, figure: bool) -> tuple:
    """``infer argv`` as a process of its own (``FIGURE_CHILD`` with
    ``--figure``), its launches logged to ``<root>/<tag>_launches.jsonl``.
    Returns (the process, its log path, its stderr file)."""
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    log = os.path.join(root, f"{tag}_launches.jsonl")
    env = dict(os.environ, PYTHONUNBUFFERED="1", **{kernels.LAUNCH_LOG_ENV: log})
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = ([sys.executable, "-c", FIGURE_CHILD, *argv, "--figure"] if figure
           else [sys.executable, "-m", "anomaly_detection_on_video_tpu_torch.infer", *argv])
    err = open(os.path.join(root, f"{tag}.log"), "w+")
    return subprocess.Popen(cmd, cwd=here, env=env, stdout=err, stderr=subprocess.STDOUT,
                            text=True), log, err


def finish_infer(proc, log: str, err) -> tuple:
    """(exit code, output, summed launches) of a ``start_infer`` process."""
    try:
        code = proc.wait(600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    err.seek(0)
    output = err.read()
    err.close()
    launches = {}
    with open(log) as f:
        for line in f:
            for name, count in json.loads(line)["launches"].items():
                launches[name] = launches.get(name, 0) + count
    return code, output, launches


def check_infer_figure(torch, root: str, checkpoint: str, weights: str, video) -> None:
    """Phase 18 (a): ``infer --threshold 0.5`` over the 4-clip video saved
    as MJPG (OpenCV decode), phase 8's MGFN and phase 10's i3res50 weights,
    bf16 ten crops, as a process with ``--figure`` and one without, at once
    on the card; meanwhile ``--watch --figure`` in this process. Gates:
    each process launches K1 / K2 / K3 1 / 1 / 3 (one group); the score
    JSONs equal key for key but ``latency_s``; with matplotlib the
    ``--figure`` process exits 0 and ``<stem>_scores.png`` holds the frame
    scores and the threshold's line; without it (the card's machine) it
    exits non-zero with the ImportError naming matplotlib, as the JAX CLI
    does, its JSON on disk and no PNG; ``--watch --figure`` keeps the JSON,
    counts the figure's error (none with matplotlib) and writes no
    ``.error.json``, launching K1 / K2 / K3 1 / 1 / 3 between a reset and a
    read of the counts."""
    import numpy as np

    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    start = time.perf_counter()
    work = os.path.join(root, "figure")
    vids = os.path.join(work, "videos")
    os.makedirs(vids)
    write_mjpg(os.path.join(vids, f"{FIGURE_STEM}.avi"), video)
    common = ["--videos", vids, "--checkpoint", checkpoint, "--i3d-weights", weights,
              "--threshold", str(FIGURE_THRESHOLD)]
    out = {tag: os.path.join(work, tag) for tag in ("plain", "figure", "watch")}
    runs = {tag: start_infer(work, tag, common + ["--outdir", out[tag]], tag == "figure")
            for tag in ("plain", "figure")}

    kernels.reset_launch_counts()
    code = infer.main(common + ["--outdir", out["watch"], "--figure", "--watch",
                                "--poll-interval", "0.2", "--idle-exit", "2"])
    watch_launches = kernels.launch_counts()
    results = {tag: finish_infer(*run) for tag, run in runs.items()}

    want = {"ten_crop_standardize": 1, "stem_conv_pool": 1, "bottleneck_block": 3}
    for tag, launches in [(tag, r[2]) for tag, r in results.items()] + [("watch", watch_launches)]:
        if any(launches.get(k, 0) != n for k, n in want.items()):
            raise AssertionError(f"phase 18 (a) {tag}: launches {launches}, expected {want}")
    plain_code, plain_out, _ = results["plain"]
    fig_code, fig_out, _ = results["figure"]
    if plain_code != 0:
        raise AssertionError(f"infer without --figure exited {plain_code}: {plain_out[-3000:]}")
    name = f"{FIGURE_STEM}_scores"
    ref = json.load(open(os.path.join(out["plain"], f"{name}.json")))
    json_path = os.path.join(out["figure"], f"{name}.json")
    if not os.path.exists(json_path):
        raise AssertionError(f"infer --figure wrote no score JSON: {fig_out[-3000:]}")
    got = json.load(open(json_path))
    if {k: v for k, v in got.items() if k != "latency_s"} != {
            k: v for k, v in ref.items() if k != "latency_s"}:
        raise AssertionError(f"--figure's score JSON differs from the plain run's: {got} / {ref}")
    png = os.path.join(out["figure"], f"{name}.png")
    mpl = has_matplotlib()
    if mpl:
        lines = json.load(open(png + ".lines.json"))[0]
        if fig_code != 0 or not os.path.exists(png) or len(lines) != 2 or lines[1] != [
                FIGURE_THRESHOLD] * 2 or np.abs(np.subtract(lines[0], got["frame_scores"])).max() > 5e-7:
            raise AssertionError(f"infer --figure: exit {fig_code}, lines {lines}: "
                                 f"{fig_out[-3000:]}")
        outcome = f"exit 0, {name}.png with the {len(lines[0])} frame scores and the threshold"
    else:
        # ModuleNotFoundError is the ImportError of a module that is not installed
        error = next((line.strip() for line in reversed(fig_out.splitlines())
                      if re.match(r"(ModuleNotFound|Import)Error: .*matplotlib", line)), None)
        if fig_code == 0 or error is None or os.path.exists(png):
            raise AssertionError(f"infer --figure without matplotlib: exit {fig_code}: "
                                 f"{fig_out[-3000:]}")
        outcome = f"exit {fig_code}, '{error}', the JSON written, no PNG"
    watch_files = sorted(os.listdir(out["watch"]))
    stats = json.load(open(os.path.join(out["watch"], "_serving_stats.json")))
    errors = 0 if mpl else 1
    if code != 0 or f"{name}.json" not in watch_files or f"{name}.error.json" in watch_files or (
            stats["errors"] != errors or (f"{name}.png" in watch_files) != mpl):
        raise AssertionError(f"--watch --figure: exit {code}, files {watch_files}, stats {stats}")
    print(f"phase 18 (a) infer --figure --threshold {FIGURE_THRESHOLD} over a 64-frame MJPG video "
          f"(matplotlib {'present' if mpl else 'absent'}): {outcome}; its score JSON equal to "
          f"the run without --figure but latency_s ({got['n_clips']} clips, {len(got['events'])} "
          f"events); K1 / K2 / K3 1 / 1 / 3 in each process and in --watch --figure, which kept "
          f"the JSON, counted {stats['errors']} error(s) and wrote no .error.json "
          f"(files {watch_files}); {time.perf_counter() - start:.1f} s", flush=True)


def check_fit_figures(torch, root: str) -> None:
    """Phase 18 (b): a 2-epoch full-width MGFN ``run`` on the card with
    ``trainer.figure_dir`` and eval_every 1, and the same run without it,
    both under cuDNN's deterministic algorithms. Gates: two figures
    (``eval_epoch0000.png``, ``eval_epoch0001.png``) with matplotlib, or
    two ``warning: eval figure failed`` lines without it; the metrics
    records equal but their clock readings (``time``, ``epoch_time_s``),
    the same checkpoint steps, and the saved models bit-equal."""
    start = time.perf_counter()
    figs = os.path.join(root, "fit_figures")
    runs, printed = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag, extra in (("fig", {"trainer.figure_dir": figs}), ("nofig", {})):
            overrides = dict(training_overrides(root, "mgfn", f"figures_{tag}"),
                             **{"trainer.max_epochs": 2, "trainer.max_steps": -1,
                                "trainer.eval_every": 1}, **extra)
            printed[tag] = run_training(overrides, "mgfn")
            with open(overrides["trainer.log_path"]) as f:
                records = [{k: v for k, v in json.loads(line).items()
                            if k not in ("time", "epoch_time_s")} for line in f]
            ckpt = overrides["trainer.checkpoint.dirpath"]
            steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
            runs[tag] = (records, steps, [checkpoint_weights(ckpt, s) for s in steps])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    warnings = [line for line in printed["fig"].splitlines()
                if line.startswith("warning: eval figure failed")]
    files = sorted(os.listdir(figs)) if os.path.isdir(figs) else []
    if has_matplotlib():
        ok = files == ["eval_epoch0000.png", "eval_epoch0001.png"] and not warnings
    else:
        ok = not files and len(warnings) == 2 and "matplotlib" in warnings[0]
    (records, steps, models), (records0, steps0, models0) = runs["fig"], runs["nofig"]
    evals = [r for r in records if "valid/rec_auc" in r]
    same_models = all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                      for a, b in zip(models, models0))
    if not ok or records != records0 or steps != steps0 or not same_models or len(evals) != 2:
        raise AssertionError(f"fit with figure_dir: files {files}, warnings {warnings}, "
                             f"records equal {records == records0}, steps {steps} / {steps0}, "
                             f"models equal {same_models}")
    print(f"phase 18 (b) run runner=mgfn, 2 epochs with trainer.figure_dir: "
          f"{files if files else warnings[0]!r} ({len(files) or len(warnings)}x); metrics "
          f"records ({len(records)}, evals at steps {[r['step'] for r in evals]}) equal to the "
          f"run without it, checkpoints at steps {steps} bit-equal; "
          f"{time.perf_counter() - start:.1f} s", flush=True)


def check_figures(torch, root: str, checkpoint: str, weights: str, video) -> None:
    """Phase 18: ``infer --figure`` and ``fit``'s eval figures on the card."""
    start = time.perf_counter()
    check_infer_figure(torch, root, checkpoint, weights, video)
    check_fit_figures(torch, root)
    print(f"figures phase (18): {time.perf_counter() - start:.1f} s", flush=True)


# ------------------------------------ phase 19: the JAX package's orbax checkpoints

ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_mgfn")


def tree_digest(root: str) -> str:
    """sha256 over a directory's relative file paths and bytes."""
    import hashlib

    digest = hashlib.sha256()
    for dirpath, dirs, files in sorted(os.walk(root)):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(dirpath, name)
            digest.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                digest.update(f.read())
    return digest.hexdigest()


def fixture_overrides(data: str) -> dict:
    """The fixture's run overrides (``resume.json``) as ``run_training``
    takes them, its relative data paths under ``data``."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE,
                           "resume.json")) as f:
        ref = json.load(f)
    overrides = {}
    for item in ref["overrides"]:
        key, _, value = item.partition("=")
        if key == "runner":
            continue
        if key.startswith("data.") and key.endswith("_path"):
            value = os.path.join(data, value[len("data/"):])
        try:
            overrides[key] = json.loads(value)
        except ValueError:
            overrides[key] = value
    return overrides, ref


def check_orbax_infer(torch, work: str, copy: str, weights: str, video) -> None:
    """Phase 19 (a), (b)."""
    from anomaly_detection_on_video_tpu_torch import infer
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.orbax import read_orbax_step

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE)
    pt = os.path.join(fixture, "mgfn_step4.pt")
    _, ref = fixture_overrides("")
    model_config = [o[len("runner.model_config."):] for o in ref["overrides"]
                    if o.startswith("runner.model_config.")]
    vids = os.path.join(work, "videos")
    os.makedirs(vids)
    write_mjpg(os.path.join(vids, f"{FIGURE_STEM}.avi"), video)
    common = ["--videos", vids, "--i3d-weights", weights]
    out = {tag: os.path.join(work, tag) for tag in ("orbax", "weights")}
    runs = {"orbax": start_infer(work, "orbax", common + ["--checkpoint", copy, "--outdir",
                                                         out["orbax"]], False),
            "weights": start_infer(work, "weights", common + [
                "--torch-weights", pt, "--model", "mgfn", "--model-config", *model_config,
                "--outdir", out["weights"]], False)}
    results = {tag: finish_infer(*run) for tag, run in runs.items()}
    want = {"ten_crop_standardize": 1, "stem_conv_pool": 1, "bottleneck_block": 3}
    for tag, (code, output, launches) in results.items():
        if code != 0 or any(launches.get(k, 0) != n for k, n in want.items()):
            raise AssertionError(f"phase 19 (a) infer {tag}: exit {code}, launches {launches}, "
                                 f"expected {want}: {output[-3000:]}")
    name = f"{FIGURE_STEM}_scores.json"
    got, ref_json = (json.load(open(os.path.join(out[tag], name))) for tag in ("orbax", "weights"))
    if {k: v for k, v in got.items() if k != "latency_s"} != {
            k: v for k, v in ref_json.items() if k != "latency_s"}:
        raise AssertionError(f"infer --checkpoint <orbax dir> differs from --torch-weights: "
                             f"{got} / {ref_json}")
    print(f"phase 19 (a) infer --checkpoint <the JAX run's orbax directory> over a 64-frame MJPG "
          f"video: exit 0, K1 / K2 / K3 1 / 1 / 3 in each process, {got['n_clips']} clip "
          f"scores {got['clip_scores']} equal to --torch-weights mgfn_step4.pt's (the JAX "
          f"exporter's) but latency_s", flush=True)

    step_dir = os.path.join(copy, "4")
    t0 = time.perf_counter()
    read_orbax_step(step_dir)
    read_ms = (time.perf_counter() - t0) * 1e3
    args = argparse.Namespace(model=None, model_config=None, checkpoint=copy, torch_weights=None,
                              official=False, i3d_weights=None, checkpoint_step="latest",
                              device="cuda")
    build_ms = []
    for _ in range(2):  # the first also pays torch's lazy imports at its first optimizer load
        t0 = time.perf_counter()
        scorer, model_name = infer.build_scorer(args)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    sd = scorer.state_dict()
    exported = torch.load(pt, map_location="cpu", weights_only=True)
    params = [n for n, _ in scorer.named_parameters()]
    unequal = [k for k, v in exported.items() if k in sd and not torch.equal(sd[k].cpu(), v)]
    if model_name != "mgfn" or unequal or not set(params) <= set(exported):
        raise AssertionError(f"phase 19 (b): {model_name}, unequal {unequal}, missing "
                             f"{sorted(set(params) - set(exported))}")
    ckpt = TopKCheckpointer(copy)
    print(f"phase 19 (b) the restored scorer's state dict bit-equal to mgfn_step4.pt "
          f"({len(exported)} tensors, {sum(v.numel() for v in exported.values())} values); "
          f"steps {ckpt.all_steps()} (orbax: {[ckpt.is_orbax(s) for s in ckpt.all_steps()]}); "
          f"read_orbax_step of step 4 {read_ms:.1f} ms, build_scorer with its restore "
          f"{build_ms[0]:.1f} ms, then {build_ms[1]:.1f} ms (host clock)", flush=True)


def check_orbax_resume(torch, work: str, copy: str) -> None:
    """Phase 19 (c), (d)."""
    from anomaly_detection_on_video_tpu_torch.training.orbax import is_orbax_step
    from anomaly_detection_on_video_tpu_torch.utils.device import full_f32

    data = os.path.join(work, "data")
    write_training_data(data)
    overrides, ref = fixture_overrides(data)
    overrides.update({"trainer.max_epochs": ref["max_epochs"], "trainer.resume": True,
                      "trainer.log_path": os.path.join(work, "resume.jsonl"),
                      "trainer.checkpoint.dirpath": copy})
    with full_f32():
        printed = run_training(overrides, "mgfn")
    with open(overrides["trainer.log_path"]) as f:
        records = [json.loads(line) for line in f]
    want = ref["records"]
    gaps = [abs(g["train_loss"] - w["train_loss"]) / abs(w["train_loss"])
            for g, w in zip(records, want) if "train_loss" in w]
    steps = sorted(os.listdir(copy))
    kept = [s for s in ("2", "4") if is_orbax_step(os.path.join(copy, s))]
    if (f"resumed from step {ref['restored_step']}" not in printed
            or [r["step"] for r in records] != [r["step"] for r in want]
            or len(gaps) != 4 or max(gaps) > 1e-4 or kept != ["2", "4"]
            or steps != ["2", "4", "6", "8", "hparams.json"]):
        raise AssertionError(f"phase 19 (c): steps {[r['step'] for r in records]}, loss gaps "
                             f"{gaps}, directory {steps}, orbax steps kept {kept}: "
                             f"{printed[-3000:]}")
    aucs = [(r["valid/rec_auc"], r["valid/pr_auc"]) for r in records if "valid/rec_auc" in r]
    print(f"phase 19 (c) run trainer.resume=true on the JAX run's directory, 2 more epochs: "
          f"resumed from step {ref['restored_step']}, steps {[r['step'] for r in records]}, "
          f"losses {[r['train_loss'] for r in records if 'train_loss' in r]}, largest relative "
          f"gap to the JAX resumed run {max(gaps):.3e} (gate 1e-4), AUCs {aucs}; the "
          f"directory {steps} keeps the JAX steps {kept}", flush=True)

    lines = []
    for _ in range(2):
        with full_f32():
            printed = run_training(dict(overrides, **{"trainer.eval_only": True,
                                                      "trainer.resume": False,
                                                      "trainer.checkpoint_step": 4,
                                                      "trainer.log_path": None}), "mgfn")
        lines.append(json.loads(printed.strip().splitlines()[-1]))
    jax_eval = next(r for r in ref["train_records"] if r["step"] == 4 and "valid/rec_auc" in r)
    keys = ("valid/rec_auc", "valid/pr_auc")
    if (lines[0] != lines[1] or lines[0]["step"] != 4
            or not all(0.0 <= lines[0][k] <= 1.0 for k in keys)
            or any(abs(lines[0][k] - jax_eval[k]) > 1e-4 for k in keys)):
        raise AssertionError(f"phase 19 (d): eval_only {lines}, the JAX run's eval {jax_eval}")
    print(f"phase 19 (d) eval_only of orbax step 4, twice: rec_auc {lines[0]['valid/rec_auc']:.6f}"
          f", pr_auc {lines[0]['valid/pr_auc']:.6f} both times (the JAX run's eval of step 4: "
          f"{jax_eval['valid/rec_auc']:.6f}, {jax_eval['valid/pr_auc']:.6f})", flush=True)


def check_orbax(torch, root: str, weights: str, video) -> None:
    """Phase 19: the JAX package's orbax checkpoints through the port's
    entry points, on a copy of the committed fixture."""
    start = time.perf_counter()
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE)
    before = tree_digest(fixture)
    work = os.path.join(root, "orbax")
    copy = os.path.join(work, "run")
    shutil.copytree(os.path.join(fixture, "run"), copy)
    check_orbax_infer(torch, work, copy, weights, video)
    check_orbax_resume(torch, work, copy)
    check_jax_dir_steps(fixture, copy)
    if tree_digest(fixture) != before:
        raise AssertionError(f"phase 19 changed the committed fixture {fixture}")
    print(f"orbax phase (19): {time.perf_counter() - start:.1f} s; the fixture's bytes unchanged",
          flush=True)


# ------------------------- phase 20: a run trained on the card, written as orbax


def checkpoint_weights(checkpoint: str, step="latest") -> dict:
    """The model state dict of a ``run`` directory's step, restored on the
    CPU through ``infer.build_scorer`` (the checkpointer's restore, either
    format)."""
    from anomaly_detection_on_video_tpu_torch import infer

    args = argparse.Namespace(model=None, model_config=None, checkpoint=checkpoint,
                              torch_weights=None, official=False, i3d_weights=None,
                              checkpoint_step=str(step), device="cpu")
    scorer, _ = infer.build_scorer(args)
    return scorer.state_dict()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


@contextlib.contextmanager
def recorded_saves(torch):
    """Every ``TopKCheckpointer.save`` in the block recorded: the live
    state dicts and step copied to the host before the save (the state the
    save was given), the save's host ms, and ``torch.save`` of the same
    payload (the live state dicts, as the earlier port saved them) timed
    right after it into a scratch file, with both sizes on disk."""
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer

    original, saves = TopKCheckpointer.save, []

    def save(self, step, state, metric=None):
        model_sd, optimizer_sd = state.state_dicts()
        live = ({k: v.detach().cpu().clone() for k, v in model_sd.items()},
                {i: {k: v.detach().cpu().clone() for k, v in moments.items()}
                 for i, moments in optimizer_sd["state"].items()}, int(state.step))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = original(self, step, state, metric)
        save_ms = (time.perf_counter() - t0) * 1e3
        scratch = os.path.join(self.directory + ".torch_save", f"{step}.pt")
        os.makedirs(os.path.dirname(scratch), exist_ok=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.save({"model": model_sd, "optimizer": optimizer_sd, "step": int(state.step)},
                   scratch)
        torch_ms = (time.perf_counter() - t0) * 1e3
        saves.append({"step": step, "metric": metric, "live": live, "save_ms": save_ms,
                      "torch_save_ms": torch_ms, "bytes": dir_bytes(path),
                      "torch_save_bytes": os.path.getsize(scratch)})
        os.remove(scratch)
        return path

    TopKCheckpointer.save = save
    try:
        yield saves
    finally:
        TopKCheckpointer.save = original


def policy_steps(saves: list, top_k: int) -> list:
    """The steps the JAX checkpointer's orbax policy keeps after ``saves``
    (in order): the latest, and the ``top_k`` best by metric (ties to the
    newer); a step saved twice counts once, as its last save."""
    last = {}
    for record in saves:
        last[record["step"]] = record["metric"]
    steps = sorted(last)
    ranked = sorted((m, s) for s, m in last.items() if m is not None)
    return sorted({steps[-1]} | {s for _, s in ranked[-top_k:]})


def check_written_steps(torch, ckpt: str, saves: list) -> None:
    """Phase 20 (a)'s gates on a directory the port's ``run`` wrote: every
    step orbax and no ``state.pt``; the last step, read by
    ``read_orbax_step`` and loaded by ``train_state_from_orbax``, bit-equal
    to the live state recorded at its save."""
    from anomaly_detection_on_video_tpu_torch.models import MGFN
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
    from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
    from anomaly_detection_on_video_tpu_torch.training.orbax import is_orbax_step, read_orbax_step
    from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
    from anomaly_detection_on_video_tpu_torch.utils.convert import train_state_from_orbax

    steps = TopKCheckpointer(ckpt).all_steps()
    for s in steps:
        path = os.path.join(ckpt, str(s))
        if not is_orbax_step(path) or any("state.pt" in files for _, _, files in os.walk(path)):
            raise AssertionError(f"phase 20: step {s} of {ckpt} is not an orbax step: "
                                 f"{os.listdir(path)}")
    model_sd, moments, step = next(r["live"] for r in reversed(saves) if r["step"] == steps[-1])
    model = MGFN()
    state = train_state_from_orbax(read_orbax_step(os.path.join(ckpt, str(steps[-1]))), "mgfn",
                                   TrainState(model, adam_with_l2(model.parameters())))
    got_sd, got_opt = state.state_dicts()
    unequal = [k for k, v in model_sd.items() if not k.endswith("num_batches_tracked")
               and not (got_sd[k].dtype == v.dtype and torch.equal(got_sd[k], v))]
    unequal += [f"{i}.{k}" for i, m in moments.items() for k, v in m.items()
                if not torch.equal(got_opt["state"][i][k], v)]
    if state.step != step or sorted(got_sd) != sorted(model_sd) or unequal or sorted(
            got_opt["state"]) != sorted(moments):
        raise AssertionError(f"phase 20: step {steps[-1]} restored unequal to the live state: "
                             f"step {state.step} / {step}, {unequal[:10]}")


def print_saves(part: str, saves: list) -> None:
    """One line for each save ``recorded_saves`` timed: the orbax save's
    host ms and bytes beside ``torch.save``'s of the same payload."""
    for r in saves:
        print(f"phase 20 {part} save of step {r['step']}: host {r['save_ms']:.1f} ms, "
              f"{r['bytes']} bytes on disk (orbax); torch.save of the same payload "
              f"{r['torch_save_ms']:.1f} ms, {r['torch_save_bytes']} bytes; card {smi_line()}",
              flush=True)


def check_orbax_written(torch, root: str, weights: str, video) -> None:
    """Phase 20: a full-width MGFN run trained on the card, its steps
    written as orbax by the port, served and resumed."""
    from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer

    start = time.perf_counter()
    work = os.path.join(root, "orbax_written")
    os.makedirs(work)
    top_k = 2
    overrides = dict(training_overrides(root, "mgfn", "orbax_written"),
                     **{"trainer.max_epochs": 2, "trainer.max_steps": -1,
                        "trainer.eval_every": 1, "trainer.checkpoint.save_top_k": top_k})
    ckpt = overrides["trainer.checkpoint.dirpath"]
    with recorded_saves(torch) as saves:
        run_training(overrides, "mgfn")
    check_written_steps(torch, ckpt, saves)
    steps = TopKCheckpointer(ckpt).all_steps()
    params = sum(v.numel() for v in saves[-1]["live"][0].values())
    print(f"phase 20 (a) run runner=mgfn at full width ({params} values in the model's state "
          f"dict), 2 epochs: orbax steps {steps}, no state.pt; the last step through "
          f"read_orbax_step + train_state_from_orbax bit-equal to the live state (weights, "
          f"exp_avg, exp_avg_sq, step; num_batches_tracked has no orbax counterpart)", flush=True)
    print_saves("(a)", saves)

    # (b) the written run served by infer --checkpoint, against --torch-weights
    pt = os.path.join(work, "restored_mgfn.pt")
    torch.save(checkpoint_weights(ckpt), pt)
    vids = os.path.join(work, "videos")
    os.makedirs(vids)
    write_mjpg(os.path.join(vids, f"{FIGURE_STEM}.avi"), video)
    common = ["--videos", vids, "--i3d-weights", weights]
    out = {tag: os.path.join(work, tag) for tag in ("checkpoint", "weights")}
    runs = {"checkpoint": start_infer(work, "checkpoint", common + [
                "--checkpoint", ckpt, "--outdir", out["checkpoint"]], False),
            "weights": start_infer(work, "weights", common + [
                "--torch-weights", pt, "--model", "mgfn", "--outdir", out["weights"]], False)}
    results = {tag: finish_infer(*run) for tag, run in runs.items()}
    want = {"ten_crop_standardize": 1, "stem_conv_pool": 1, "bottleneck_block": 3}
    for tag, (code, output, launches) in results.items():
        if code != 0 or any(launches.get(k, 0) != n for k, n in want.items()):
            raise AssertionError(f"phase 20 (b) infer {tag}: exit {code}, launches {launches}, "
                                 f"expected {want}: {output[-3000:]}")
    name = f"{FIGURE_STEM}_scores.json"
    got, ref = (json.load(open(os.path.join(out[tag], name))) for tag in ("checkpoint", "weights"))
    if {k: v for k, v in got.items() if k != "latency_s"} != {
            k: v for k, v in ref.items() if k != "latency_s"}:
        raise AssertionError(f"phase 20 (b): infer --checkpoint differs from --torch-weights: "
                             f"{got} / {ref}")
    print(f"phase 20 (b) infer --checkpoint <the port-written run> over a 64-frame MJPG video: "
          f"exit 0, K1 / K2 / K3 {results['checkpoint'][2].get('ten_crop_standardize')} / "
          f"{results['checkpoint'][2].get('stem_conv_pool')} / "
          f"{results['checkpoint'][2].get('bottleneck_block')}, {got['n_clips']} clip scores "
          f"{got['clip_scores']} equal to --torch-weights of the restored scorer's state dict "
          f"but latency_s", flush=True)

    # (c) a copy of the written run resumed for two more epochs
    copy_dir = ckpt + "_resumed"
    shutil.copytree(ckpt, copy_dir)
    resume = dict(overrides, **{"trainer.max_epochs": 4, "trainer.resume": True,
                                "trainer.checkpoint.dirpath": copy_dir,
                                "trainer.log_path": os.path.join(work, "resumed.jsonl")})
    with recorded_saves(torch) as resumed_saves:
        printed = run_training(resume, "mgfn")
    with open(resume["trainer.log_path"]) as f:
        records = [json.loads(line) for line in f]
    check_written_steps(torch, copy_dir, resumed_saves)
    got_steps = TopKCheckpointer(copy_dir).all_steps()
    want_steps = policy_steps(saves + resumed_saves, top_k)
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    if (f"resumed from step {steps[-1]}" not in printed or not records
            or min(r["step"] for r in records) < steps[-1] or got_steps != want_steps
            or not all(r["step"] > steps[-1] for r in resumed_saves)
            or not losses or not all(l == l for l in losses)):
        raise AssertionError(f"phase 20 (c): saves {[r['step'] for r in resumed_saves]}, "
                             f"steps {got_steps} (policy {want_steps}), records "
                             f"{[r['step'] for r in records]}: {printed[-3000:]}")
    print(f"phase 20 (c) run trainer.resume=true on a copy, 2 more epochs: resumed from step "
          f"{steps[-1]}, saves at {[r['step'] for r in resumed_saves]}, losses {losses}; orbax "
          f"steps kept {got_steps} (the JAX policy, top {top_k} by metric + latest: "
          f"{want_steps}); phase 20 (a)-(c) {time.perf_counter() - start:.1f} s", flush=True)
    print_saves("(c)", resumed_saves)


def check_jax_dir_steps(fixture: str, copy: str) -> None:
    """Phase 20 (d): after phase 19 (c)'s port resume in the JAX run's
    directory, every step is orbax (the port's 6 and 8 too) and the JAX
    steps 2 and 4 keep their bytes."""
    from anomaly_detection_on_video_tpu_torch.training.orbax import is_orbax_step

    steps = sorted(int(s) for s in os.listdir(copy) if s.isdigit())
    orbax = [s for s in steps if is_orbax_step(os.path.join(copy, str(s)))
             and not any("state.pt" in f for _, _, f in os.walk(os.path.join(copy, str(s))))]
    kept = [s for s in (2, 4) if tree_digest(os.path.join(copy, str(s))) == tree_digest(
        os.path.join(fixture, "run", str(s)))]
    if steps != [2, 4, 6, 8] or orbax != steps or kept != [2, 4]:
        raise AssertionError(f"phase 20 (d): steps {steps}, orbax {orbax}, byte-equal {kept}")
    print(f"phase 20 (d) the JAX run's directory after the port's resume: steps {steps}, every "
          f"one orbax, none holding state.pt; steps {kept} byte for byte the JAX run's",
          flush=True)


# ------------------------------------------------------ phase 21: the network mode

NETWORK_DATASET = "stand-in/anomaly-videos"
# phase 21's CLI processes: a module run as ``python -m`` is, under cuDNN's
# deterministic algorithms (features are compared byte for byte), with the
# modules BLOCKED_MODULES names (comma-separated) made unimportable, as on a
# host without them, and, where STAND_INS names a spec, the tests' stand-in
# huggingface_hub, datasets and wandb put in their place (the card's machine
# has no network, and has had none, some or all of the packages installed)
# and their recorded calls written out when the module ends
NETWORK_CHILD = ("import os, runpy, sys, torch\n"
                 "for name in filter(None, os.environ.get('BLOCKED_MODULES', '').split(',')):\n"
                 "    sys.modules[name] = None\n"
                 "record = None\n"
                 "if os.environ.get('STAND_INS'):\n"
                 "    sys.path.append(os.path.join(os.getcwd(), 'tests'))\n"
                 "    from torch_network_fixtures import install_stand_ins\n"
                 "    record = install_stand_ins(os.environ['STAND_INS'])\n"
                 "torch.backends.cudnn.deterministic = True\n"
                 "try:\n"
                 "    runpy.run_module(sys.argv.pop(1), run_name='__main__', alter_sys=True)\n"
                 "finally:\n"
                 "    if record:\n"
                 "        record()\n")
NETWORK_PACKAGES = ("huggingface_hub", "datasets", "wandb", "decord")


def json_lines(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def start_network_cli(work: str, tag: str, module: str, argv: list, env: dict) -> tuple:
    """``module argv`` as a process (``NETWORK_CHILD``) in the environment
    ``env``, its output to ``<work>/<tag>.log`` and its launches to
    ``<work>/<tag>_launches.jsonl``."""
    from anomaly_detection_on_video_tpu_torch.ops import kernels

    log = os.path.join(work, f"{tag}_launches.jsonl")
    env = dict(env, PYTHONUNBUFFERED="1", **{kernels.LAUNCH_LOG_ENV: log})
    err = open(os.path.join(work, f"{tag}.log"), "w+")
    proc = subprocess.Popen([sys.executable, "-c", NETWORK_CHILD,
                             f"anomaly_detection_on_video_tpu_torch.{module}", *argv],
                            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=err,
                            stderr=subprocess.STDOUT, text=True)
    return proc, log, err


def feature_tree(root: str) -> dict:
    """Relative path -> bytes of every file under ``root``."""
    tree = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                tree[os.path.relpath(path, root)] = f.read()
    return tree


def check_network_mode(torch, root: str, weights: str, video) -> None:
    """Phase 21: the JAX package's network mode, with the tests' stand-in
    ``huggingface_hub``, ``datasets`` and ``wandb``
    (``tests/torch_network_fixtures.py``, installed by ``NETWORK_CHILD``)
    and no network. Four processes at once: (a) ``extract_features
    --hf-dataset`` with no ``--weights`` (the default spec served by the
    stand-in hub as phase 10's weights) over three MJPG videos of the 4-clip
    video in two splits, and ``extract_features --videos`` of the train
    split with ``--weights`` that file: K1 / K2 / K3 1 / 1 / 3 per video (one
    group each), features and segments byte-equal (the test video is the
    first train video's frames: its features equal that video's); (b)
    ``run runner=mgfn`` at full width with no data path (the zips and
    ``ground_truth.json`` of phase 8's bags served by the stand-in hub),
    ``wandb_key``, ``trainer/logger=wandb``, ``log_model`` and
    ``figure_dir``, 2 epochs: the hub calls the JAX package makes, every
    JSONL record logged to W&B at its step, one ``checkpoint-step{step}``
    artifact per saved step, ``valid/overlay`` only where matplotlib
    imports; (c) without the packages (the stand-ins off the path and the
    four names blocked, since the card's machine may have some of them):
    ``--hf-dataset`` exits non-zero with the ModuleNotFoundError naming
    ``datasets`` after the default weights resolve in phase 17's cache;
    then in this process the cache reader serves phase 17's weights and a
    2-epoch run from its zips that warns as the JAX logger does and saves
    its steps."""
    import importlib.util

    import numpy as np

    from anomaly_detection_on_video_tpu_torch.utils import hub as thub

    start = time.perf_counter()
    print("phase 21: installed on this machine: " + ", ".join(
        f"{name} {'yes' if importlib.util.find_spec(name) else 'no'}"
        for name in NETWORK_PACKAGES), flush=True)
    work = os.path.join(root, "network")
    served = [["jinmang2/test_video_fe", "converted_ref_i3d.pt", weights]]
    for split, path in feature_repo_files(root).items():
        served.append([FEATURE_REPO, os.path.basename(path) if split == "ground_truth"
                       else f"{split}.zip", path])
    videos = {"train": ["Abuse001_x264.avi", "Normal_Videos002_x264.avi"],
              "test": ["Abuse003_x264.avi"]}
    for mode, names in videos.items():
        os.makedirs(os.path.join(work, "videos", mode))
        for name in names:
            frames = video[::-1] if name.startswith("Normal") else video
            write_mjpg(os.path.join(work, "videos", mode, name), frames)
    base, net_env = dict(os.environ), {}
    for tag in ("hf", "run"):  # each process records its own calls
        spec = {"hub": served, "cache": os.path.join(work, "hf_cache"),
                "datasets": {mode: [os.path.join(work, "videos", mode, n) for n in names]
                             for mode, names in videos.items()},
                "record": os.path.join(work, f"{tag}_calls.json")}
        with open(os.path.join(work, f"{tag}_stand_ins.json"), "w") as f:
            json.dump(spec, f)
        net_env[tag] = dict(base, STAND_INS=f.name)
    phase17_cache = os.path.join(root, "hf_cache")
    if not os.path.isdir(phase17_cache):
        write_hub_cache(root, weights)
    cache_env = dict(base, HF_HUB_CACHE=phase17_cache, BLOCKED_MODULES=",".join(NETWORK_PACKAGES))
    out = {tag: os.path.join(work, tag) for tag in ("hf", "local", "missing")}
    common = ["--decode-workers", "1"]
    run_dir = os.path.join(work, "run")
    run_argv = ["runner=mgfn", "data.batch_size=3", "runner.optimizer.learning_rate=0.0001",
                "trainer.max_epochs=2", "trainer.eval_every=1", "wandb_key=stand-in-key",
                "trainer/logger=wandb", "trainer.logger.log_model=true",
                f"trainer.log_path={run_dir}/metrics.jsonl",
                f"trainer.checkpoint.dirpath={run_dir}/checkpoints",
                f"trainer.figure_dir={run_dir}/figures"]
    procs = {
        "hf": start_network_cli(work, "hf", "extract_features", common + [
            "--hf-dataset", NETWORK_DATASET, "--outdir", out["hf"]], net_env["hf"]),
        "local": start_network_cli(work, "local", "extract_features", common + [
            "--videos", os.path.join(work, "videos", "train"), "--split", "train",
            "--outdir", out["local"], "--weights", weights], base),
        "run": start_network_cli(work, "run", "run", run_argv, net_env["run"]),
        "missing": start_network_cli(work, "missing", "extract_features", common + [
            "--hf-dataset", NETWORK_DATASET, "--outdir", out["missing"]], cache_env),
    }
    results = {}
    try:
        for tag, (proc, log, err) in procs.items():
            code = proc.wait(600)
            err.seek(0)
            launches = {}
            for record in json_lines(log):
                for name, count in record["launches"].items():
                    launches[name] = launches.get(name, 0) + count
            results[tag] = (code, err.read(), launches)
            err.close()
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
    print(f"phase 21 processes: {time.perf_counter() - start:.1f} s", flush=True)

    # (a) --hf-dataset against --videos
    for tag in ("hf", "local", "run"):
        if results[tag][0] != 0:
            raise AssertionError(f"phase 21 {tag} exited {results[tag][0]}: "
                                 f"{results[tag][1][-3000:]}")
    default = f"--weights not given; defaulting to {HUB_WEIGHTS} (reference network-mode flow)"
    hf_out, hf_launches = results["hf"][1], results["hf"][2]
    n_groups = sum(len(names) for names in videos.values())
    want = {"ten_crop_standardize": n_groups, "stem_conv_pool": n_groups,
            "bottleneck_block": 3 * n_groups}
    for tag, launches, groups in (("hf", hf_launches, n_groups),
                                  ("local", results["local"][2], len(videos["train"]))):
        expected = {k: v // n_groups * groups for k, v in want.items()}
        if any(launches.get(k, 0) != v for k, v in expected.items()) or any(
                launches.get(k, 0) for k in ("int8_matmul", "int8_conv")):
            raise AssertionError(f"phase 21 (a) {tag}: launches {launches}, expected {expected}")
    hf_tree, local_tree = feature_tree(out["hf"]), feature_tree(out["local"])
    renamed = {k.replace(os.path.join("anomaly_features", ""), "", 1): v
               for k, v in hf_tree.items()}
    test_name = os.path.join("test", "Abuse003_x264_i3d.npy")
    same = os.path.join("train", "Abuse001_x264_i3d.npy")
    lines = [f"{mode}: extracted {len(names)} new videos -> "
             f"{os.path.join(out['hf'], 'anomaly_features', mode)}" for mode, names in videos.items()]
    if default not in hf_out or any(line not in hf_out for line in lines) or (
            set(renamed) != set(local_tree) | {test_name}) or any(
            renamed[k] != v for k, v in local_tree.items()) or renamed[test_name] != local_tree[same]:
        raise AssertionError(f"phase 21 (a): files {sorted(hf_tree)} / {sorted(local_tree)}; "
                             f"{hf_out[-3000:]}")
    feats = np.load(os.path.join(out["hf"], "anomaly_features", same))
    seg = np.load(os.path.join(out["hf"], "segment_features_32", "Abuse001_x264_i3d.npy"))
    if feats.shape != (4, 10, FEATURE_DIM) or seg.shape != (10, 32, FEATURE_DIM) or not (
            np.isfinite(feats).all() and np.isfinite(seg).all()):
        raise AssertionError(f"phase 21 (a): features {feats.shape}, segments {seg.shape}")
    recorded = {}
    for tag in ("hf", "run"):
        with open(os.path.join(work, f"{tag}_calls.json")) as f:
            recorded[tag] = json.load(f)
    if recorded["hf"]["hub"] != [{"repo_id": "jinmang2/test_video_fe",
                                  "filename": "converted_ref_i3d.pt", "revision": None,
                                  "cache_dir": None}] or recorded["hf"]["datasets"] != [
            [[NETWORK_DATASET, "anomaly"], {}]]:
        raise AssertionError(f"phase 21 (a): hub and datasets calls {recorded['hf']}")
    print(f"phase 21 (a) extract_features --hf-dataset {NETWORK_DATASET} (stand-in datasets and "
          f"hub, no --weights: '{default}'): {len(hf_tree)} files ({sorted(renamed)}) byte-equal "
          f"to --videos with --weights {os.path.basename(weights)}, the test video's features "
          f"equal to the same frames' in train; launches {hf_launches} over {n_groups} videos of "
          f"one group each (--videos: {results['local'][2]})", flush=True)

    # (b) run with no data path and wandb_key
    records = json_lines(os.path.join(run_dir, "metrics.jsonl"))
    calls = recorded["run"]["wandb"]
    data_calls = sorted(({k: v for k, v in c.items() if v is not None}
                         for c in recorded["run"]["hub"]), key=lambda c: c["filename"])
    # by filename: the zips at the data config's revision, the ground truth with none
    want_data = [{"repo_id": FEATURE_REPO, "filename": "ground_truth.json",
                  "repo_type": "dataset"},
                 {"repo_id": FEATURE_REPO, "filename": "test.zip", "revision": "tushar-n",
                  "repo_type": "dataset"},
                 {"repo_id": FEATURE_REPO, "filename": "train.zip", "revision": "tushar-n",
                  "repo_type": "dataset"}]
    steps = sorted(int(d) for d in os.listdir(os.path.join(run_dir, "checkpoints")) if d.isdigit())
    logged = [(c[2], c[1]) for c in calls if c[0] == "log"]
    scalars = [(step, {k: v for k, v in m.items() if k != "valid/overlay"}) for step, m in logged]
    scalars = [entry for entry in scalars if entry[1]]
    from_jsonl = [(r["step"], {k: v for k, v in r.items() if k not in ("step", "time")})
                  for r in records]
    overlays = [m["valid/overlay"][1] for _, m in logged if "valid/overlay" in m]
    artifacts = [c[1:] for c in calls if c[0] == "log_artifact"]
    want_artifacts = [[f"checkpoint-step{s}", "model",
                       [["dir", os.path.join(run_dir, "checkpoints", str(s))]]] for s in steps]
    mpl = has_matplotlib()
    name = calls[1][2] if len(calls) > 1 else ""
    if (data_calls != want_data or calls[:1] != [["login", "stand-in-key"]]
            or calls[1][:2] != ["init", "anomaly-detection-on-video-tpu"]
            or not re.match(r"^default-mgfn-\d{8}-\d{6}$", name) or scalars != from_jsonl
            or steps != [2, 4] or artifacts != want_artifacts
            or len(overlays) != (2 if mpl else 0)):
        raise AssertionError(f"phase 21 (b): hub {data_calls}; steps {steps}; wandb {calls}; "
                             f"records {records}; {results['run'][1][-3000:]}")
    print(f"phase 21 (b) run runner=mgfn with no data path, wandb_key, log_model, figure_dir "
          f"(matplotlib {'present' if mpl else 'absent'}): hub calls {want_data}; W&B run "
          f"{name!r}, {len(scalars)} metric logs at steps {[s for s, _ in scalars]} equal to the "
          f"JSONL records, artifacts {[a[0] for a in artifacts]}, {len(overlays)} overlays; "
          f"launches {results['run'][2]}", flush=True)

    # (c) without the stand-ins
    code, output, launches = results["missing"]
    error = next((line.strip() for line in reversed(output.splitlines())
                  if line.startswith("ModuleNotFoundError")), "")
    if code == 0 or "datasets" not in error or default not in output or os.path.exists(
            os.path.join(out["missing"], "anomaly_features")):
        raise AssertionError(f"phase 21 (c) --hf-dataset without datasets: exit {code}: "
                             f"{output[-3000:]}")
    saved = {name: sys.modules.get(name, False) for name in NETWORK_PACKAGES}
    saved_cache = os.environ.get("HF_HUB_CACHE")
    try:
        for name in saved:
            sys.modules[name] = None
        os.environ["HF_HUB_CACHE"] = phase17_cache
        path = thub.resolve_weights(HUB_WEIGHTS)
        with open(path, "rb") as f, open(weights, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"phase 21 (c): {path} differs from {weights}")
        overrides = dict(training_overrides(root, "mgfn", "network_nowandb"),
                         **{"data.train_path": None, "data.test_path": None,
                            "data.ground_truth_path": None, "trainer.max_epochs": 2,
                            "trainer.max_steps": -1, "trainer.eval_every": 1,
                            "wandb_key": "stand-in-key"})
        with contextlib.redirect_stderr(io.StringIO()) as err:
            run_training(overrides, "mgfn")
    finally:
        for name, module in saved.items():
            if module is False:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
        if saved_cache is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved_cache
    warning = ("warning: wandb_key is set but the wandb package is not installed; W&B logging "
               "disabled (JSONL/console logging unaffected)")
    ckpt = overrides["trainer.checkpoint.dirpath"]
    saved_steps = sorted(int(d) for d in os.listdir(ckpt) if d.isdigit())
    if err.getvalue().splitlines().count(warning) != 1 or saved_steps != [2, 4]:
        raise AssertionError(f"phase 21 (c) run without wandb: steps {saved_steps}; "
                             f"{err.getvalue()[-3000:]}")
    print(f"phase 21 (c) without the packages: --hf-dataset exit {code}, '{error}' (after "
          f"'{default}' resolved in phase 17's cache, launches {launches}); the cache reader "
          f"served {HUB_WEIGHTS} ({os.path.getsize(path)} bytes, equal to the file) and a 2-epoch "
          f"run from its zips that warned '{warning}' and saved steps {saved_steps}", flush=True)
    print(f"network mode phase (21): {time.perf_counter() - start:.1f} s", flush=True)


# ------------------------------------------- phase 22: the JAX package's probes

PROBE_REPS = 3  # each timing's repetitions in phase 22 (the probes' own: 10-50)
COSINE_2D_FLOOR = 0.9999  # bf16 2-D against 3-D formulations (conv2d_probe)
STEM2D_REL = 1e-5  # float32 stem2d against stem3d, relative to the peak, TF32 off
PEAK_SHARE = 1.05  # an MFU or HBM rate above 105% of its peak is a miscount


def probe_records(name: str, records) -> dict:
    """Print each record of probe ``name`` on a line of its own; raise on
    an error record. Returns the records by their ``probe``."""
    records = list(records)
    for record in records:
        print(f"phase 22 {name}: {json.dumps(record)}", flush=True)
    errors = [r for r in records if "error" in r]
    if errors:
        raise AssertionError(f"phase 22 {name}: {errors}")
    return {r.get("probe", name): r for r in records}


def gate(name: str, ok: bool, what) -> None:
    if not ok:
        raise AssertionError(f"phase 22 {name}: {what}")


def check_probes(torch, root: str) -> None:
    """Phase 22: the eight probes of the JAX package's ``scripts/``, ported,
    at the JAX shapes with ``PROBE_REPS`` repetitions, in this process.
    Gates: no error record; ``int8_pallas_probe``'s verify; ``stage_probe``
    every 0 < MFU and HBM rate <= 105% of the peak it is divided by, and
    §2's K1 / K2 / K3 launches 2 / 2 / 6 a pass (two groups); the int8
    stages bit-equal to K4's and K5's plain versions, their launches the
    counts their specs imply; ``conv2d_probe``'s 2-D outputs against the
    3-D ones (bf16 cosine >= 0.9999, int8 bit-equal); ``stem2d_vs_3d_f32``
    within 1e-5 of the peak, TF32 off; ``int8_probe``'s cosine >= 0.99
    (phase 5's int8 gate); ``overlap_ab``'s modes bit-equal. Then one probe
    as a user runs it, ``python -m ...int8_pallas_probe --verify`` with no
    ``--device``: ``{"verify": "ok"}``, K4 and K5 launched (the card by
    default)."""
    from anomaly_detection_on_video_tpu_torch.scripts import (
        conv2d_probe, eval_probe, int8_pallas_probe, int8_probe, int8_stage_probe, overlap_ab,
        stage_probe, stem2d_probe)

    dev = torch.device("cuda")
    start = time.perf_counter()
    seconds = {}

    def timed_probe(name, records):
        t0 = time.perf_counter()
        out = probe_records(name, records)
        torch.cuda.empty_cache()
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    timed_probe("int8_pallas_probe", int8_pallas_probe.run(dev, reps=PROBE_REPS))
    int8_pallas_probe.verify_kernel_correctness(dev)
    print("phase 22 int8_pallas_probe --verify: K4 and K5 bit-equal to their plain versions, K5 "
          "to a float64 F.conv2d", flush=True)

    recs = timed_probe("stage_probe", stage_probe.run(dev, reps=PROBE_REPS))
    hbm_gbps = HBM_BYTES_PER_S / 1e9
    for s in stage_probe.STAGE_SPECS:
        r = recs[f"stage{s}"]
        gate(f"stage{s}", 0 < r["mfu"] <= PEAK_SHARE and 0 < r["hbm_gbps"] <= PEAK_SHARE * hbm_gbps,
             r)
    for batch in stage_probe.PIPELINE_BATCHES:
        r = recs[f"pipeline_batch{batch}"]
        gate(r["probe"], r["launches"] == dict(zip(stage_probe.KERNELS_K1_K3, (2, 2, 6))), r)

    recs = timed_probe("int8_stage_probe",
                       int8_stage_probe.run(dev, reps=PROBE_REPS, check_plain=True))
    for s in int8_stage_probe.INT8_STAGES:
        r = recs[f"stage{s}_int8"]
        gate(r["probe"], r["unequal_vs_plain"] == 0 and r["launches"] == r["expected_launches"], r)

    recs = timed_probe("conv2d_probe", conv2d_probe.run(dev, reps=PROBE_REPS))
    for tag in conv2d_probe.CASES:
        gate(tag, recs[f"{tag}_2d_bf16"]["cosine_vs_3d"] >= COSINE_2D_FLOOR
             and recs[f"{tag}_2d_int8"]["unequal_vs_3d"] == 0,
             (recs[f"{tag}_2d_bf16"], recs[f"{tag}_2d_int8"]))

    recs = timed_probe("stem2d_probe", stem2d_probe.run(dev, reps=PROBE_REPS))
    r = recs["stem2d_vs_3d_f32"]
    gate(r["probe"], r["max_rel_to_peak"] <= STEM2D_REL and r["tf32"] is False, r)

    recs = timed_probe("int8_probe", int8_probe.run(dev, reps=PROBE_REPS))
    gate("int8_probe", recs["pipeline_int8"]["cosine_vs_bf16"] >= 0.99, recs["pipeline_int8"])

    timed_probe("eval_probe", eval_probe.run(dev))
    recs = timed_probe("overlap_ab", overlap_ab.run(dev, reps=2))
    gate("overlap_ab", recs["overlap_ab"]["modes_bit_equal"] is True, recs["overlap_ab"])
    out, records, cli_s = run_tool(root, "int8_pallas_probe", ["--verify"])
    launches = launches_of(records, f"{TOOLS}.int8_pallas_probe")
    gate("int8_pallas_probe --verify", json.loads(out.strip().splitlines()[-1]) == {"verify": "ok"}
         and launches.get("int8_matmul", 0) >= 1 and launches.get("int8_conv", 0) >= 1,
         (out, launches))
    print(f"phase 22 python -m {TOOLS}.int8_pallas_probe --verify: {out.strip()}, launches "
          f"{json.dumps(launches)}; {cli_s:.1f} s", flush=True)
    print(f"probes phase (22): {time.perf_counter() - start:.1f} s; by probe {json.dumps(seconds)}",
          flush=True)


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
    # no phase reaches a network: a hub library on this machine stays offline
    for name, value in (("HF_HUB_OFFLINE", "1"), ("HF_DATASETS_OFFLINE", "1"),
                        ("WANDB_MODE", "offline")):
        os.environ.setdefault(name, value)
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
    check_int8_probe_shapes()
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
        torch.cuda.empty_cache()

        # 16. the user tools of scripts/, ported: demo, operating_point,
        # convert_checkpoint, convergence_bench, int8_e2e, tp_audit
        check_user_tools(torch, work, checkpoints["mgfn"], os.path.join(work, "i3res50.pt"))
        torch.cuda.empty_cache()

        # 17. the last of the JAX package: weights and features from a local
        # HF cache, parity_check against the reference topologies, dynamics_ab
        check_reference_tools(torch, work, checkpoints["mgfn"], os.path.join(work, "i3res50.pt"))
        torch.cuda.empty_cache()

        # 18. eval figures and infer --figure: the slice's path (K1-K3 in
        # the CLI's processes), then fit with figure_dir
        check_figures(torch, work, checkpoints["mgfn"], os.path.join(work, "i3res50.pt"), video)
        torch.cuda.empty_cache()

        # 19. the JAX package's orbax checkpoints: infer --checkpoint, run
        # resume and eval_only on a copy of a JAX run's directory
        check_orbax(torch, work, os.path.join(work, "i3res50.pt"), video)
        torch.cuda.empty_cache()

        # 20. a full-width run trained on the card, its steps written as
        # orbax: restored bit-equal, served by infer --checkpoint, resumed
        check_orbax_written(torch, work, os.path.join(work, "i3res50.pt"), video)
        torch.cuda.empty_cache()

        # 21. the network mode, through stand-in huggingface_hub, datasets
        # and wandb packages: extract_features --hf-dataset, run with no data
        # path and wandb_key, and both without the stand-ins
        check_network_mode(torch, work, os.path.join(work, "i3res50.pt"), video)
        torch.cuda.empty_cache()

        # 22. the JAX package's last eight scripts, its probes: stages,
        # conv formulations, the stem, int8, eval and the dispatch A/B
        check_probes(torch, work)
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
    if sys.argv[1:2] == ["--trace-probe"]:
        sys.exit(probe_trace(int(sys.argv[2])))
    sys.exit(main())
