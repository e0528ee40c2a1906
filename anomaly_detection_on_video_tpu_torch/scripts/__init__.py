"""The repository's user tools of ``scripts/``, on the port (torch, numpy
and host libraries only; no JAX). Each runs as ``python -m
anomaly_detection_on_video_tpu_torch.scripts.<name>`` with the JAX script's
flags and JSON keys:

- ``operating_point``: a deployment threshold from ``infer`` score JSONs and
  a frame ground truth (host numpy);
- ``convert_checkpoint``: torch state dicts to flax ``.msgpack`` variables
  and back (``--reverse``), the JAX script's bytes, without flax;
- ``demo``: extraction, training and export through the port's CLIs;
- ``convergence_bench``: MGFN, RTFM and Sultani on structured synthetic bags;
- ``int8_e2e``: the int8 and center-crop cost in scores and AUC;
- ``tp_audit``: what ``tensor_parallel_specs`` shards, and the full-size
  MGFN step under DP and DP x TP over real ranks;
- the probes, each printing the JAX probe's JSON records (names and keys),
  a section that raises printing ``{"probe": ..., "error": ...}``:
  ``int8_pallas_probe`` (K4 and K5 at the TPU probe's stage-2 shapes and
  the bf16 cuDNN conv; ``--verify``), ``stage_probe`` (stages 1-4 in bf16
  with MFU and HBM rate, the extractor at batch 240 and 480, the int8
  product and conv), ``int8_stage_probe`` (conv geometries and stages 1-2
  in int8 against bf16), ``conv2d_probe`` (3-D against 2-D
  formulations), ``stem2d_probe`` (the stem as one 2-D conv),
  ``int8_probe`` (the int8 pipeline against bf16), ``eval_probe``
  (``evaluate``'s host assembly against device work) and ``overlap_ab``
  (serial against dispatched extraction of an MJPG).

The tools that compute on tensors take ``--device`` (``cuda`` unless told
``cpu``); the other two do host work only. The probes' timings come from
CUDA events on the card (``utils/measure.py``); a ``--device cpu`` run
times torch's CPU kernels.
"""
