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
  MGFN step under DP and DP x TP over real ranks.

The tools that compute on tensors take ``--device`` (``cuda`` unless told
``cpu``); the other two do host work only.
"""
