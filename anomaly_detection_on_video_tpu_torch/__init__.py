"""PyTorch / CUDA port of the video anomaly detection framework for the H100.

The JAX package ``anomaly_detection_on_video_tpu`` is the reference; this
package mirrors its layout (``ops/``, ``models/``, ``data/``, ``training/``,
``utils/``) so every counterpart is found by name. It imports torch, numpy
and the standard library only.

It covers the inference path of one video: uint8 frames -> PIL-exact
resize -> ten 224x224 standardized crops (CUDA kernel K1) -> i3res50 with its
stem (K2) and stage-1 bottleneck blocks (K3) as CUDA kernels, or int8 convs
(K4, K5) -> (n_clips, 10, 2048) features -> padded-bucket MGFN scores ->
frame scores; and MGFN training: feature directories -> MIL batches -> the
train step (``training/``, ``losses/``) -> frame-level AUC, checkpoints and
logs, driven by ``python -m anomaly_detection_on_video_tpu_torch.run`` over
the repository's ``configs/``.
"""

__version__ = "0.1.0"
