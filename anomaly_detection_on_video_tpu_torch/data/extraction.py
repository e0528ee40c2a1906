"""I3D feature extraction for the RGB and optical-flow streams: ten crops or
the center crop, serial or with a pool of decode threads, one stream or both
from one decode pass.

Counterpart of the JAX package's ``data/extraction.py``: ``adapt_stem_channels``,
``FeatureExtractor`` (``pad_frames``, ``_group_for``, ``dispatch_frames`` /
``materialize_features``, ``extract_video`` with per-chunk caches, the
resize -> crop -> forward pipeline, the flow stream's transform),
``extract_videos``, ``extract_videos_two_stream``,
``extract_video_two_stream`` and ``extract_videos_pooled``. Frames are
loop-padded on the host so every clip is a contiguous run of frames,
resized on the device, then each group of RGB clips goes through kernel K1
(ten-crop + standardize) or, for center crops, ``center_crop`` +
``standardize`` as torch ops (the JAX package runs them through XLA), and
the i3res50 forward (kernels K2 and K3). The JAX package's ``lax.map`` over
groups is a Python loop here. Output: ``(n_clips, 10, 2048)`` float32, the
reference's on-disk feature contract, or ``(n_clips, 1, 2048)`` for center
crops (the serving protocol).

``stream="flow"`` is the optical-flow stream: decoded RGB chunks become
uint8 two-channel flow (``_host_transform``: OpenCV Farneback on the host,
or Farneback or TV-L1 on the extractor's device, ``flow_backend``), which
goes through the same resize and crops as torch ops (K1 takes three
channels, as the JAX package's Pallas crop does), is dequantized as ``x /
127.5 - 1``, and runs the forward with a 2-channel stem
(``adapt_stem_channels`` of the RGB weights). Its clips are not K2's or
K3's shape, so the float forward takes the plain chain, as the JAX model
runs them through XLA; under int8 K5 takes the 2-channel stem. Features go
to ``<stem>_flow.npy``, and ``flow_backend.json`` pins the backend of a
directory (``record_flow_backend``).

``devices`` splits the clip axis of every group over several devices, the
JAX package's process-local clip-axis mesh: each device runs its slice of
the group (crops and forward) on its own replica of the model, the groups
grow by the number of devices, and the features come back to the host in
clip order, equal to one device's.

``quantize=True`` is the int8 extractor (the JAX package's
``FeatureExtractor(quantize=True)``): the first chunk calibrates static
per-conv activation scales (``_calibrate``), then every conv runs in int8
through kernels K4 and K5. ``pin_calibration`` keeps one set of scales per
feature directory in ``act_scales_<stream>.json``, the JAX package's sidecar
name and format, so either package resumes the other's directory.

Threads: the device work of ``dispatch_frames`` runs on one worker thread
per extractor, so the caller decodes and pads the next chunk meanwhile;
``extract_frames`` (a request, with nothing to overlap) runs the same work
on the caller's thread once the worker is idle, so one thread at a time
launches the extractor's kernels. Grad mode is per thread, so the device
work enters ``torch.no_grad`` itself; it launches on its thread's current
stream and copies the features to the host there, so the copy waits for
that stream's work. int8 calibration runs on the caller's thread before
the first dispatch. A flow transform on the device runs on the thread that
asks for it: the caller's in the serial drivers, the consumer's (the
thread that dispatches) in ``extract_videos_pooled``, never a decode
thread; the host (OpenCV) transform runs in the decode threads there. A
device flow's uint8 frames stay on the device, padded and cropped where
they lie (the threads share the default stream, which orders the dispatch
worker's work after the flow's). A float32 extractor runs its device work with TF32 off
(``full_f32``) on every thread, so the process-wide flags that another
thread's flow or resize sets do not change its features.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import queue as queue_mod
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models import seeded_init_
from ..models.i3d import build_i3d_feature_extractor, calibrate_act_scales
from ..ops.gtransforms import center_crop, loop_pad_indices, standardize, ten_crop
from ..ops.flow import compute_flow_device
from ..ops.kernels.crop_norm import ten_crop_standardize
from ..ops.resize import resize_bilinear_exact, resize_bilinear_fast, short_side_size
from ..ops.tvl1 import compute_flow_tvl1
from ..utils.convert import load_known_keys
from ..utils.device import DeviceLike, full_f32, resolve_device
from ..utils.npyio import atomic_save
from .flow import compute_flow, flow_standardize, flow_to_uint8
from .video import CHUNK_FRAMES, VideoFrameSource, is_large_video

STREAMS = ("rgb", "flow")
FLOW_BACKENDS = ("host", "device", "tvl1")
# the stem conv's weight in the reference's state-dict names
STEM_WEIGHT = "conv1.weight"
# decoded chunks waiting for the device in extract_videos_pooled: bounds
# the host memory of raw frames (a 3,008-frame 240x320 chunk is 0.7 GB)
QUEUE_CHUNKS = 3


# uint8 frames: decoded on the host, or a device flow on its device
Frames = Union[np.ndarray, torch.Tensor]


def _on_device(frames: Frames, device: torch.device) -> torch.Tensor:
    """Host frames copied to ``device``; a tensor moved only if it lies
    elsewhere."""
    if isinstance(frames, torch.Tensor):
        return frames.to(device)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device)


def _on(device: torch.device):
    """The context that makes ``device`` current for kernel launches."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def adapt_stem_channels(state_dict: dict, channels: int) -> dict:
    """A ``channels``-input stem from pretrained RGB weights, the JAX
    package's ``adapt_stem_channels`` on a torch state dict: the stem
    conv's weight (``conv1.weight``, ``(64, C, kt, kh, kw)``) averaged over
    its input channels, repeated ``channels`` times and scaled by
    C / ``channels``, so pre-activation magnitudes are kept (the two-stream
    recipe's cross-modality start). Returns ``state_dict`` itself when the
    stem already has ``channels`` inputs or is absent; otherwise a shallow
    copy, computed in numpy as the JAX function computes it."""
    weight = state_dict.get(STEM_WEIGHT)
    if weight is None or weight.shape[1] == channels:
        return state_dict
    k = weight.detach().cpu().numpy()
    adapted = np.repeat(k.mean(axis=1, keepdims=True), channels, axis=1)
    adapted *= k.shape[1] / channels
    return {**state_dict, STEM_WEIGHT: torch.from_numpy(adapted).to(weight.dtype)}


class FeatureExtractor:
    """I3D extractor for one stream, RGB or optical flow (``stream``), ten
    crops (the reference protocol) or the center crop (``crops="center"``,
    the serving protocol: exactly ten-crop row 4).

    ``batch`` bounds the (clip, crop) forwards per step: ten-crop clips go
    in groups of ``batch // 10``; center-crop clips in groups of
    ``batch // 4`` (the JAX package's rule, a quarter of the padding of
    ``batch`` clips), the last group padded with copies of the final clip
    whose results are dropped. ``model`` replaces the named model (tests
    pass a narrow ``I3DResNet``); without ``state_dict`` the weights are
    random from ``seed``. float32 runs are parity runs and take the exact
    PIL resize; bfloat16 runs take the float resize (bfloat16 convs already
    break bit-parity). ``quantize`` runs the convs in int8, computing in
    ``dtype`` around them, with scales calibrated on the first chunk
    unless ``pin_calibration`` loads them.

    The flow stream takes uint8 two-channel flow frames in
    ``extract_frames`` / ``dispatch_frames``; ``extract_video`` and the
    drivers make them from decoded RGB chunks with ``_host_transform``.
    ``flow_backend`` is ``host`` (OpenCV), ``device`` (Farneback) or
    ``tvl1``, the last two on this extractor's device; it defaults to
    ``device`` on a CUDA device and ``host`` on the CPU. A ``state_dict``
    (RGB weights, ``--stream both`` shares one) goes through
    ``adapt_stem_channels`` and loads as the JAX converter reads it
    (``utils.convert.load_known_keys``: keys the model lacks, such as a
    Kinetics head, are dropped with a printed line; a missing key raises);
    a ``model`` must have the stream's input channels.

    ``devices`` (several torch devices, ``device`` then unused): each
    group's clips split evenly over them, every device with its own replica
    of the model (and its kernels), so groups hold ``group_clips`` clips per
    device; frames are resized on the first, and the features are gathered
    in clip order. int8 calibrates on the first device's model and every
    replica takes its scales.
    """

    def __init__(
        self,
        model_name: str = "tushar-n-baseline",
        state_dict: Optional[dict] = None,
        dtype: torch.dtype = torch.bfloat16,
        batch: int = 240,
        frames_per_clip: int = 16,
        resize: int = 256,
        cropsize: int = 224,
        adaptive_groups: bool = False,
        device: DeviceLike = "cuda",
        model: Optional[nn.Module] = None,
        seed: int = 0,
        quantize: bool = False,
        crops: str = "ten",
        stream: str = "rgb",
        flow_backend: Optional[str] = None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        if stream not in STREAMS:
            raise ValueError(f"stream must be rgb or flow, got {stream!r}")
        if crops not in ("ten", "center"):
            raise ValueError(f"crops must be ten or center, got {crops!r}")
        if flow_backend not in (None, *FLOW_BACKENDS):
            raise ValueError(f"flow_backend must be host, device, or tvl1, got {flow_backend!r}")
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.stream = stream
        # flow on the card where there is one, OpenCV on the host elsewhere
        # (the JAX package's "device on TPU, host elsewhere")
        if flow_backend is None:
            flow_backend = "device" if self.device.type == "cuda" else "host"
        self.flow_backend = flow_backend
        self.channels = 3 if stream == "rgb" else 2
        if model is None:
            model = build_i3d_feature_extractor(model_name, dtype=dtype, in_channels=self.channels)
        if model.conv1.in_channels != self.channels:
            raise ValueError(f"the {stream} stream takes {self.channels} input channels, but the "
                             f"model's stem takes {model.conv1.in_channels}")
        model.dtype = dtype
        if state_dict is not None:
            load_known_keys(model, adapt_stem_channels(state_dict, self.channels), "I3D weights")
        else:
            seeded_init_(model, seed)
        self.model = model.to(self.device).eval()
        # one replica per further device (the clip-axis split's shards)
        self._models = [self.model] + [copy.deepcopy(self.model).to(d) for d in self.devices[1:]]
        self.n_shards = len(self.devices)
        self.dtype = dtype
        self.crops = crops
        self.n_crops = 10 if crops == "ten" else 1
        # center crops: batch // 4 clips per group, the JAX package's knee
        # between padding a short video and filling the device; a split
        # group holds that many clips per device
        self.group_clips = max(1, batch // (4 if crops == "center" else self.n_crops)) * self.n_shards
        self.adaptive_groups = adaptive_groups
        self.frames_per_clip = frames_per_clip
        self.resize = resize
        self.cropsize = cropsize
        self.quantize = quantize
        self._calibration_path: Optional[str] = None  # set by pin_calibration
        self._dispatch_pool: Optional[ThreadPoolExecutor] = None  # dispatch_frames' worker
        self._last_dispatch: Optional[Future] = None  # the worker's newest job

    @property
    def _needs_calibration(self) -> bool:
        return self.quantize and self.model.act_scales is None

    @property
    def transform_on_device(self) -> bool:
        """Whether ``_host_transform`` computes on this extractor's device
        (the flow stream's ``device`` and ``tvl1`` backends)."""
        return self.stream == "flow" and self.flow_backend != "host"

    def _group_for(self, n_clips: int) -> int:
        """Clips per group: always ``group_clips`` in fixed mode; in
        adaptive (serving) mode the smallest power of two per device that
        holds the request, times the devices (so the split stays even),
        capped at ``group_clips``."""
        if not self.adaptive_groups or n_clips >= self.group_clips:
            return self.group_clips
        per_shard = -(-n_clips // self.n_shards)
        rung = 1 << max(0, per_shard - 1).bit_length()
        return min(self.n_shards * rung, self.group_clips)

    def pad_frames(self, frames: Frames, group_clips: Optional[int] = None) -> Frames:
        """Loop-pad + group-pad of the raw uint8 frames, where they lie (a
        numpy array on the host, a device flow's tensor on its device): a
        short tail clip repeats its own frames (tail[i % L]); the last
        group fills with copies of the final clip."""
        fpc = self.frames_per_clip
        gc = group_clips or self.group_clips
        n_frames = frames.shape[0]
        n_clips = (n_frames - 1) // fpc + 1
        tail = n_frames - (n_clips - 1) * fpc
        missing = -(-n_clips // gc) * gc - n_clips
        if tail == fpc and not missing:
            return frames
        index = np.arange(n_frames)
        if tail != fpc:
            index = np.concatenate([index, (n_clips - 1) * fpc + np.arange(fpc - tail) % tail])
        index = np.concatenate([index] + [index[-fpc:]] * missing)
        if isinstance(frames, torch.Tensor):
            return frames[torch.from_numpy(index).to(frames.device)]
        return frames[index]

    def extract_frames(self, frames: Frames) -> np.ndarray:
        """uint8 (n_frames, H, W, channels) -> float32 (n_clips, n_crops, C):
        RGB frames, or uint8 flow for the flow stream (a numpy array, or a
        device flow's tensor, which is used where it lies).

        The same work and result as ``materialize_features(dispatch_frames(
        frames))``, run on this thread: a single call has nothing to
        overlap, so it skips the hop to the worker. It first waits for the
        worker to finish what was dispatched before, so one thread at a
        time launches.
        """
        padded, gc, n_clips = self._prepare(frames)
        if self._last_dispatch is not None:
            wait([self._last_dispatch])
        return self._extract(padded, gc, n_clips)

    def dispatch_frames(self, frames: Frames) -> Tuple[Future, int]:
        """Start extracting ``frames`` without waiting for the result.

        Calibrates first where int8 still needs it (on this thread), pads
        the frames, and hands the device work to the extractor's one worker
        thread, which copies the frames in, runs every group and copies the
        features out. The caller meanwhile decodes and pads the next chunk.
        Order is preserved (one worker). Returns a handle for
        ``materialize_features``.
        """
        padded, gc, n_clips = self._prepare(frames)
        if self._dispatch_pool is None:
            # a new thread's OpenMP team defaults to every core: give the
            # worker the caller's intra-op thread count
            self._dispatch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="extract-dispatch",
                initializer=torch.set_num_threads, initargs=(torch.get_num_threads(),))
        self._last_dispatch = self._dispatch_pool.submit(self._extract, padded, gc, n_clips)
        return self._last_dispatch, n_clips

    def _prepare(self, frames: Frames) -> Tuple[Frames, int, int]:
        """Calibrate where int8 still needs it, then pad: -> (padded
        frames, clips per group, clips)."""
        if frames.ndim != 4 or frames.shape[-1] != self.channels:
            raise ValueError(f"the {self.stream} extractor takes (n, H, W, {self.channels}) "
                             f"frames, got {frames.shape}")
        if self._needs_calibration:
            self._calibrate(frames)
        n_clips = (frames.shape[0] - 1) // self.frames_per_clip + 1
        gc = self._group_for(n_clips)
        return self.pad_frames(frames, gc), gc, n_clips

    @staticmethod
    def materialize_features(dispatched: Tuple[Future, int]) -> np.ndarray:
        """Wait for a ``dispatch_frames`` handle -> (n_clips, n_crops, C)
        float32; an error of the device work raises here."""
        future, _ = dispatched
        return future.result()

    def _precision(self):
        """The context of this extractor's device work: a float32 run is a
        parity run, with TF32 off (``full_f32``) whatever thread it runs on
        and whatever other threads do with the process-wide flags."""
        return full_f32() if self.dtype == torch.float32 else contextlib.nullcontext()

    def _extract(self, padded: Frames, gc: int, n_clips: int) -> np.ndarray:
        """The device work of one call: copy in (host frames), resize, then
        per group and device slice crop and forward, and copy the first
        ``n_clips`` clips' features out in clip order."""
        with torch.no_grad(), self._precision():  # grad mode is per thread
            frames = _on_device(padded, self.device)
            out_h, out_w = short_side_size(frames.shape[1], frames.shape[2], self.resize)
            resize_fn = (resize_bilinear_exact if self.dtype == torch.float32
                         else resize_bilinear_fast)
            resized = resize_fn(frames, out_h, out_w).contiguous()  # uint8 on the device
            for model in self._models[1:]:
                if model.act_scales != self.model.act_scales:  # int8: the leader calibrated
                    model.act_scales = self.model.act_scales
            feats = []
            for group in resized.reshape(-1, gc, self.frames_per_clip, out_h, out_w, self.channels):
                for model, device, part in zip(self._models, self.devices,
                                               group.chunk(self.n_shards)):
                    with _on(device):
                        feats.append(self._forward(model, part.to(device)))
            out = torch.cat([f.to(self.device) for f in feats])[:n_clips]
            return out.to(torch.float32).cpu().numpy()

    def _forward(self, model: nn.Module, group: torch.Tensor) -> torch.Tensor:
        """Resized uint8 clips (gc, fpc, H, W, channels) -> their features
        (gc, n_crops, C) on the clips' device."""
        size = self.cropsize
        if self.n_crops == 1:
            x = self._standardize(center_crop(group, size)).contiguous()
        elif self.stream == "rgb":
            x = ten_crop_standardize(group, size, self.dtype)  # K1
        else:
            # (10, gc, ...) -> (gc, 10, ...) -> the batch (gc * 10)
            x = self._standardize(ten_crop(group, size)).transpose(0, 1)
            x = x.reshape(-1, self.frames_per_clip, size, size, self.channels)
        return model(x).reshape(group.shape[0], self.n_crops, -1)

    def _standardize(self, crops: torch.Tensor) -> torch.Tensor:
        """uint8 crops -> the model's input in its dtype: standardized
        pixels, or flow dequantized to [-1, 1] (``data/flow.py``)."""
        if self.stream == "flow":
            return flow_standardize(crops).to(self.dtype)
        return standardize(crops).to(self.dtype)

    def _host_transform(self) -> Optional[Callable[[np.ndarray], Frames]]:
        """The stream's per-chunk transform, None for RGB: decoded uint8 RGB
        ``(n, H, W, 3)`` -> uint8 flow ``(n, H, W, 2)``, by OpenCV on the
        host (``host``, a numpy array) or by Farneback (``device``) or
        TV-L1 (``tvl1``) on this extractor's device, never quietly on
        another; a device flow stays there as a tensor, which
        ``extract_frames`` / ``dispatch_frames`` take as it is."""
        if self.stream != "flow":
            return None
        if self.flow_backend == "host":
            return lambda chunk: flow_to_uint8(compute_flow(chunk))
        flow_fn = compute_flow_device if self.flow_backend == "device" else compute_flow_tvl1

        def transform(chunk: np.ndarray) -> torch.Tensor:
            return flow_to_uint8(flow_fn(_on_device(chunk, self.device)))

        return transform

    def extract_video(self, video_path: str, chunk_frames: int = CHUNK_FRAMES,
                      cache_dir: Optional[str] = None, timer=None) -> np.ndarray:
        """Whole-video extraction over decoded chunks, one deep: chunk N is
        dispatched before chunk N-1's features are waited for, so N's copy
        and forward overlap N-1's readback and the next decode.

        ``cache_dir`` keeps each chunk's features in
        ``chunk_cache_path(cache_dir, video_path, i)`` and reuses the
        chunks found there (resuming an interrupted large video).
        ``timer``: a ``utils.profiling.StageTimer``, given the stages
        ``decode_wait``, ``host_transform`` (the flow stream's transform,
        run on this thread for chunks not found in the cache; for a device
        flow, its launches, its device time falling in the next wait) and
        ``device_extract``.
        """
        stage = timer.stage if timer is not None else _null_stage
        transform = self._host_transform()
        outputs: list = []
        pending = None  # (output index, dispatch handle, cache path or None)

        def resolve(entry) -> None:
            """Wait for an in-flight chunk's features and store them."""
            if entry is None:
                return
            idx, dispatched, chunk_path = entry
            with stage("device_extract"):
                feats = self.materialize_features(dispatched)
            if chunk_path is not None:
                atomic_save(chunk_path, feats)
            outputs[idx] = feats

        source = VideoFrameSource(video_path, chunk_frames)
        try:
            chunks = iter(source)
            while True:
                with stage("decode_wait"):
                    chunk = next(chunks, None)
                if chunk is None:
                    break
                i = len(outputs)
                chunk_path = None
                if cache_dir is not None:
                    chunk_path = self.chunk_cache_path(cache_dir, video_path, i)
                    if os.path.exists(chunk_path):
                        resolve(pending)
                        pending = None
                        outputs.append(np.load(chunk_path))
                        continue
                if transform is not None:
                    with stage("host_transform"):
                        chunk = transform(chunk)
                outputs.append(None)
                prev = pending
                pending = (i, self.dispatch_frames(chunk), chunk_path)
                resolve(prev)
            resolve(pending)
        finally:
            source.close()
        if not outputs:
            raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
        return np.vstack(outputs)

    def chunk_cache_path(self, cache_dir: str, video_path: str, index: int) -> str:
        """Per-chunk feature cache, the reference's layout:
        ``<cache_dir>/<stem>/<stem>_{index}.npy``; the flow stream's stem
        is ``<stem>_flow``, so two streams into one directory never
        collide."""
        stem = os.path.splitext(os.path.basename(video_path))[0]
        if self.stream == "flow":
            stem = f"{stem}_flow"
        return os.path.join(cache_dir, stem, f"{stem}_{index}.npy")

    def _calibrate(self, frames: Frames) -> None:
        """Calibrate the int8 activation scales on the first chunk.

        At most four clips of it go through the exact resize, the crops of
        this extractor's protocol (ten, or the center one) and the
        standardization (flow: the dequantization), as the JAX package's
        calibration does, then one
        unquantized forward of the unfused chain records every conv
        input's range (``models.i3d.calibrate_act_scales``). Later chunks
        that exceed a calibrated range saturate.
        """
        n_frames = int(min(frames.shape[0], 4 * self.frames_per_clip))
        sample = _on_device(frames[:n_frames], self.device)
        out_h, out_w = short_side_size(sample.shape[1], sample.shape[2], self.resize)
        resized = resize_bilinear_exact(sample, out_h, out_w)
        if self.n_crops == 1:
            crops = center_crop(resized, self.cropsize)[None]
        else:
            crops = ten_crop(resized, self.cropsize)
        clip_idx = loop_pad_indices(n_frames, self.frames_per_clip).astype(np.int64)
        clips = crops[:, torch.from_numpy(clip_idx).to(self.device)]  # (n_crops, n, fpc, ...)
        clips = flow_standardize(clips) if self.stream == "flow" else standardize(clips)
        batch = clips.reshape(-1, self.frames_per_clip, self.cropsize, self.cropsize,
                              self.channels)
        with self._precision():
            self.model.act_scales = calibrate_act_scales(self.model, batch)
        if self._calibration_path is not None:
            _write_json(self._calibration_path, self.model.act_scales)

    def pin_calibration(self, outdir: str) -> None:
        """Pin the int8 scales to a feature directory.

        The first quantized run into ``outdir`` records its scales in
        ``act_scales_<stream>.json``; later runs load them instead of
        calibrating on their own first chunk, so one directory holds one
        quantization. Scales applied before (calibrated elsewhere) are
        written here at once. No-op for a full-precision extractor.
        """
        if not self.quantize:
            return
        os.makedirs(outdir, exist_ok=True)
        # the JAX package's sidecar name, one per stream
        self._calibration_path = os.path.join(outdir, f"act_scales_{self.stream}.json")
        if os.path.exists(self._calibration_path):
            with open(self._calibration_path) as f:
                self.model.act_scales = json.load(f)
        elif not self._needs_calibration:
            _write_json(self._calibration_path, self.model.act_scales)

    def ensure_calibrated(self, outdir: str, video_path: str,
                          chunk_frames: int = CHUNK_FRAMES) -> None:
        """Make sure ``outdir`` holds the scales sidecar: load it, or
        calibrate on the first chunk of ``video_path`` (through the
        stream's transform) and write it, even when no video of the
        directory is left to extract. No-op for a full-precision
        extractor."""
        if not self.quantize:
            return
        self.pin_calibration(outdir)
        if not self._needs_calibration:
            return
        source = VideoFrameSource(video_path, chunk_frames)
        try:
            chunk = next(iter(source), None)
        finally:
            source.close()
        if chunk is None:
            raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
        transform = self._host_transform()
        self._calibrate(chunk if transform is None else transform(chunk))


def _write_json(path: str, value) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(value, f)
    os.replace(tmp, path)


def _null_stage(name: str):
    return contextlib.nullcontext()


def _cached_chunk(extractor: FeatureExtractor, chunk: np.ndarray, path: str, index: int,
                  cache: Optional[str], transform=None, stage=_null_stage) -> np.ndarray:
    """One chunk's features, serially, with the per-chunk cache: read from
    ``cache`` where the chunk is there, else ``transform``ed (the flow
    stream's, only on such a miss) and extracted, and written there when
    ``cache`` is set. ``stage`` is a ``StageTimer.stage``-like context
    factory."""
    chunk_path = None
    if cache is not None:
        chunk_path = extractor.chunk_cache_path(cache, path, index)
        if os.path.exists(chunk_path):
            return np.load(chunk_path)
    if transform is not None:
        with stage("host_transform"):
            chunk = transform(chunk)
    with stage("device_extract"):
        feats = extractor.extract_frames(chunk)
    if chunk_path is not None:
        atomic_save(chunk_path, feats)
    return feats


def feature_filename(stem: str, stream: str = "rgb") -> str:
    """``<stem>_i3d.npy`` for RGB, the reference's on-disk name, and
    ``<stem>_flow.npy`` for the flow stream, so two streams written into
    one directory neither collide nor mislabel each other."""
    return f"{stem}_{'i3d' if stream == 'rgb' else 'flow'}.npy"


def record_flow_backend(outdir: str, backend: str) -> None:
    """Pin the flow backend of a feature directory in ``flow_backend.json``,
    the JAX package's ``record_flow_backend``.

    The backends differ numerically (host and device Farneback agree only in
    distribution; TV-L1 is another algorithm), so resuming a directory with
    another backend would mix flow definitions. The first flow run pins its
    backend; a later run with another raises.
    """
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "flow_backend.json")
    if os.path.exists(path):
        with open(path) as f:
            previous = json.load(f).get("flow_backend")
        if previous != backend:
            raise ValueError(
                f"{outdir} holds flow features from the {previous!r} backend but this run uses "
                f"{backend!r}; the flow backends differ numerically. Pass "
                f"flow_backend={previous!r} to resume, or use a fresh outdir.")
        return
    print(f"flow backend: {backend} (pinned in {path})")
    _write_json(path, {"flow_backend": backend})


def record_crop_protocol(outdir: str, crops: str) -> None:
    """Pin the crop protocol of a feature directory in ``crops.json``, the
    JAX package's ``record_crop_protocol``.

    Ten-crop ``(n, 10, 2048)`` and center-crop ``(n, 1, 2048)`` features
    share filenames, so resuming a directory under the other protocol would
    mix them. A center-crop run pins ``{"crops": "center"}``; a ten-crop run
    writes nothing, and a directory with feature files but no pin is
    ten-crop. Raises when ``crops`` differs from the directory's protocol.
    """
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "crops.json")
    previous = None
    if os.path.exists(path):
        with open(path) as f:
            previous = json.load(f).get("crops")
    elif any(name.endswith(("_i3d.npy", "_flow.npy")) for name in os.listdir(outdir)):
        previous = "ten"  # unpinned features predate the center protocol
    if previous is not None:
        if previous != crops:
            raise ValueError(
                f"{outdir} holds {previous}-crop features but this run uses crops={crops!r}; "
                f"the two protocols are shape-incompatible on disk ((n, 10, 2048) vs "
                f"(n, 1, 2048)). Pass crops={previous!r} to resume, or use a fresh outdir.")
        return
    if crops != "ten":
        print(f"crop protocol: {crops} (pinned in {path})")
        _write_json(path, {"crops": crops})


def _progress_bar(total: int, progress: bool):
    """A tqdm bar of ``total`` steps where tqdm is installed and
    ``progress`` is set, else None."""
    if progress:
        try:
            from tqdm.auto import tqdm

            return tqdm(total=total)
        except ImportError:
            pass
    return None


def _pin_directory(outdir: str, extractors: Sequence[FeatureExtractor]) -> None:
    """Check and pin ``outdir``'s crop protocol, its flow backend when a
    flow extractor writes there, and each extractor's int8 scales, before
    anything is built or written."""
    os.makedirs(outdir, exist_ok=True)
    record_crop_protocol(outdir, extractors[0].crops)
    for ex in extractors:
        if ex.stream == "flow":
            record_flow_backend(outdir, ex.flow_backend)
    for ex in extractors:
        ex.pin_calibration(outdir)


def _check_two_streams(rgb_extractor: FeatureExtractor, flow_extractor: FeatureExtractor) -> None:
    if rgb_extractor.stream != "rgb" or flow_extractor.stream != "flow":
        raise ValueError("extractors must be (rgb, flow) in that order")
    if rgb_extractor.crops != flow_extractor.crops:
        raise ValueError("two-stream extractors must share a crop protocol, got "
                         f"{rgb_extractor.crops!r} vs {flow_extractor.crops!r}")


def extract_videos(video_paths: Sequence[str], outdir: str, extractor: FeatureExtractor,
                   chunk_cache_for_large: bool = True, progress: bool = True,
                   timer=None) -> int:
    """Extract every video into ``outdir/<stem>_i3d.npy`` (or
    ``_flow.npy``), one at a time, skipping those already on disk. Checks
    (and for center crops pins) the directory's crop protocol and, for the
    flow stream, its flow backend before anything is built or written, and
    pins the int8 scales to ``outdir``. Videos over 1 GB
    (``is_large_video``) keep per-chunk caches in ``outdir`` when
    ``chunk_cache_for_large``, so an interrupted run resumes them.
    ``timer`` is handed to ``extract_video``. Returns the number of videos
    extracted.
    """
    _pin_directory(outdir, [extractor])
    bar = _progress_bar(len(video_paths), progress)
    n_done = 0
    try:
        for path in video_paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            savepath = os.path.join(outdir, feature_filename(stem, extractor.stream))
            if not os.path.exists(savepath):
                cache = outdir if chunk_cache_for_large and is_large_video(path) else None
                atomic_save(savepath, extractor.extract_video(path, cache_dir=cache, timer=timer))
                n_done += 1
            if bar is not None:
                bar.update(1)
    finally:
        if bar is not None:
            bar.close()
    return n_done


def extract_videos_two_stream(video_paths: Sequence[str], outdir: str,
                              rgb_extractor: FeatureExtractor, flow_extractor: FeatureExtractor,
                              chunk_frames: int = CHUNK_FRAMES, chunk_cache_for_large: bool = True,
                              progress: bool = True, timer=None) -> int:
    """RGB and flow features of every video from one decode pass, serially:
    each decoded chunk feeds the RGB extractor as it is and the flow
    extractor through its flow transform, writing ``<stem>_i3d.npy`` and
    ``<stem>_flow.npy``. A video is decoded again only if one of its files
    is missing, and only the missing streams are extracted. Pins as
    ``extract_videos`` does; large videos keep per-stream chunk caches.
    ``timer``: a ``StageTimer`` given ``decode_wait``, ``host_transform``
    and ``device_extract``. Returns the number of videos extracted.
    """
    _check_two_streams(rgb_extractor, flow_extractor)
    _pin_directory(outdir, [rgb_extractor, flow_extractor])
    transform = flow_extractor._host_transform()
    stage = timer.stage if timer is not None else _null_stage
    bar = _progress_bar(len(video_paths), progress)
    n_done = 0
    try:
        for path in video_paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            rgb_path = os.path.join(outdir, feature_filename(stem, "rgb"))
            flow_path = os.path.join(outdir, feature_filename(stem, "flow"))
            need_rgb, need_flow = not os.path.exists(rgb_path), not os.path.exists(flow_path)
            if need_rgb or need_flow:
                cache = outdir if chunk_cache_for_large and is_large_video(path) else None
                rgb_chunks, flow_chunks = [], []
                source = VideoFrameSource(path, chunk_frames)
                try:
                    chunks = iter(source)
                    index = 0
                    while True:
                        with stage("decode_wait"):
                            chunk = next(chunks, None)
                        if chunk is None:
                            break
                        if need_rgb:
                            rgb_chunks.append(_cached_chunk(rgb_extractor, chunk, path, index,
                                                            cache, stage=stage))
                        if need_flow:
                            flow_chunks.append(_cached_chunk(flow_extractor, chunk, path, index,
                                                             cache, transform, stage))
                        index += 1
                finally:
                    source.close()
                if index == 0:
                    raise ValueError(f"{path}: decoded zero frames (corrupt or empty video)")
                if need_rgb:
                    atomic_save(rgb_path, np.vstack(rgb_chunks))
                if need_flow:
                    atomic_save(flow_path, np.vstack(flow_chunks))
                n_done += 1
            if bar is not None:
                bar.update(1)
    finally:
        if bar is not None:
            bar.close()
    return n_done


def extract_video_two_stream(rgb_extractor: FeatureExtractor, flow_extractor: FeatureExtractor,
                             video_path: str, chunk_frames: int = CHUNK_FRAMES,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """One video -> (RGB, flow) features ``((n_clips, n_crops, 2048),
    (n_clips, n_crops, 2048))`` from one decode pass, for serving
    (``infer --stream both``): each chunk feeds the RGB extractor and,
    through the flow transform, the flow extractor, on this thread."""
    _check_two_streams(rgb_extractor, flow_extractor)
    transform = flow_extractor._host_transform()
    rgb_chunks, flow_chunks = [], []
    source = VideoFrameSource(video_path, chunk_frames)
    try:
        for chunk in source:
            rgb_chunks.append(rgb_extractor.extract_frames(chunk))
            flow_chunks.append(flow_extractor.extract_frames(transform(chunk)))
    finally:
        source.close()
    if not rgb_chunks:
        raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
    return np.vstack(rgb_chunks), np.vstack(flow_chunks)


def extract_videos_pooled(
    video_paths: Sequence[str],
    outdir: str,
    extractor: FeatureExtractor,
    flow_extractor: Optional[FeatureExtractor] = None,
    decode_workers: Optional[int] = None,
    chunk_frames: int = CHUNK_FRAMES,
    chunk_cache_for_large: bool = True,
    progress: bool = True,
) -> int:
    """Many videos, decoded by a pool of threads into one device queue.

    One decode stream cannot keep the device busy, so ``decode_workers``
    videos (default: one per core, at most 8) decode at once into a queue
    of ``QUEUE_CHUNKS`` chunks, which bounds the host memory of raw frames.
    This thread takes the chunks in arrival order and dispatches each, one
    deep as ``extract_video`` does; each video's file is assembled from its
    chunks in index order once its producer reports it done. Outputs, skip
    of existing files and per-chunk caches of large videos are those of
    ``extract_videos``: cached chunks are read back, not extracted, and stay
    on disk (as paths) until assembly.

    ``extractor`` may be either stream. With ``flow_extractor`` it must be
    the RGB one, and each decoded chunk feeds both streams, writing
    ``<stem>_i3d.npy`` and ``<stem>_flow.npy`` (the pooled
    ``extract_videos_two_stream``); only missing streams are extracted. The
    flow transform runs on a chunk not found in the cache: OpenCV's
    (``host``) in the decode threads, a device backend's on this thread
    just before its dispatch, so no decode thread launches on the card
    (the host-side transform is the part that needs the threads' cores).

    An error in a producer re-raises here; on any exit the producers' puts
    time out against a stop event, so no decode thread stays blocked.
    Returns the number of videos extracted.
    """
    if flow_extractor is not None:
        _check_two_streams(extractor, flow_extractor)
    if decode_workers is None:
        decode_workers = min(8, os.cpu_count() or 1)
    sinks: Dict[str, FeatureExtractor] = {extractor.stream: extractor}
    if flow_extractor is not None:
        sinks["flow"] = flow_extractor
    _pin_directory(outdir, list(sinks.values()))
    transforms = {name: ex._host_transform() for name, ex in sinks.items()}
    in_decode = {name: fn for name, fn in transforms.items()
                 if fn is not None and not sinks[name].transform_on_device}
    on_device = {name: fn for name, fn in transforms.items()
                 if fn is not None and sinks[name].transform_on_device}

    def savepath_for(path: str, name: str) -> str:
        stem = os.path.splitext(os.path.basename(path))[0]
        return os.path.join(outdir, feature_filename(stem, name))

    # per video, the streams whose file is missing; of videos that share a
    # stem (and so files) only the first, as the serial path extracts only
    # the first
    todo, claimed = [], set()
    for path in video_paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        if stem in claimed:
            continue
        claimed.add(stem)
        needed = tuple(name for name in sinks if not os.path.exists(savepath_for(path, name)))
        if needed:
            todo.append((path, needed,
                         outdir if chunk_cache_for_large and is_large_video(path) else None))
    if not todo:
        return 0

    chunk_queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=QUEUE_CHUNKS)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                chunk_queue.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer(path: str, needed: Tuple[str, ...], cache: Optional[str]) -> None:
        source = None
        try:
            source = VideoFrameSource(path, chunk_frames)
            index = -1
            for index, chunk in enumerate(source):
                payload = {}
                for name in needed:
                    if cache is not None and os.path.exists(
                            sinks[name].chunk_cache_path(cache, path, index)):
                        payload[name] = None  # read back by the consumer: no frames
                    elif name in in_decode:
                        payload[name] = in_decode[name](chunk)
                    else:
                        payload[name] = chunk
                if not _put(("chunk", path, index, (cache, payload))):
                    return
            if index < 0:
                raise ValueError(f"{path}: decoded zero frames (corrupt or empty video)")
            _put(("done", path, index + 1, None))
        except BaseException as exc:  # re-raised by the consumer
            _put(("error", path, 0, exc))
        finally:
            if source is not None:
                source.close()

    pool = ThreadPoolExecutor(max_workers=max(1, decode_workers),
                              thread_name_prefix="decode-pool")
    for path, needed, cache in todo:
        pool.submit(producer, path, needed, cache)
    bar = _progress_bar(len(todo), progress)

    # per (video, stream), the chunks in flight: cached ones as paths
    # (features on disk), the others as arrays, so host memory stays
    # bounded for large videos
    partial: dict = {}
    totals: dict = {}
    remaining = {path: set(needed) for path, needed, _ in todo}
    pending = None  # the 1-deep device pipeline, as in extract_video

    def resolve(entry) -> None:
        if entry is None:
            return
        key, res_index, res_chunk_path, ex, dispatched = entry
        feats = ex.materialize_features(dispatched)
        if res_chunk_path is not None:
            atomic_save(res_chunk_path, feats)
            feats = res_chunk_path
        partial.setdefault(key, {})[res_index] = feats

    def assemble(path: str, name: str) -> bool:
        """Write the (video, stream) file if every chunk of it is in."""
        chunks = partial.get((path, name), {})
        if path not in totals or len(chunks) != totals[path]:
            return False
        feats = np.vstack([np.load(c) if isinstance(c, str) else c
                           for c in (chunks[i] for i in range(totals[path]))])
        atomic_save(savepath_for(path, name), feats)
        partial.pop((path, name), None)
        return True

    n_done = 0
    try:
        while n_done < len(todo):
            kind, path, index, payload = chunk_queue.get()
            if kind == "error":
                raise payload
            if kind == "chunk":
                cache, chunks = payload
                for name, chunk in chunks.items():
                    ex = sinks[name]
                    chunk_path = None if cache is None else ex.chunk_cache_path(cache, path, index)
                    if chunk is None or (chunk_path is not None and os.path.exists(chunk_path)):
                        resolve(pending)
                        pending = None
                        partial.setdefault((path, name), {})[index] = chunk_path
                    else:
                        if name in on_device:
                            chunk = on_device[name](chunk)
                        # dispatch this chunk before waiting on the previous one
                        prev = pending
                        pending = ((path, name), index, chunk_path, ex, ex.dispatch_frames(chunk))
                        resolve(prev)
            else:
                totals[path] = index
                # "done" follows all of a video's chunks: resolving here
                # lets its assembly below see every chunk
                resolve(pending)
                pending = None
            for name in list(remaining.get(path, ())):
                if assemble(path, name):
                    remaining[path].discard(name)
            if path in remaining and not remaining[path]:
                remaining.pop(path)
                n_done += 1
                if bar is not None:
                    bar.update(1)
    finally:
        stop.set()
        pool.shutdown(wait=True, cancel_futures=True)
        if bar is not None:
            bar.close()
    return n_done
