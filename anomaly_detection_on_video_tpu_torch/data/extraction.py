"""I3D feature extraction for the RGB ten-crop stream.

Counterpart of the JAX package's ``data/extraction.py`` ``FeatureExtractor``
(``pad_frames``, ``_group_for``, ``extract_frames``, ``extract_video`` and the
resize -> crop -> forward pipeline). Frames are loop-padded on the host so
every clip is a contiguous run of frames, resized on the device, then each
group of clips goes through kernel K1 (ten-crop + standardize) and the
i3res50 forward (kernels K2 and K3). The JAX package's ``lax.map`` over
groups is a Python loop here. Output: ``(n_clips, 10, 2048)`` float32, the
reference's on-disk feature contract.

``quantize=True`` is the int8 extractor (the JAX package's
``FeatureExtractor(quantize=True)``): the first chunk calibrates static
per-conv activation scales (``_calibrate``), then every conv runs in int8
through kernels K4 and K5. ``pin_calibration`` keeps one set of scales per
feature directory in ``act_scales_rgb.json``, the JAX package's sidecar
name and format, so either package resumes the other's directory.
``extract_videos`` is the serial, skip-existing directory extraction.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..models import seeded_init_
from ..models.i3d import build_i3d_feature_extractor, calibrate_act_scales
from ..ops.gtransforms import loop_pad_indices, standardize, ten_crop
from ..ops.kernels.crop_norm import ten_crop_standardize
from ..ops.resize import resize_bilinear_exact, resize_bilinear_fast, short_side_size
from ..utils.device import DeviceLike, resolve_device
from ..utils.npyio import atomic_save
from .video import CHUNK_FRAMES, VideoFrameSource, iter_decoded_chunks

# the JAX package's sidecar of int8 scales for the RGB stream
CALIBRATION_FILE = "act_scales_rgb.json"


class FeatureExtractor:
    """Ten-crop RGB I3D extractor.

    ``batch`` bounds the (clip, crop) forwards per step: clips go in groups
    of ``batch // 10``, the last group padded with copies of the final clip
    whose results are dropped. ``model`` replaces the named model (tests
    pass a narrow ``I3DResNet``); without ``state_dict`` the weights are
    random from ``seed``. float32 runs are parity runs and take the exact
    PIL resize; bfloat16 runs take the float resize (bfloat16 convs already
    break bit-parity). ``quantize`` runs the convs in int8, computing in
    ``dtype`` around them, with scales calibrated on the first chunk
    unless ``pin_calibration`` loads them.
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
    ):
        self.device = resolve_device(device)
        if model is None:
            model = build_i3d_feature_extractor(model_name, dtype=dtype)
        model.dtype = dtype
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            seeded_init_(model, seed)
        self.model = model.to(self.device).eval()
        self.dtype = dtype
        self.n_crops = 10
        self.group_clips = max(1, batch // self.n_crops)
        self.adaptive_groups = adaptive_groups
        self.frames_per_clip = frames_per_clip
        self.resize = resize
        self.cropsize = cropsize
        self.quantize = quantize
        self._calibration_path: Optional[str] = None  # set by pin_calibration

    @property
    def _needs_calibration(self) -> bool:
        return self.quantize and self.model.act_scales is None

    def _group_for(self, n_clips: int) -> int:
        """Clips per group: always ``group_clips`` in fixed mode; in
        adaptive (serving) mode the smallest power of two that holds the
        request, capped at ``group_clips``."""
        if not self.adaptive_groups or n_clips >= self.group_clips:
            return self.group_clips
        rung = 1 << max(0, n_clips - 1).bit_length()
        return min(rung, self.group_clips)

    def pad_frames(self, frames: np.ndarray, group_clips: Optional[int] = None) -> np.ndarray:
        """Host loop-pad + group-pad of the raw uint8 frames: a short tail
        clip repeats its own frames (tail[i % L]); the last group fills
        with copies of the final clip."""
        fpc = self.frames_per_clip
        gc = group_clips or self.group_clips
        n_frames = frames.shape[0]
        n_clips = (n_frames - 1) // fpc + 1
        tail = n_frames - (n_clips - 1) * fpc
        if tail != fpc:
            tail_frames = frames[(n_clips - 1) * fpc:]
            reps = -(-fpc // tail)
            pad = np.tile(tail_frames, (reps, 1, 1, 1))[: fpc - tail]
            frames = np.concatenate([frames, pad])
        missing = -(-n_clips // gc) * gc - n_clips
        if missing:
            last_clip = frames[-fpc:]
            frames = np.concatenate([frames] + [last_clip] * missing)
        return frames

    @torch.no_grad()
    def extract_frames(self, frames: np.ndarray) -> np.ndarray:
        """uint8 (n_frames, H, W, 3) -> float32 (n_clips, 10, C)."""
        if self._needs_calibration:
            self._calibrate(frames)
        fpc = self.frames_per_clip
        n_clips = (frames.shape[0] - 1) // fpc + 1
        gc = self._group_for(n_clips)
        padded = torch.from_numpy(np.ascontiguousarray(self.pad_frames(frames, gc)))
        padded = padded.to(self.device)
        height, width = padded.shape[1], padded.shape[2]
        out_h, out_w = short_side_size(height, width, self.resize)
        resize_fn = resize_bilinear_exact if self.dtype == torch.float32 else resize_bilinear_fast
        resized = resize_fn(padded, out_h, out_w).contiguous()  # uint8 on the device
        groups = resized.reshape(-1, gc, fpc, out_h, out_w, 3)
        feats = []
        for group in groups:
            x = ten_crop_standardize(group, self.cropsize, self.dtype)  # K1
            feats.append(self.model(x).reshape(gc, self.n_crops, -1))
        out = torch.cat(feats)[:n_clips]
        return out.to(torch.float32).cpu().numpy()

    def extract_video(self, video_path: str, chunk_frames: int = CHUNK_FRAMES) -> np.ndarray:
        """Whole-video extraction over decoded chunks; a worker thread
        decodes the next chunk while the device runs this one."""
        outputs = [self.extract_frames(chunk) for chunk in VideoFrameSource(video_path, chunk_frames)]
        if not outputs:
            raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
        return np.vstack(outputs)

    def _calibrate(self, frames: np.ndarray) -> None:
        """Calibrate the int8 activation scales on the first chunk.

        At most four clips of it go through the exact resize, the ten
        crops and the standardization, as the JAX package's calibration
        does, then one unquantized forward of the unfused chain records
        every conv input's range (``models.i3d.calibrate_act_scales``).
        Later chunks that exceed a calibrated range saturate.
        """
        n_frames = int(min(frames.shape[0], 4 * self.frames_per_clip))
        sample = torch.from_numpy(np.ascontiguousarray(frames[:n_frames])).to(self.device)
        out_h, out_w = short_side_size(sample.shape[1], sample.shape[2], self.resize)
        crops = ten_crop(resize_bilinear_exact(sample, out_h, out_w), self.cropsize)
        clip_idx = loop_pad_indices(n_frames, self.frames_per_clip).astype(np.int64)
        clips = standardize(crops[:, torch.from_numpy(clip_idx).to(self.device)])  # (10, n, fpc, ...)
        batch = clips.reshape(-1, self.frames_per_clip, self.cropsize, self.cropsize, 3)
        self.model.act_scales = calibrate_act_scales(self.model, batch)
        if self._calibration_path is not None:
            _write_json(self._calibration_path, self.model.act_scales)

    def pin_calibration(self, outdir: str) -> None:
        """Pin the int8 scales to a feature directory.

        The first quantized run into ``outdir`` records its scales in
        ``act_scales_rgb.json``; later runs load them instead of
        calibrating on their own first chunk, so one directory holds one
        quantization. Scales applied before (calibrated elsewhere) are
        written here at once. No-op for a full-precision extractor.
        """
        if not self.quantize:
            return
        os.makedirs(outdir, exist_ok=True)
        self._calibration_path = os.path.join(outdir, CALIBRATION_FILE)
        if os.path.exists(self._calibration_path):
            with open(self._calibration_path) as f:
                self.model.act_scales = json.load(f)
        elif not self._needs_calibration:
            _write_json(self._calibration_path, self.model.act_scales)

    def ensure_calibrated(self, outdir: str, video_path: str,
                          chunk_frames: int = CHUNK_FRAMES) -> None:
        """Make sure ``outdir`` holds the scales sidecar: load it, or
        calibrate on the first chunk of ``video_path`` and write it, even
        when no video of the directory is left to extract. No-op for a
        full-precision extractor."""
        if not self.quantize:
            return
        self.pin_calibration(outdir)
        if not self._needs_calibration:
            return
        chunks = iter_decoded_chunks(video_path, chunk_frames)
        try:
            chunk = next(chunks, None)
        finally:
            chunks.close()
        if chunk is None:
            raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
        self._calibrate(chunk)


def _write_json(path: str, value) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(value, f)
    os.replace(tmp, path)


def feature_filename(stem: str) -> str:
    """``<stem>_i3d.npy``, the reference's on-disk name for RGB features."""
    return f"{stem}_i3d.npy"


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
        _write_json(path, {"crops": crops})


def extract_videos(video_paths: Iterable[str], outdir: str, extractor: FeatureExtractor) -> int:
    """Extract every video into ``outdir/<stem>_i3d.npy``, skipping those
    already on disk; checks the directory's crop protocol (this extractor
    is ten-crop) and pins the int8 scales to ``outdir`` first. Returns the
    number of videos extracted."""
    os.makedirs(outdir, exist_ok=True)
    record_crop_protocol(outdir, "ten")
    extractor.pin_calibration(outdir)
    n_done = 0
    for path in video_paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        savepath = os.path.join(outdir, feature_filename(stem))
        if os.path.exists(savepath):
            continue
        atomic_save(savepath, extractor.extract_video(path))
        n_done += 1
    return n_done
