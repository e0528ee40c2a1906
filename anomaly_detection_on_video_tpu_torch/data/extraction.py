"""I3D feature extraction for the RGB ten-crop stream.

Counterpart of the JAX package's ``data/extraction.py`` ``FeatureExtractor``
(``pad_frames``, ``_group_for``, ``extract_frames``, ``extract_video`` and the
resize -> crop -> forward pipeline). Frames are loop-padded on the host so
every clip is a contiguous run of frames, resized on the device, then each
group of clips goes through kernel K1 (ten-crop + standardize) and the
i3res50 forward (kernels K2 and K3). The JAX package's ``lax.map`` over
groups is a Python loop here. Output: ``(n_clips, 10, 2048)`` float32, the
reference's on-disk feature contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models import seeded_init_
from ..models.i3d import build_i3d_feature_extractor
from ..ops.kernels.crop_norm import ten_crop_standardize
from ..ops.resize import resize_bilinear_exact, resize_bilinear_fast, short_side_size
from ..utils.device import DeviceLike, resolve_device
from .video import CHUNK_FRAMES, VideoFrameSource


class FeatureExtractor:
    """Ten-crop RGB I3D extractor.

    ``batch`` bounds the (clip, crop) forwards per step: clips go in groups
    of ``batch // 10``, the last group padded with copies of the final clip
    whose results are dropped. ``model`` replaces the named model (tests
    pass a narrow ``I3DResNet``); without ``state_dict`` the weights are
    random from ``seed``. float32 runs are parity runs and take the exact
    PIL resize; bfloat16 runs take the float resize (bfloat16 convs already
    break bit-parity).
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
