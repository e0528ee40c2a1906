"""Helpers of the port's scoring-CLI tests (``tests/test_torch_infer_*.py``)
that other port tests share: files and videos on disk, the narrow
extractor, weights of each family in the JAX exporters' layouts, cached
features, and the CLIs' argument namespace. Not a test module.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from anomaly_detection_on_video_tpu.models import build_model as j_build_model
from anomaly_detection_on_video_tpu.utils import convert as jconvert
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models import MGFN, MGFNConfig, seeded_init_
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from test_torch_i3d import NARROW as I3D_NARROW
from test_torch_mgfn import randomize_norms
from torch_runner_fixtures import C


# ---------------------------------------------------- video discovery

def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb"):
        pass
    return str(path)


def _narrow_extractor(**kwargs):
    """The CLIs' FeatureExtractor at a narrow width and a small crop."""
    kwargs.setdefault("dtype", torch.float32)
    return FeatureExtractor(model=I3DResNet(stages=I3D_NARROW), resize=64, cropsize=56, **kwargs)


def _write_avi(path, rng, n_frames=20):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 120))
    for _ in range(n_frames):
        writer.write(rng.randint(0, 256, (120, 160, 3), np.uint8))
    writer.release()


# ------------------------------------------------ the scorer from weights

MODEL_CONFIG = {
    "mgfn": ["dims=[16,16,32]", "depths=[1,1,1]", "dim_head=8", f"channels={C}"],
    "rtfm": [f"channels={C}", "hidden_dims=[32,16]"],
    "sultani": [f"channels={C}", "hidden_dims=[32,16]"],
}
# the official remap puts an intermediate at block index 3: the reference's depths
MODEL_CONFIG["mgfn_official"] = ["dims=[16,16,32]", "depths=[3,3,1]", "dim_head=8",
                                 f"channels={C}"]
EXPORT = {"mgfn": jconvert.export_mgfn_state_dict, "rtfm": jconvert.export_rtfm_state_dict,
          "sultani": jconvert.export_sultani_state_dict}


def official_mgfn_layout(hf):
    """HF-named MGFN tensors -> the official release's keys, the inverse of
    the reference's official -> HF remap (scripts/convert_official_to_hf.py)."""
    out = {}
    for key, value in hf.items():
        parts = key.split(".")
        if parts[0] == "backbone" and parts[1] == "amplifier":
            out[".".join(parts[2:])] = value
        elif parts[0] == "layer_norm":
            out[f"to_logits.0.{parts[1]}"] = value
        elif parts[0] == "fc":
            out[key] = value
        else:
            stage, block, module, rest = parts[2], parts[3], parts[4], parts[5:]
            if module in ("layer_norm", "conv"):  # the intermediate, at block index 3
                out[f"stages.{stage}.1.{0 if module == 'layer_norm' else 1}.{rest[-1]}"] = value
            elif module == "scc":
                out[f"stages.{stage}.0.0.{block}.0.{rest[-1]}"] = value
            elif module == "attention":
                out[f"stages.{stage}.0.0.{block}.1.{rest[0]}.{rest[-1]}"] = value
            else:
                index = {"layer_norm": 0, "in_conv": 1, "out_conv": 4}[rest[0]]
                out[f"stages.{stage}.0.0.{block}.2.{index}.{rest[-1]}"] = value
    return out


def _flax_variables(name, config, rng, seed=0):
    _, model = j_build_model(name, **config)
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    jnp.zeros((2, 10, 8, config["channels"] + 1)))
    return randomize_norms(variables, rng) if name == "mgfn" else variables


def _save_weights(path, name, variables, official=False):
    sd = EXPORT[name](variables)
    if official:
        sd = official_mgfn_layout(sd)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, str(path))
    return str(path)


def _args(**kw):
    defaults = dict(model=None, model_config=None, checkpoint=None, torch_weights=None,
                    official=False, i3d_weights=None, checkpoint_step="latest", device="cpu")
    return argparse.Namespace(**dict(defaults, **kw))


# ----------------------------------------------------- main, end to end

class _NoExtractor:
    """The JAX CLI's extractor where every video's features are cached:
    built, never run (its full-width init would only cost compile time)."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs


NARROW_2048 = ["dims=[16,16,32]", "depths=[1,1,1]", "dim_head=8"]  # MGFN on 2048-d features


def _cached_videos(tmp_path, rng):
    """Two videos in class subfolders (empty files: never decoded) and
    their cached 2048-d features."""
    vids = tmp_path / "vids"
    feats = tmp_path / "feats"
    feats.mkdir()
    for rel, n in (("Abuse/Abuse001_x264.mp4", 9), ("Normal/Normal_Videos_003_x264.mp4", 40)):
        stem = os.path.splitext(os.path.basename(_touch(vids / rel)))[0]
        np.save(feats / f"{stem}_i3d.npy", (np.abs(rng.randn(n, 10, 2048)) * 0.5).astype(np.float32))
    return vids, feats


def _port_mgfn_weights(path, channels):
    """A seeded port MGFN's state dict (HF names) at ``channels``."""
    config = MGFNConfig(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=channels)
    torch.save(seeded_init_(MGFN(config), seed=3).state_dict(), str(path))
    return str(path)
