"""The PyTorch port's slice 1 end to end against the JAX package, plus the
port's independence from JAX.

Frames -> the port's FeatureExtractor (narrow I3D, CPU, float32, small
resize/crop) -> padded-bucket MGFN scores, against the same composition of
JAX functions.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.data.features import pad_eval_batch as j_pad_eval_batch
from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.ops import gtransforms as jgt
from anomaly_detection_on_video_tpu.ops.resize import resize_bilinear_exact, short_side_size
from anomaly_detection_on_video_tpu.training.runner import eval_bucket as j_eval_bucket
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.data.video import find_videos
from anomaly_detection_on_video_tpu_torch.infer import process_video, score_features
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_from_flax
from test_torch_i3d import NARROW, _randomize_bn
from test_torch_mgfn import build_pair
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "anomaly_detection_on_video_tpu_torch"


def _narrow_pair(rng, size):
    model = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32)
    x = jnp.zeros((1, 16, size, size, 3), jnp.float32)
    variables = _randomize_bn(jax.jit(model.init)(jax.random.PRNGKey(0), x), rng)
    port = I3DResNet(stages=NARROW)
    port.load_state_dict(i3d_state_dict_from_flax(variables))
    return model, variables, port


def test_slice_matches_jax_composition(rng):
    """20 frames (2 clips, tail 4) -> features -> scores, port vs JAX."""
    frames = rng.randint(0, 256, (20, 120, 160, 3), np.uint8)
    jmodel, jvars, port_i3d = _narrow_pair(rng, 56)
    mgfn, mvars, port_mgfn = build_pair(rng, ncrops=10)

    # JAX: loop-pad, exact resize, ten-crop, standardize, I3D, bucket, MGFN
    clips = frames[jgt.loop_pad_indices(20, 16)]  # (2, 16, H, W, 3)
    out_h, out_w = short_side_size(120, 160, 64)
    resized = resize_bilinear_exact(jnp.asarray(clips), out_h, out_w)
    crops = jgt.standardize(jgt.ten_crop(resized, 56))  # (10, 2, 16, 56, 56, 3)
    batch = jnp.transpose(crops, (1, 0, 2, 3, 4, 5)).reshape(20, 16, 56, 56, 3)
    # jitted: one compile each instead of op-by-op dispatch
    j_feats = np.asarray(jax.jit(jmodel.apply)(jvars, batch)).reshape(2, 10, -1)
    bucket = j_pad_eval_batch(j_feats, j_eval_bucket(2))
    scores_of = jax.jit(lambda v, x, n: mgfn.apply(v, x, length=n).scores)
    j_scores = np.asarray(scores_of(mvars, jnp.asarray(bucket), jnp.asarray([2])))[0, :2, 0]

    extractor = FeatureExtractor(model=port_i3d, state_dict=port_i3d.state_dict(),
                                 dtype=torch.float32, batch=20, resize=64, cropsize=56,
                                 device="cpu")
    feats = extractor.extract_frames(frames)
    assert feats.shape == (2, 10, 64) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, j_feats, rtol=1e-4, atol=1e-4)
    scores = score_features(feats, port_mgfn)
    np.testing.assert_allclose(scores, j_scores, atol=1e-4, rtol=0)


def test_extractor_padding_and_groups(rng):
    ex = FeatureExtractor(model=I3DResNet(stages=NARROW), dtype=torch.float32, batch=40,
                          device="cpu", adaptive_groups=True)
    assert ex.group_clips == 4
    assert [ex._group_for(n) for n in (1, 2, 3, 4, 9)] == [1, 2, 4, 4, 4]
    frames = np.arange(20)[:, None, None, None].repeat(2, 1).repeat(2, 2).repeat(3, 3)
    padded = ex.pad_frames(frames.astype(np.uint8), 4)
    assert padded.shape[0] == 4 * 16
    # tail of 4 frames loop-pads as tail[i % 4]; the group pads with the last clip
    np.testing.assert_array_equal(padded[16:32, 0, 0, 0], [16, 17, 18, 19] * 4)
    np.testing.assert_array_equal(padded[48:64, 0, 0, 0], padded[16:32, 0, 0, 0])


def test_infer_writes_score_json(rng, tmp_path):
    """The package CLI's per-video path on a real (cv2-written) video."""
    import cv2

    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 120))
    for _ in range(20):
        writer.write(rng.randint(0, 256, (120, 160, 3), np.uint8))
    writer.release()
    _, _, port_i3d = _narrow_pair(rng, 56)
    _, _, scorer = build_pair(rng, ncrops=10)
    extractor = FeatureExtractor(model=port_i3d, state_dict=port_i3d.state_dict(),
                                 dtype=torch.float32, batch=20, resize=64, cropsize=56,
                                 device="cpu")
    assert find_videos(str(tmp_path)) == [path]
    out = process_video(path, extractor, scorer, str(tmp_path / "scores"))
    on_disk = json.loads((tmp_path / "scores" / "clip_scores.json").read_text())
    assert on_disk == out
    assert set(out) == {"video", "model", "stream", "n_clips", "frames_per_clip",
                        "clip_scores", "frame_scores", "latency_s"}
    assert out["n_clips"] == 2 and len(out["frame_scores"]) == 32
    assert all(0.0 <= s <= 1.0 for s in out["frame_scores"])


def test_port_imports_no_jax():
    """Importing every port module pulls in neither jax nor the JAX package,
    nor matplotlib (imported only where a figure is drawn)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.split('.')[0] in ('anomaly_detection_on_video_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import jax|from jax)|anomaly_detection_on_video_tpu\."
        r"|anomaly_detection_on_video_tpu import", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        assert not pattern.search(text), f"{path} names JAX or the JAX package"
