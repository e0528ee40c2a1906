"""PyTorch port vs the JAX package: the scoring CLI's anomaly events, the
video discovery both CLIs share (recursive, case-insensitive, class
subfolders; fault 4) with its duplicate-stem warning, and the warm-up
buckets.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

import extract_features as j_extract_features
import infer as j_infer
from anomaly_detection_on_video_tpu.ops import metrics as jmetrics
from anomaly_detection_on_video_tpu.utils.aot import export_buckets
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch.data.video import find_videos, warn_duplicate_stems
from anomaly_detection_on_video_tpu_torch.ops.metrics import anomaly_events
from anomaly_detection_on_video_tpu_torch.training.runner import buckets_up_to
from torch_infer_fixtures import _narrow_extractor, _touch, _write_avi
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------- events

EVENT_CASES = {
    "seeded": (np.random.RandomState(0).rand(200), 0.6, 1),
    "seeded_debounced": (np.random.RandomState(1).rand(300), 0.4, 3),
    "all_above": (np.full(48, 0.9), 0.5, 1),
    "none_above": (np.full(48, 0.1), 0.5, 1),
    "run_at_last_frame": (np.r_[np.zeros(20), np.linspace(0.6, 0.9, 12)], 0.5, 1),
    "min_frames": (np.repeat(np.random.RandomState(2).rand(40), 16), 0.5, 32),
}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_anomaly_events_match_jax(case):
    scores, threshold, min_frames = EVENT_CASES[case]
    got = anomaly_events(scores, threshold, min_frames)
    assert got == jmetrics.anomaly_events(scores, threshold, min_frames)
    if case == "run_at_last_frame":
        assert got[-1]["end_frame"] == len(scores) - 1


def _video_tree(root):
    """The UCF-Crime layout: videos in class subfolders, one stem twice."""
    for rel in ("Abuse/Abuse001_x264.mp4", "Normal/Normal_Videos_003_x264.MP4",
                "Normal/deeper/Normal_Videos_010_x264.avi", "Fighting/Abuse001_x264.avi",
                "Abuse/notes.txt", "top[1].mkv"):
        _touch(os.path.join(root, rel))
    return str(root)


def test_find_videos_matches_jax(tmp_path):
    """Recursive, case-insensitive, sorted discovery of a directory; a
    file named with glob characters is itself; a glob is a glob."""
    root = _video_tree(tmp_path / "vids")
    found = find_videos(root)
    assert len(found) == 5 and not any(p.endswith(".txt") for p in found)
    assert found == j_infer.find_videos(root) == j_extract_features.find_videos(root)
    single = os.path.join(root, "top[1].mkv")
    assert find_videos(single) == j_infer.find_videos(single) == [single]
    pattern = os.path.join(root, "*", "*.mp4")
    assert find_videos(pattern) == j_infer.find_videos(pattern) == [
        os.path.join(root, "Abuse", "Abuse001_x264.mp4")]
    assert find_videos(os.path.join(root, "missing*.mp4")) == []


def test_warn_duplicate_stems_matches_jax(tmp_path):
    paths = find_videos(_video_tree(tmp_path / "vids"))
    outputs = []
    for warn in (warn_duplicate_stems, j_extract_features.warn_duplicate_stems):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            dups = warn(paths, what="scored")
        outputs.append((dups, err.getvalue()))
    assert outputs[0] == outputs[1]
    assert list(outputs[0][0]) == ["Abuse001_x264"] and "will be scored" in outputs[0][1]


def test_extract_features_finds_class_subfolders(rng, tmp_path, monkeypatch, capsys):
    """Both CLIs pointed at a UCF-Crime style tree: every video of every
    class subfolder is extracted (the port listed only the top level and
    found none), a shared stem is warned about, and an empty directory
    exits with each JAX CLI's message."""
    vids = tmp_path / "vids"
    for rel in ("Abuse/Abuse001_x264.avi", "Normal/Normal_Videos_003_x264.avi",
                "Normal/again/Abuse001_x264.avi"):
        _write_avi(vids / rel, rng)
    monkeypatch.setattr(t_extract_features, "FeatureExtractor",
                        lambda **kw: _narrow_extractor(**dict(kw, dtype=torch.float32)))
    t_extract_features.main(["--videos", str(vids), "--outdir", str(tmp_path / "out"),
                             "--device", "cpu", "--batch", "20"])
    assert sorted(os.listdir(tmp_path / "out")) == ["Abuse001_x264_i3d.npy",
                                                    "Normal_Videos_003_x264_i3d.npy",
                                                    "segment_features_32"]
    assert np.load(tmp_path / "out" / "Abuse001_x264_i3d.npy").shape == (2, 10, 64)
    assert "2 videos share the stem 'Abuse001_x264'" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no videos found under"):
        t_extract_features.main(["--videos", str(empty), "--outdir", str(tmp_path / "o"),
                                 "--device", "cpu"])
    with pytest.raises(SystemExit, match="no videos match"):
        t_infer.main(["--videos", str(empty), "--outdir", str(tmp_path / "o"),
                      "--torch-weights", "w.pt", "--device", "cpu"])


@pytest.mark.parametrize("max_clips", [1, 5, 32, 40, 100, 1024])
def test_warmup_buckets_match_jax(max_clips):
    assert buckets_up_to(max_clips) == export_buckets(max_clips)
