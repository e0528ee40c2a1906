"""PyTorch port vs the JAX package: the scoring CLI's scorer side and the
video discovery both CLIs share.

``anomaly_events``; ``find_videos`` and ``warn_duplicate_stems`` on a
class-subfolder tree (the recursive discovery the port lacked); the
warm-up's bucket list; ``build_scorer`` + ``score_features`` from one
``.pt`` per scorer family (and the official MGFN layout) against the JAX
CLI's; ``main`` against the JAX ``main`` on cached features with events;
the flags of this CLI (``--warmup``, ``--group-mode``, ``--frames-per-clip``,
``--features-dir`` and the int8 pin); serving the port's own ``run``
checkpoints of RTFM and Sultani, with ``--checkpoint-step`` and
``--model-config``; and the port's ``run runner=rtfm|sultani`` against the
repository-root ``run.py``.
"""

import argparse
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extract_features as j_extract_features
import infer as j_infer
import run as j_run
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.models import build_model as j_build_model
from anomaly_detection_on_video_tpu.ops import metrics as jmetrics
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu.utils import convert as jconvert
from anomaly_detection_on_video_tpu.utils.aot import export_buckets
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.data.video import find_videos, warn_duplicate_stems
from anomaly_detection_on_video_tpu_torch.models import MGFN, MGFNConfig, build_model, seeded_init_
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from anomaly_detection_on_video_tpu_torch.ops.metrics import anomaly_events, frame_level_scores
from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState, buckets_up_to
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    rtfm_state_dict_from_flax,
    sultani_state_dict_from_flax,
)
from test_torch_i3d import NARROW as I3D_NARROW
from test_torch_mgfn import randomize_norms
from test_torch_runner import C, write_features


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


# ---------------------------------------------------- video discovery

def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb"):
        pass
    return str(path)


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


@pytest.mark.parametrize("case", ["mgfn", "mgfn_official", "rtfm", "sultani"])
def test_build_scorer_from_weights_matches_jax(rng, tmp_path, case):
    """One ``.pt`` per family (the JAX exporters' layouts; the official
    MGFN release layout with ``--official``) through both CLIs'
    ``build_scorer`` + ``score_features``: scores at 1e-5."""
    name = case.split("_")[0]
    official = case.endswith("official")
    overrides = MODEL_CONFIG[case]
    config = {k: v for k, v in (kv.split("=") for kv in overrides)}
    config = {k: json.loads(v) for k, v in config.items()}
    path = _save_weights(tmp_path / "w.pt", name, _flax_variables(name, config, rng), official)
    args = _args(model=name, model_config=overrides, torch_weights=path, official=official)
    apply_fn, variables, eval_step, j_name, _ = j_infer.build_scorer(args)
    scorer, t_name = t_infer.build_scorer(args)
    assert t_name == j_name == name and not scorer.training
    feats = (np.abs(rng.randn(7, 10, C)) * 0.5).astype(np.float32)
    want = j_infer.score_features(feats, apply_fn, variables, eval_step)
    np.testing.assert_allclose(t_infer.score_features(feats, scorer), want, atol=1e-5, rtol=1e-5)


def test_build_scorer_errors_match_jax(rng, tmp_path):
    """Path typos, a missing weights flag, a bad --model-config value and
    weights of another family exit in both CLIs with the same content."""
    rtfm = _save_weights(tmp_path / "rtfm.pt", "rtfm",
                         _flax_variables("rtfm", dict(channels=C, hidden_dims=[32, 16]), rng))
    cases = [
        (dict(checkpoint=str(tmp_path / "nope")), r"--checkpoint '.*nope': no such directory"),
        (dict(torch_weights=str(tmp_path / "nope.pt")), r"--torch-weights '.*nope.pt': no such file"),
        (dict(model="mgfn"), "one of --checkpoint / --torch-weights is required"),
        (dict(model="mgfn", model_config=["k=[unclosed"]), r"--model-config 'k=\[unclosed'"),
        (dict(model="mgfn", torch_weights=rtfm, model_config=MODEL_CONFIG["mgfn"]),
         r"(?s)does not look like a 'mgfn' state dict .*pass --model \{mgfn,rtfm,sultani\}"),
    ]
    for kw, pattern in cases:
        for build in (j_infer.build_scorer, t_infer.build_scorer):
            with pytest.raises(SystemExit, match=pattern):
                build(_args(**kw))


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


# the JSON rounds scores to 6 decimals: peaks and means recomputed from the
# written scores differ from the written ones by at most this
ROUNDING = 1.5e-6


def assert_events_close(got, want, atol):
    """Equal windows (start, end, frame count); peak and mean within
    ``atol``: the two frameworks' float32 scores differ in the last bits,
    which can move the 6th rounded decimal."""
    assert [{k: e[k] for k in ("start_frame", "end_frame", "frames")} for e in got] == [
        {k: e[k] for k in ("start_frame", "end_frame", "frames")} for e in want]
    for g, w in zip(got, want):
        assert abs(g["peak"] - w["peak"]) <= atol and abs(g["mean"] - w["mean"]) <= atol


def test_main_matches_jax_main_on_cached_features(rng, tmp_path, monkeypatch):
    """The port's main and the JAX main on the same cached features and
    weights, with --threshold, --min-event-frames and 8-frame clips: the
    same files and keys, clip scores to 1e-5, equal event windows (their
    peak and mean to 1e-5)."""
    vids, feats = _cached_videos(tmp_path, rng)
    overrides = NARROW_2048
    weights = _save_weights(tmp_path / "mgfn.pt", "mgfn", _flax_variables(
        "mgfn", dict(dims=[16, 16, 32], depths=[1, 1, 1], dim_head=8, channels=2048), rng))
    apply_fn, variables, eval_step, _, _ = j_infer.build_scorer(
        _args(torch_weights=weights, model_config=overrides))
    scores = j_infer.score_features(np.load(feats / "Normal_Videos_003_x264_i3d.npy"), apply_fn,
                                    variables, eval_step)
    threshold = float(np.round(np.median(scores), 3))  # events of several lengths
    common = ["--videos", str(vids), "--torch-weights", weights, "--features-dir", str(feats),
              "--threshold", str(threshold), "--min-event-frames", "16", "--frames-per-clip", "8",
              "--group-mode", "fixed", "--model-config"] + overrides
    monkeypatch.setattr(jextraction, "FeatureExtractor", _NoExtractor)
    j_infer.main(common + ["--outdir", str(tmp_path / "j")])
    assert t_infer.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "Abuse001_x264_scores.json", "Normal_Videos_003_x264_scores.json"]
    n_events = 0
    for name in os.listdir(tmp_path / "j"):
        ref = json.loads((tmp_path / "j" / name).read_text())
        got = json.loads((tmp_path / "t" / name).read_text())
        assert list(got) == list(ref)
        for key in ("video", "model", "stream", "n_clips", "frames_per_clip", "threshold"):
            assert got[key] == ref[key], key
        assert got["model"] == "mgfn" and got["frames_per_clip"] == 8
        np.testing.assert_allclose(got["clip_scores"], ref["clip_scores"], atol=1e-5)
        assert len(got["frame_scores"]) == 8 * got["n_clips"]
        assert_events_close(got["events"], ref["events"], 1e-5)
        assert_events_close(got["events"], anomaly_events(got["frame_scores"], threshold, 16),
                            ROUNDING)
        n_events += len(got["events"])
    assert n_events >= 2


def test_main_parser_checks_match_jax(tmp_path, capsys):
    """--threshold outside [0, 1] and --batch 0 stop at the parser with the
    JAX wording; --threshold with int8 warns as JAX does, where JAX sends
    the user to its own tool and TPU records the port sends them to the
    port's ``scripts.operating_point`` and its H100 record in PERF.md."""
    base = ["--videos", str(tmp_path / "none*.mp4"), "--outdir", str(tmp_path / "o"),
            "--torch-weights", "w.pt"]
    for extra in (["--threshold", "7"], ["--batch", "0"]):
        errors = []
        for main in (j_infer.main, t_infer.main):
            with pytest.raises(SystemExit) as exc:
                main(base + extra)
            assert exc.value.code == 2
            errors.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert errors[0] == errors[1]
    warnings = []
    for main in (j_infer.main, t_infer.main):
        with pytest.raises(SystemExit, match="no videos match"):
            main(base + ["--threshold", "0.5", "--dtype", "int8"])
        warnings.append(capsys.readouterr().err)
    prefix = "warning: --threshold with --dtype int8: "
    assert warnings[0].startswith(prefix) and warnings[1].startswith(prefix)
    assert "scripts/operating_point.py" in warnings[0] and "docs/ROOFLINE.md" in warnings[0]
    assert "anomaly_detection_on_video_tpu_torch.scripts.operating_point" in warnings[1]
    assert "PERF.md" in warnings[1] and "docs/" not in warnings[1]


def test_main_flags_reach_the_extractor_warmup_and_pin(rng, tmp_path, monkeypatch, capsys):
    """--frames-per-clip, --group-mode and --dtype reach the extractor;
    int8 pins its scales to --features-dir; --warmup skips the extractor
    while int8 awaits calibration, else runs it once, and scores every
    bucket up to its clip count; a scorer of another width stops before
    any extraction."""
    vids, feats = _cached_videos(tmp_path, rng)
    weights, overrides = _port_mgfn_weights(tmp_path / "mgfn.pt", 2048), NARROW_2048
    built = []

    def factory(**kw):
        built.append(kw)
        ex = _narrow_extractor(**kw)
        built.append(ex)
        return ex

    monkeypatch.setattr(t_infer, "FeatureExtractor", factory)
    common = ["--videos", str(vids), "--torch-weights", weights, "--features-dir", str(feats),
              "--outdir", str(tmp_path / "o"), "--device", "cpu", "--warmup", "40",
              "--model-config"] + overrides
    t_infer.main(common + ["--dtype", "int8", "--group-mode", "fixed", "--frames-per-clip", "8",
                           "--batch", "20"])
    kw, ex = built
    assert (kw["frames_per_clip"], kw["adaptive_groups"], kw["quantize"], kw["batch"]) == (
        8, False, True, 20)
    assert ex._calibration_path == str(feats / "act_scales_rgb.json") and ex._needs_calibration
    out = capsys.readouterr().out
    assert "warmup: skipping rgb extractor (int8 awaits calibration" in out
    assert "(eval buckets [32, 64])" in out
    built.clear()
    t_infer.main(common + ["--dtype", "float32"])
    kw, ex = built
    assert kw["adaptive_groups"] and not kw["quantize"] and kw["frames_per_clip"] == 16
    out = capsys.readouterr().out
    assert "skipping" not in out and "warmup done" in out
    built.clear()
    narrow = _port_mgfn_weights(tmp_path / "m64.pt", C)
    with pytest.raises(SystemExit, match="scorer expects 64-d input; pass --model-config "
                                         "channels=2048"):
        t_infer.main(["--videos", str(vids), "--torch-weights", narrow, "--outdir",
                      str(tmp_path / "o"), "--device", "cpu", "--model-config", f"channels={C}"]
                     + overrides)
    assert not built


def test_process_video_caches_and_reuses_features(rng, tmp_path, monkeypatch):
    """A cache miss extracts and writes <stem>_i3d.npy atomically; a hit
    loads it without extracting; --threshold adds the events."""
    path = str(tmp_path / "Abuse002_x264.avi")
    _write_avi(path, rng, n_frames=36)
    extractor = _narrow_extractor(batch=20, device="cpu")
    scorer = build_model("sultani", channels=C, hidden_dims=(8, 4))[1].eval()
    first = t_infer.process_video(path, extractor, scorer, str(tmp_path / "o"), "sultani",
                                  features_dir=str(tmp_path / "f"))
    cached = np.load(tmp_path / "f" / "Abuse002_x264_i3d.npy")
    assert cached.shape == (3, 10, C) and "events" not in first
    monkeypatch.setattr(extractor, "extract_video", lambda p: pytest.fail("extracted again"))
    again = t_infer.process_video(path, extractor, scorer, str(tmp_path / "o"), "sultani", 0.3, 2,
                                  str(tmp_path / "f"))
    assert again["clip_scores"] == first["clip_scores"] and again["model"] == "sultani"
    # the events come from the unrounded frame scores, not the JSON's 6-place ones
    frame_scores = frame_level_scores(t_infer.score_features(cached, scorer), 16)
    assert again["events"] == anomaly_events(frame_scores, 0.3, 2)


# ------------------------------------------ serving the port's checkpoints

RUN_NARROW = {"rtfm": [f"runner.model_config.channels={C}", "runner.model_config.hidden_dims=[32,16]",
                       "runner.model_config.dropout_rate=0.0"],
              "sultani": [f"runner.model_config.channels={C}",
                          "runner.model_config.hidden_dims=[32,16]",
                          "runner.model_config.dropout_rate=0.0"]}


def _common(runner, root, rng):
    train, test, _, gt_path = write_features(str(root), rng)
    return [f"runner={runner}", f"data.train_path={train}", f"data.test_path={test}",
            f"data.ground_truth_path={gt_path}", "data.batch_size=2", "data.num_workers=0",
            "runner.optimizer.learning_rate=1e-4"] + RUN_NARROW[runner]


@pytest.mark.parametrize("runner", ["rtfm", "sultani"])
def test_checkpoint_of_port_run_is_served(rng, tmp_path, runner):
    """A 3-step port run's checkpoints (steps 2 and 3) served through
    build_scorer: latest, best and an exact step each give the scores of
    that step's model scored directly; a missing step, a reshaping
    --model-config and --model of another family fail as in the JAX CLI."""
    ck = tmp_path / "ck"
    t_run.main(_common(runner, tmp_path, rng) + [
        "device=cpu", "trainer.max_steps=3", f"trainer.checkpoint.dirpath={ck}",
        f"trainer.log_path={tmp_path}/log.jsonl"])
    ckpt = TopKCheckpointer(str(ck))
    assert ckpt.all_steps() == [2, 3]
    feats = (np.abs(rng.randn(11, 10, C)) * 0.5).astype(np.float32)
    best = max(ckpt.all_steps(), key=lambda s: (ckpt.metrics(s)["metric"], s))
    for selector, step in (("latest", 3), ("best", best), ("2", 2)):
        scorer, name = t_infer.build_scorer(_args(checkpoint=str(ck), checkpoint_step=selector))
        assert name == runner
        direct = build_model(runner, channels=C, hidden_dims=(32, 16))[1]
        ckpt.restore(TrainState(direct, adam_with_l2(direct.parameters())), step=step)
        np.testing.assert_array_equal(t_infer.score_features(feats, scorer),
                                      t_infer.score_features(feats, direct.eval()))
    scorer, _ = t_infer.build_scorer(_args(checkpoint=str(ck), model_config=["dropout_rate=0.5"]))
    assert scorer.config.dropout_rate == 0.5 and scorer.config.hidden_dims == [32, 16]
    with pytest.raises(SystemExit, match=r"--checkpoint-step: checkpoint step 7 not found.*\[2, 3\]"):
        t_infer.build_scorer(_args(checkpoint=str(ck), checkpoint_step="7"))
    with pytest.raises(ValueError, match="could not restore checkpoint step 3"):
        t_infer.build_scorer(_args(checkpoint=str(ck), model_config=["hidden_dims=[8,8]"]))
    other = "sultani" if runner == "rtfm" else "rtfm"
    with pytest.raises(ValueError, match="could not restore"):
        t_infer.build_scorer(_args(checkpoint=str(ck), model=other,
                                   model_config=[f"channels={C}"]))


def test_checkpoint_without_port_steps_names_the_export_route(tmp_path):
    """A JAX (orbax) step that cannot be read (here its tree metadata,
    ``default/_METADATA``, is missing; readable orbax steps are served,
    tests/test_torch_orbax.py) fails naming the step, the missing file,
    the JAX package's exporters and --torch-weights; an empty directory
    holds no checkpoints."""
    step = tmp_path / "orbax" / "1"  # orbax's layout: no state.pt in a step
    (step / "default").mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=r"(?s)orbax checkpoint step 1 .*_METADATA.*"
                                         r"export_\{mgfn,rtfm,sultani\}_state_dict.*--torch-weights"):
        t_infer.build_scorer(_args(checkpoint=str(tmp_path / "orbax"), model="sultani"))
    (tmp_path / "empty").mkdir()
    for build in (j_infer.build_scorer, t_infer.build_scorer):
        with pytest.raises(SystemExit, match="directory contains no checkpoints"):
            build(_args(checkpoint=str(tmp_path / "empty"), model="sultani"))


@pytest.mark.parametrize("runner", ["rtfm", "sultani"])
def test_run_matches_jax_run_py(rng, tmp_path, monkeypatch, runner):
    """``run runner=rtfm|sultani`` of the port against the root run.py, 2
    epochs, dropout off, the same initial weights (the JAX runner's,
    loaded into the port's): per-step losses to 1e-4, AUCs to 1e-4, the
    same hparams.json."""
    common = _common(runner, tmp_path, rng) + ["trainer.max_epochs=2"]
    captured = {}
    j_init = jrunner.VideoAnomalyDetectionRunner.init_state
    from_flax = {"rtfm": rtfm_state_dict_from_flax, "sultani": sultani_state_dict_from_flax}

    def jax_init(self, example):
        state = j_init(self, example)
        captured["sd"] = from_flax[runner](jax.tree_util.tree_map(np.asarray,
                                                                  {"params": state.params}))
        return state

    monkeypatch.setattr(jrunner.VideoAnomalyDetectionRunner, "init_state", jax_init)
    j_run.main(common + ["trainer.data_parallel=false", f"trainer.log_path={tmp_path}/j.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/ck_j"])
    t_init = VideoAnomalyDetectionRunner.init_state

    def port_init(self):
        state = t_init(self)
        state.model.load_state_dict(captured["sd"])
        return state

    monkeypatch.setattr(VideoAnomalyDetectionRunner, "init_state", port_init)
    t_run.main(common + ["device=cpu", f"trainer.log_path={tmp_path}/t.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/ck_t"])

    def records(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    ref, got = records("j.jsonl"), records("t.jsonl")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0, 1, 2, 2, 3, 4]
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("train_loss", "train_loss_epoch"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], rtol=1e-4)
        for key in ("valid/rec_auc", "valid/pr_auc"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], atol=1e-4)
    assert (TopKCheckpointer.load_metadata(str(tmp_path / "ck_t"))
            == JCheckpointer.load_metadata(str(tmp_path / "ck_j")))
