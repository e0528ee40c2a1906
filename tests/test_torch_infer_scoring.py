"""PyTorch port vs the JAX package: the scoring CLI's scorer side. Weights
of every family (and the official MGFN layout) through both CLIs'
``build_scorer`` and their errors; ``main`` end to end on cached
features, its parser checks and flags; ``process_video``'s feature
cache; the port's ``run`` checkpoints served, and its RTFM and Sultani
runs against the root ``run.py``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import infer as j_infer
import run as j_run
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.models import build_model
from anomaly_detection_on_video_tpu_torch.ops.metrics import anomaly_events, frame_level_scores
from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    rtfm_state_dict_from_flax,
    sultani_state_dict_from_flax,
)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker
from torch_runner_fixtures import C, write_features
from torch_infer_fixtures import (
    MODEL_CONFIG,
    NARROW_2048,
    _NoExtractor,
    _args,
    _cached_videos,
    _flax_variables,
    _narrow_extractor,
    _port_mgfn_weights,
    _save_weights,
    _write_avi,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    tests/test_torch_orbax_steps.py) fails naming the step, the missing file,
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
