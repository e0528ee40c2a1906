"""PyTorch port vs the JAX package: serving on one device.

Weight files with keys outside the model (an i3res50 ``.pt`` with its
Kinetics head, a Sultani file with one more key) load as the JAX converters
read them; the port's ``infer`` ``--watch`` loop, ``--serve`` endpoint and
``--export`` / ``--from-export`` against the JAX CLI on the same cached
features and weights; the flag checks; ``enable_compile_cache`` and the
``--compile-cache`` of the three CLIs.

Every video here has cached features (``--features-dir``), so nothing is
decoded: the JAX CLI's extractor is built and never run (``_NoExtractor``),
the port's is narrow. A video without features raises ValueError in both
extractors, the failure of an undecodable file. Each server binds
127.0.0.1 on a free port and is shut down in a ``finally``; every HTTP call
has a timeout; the watch loops end on ``--idle-exit``.
"""

import http.client
import json
import os
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import extract_features as j_extract_features
import infer as j_infer
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.utils import aot as jaot
from anomaly_detection_on_video_tpu.utils import convert as jconvert
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models import seeded_init_
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from anomaly_detection_on_video_tpu_torch.ops.kernels import _build
from anomaly_detection_on_video_tpu_torch.utils import aot as taot
from anomaly_detection_on_video_tpu_torch.utils.compile_cache import enable_compile_cache
from test_torch_i3d import NARROW as I3D_NARROW
from torch_infer_fixtures import (
    MODEL_CONFIG,
    _args,
    _flax_variables,
    _narrow_extractor,
    _NoExtractor,
    _port_mgfn_weights,
    _save_weights,
    _touch,
    _write_avi,
)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker
from torch_runner_fixtures import C

TIMEOUT = 10  # seconds, for every HTTP call and join
START_TIMEOUT = 60  # seconds for a server to bind (its scorer and extractor built first)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _undecodable(path):
    raise ValueError(f"cannot decode {os.path.basename(path)}")


class _UndecodableExtractor(_NoExtractor):
    """The JAX CLI's extractor: never run for a cached video; any other
    video is undecodable."""

    def extract_video(self, path, *args, **kwargs):
        _undecodable(path)


def _port_extractor(**kwargs):
    """The port CLI's extractor, narrow; a video without cached features is
    undecodable, as in ``_UndecodableExtractor``."""
    extractor = _narrow_extractor(**dict(kwargs, dtype=torch.float32))
    extractor.extract_video = lambda path, *a, **k: _undecodable(path)
    return extractor


@pytest.fixture
def no_extractors(monkeypatch):
    monkeypatch.setattr(jextraction, "FeatureExtractor", _UndecodableExtractor)
    monkeypatch.setattr(t_infer, "FeatureExtractor", _port_extractor)


SULTANI = ["--model", "sultani", "--model-config", "hidden_dims=[32,16]"]
CLIPS = {"Abuse001_x264": 9, "Arson002_x264": 40, "Normal_Videos_003_x264": 3,
         "Fighting004_x264": 17, "Shooting005_x264": 33}


def _sultani_weights(tmp_path, rng):
    return _save_weights(tmp_path / "sultani.pt", "sultani", _flax_variables(
        "sultani", dict(channels=2048, hidden_dims=[32, 16]), rng))


def _features(tmp_path, rng, stems=CLIPS):
    """Cached 2048-d features of ``stems`` in ``tmp_path / "feats"``."""
    feats = tmp_path / "feats"
    feats.mkdir(exist_ok=True)
    for stem in stems:
        np.save(feats / f"{stem}_i3d.npy",
                (np.abs(rng.randn(CLIPS[stem], 10, 2048)) * 0.5).astype(np.float32))
    return feats


def _read(path):
    return json.loads(Path(path).read_text())


def assert_scores_match(got, want, atol=1e-5):
    """Every key but ``latency_s`` equal, the scores within ``atol``."""
    assert sorted(got) == sorted(want)
    for key in want:
        if key in ("clip_scores", "frame_scores"):
            np.testing.assert_allclose(got[key], want[key], atol=atol)
        elif key != "latency_s":
            assert got[key] == want[key], key


# ---------------------------------------------------- fault 5: weight files

def test_i3res50_weights_with_a_head_load_as_jax_reads_them(rng, tmp_path, capsys):
    """An i3res50 ``.pt`` holding the Kinetics head ``fc.*``: the port's
    extractor loads the backbone (one printed line names the head) with the
    parameters of the JAX ``load_weights`` output taken back through
    ``export_i3res50_state_dict``; without a backbone key both fail."""
    narrow = seeded_init_(I3DResNet(stages=I3D_NARROW), seed=5).state_dict()
    sd = {k: (torch.from_numpy(np.abs(rng.randn(*v.shape)).astype(np.float32))
              if v.is_floating_point() else v) for k, v in narrow.items()}
    sd["fc.weight"], sd["fc.bias"] = torch.randn(400, 16), torch.randn(400)
    path = str(tmp_path / "i3res50.pt")
    torch.save(sd, path)
    want = jconvert.export_i3res50_state_dict(
        j_extract_features.load_weights(path, "tushar-n-baseline"))
    extractor = FeatureExtractor(model=I3DResNet(stages=I3D_NARROW), dtype=torch.float32,
                                 state_dict=t_infer.load_i3d_weights(path, "tushar-n-baseline"),
                                 device="cpu")
    got = extractor.model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in got.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)
    assert "I3D weights: ignoring 2 key(s) the model does not have: fc.weight, fc.bias" in (
        capsys.readouterr().err)
    del sd["conv1.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="conv1.weight"):
        j_extract_features.load_weights(path, "tushar-n-baseline")
    with pytest.raises(KeyError, match="I3D weights: missing key.* conv1.weight"):
        FeatureExtractor(model=I3DResNet(stages=I3D_NARROW), device="cpu",
                         state_dict=t_infer.load_i3d_weights(path, "tushar-n-baseline"))


def test_scorer_weights_with_an_extra_key_match_jax(rng, tmp_path, capsys):
    """``--torch-weights`` with one key the model lacks: a Sultani file,
    whose JAX converter ignores it, scores in both CLIs alike at 1e-5 and
    the port names the key; an HF-layout MGFN file, whose JAX converter
    raises on it, exits in both."""
    overrides = MODEL_CONFIG["sultani"]
    path = _save_weights(tmp_path / "w.pt", "sultani", _flax_variables(
        "sultani", dict(channels=C, hidden_dims=[32, 16]), rng))
    sd = torch.load(path)
    sd["fc4.weight"] = torch.zeros(3)
    torch.save(sd, path)
    args = _args(model="sultani", model_config=overrides, torch_weights=path)
    apply_fn, variables, eval_step, _, _ = j_infer.build_scorer(args)
    scorer, _ = t_infer.build_scorer(args)
    assert "ignoring 1 key(s) the model does not have: fc4.weight" in capsys.readouterr().err
    feats = (np.abs(rng.randn(7, 10, C)) * 0.5).astype(np.float32)
    np.testing.assert_allclose(t_infer.score_features(feats, scorer),
                               j_infer.score_features(feats, apply_fn, variables, eval_step),
                               atol=1e-5)
    path = _port_mgfn_weights(tmp_path / "mgfn.pt", C)
    sd = torch.load(path)
    sd["head.weight"] = torch.zeros(3)
    torch.save(sd, path)
    args = _args(model="mgfn", model_config=MODEL_CONFIG["mgfn"], torch_weights=path)
    for build in (j_infer.build_scorer, t_infer.build_scorer):
        with pytest.raises(SystemExit, match="does not look like a 'mgfn' state dict .*head.weight"):
            build(args)


# ------------------------------------------------------------------ --watch

def test_watch_matches_jax(rng, tmp_path, no_extractors):
    """Both CLIs' ``--watch`` over two cached videos and an undecodable
    one: the same files, scores within 1e-5, equal error JSONs (not
    retryable) and stats counts. A second run scores nothing and retries
    nothing; the failed file retries once its size changes."""
    stems = ["Abuse001_x264", "Normal_Videos_003_x264"]
    feats = _features(tmp_path, rng, stems)
    vids = tmp_path / "vids"
    for stem in stems + ["Broken006_x264"]:
        _touch(vids / f"{stem}.mp4")
    common = ["--videos", str(vids), "--torch-weights", _sultani_weights(tmp_path, rng),
              "--features-dir", str(feats), "--watch", "--poll-interval", "0.05",
              "--idle-exit", "0.5"] + SULTANI
    j_infer.main(common + ["--outdir", str(tmp_path / "j")])
    assert t_infer.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == [
        "Abuse001_x264_scores.json", "Broken006_x264_scores.error.json",
        "Normal_Videos_003_x264_scores.json", "_serving_stats.json"]
    for stem in stems:
        assert_scores_match(_read(tmp_path / "t" / f"{stem}_scores.json"),
                            _read(tmp_path / "j" / f"{stem}_scores.json"))
    error = _read(tmp_path / "t" / "Broken006_x264_scores.error.json")
    assert error == _read(tmp_path / "j" / "Broken006_x264_scores.error.json") == {
        "video": "Broken006_x264.mp4", "error": "cannot decode Broken006_x264.mp4", "size": 0,
        "retryable": False}
    counts = ("videos_scored", "clips_scored", "errors", "watching", "last_video")
    stats = _read(tmp_path / "t" / "_serving_stats.json")
    assert {k: stats[k] for k in counts} == {
        k: _read(tmp_path / "j" / "_serving_stats.json")[k] for k in counts}
    assert (stats["videos_scored"], stats["clips_scored"], stats["errors"]) == (2, 12, 1)

    t_infer.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"])
    again = _read(tmp_path / "t" / "_serving_stats.json")
    assert (again["videos_scored"], again["errors"], again["watching"]) == (0, 0, 3)
    (vids / "Broken006_x264.mp4").write_bytes(b"rewritten")
    t_infer.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"])
    assert _read(tmp_path / "t" / "_serving_stats.json")["errors"] == 1
    assert _read(tmp_path / "t" / "Broken006_x264_scores.error.json")["size"] == 9


# ------------------------------------------------------------------ --serve

def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body)
        response = conn.getresponse()
        return response.status, json.loads(response.read())
    finally:
        conn.close()


class _Server:
    """The port's ``main`` with ``--serve 0`` on a thread; the bound
    server once it is ready."""

    def __init__(self, argv):
        self.ready, self.server, self.error = threading.Event(), None, None
        self.thread = threading.Thread(target=self._run, args=(argv,), daemon=True)

    def _run(self, argv):
        try:
            t_infer.main(argv, on_ready=self._on_ready)
        except BaseException as exc:  # reported by __enter__
            self.error = exc
            self.ready.set()

    def _on_ready(self, server):
        self.server = server
        self.ready.set()

    def __enter__(self):
        self.thread.start()
        assert self.ready.wait(START_TIMEOUT) and self.error is None, self.error
        return self.server.server_port

    def __exit__(self, *exc):
        if self.server is not None:
            self.server.shutdown()
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()


def test_serve_matches_jax_one_shot(rng, tmp_path, no_extractors):
    """The port's ``--serve``: a reply equals the JAX CLI's score JSON of
    the same video (every key but latency_s, scores at 1e-5); a repeat POST
    answers from the JSON and ``/stats`` does not count it; ``/scores``,
    ``/healthz``; 404, 400 and 500 (counted in ``errors``); 4 concurrent
    POSTs each get their own scores; the spool is left empty."""
    feats = _features(tmp_path, rng)
    weights = _sultani_weights(tmp_path, rng)
    vids = tmp_path / "vids"
    for stem in CLIPS:
        _touch(vids / f"{stem}.mp4")
    j_infer.main(["--videos", str(vids), "--torch-weights", weights, "--features-dir", str(feats),
                  "--outdir", str(tmp_path / "j")] + SULTANI)
    want = {stem: _read(tmp_path / "j" / f"{stem}_scores.json") for stem in CLIPS}
    outdir = tmp_path / "t"
    argv = ["--torch-weights", weights, "--features-dir", str(feats), "--outdir", str(outdir),
            "--serve", "0", "--device", "cpu"] + SULTANI
    with _Server(argv) as port:
        status, first = _request(port, "POST", "/score?name=Abuse001_x264.mp4", b"video bytes")
        assert status == 200
        assert_scores_match(first, want["Abuse001_x264"])
        assert _request(port, "POST", "/score?name=Abuse001_x264.mp4", b"again") == (200, first)
        assert _request(port, "GET", "/scores/Abuse001_x264") == (200, first)
        status, stats = _request(port, "GET", "/stats")
        assert (status, stats["videos_scored"], stats["clips_scored"], stats["errors"]) == (
            200, 1, 9, 0)
        assert _request(port, "GET", "/healthz") == (200, {"ok": True, "device": "cpu",
                                                           "scoring": False})
        assert _request(port, "GET", "/nope")[0] == 404
        assert _request(port, "POST", "/nope", b"x")[0] == 404
        assert _request(port, "GET", "/scores/Arson002_x264")[0] == 404
        assert _request(port, "POST", "/score?name=x%2F..", b"x") == (
            400, {"error": "invalid name '..'"})
        assert _request(port, "POST", "/score?name=Empty_x264.mp4", b"")[0] == 400
        assert _request(port, "POST", "/score?name=Missing007_x264.mp4", b"x") == (
            500, {"error": "cannot decode Missing007_x264.mp4"})
        assert _request(port, "GET", "/stats")[1]["errors"] == 1

        burst = [stem for stem in CLIPS if stem != "Abuse001_x264"]
        replies = {}

        def post(stem):
            replies[stem] = _request(port, "POST", f"/score?name={stem}.mp4", b"x" * 64)

        threads = [threading.Thread(target=post, args=(stem,)) for stem in burst]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(TIMEOUT)
            assert not thread.is_alive()
        for stem in burst:
            status, reply = replies[stem]
            assert status == 200 and reply["n_clips"] == CLIPS[stem]
            assert_scores_match(reply, want[stem])
        stats = _request(port, "GET", "/stats")[1]
        assert (stats["videos_scored"], stats["errors"]) == (5, 1)
    assert os.listdir(outdir / "_spool") == []


# --------------------------------------------------- --export / --from-export

@pytest.mark.parametrize("name", ["sultani", "mgfn"])
def test_export_matches_live_and_jax(rng, tmp_path, name):
    """``export_scorer`` + ``save_scorer_export`` on the CPU: the loaded
    programs score exactly as the live scorer; within 1e-5 of the JAX
    ``ExportedScorer`` exported for ``("cpu",)``; the manifest has the JAX
    manifest's keys, ``device`` and ``torch_version`` in place of
    ``platforms`` and ``jax_version``."""
    overrides = MODEL_CONFIG[name]
    config = {k: json.loads(v) for k, v in (kv.split("=") for kv in overrides)}
    path = _save_weights(tmp_path / "w.pt", name, _flax_variables(name, config, rng))
    args = _args(model=name, model_config=overrides, torch_weights=path)
    scorer, _ = t_infer.build_scorer(args)
    apply_fn, variables, _, _, _ = j_infer.build_scorer(args)
    buckets = taot.export_buckets(20)
    assert buckets == jaot.export_buckets(20) == [32]
    port_dir, jax_dir = str(tmp_path / "t"), str(tmp_path / "j")
    taot.save_scorer_export(port_dir, taot.export_scorer(scorer, channels=C, buckets=buckets,
                                                         device="cpu"),
                            model_name=name, channels=C, device="cpu")
    jaot.save_scorer_export(jax_dir, jaot.export_scorer(apply_fn, variables, channels=C,
                                                        buckets=buckets, platforms=("cpu",)),
                            model_name=name, channels=C, platforms=("cpu",))
    exported = taot.ExportedScorer(port_dir, "cpu")
    feats = (np.abs(rng.randn(13, 10, C)) * 0.5).astype(np.float32)
    got = exported.score(feats)
    np.testing.assert_array_equal(got, t_infer.score_features(feats, scorer))
    np.testing.assert_allclose(got, jaot.ExportedScorer(jax_dir).score(feats), atol=1e-5)
    manifest, jmanifest = _read(Path(port_dir) / "manifest.json"), _read(Path(jax_dir) /
                                                                          "manifest.json")
    assert sorted(set(manifest) - {"device", "torch_version"} | {"platforms", "jax_version"}) == (
        sorted(jmanifest))
    assert manifest["format"] == "anomaly_detection_on_video_tpu_torch.scorer_export.v1"
    assert (manifest["device"], manifest["torch_version"]) == ("cpu", torch.__version__)
    for key in ("model_name", "channels", "n_crops", "stream", "buckets"):
        assert manifest[key] == jmanifest[key], key


def test_export_cli_and_from_export_errors(rng, tmp_path, no_extractors, capsys):
    """``infer --export`` then ``--from-export``: the scores of the live
    one-shot CLI exactly, a warm-up of the exported buckets only; each
    failure is one line, as the JAX CLI's where it has one: the crop count,
    a video over the largest bucket, a corrupt manifest, a JAX export."""
    feats = _features(tmp_path, rng, ["Abuse001_x264", "Arson002_x264"])
    weights = _sultani_weights(tmp_path, rng)
    vids = tmp_path / "vids"
    _touch(vids / "Abuse001_x264.mp4")
    export, jax_export = str(tmp_path / "export"), str(tmp_path / "jax_export")
    assert t_infer.main(["--outdir", str(tmp_path / "x"), "--torch-weights", weights,
                         "--export", export, "--export-max-clips", "20", "--device", "cpu"]
                        + SULTANI) == 0
    assert "exported sultani scorer for buckets [32] (10 crops, 2048-d, " in capsys.readouterr().out
    assert sorted(os.listdir(export)) == ["manifest.json", "scorer_b32.pt2"]
    common = ["--features-dir", str(feats), "--device", "cpu"]
    t_infer.main(["--videos", str(vids), "--torch-weights", weights, "--outdir",
                  str(tmp_path / "live")] + SULTANI + common)
    t_infer.main(["--videos", str(vids), "--from-export", export, "--outdir",
                  str(tmp_path / "exp"), "--warmup", "100"] + common)
    assert "(eval buckets [32])" in capsys.readouterr().out
    got = _read(tmp_path / "exp" / "Abuse001_x264_scores.json")
    want = _read(tmp_path / "live" / "Abuse001_x264_scores.json")
    assert got["clip_scores"] == want["clip_scores"] and got["model"] == "sultani"

    apply_fn, variables, _, _, _ = j_infer.build_scorer(_args(
        model="sultani", model_config=SULTANI[-1:], torch_weights=weights))
    jaot.save_scorer_export(jax_export, jaot.export_scorer(
        apply_fn, variables, buckets=[32], platforms=("cpu",)), model_name="sultani",
        platforms=("cpu",))
    long_video = str(_touch(tmp_path / "long" / "Arson002_x264.mp4"))
    for extra, videos in ((["--crops", "center"], str(vids)), ([], long_video)):
        messages = []
        for main, directory in ((j_infer.main, jax_export), (t_infer.main, export)):
            with pytest.raises(SystemExit) as exc:
                main(["--videos", videos, "--from-export", directory, "--outdir",
                      str(tmp_path / "o"), "--features-dir", str(feats)] + extra
                     + (["--device", "cpu"] if main is t_infer.main else []))
            messages.append(str(exc.value))
        assert messages[0] == messages[1]
        assert "re-export with" in messages[1] and "\n" not in messages[1]
    assert messages[1] == (f"{long_video}: video has 40 clips but the largest exported bucket "
                           "is 32; re-export with a larger --export-max-clips")
    with pytest.raises(SystemExit, match=r"^--from-export: '.*jax_export' holds a "
                                         r"'anomaly_detection_on_video_tpu\.scorer_export\.v1' "
                                         r"export, not the port's .*; re-export the scorer with "
                                         r"the port's infer --export$"):
        t_infer.main(["--videos", str(vids), "--from-export", jax_export, "--outdir",
                      str(tmp_path / "o")] + common)
    (Path(export) / "manifest.json").write_text("{")
    with pytest.raises(SystemExit, match=r"^--from-export: corrupt manifest '.*manifest\.json': "):
        t_infer.main(["--videos", str(vids), "--from-export", export, "--outdir",
                      str(tmp_path / "o")] + common)


# ------------------------------------------------------------------- parser

PARSER_CASES = {
    "threshold": ["--videos", "v", "--checkpoint", "c", "--threshold", "7"],
    "batch": ["--videos", "v", "--checkpoint", "c", "--batch", "0"],
    "serve_port": ["--checkpoint", "c", "--serve", "99999"],
    "export_max_clips": ["--checkpoint", "c", "--export", "e", "--export-max-clips", "0"],
    "watch_and_serve": ["--checkpoint", "c", "--videos", "v", "--serve", "8080", "--watch"],
    "export_and_from_export": ["--export", "e", "--from-export", "f"],
    "export_and_watch": ["--checkpoint", "c", "--videos", "v", "--export", "e", "--watch"],
    "from_export_and_checkpoint": ["--videos", "v", "--from-export", "f", "--checkpoint", "c"],
    "videos_required": ["--checkpoint", "c"],
}


@pytest.mark.parametrize("case", sorted(PARSER_CASES))
def test_serving_flag_checks_match_jax(tmp_path, capsys, case):
    """Each flag check stops both CLIs at the parser (exit code 2) with the
    same message, before any device or weights work."""
    errors = []
    for main in (j_infer.main, t_infer.main):
        with pytest.raises(SystemExit) as exc:
            main(PARSER_CASES[case] + ["--outdir", str(tmp_path / "o")])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "error: " in errors[0]


# ------------------------------------------------------------ compile cache

def test_enable_compile_cache_points_the_build(tmp_path, monkeypatch):
    """``enable_compile_cache`` makes a directory the kernels' build
    directory (no nvcc needed); the library's key covers the nvcc flags;
    once a library has loaded from one directory, another raises."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_LIB", None)
    cache = tmp_path / "kernels"
    enable_compile_cache(str(cache))
    assert cache.is_dir() and _build.library_path().parent.parent == cache.resolve()
    key = _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path() != key and _build.library_path().parent.parent == key.parent.parent
    monkeypatch.setattr(_build, "_LIB", SimpleNamespace(path=key))
    enable_compile_cache(str(cache))  # the directory it loaded from
    with pytest.raises(RuntimeError, match="already loaded from .*before the first kernel launch"):
        enable_compile_cache(str(tmp_path / "other"))
    assert _build.BUILD_DIR == cache.resolve()


def test_compile_cache_reaches_each_cli(rng, tmp_path, monkeypatch):
    """``infer --compile-cache``, ``extract_features --compile-cache`` and
    ``run``'s ``trainer.compile_cache`` set the build directory before
    their first extractor or model is built."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_LIB", None)
    seen = []

    def extractor(**kw):
        seen.append(_build.BUILD_DIR)
        return _narrow_extractor(**dict(kw, dtype=torch.float32))

    monkeypatch.setattr(t_infer, "FeatureExtractor", extractor)
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", extractor)
    feats = _features(tmp_path, rng, ["Abuse001_x264"])
    _touch(tmp_path / "vids" / "Abuse001_x264.mp4")
    t_infer.main(["--videos", str(tmp_path / "vids"), "--outdir", str(tmp_path / "o"),
                  "--torch-weights", _sultani_weights(tmp_path, rng), "--features-dir", str(feats),
                  "--compile-cache", str(tmp_path / "a"), "--device", "cpu"] + SULTANI)
    _write_avi(tmp_path / "avi" / "Abuse002_x264.avi", rng)
    t_extract_features.main(["--videos", str(tmp_path / "avi"), "--outdir", str(tmp_path / "f"),
                             "--compile-cache", str(tmp_path / "b"), "--decode-workers", "1",
                             "--no-segments", "--batch", "20", "--device", "cpu"])
    assert os.listdir(tmp_path / "f") == ["Abuse002_x264_i3d.npy"]
    assert seen == [(tmp_path / "a").resolve(), (tmp_path / "b").resolve()]
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(SystemExit, match="no model selected"):
        t_run.train({"trainer": {"compile_cache": str(tmp_path / "c")}, "runner": {}}, "cpu")
    assert _build.BUILD_DIR == (tmp_path / "c").resolve()
