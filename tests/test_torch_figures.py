"""PyTorch port vs the JAX package: eval figures and ``infer --figure``.

``Figure.savefig`` is wrapped so each test reads what a figure holds (every
line's data and style, titles, axis labels and limits, the figure's size and
the save's arguments) rather than its PNG bytes. The same inputs, made with
numpy from a seed, go through both packages: ``EvalResult.save_figure``,
``fit`` with ``figure_dir``, and both CLIs' ``--figure`` on one shared
``--features-dir`` cache (nothing is decoded). With matplotlib blocked in
the port (``sys.modules["matplotlib"] = None``) each path fails as the JAX
package's does: the score JSON stays, the figure's error is the caller's.
"""

import os
import sys

import numpy as np
import pytest
import torch
from matplotlib.figure import Figure

import infer as j_infer
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch.data import features as tfeatures
from anomaly_detection_on_video_tpu_torch.models.mgfn import MGFN, MGFNConfig
from anomaly_detection_on_video_tpu_torch.ops.metrics import roc_auc
from anomaly_detection_on_video_tpu_torch.training import runner as trunner
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from test_torch_serving import _port_extractor, _read, _request, _Server
from torch_infer_fixtures import NARROW_2048, _flax_variables, _NoExtractor, _port_mgfn_weights, \
    _save_weights, _touch
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker
from torch_runner_fixtures import C, write_features

# the files the JAX ``fit`` writes into ``figure_dir`` over 2 epochs with
# eval_every=1: ``f"eval_epoch{epoch:04d}.png"`` for epochs 0 and 1
# (anomaly_detection_on_video_tpu/training/runner.py, the figure step of
# ``fit``); recorded, since a JAX fit costs more than this file's budget
JAX_FIT_FIGURES = ["eval_epoch0000.png", "eval_epoch0001.png"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as the other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _describe(fig: Figure, fname, kwargs) -> dict:
    axes = []
    for ax in fig.axes:
        axes.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
            "lines": [{"x": np.asarray(line.get_xdata(), np.float64),
                       "y": np.asarray(line.get_ydata(), np.float64),
                       "style": (line.get_alpha(), line.get_linestyle(), line.get_linewidth(),
                                 line.get_color())}
                      for line in ax.get_lines()]})
    return {"name": os.path.basename(str(fname)), "size": tuple(fig.get_size_inches()),
            "facecolor": fig.get_facecolor(), "kwargs": dict(kwargs), "axes": axes}


@pytest.fixture
def figures(monkeypatch):
    """What every ``Figure.savefig`` call held, in order; the PNG is still
    written."""
    saved = []
    savefig = Figure.savefig

    def recording(self, fname, *args, **kwargs):
        saved.append(_describe(self, fname, kwargs))
        return savefig(self, fname, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", recording)
    return saved


def assert_same_figure(got: dict, want: dict, atol: float = 0.0) -> None:
    """Equal names, sizes, save arguments, titles, labels and line styles;
    line data and axis limits within ``atol`` (0: equal)."""
    for key in ("name", "size", "facecolor", "kwargs"):
        assert got[key] == want[key], key
    assert len(got["axes"]) == len(want["axes"])
    for g, w in zip(got["axes"], want["axes"]):
        assert (g["title"], g["xlabel"], g["ylabel"]) == (w["title"], w["xlabel"], w["ylabel"])
        np.testing.assert_allclose(g["xlim"], w["xlim"], rtol=0, atol=atol)
        np.testing.assert_allclose(g["ylim"], w["ylim"], rtol=0, atol=atol)
        assert len(g["lines"]) == len(w["lines"])
        for gl, wl in zip(g["lines"], w["lines"]):
            assert gl["style"] == wl["style"]
            np.testing.assert_array_equal(gl["x"], wl["x"])
            np.testing.assert_allclose(gl["y"], wl["y"], rtol=0, atol=atol)


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib fails to import, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)


# ------------------------------------------------- EvalResult.save_figure

@pytest.mark.parametrize("case", ["tied", "one_class"])
def test_save_figure_matches_jax(rng, tmp_path, figures, case):
    """The same preds and labels (scores tied in tenths; or labels all
    negative, where the ROC curve is all zeros) through both packages'
    ``EvalResult.save_figure``: the same figure, line for line."""
    preds = np.round(rng.rand(300), 1).astype(np.float32)
    labels = (rng.rand(300) > 0.7).astype(np.float32) if case == "tied" else np.zeros(300,
                                                                                      np.float32)
    auc = roc_auc(labels, preds) if case == "tied" else 0.5
    jrunner.EvalResult(auc, 0.25, preds, labels).save_figure(str(tmp_path / "j" / "fig.png"))
    trunner.EvalResult(auc, 0.25, preds, labels).save_figure(str(tmp_path / "t" / "fig.png"))
    assert (tmp_path / "j" / "fig.png").stat().st_size > 0
    assert (tmp_path / "t" / "fig.png").stat().st_size > 0
    want, got = figures
    assert_same_figure(got, want)
    assert got["size"] == (16.0, 4.0) and got["kwargs"] == {"dpi": 80, "bbox_inches": "tight"}
    assert [ax["title"] for ax in got["axes"]] == ["frame scores vs ground truth",
                                                   f"ROC (AUC={auc:.4f})"]
    np.testing.assert_array_equal(got["axes"][0]["lines"][0]["y"], preds)
    np.testing.assert_array_equal(got["axes"][0]["lines"][1]["y"], labels)
    assert got["axes"][0]["lines"][1]["style"][0] == 0.5


# ---------------------------------------------------------- fit's figures

TINY = dict(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C, dropout_rate=0.0)


class _Logger:
    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append((step, dict(metrics)))


class _ImageLogger(_Logger):
    def __init__(self):
        super().__init__()
        self.images = []

    def log_image(self, key, path, step):
        self.images.append((key, os.path.basename(path), step, os.path.exists(path)))


def _fit(tmp_path, data, logger, tag, figure_dir=None):
    """A 2-epoch tiny MGFN fit with eval_every=1 and a checkpointer."""
    train, test, gt_path = data
    torch.manual_seed(0)
    ckpt = TopKCheckpointer(str(tmp_path / tag / "ckpt"))
    runner = trunner.VideoAnomalyDetectionRunner(MGFN(MGFNConfig(**TINY)), checkpointer=ckpt,
                                                 loggers=[logger], device="cpu")
    result = runner.fit(tfeatures.build_feature_dataset("train", local_path=train),
                        valid_dataset=tfeatures.build_feature_dataset(
                            "test", local_path=test, ground_truth_path=gt_path),
                        max_epochs=2, batch_size=2, eval_every=1, figure_dir=figure_dir)
    return result, ckpt


@pytest.fixture
def fit_data(rng, tmp_path):
    train, test, _, gt_path = write_features(str(tmp_path / "data"), rng)
    return train, test, gt_path


def test_fit_writes_an_eval_figure_per_evaluation(tmp_path, fit_data, figures):
    """``fit`` with ``figure_dir``: the JAX ``fit``'s file names, each handed
    to ``log_image`` once written, and the last one's figure equal to what
    the returned ``EvalResult`` draws itself."""
    logger = _ImageLogger()
    result, _ = _fit(tmp_path, fit_data, logger, "fig", str(tmp_path / "figs"))
    assert sorted(os.listdir(tmp_path / "figs")) == JAX_FIT_FIGURES
    assert logger.images == [("valid/overlay", name, step, True)
                             for name, step in zip(JAX_FIT_FIGURES, (2, 4))]
    assert [f["name"] for f in figures] == JAX_FIT_FIGURES
    result.save_figure(str(tmp_path / "again" / JAX_FIT_FIGURES[-1]))
    assert_same_figure(figures[-1], figures[-2])
    assert len(figures[-1]["axes"][0]["lines"][0]["y"]) == len(result.preds)


def test_fit_without_matplotlib_warns_and_keeps_metrics_and_checkpoints(
        tmp_path, fit_data, capsys, no_matplotlib):
    """A figure that cannot import matplotlib prints the JAX runner's
    warning at each evaluation; the metrics and checkpoints equal those of
    the same fit without ``figure_dir``."""
    with_dir, plain = _Logger(), _Logger()
    _, ckpt = _fit(tmp_path, fit_data, with_dir, "with", str(tmp_path / "figs"))
    warnings = [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("warning: eval figure failed:")]
    assert len(warnings) == 2 and "matplotlib" in warnings[0]
    assert not (tmp_path / "figs").exists() or not os.listdir(tmp_path / "figs")
    _, ckpt_plain = _fit(tmp_path, fit_data, plain, "plain")

    def strip(records):
        return [(step, {k: v for k, v in m.items() if k != "epoch_time_s"})
                for step, m in records]

    assert strip(with_dir.records) == strip(plain.records)
    assert sum("valid/rec_auc" in m for _, m in with_dir.records) == 2
    assert ckpt.all_steps() == ckpt_plain.all_steps() == [2, 4]


# ------------------------------------------------------- infer --figure

@pytest.fixture
def cached(rng, tmp_path):
    """One video (an empty file: never decoded) and its cached features."""
    vids, feats = tmp_path / "vids", tmp_path / "feats"
    feats.mkdir()
    _touch(vids / "Abuse001_x264.mp4")
    np.save(feats / "Abuse001_x264_i3d.npy",
            (np.abs(rng.randn(9, 10, 2048)) * 0.5).astype(np.float32))
    return vids, feats


def test_infer_figure_matches_jax(rng, tmp_path, cached, figures, monkeypatch):
    """Both CLIs with ``--figure --threshold 0.5`` on one cache and one
    MGFN's weights: the same files, ``<stem>_scores.png`` written, and the
    same figure (the frame scores within 1e-5, as the scores are; the
    threshold line equal)."""
    vids, feats = cached
    weights = _save_weights(tmp_path / "mgfn.pt", "mgfn", _flax_variables(
        "mgfn", dict(dims=[16, 16, 32], depths=[1, 1, 1], dim_head=8, channels=2048), rng))
    common = ["--videos", str(vids), "--torch-weights", weights, "--features-dir", str(feats),
              "--figure", "--threshold", "0.5", "--model-config"] + NARROW_2048
    monkeypatch.setattr(jextraction, "FeatureExtractor", _NoExtractor)
    monkeypatch.setattr(t_infer, "FeatureExtractor", _port_extractor)
    j_infer.main(common + ["--outdir", str(tmp_path / "j")])
    assert t_infer.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    names = ["Abuse001_x264_scores.json", "Abuse001_x264_scores.png"]
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == names
    want, got = figures
    assert_same_figure(got, want, atol=1e-5)
    ax = got["axes"][0]
    assert (got["size"], got["kwargs"], ax["title"], ax["xlabel"], ax["ylabel"], ax["ylim"]) == (
        (12.0, 3.0), {"dpi": 80}, "Abuse001_x264", "frame", "anomaly score", (0.0, 1.02))
    scores, threshold = ax["lines"]
    np.testing.assert_allclose(scores["y"], _read(tmp_path / "t" / names[0])["frame_scores"],
                               rtol=0, atol=5e-7)
    assert list(threshold["y"]) == [0.5, 0.5] and threshold["style"][1:] == ("--", 1.0, "crimson")


def _port_argv(tmp_path, feats):
    weights = _port_mgfn_weights(tmp_path / "mgfn.pt", 2048)
    return ["--torch-weights", weights, "--features-dir", str(feats), "--figure",
            "--outdir", str(tmp_path / "t"), "--device", "cpu",
            "--model-config"] + NARROW_2048


def test_infer_figure_without_matplotlib_fails_as_jax(tmp_path, cached, monkeypatch,
                                                      no_matplotlib):
    """One-shot: the score JSON is written, then the ImportError ends the
    run (a non-zero exit), as the JAX CLI's does. ``--watch``: the JSON
    stays, the error is counted, no ``.error.json`` is written."""
    vids, feats = cached
    monkeypatch.setattr(t_infer, "FeatureExtractor", _port_extractor)
    argv = _port_argv(tmp_path, feats)
    with pytest.raises(ImportError, match="matplotlib"):
        t_infer.main(argv + ["--videos", str(vids)])
    assert sorted(os.listdir(tmp_path / "t")) == ["Abuse001_x264_scores.json"]
    os.remove(tmp_path / "t" / "Abuse001_x264_scores.json")
    assert t_infer.main(argv + ["--videos", str(vids), "--watch", "--poll-interval", "0.05",
                                "--idle-exit", "0.5"]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == ["Abuse001_x264_scores.json",
                                                  "_serving_stats.json"]
    stats = _read(tmp_path / "t" / "_serving_stats.json")
    assert (stats["videos_scored"], stats["errors"]) == (0, 1)


def test_serve_writes_the_figure_and_answers_500_without_matplotlib(tmp_path, cached,
                                                                    monkeypatch, figures):
    """``--serve --figure``: a request writes ``<stem>_scores.png`` of the
    frame scores it answers; with matplotlib blocked the next request gets
    the handler's 500 with the error, counted, and its JSON is written."""
    vids, feats = cached
    np.save(feats / "Arson002_x264_i3d.npy", np.load(feats / "Abuse001_x264_i3d.npy")[:5])
    monkeypatch.setattr(t_infer, "FeatureExtractor", _port_extractor)
    with _Server(_port_argv(tmp_path, feats) + ["--serve", "0"]) as port:
        status, reply = _request(port, "POST", "/score?name=Abuse001_x264.mp4", b"video")
        assert status == 200 and (tmp_path / "t" / "Abuse001_x264_scores.png").exists()
        np.testing.assert_allclose(figures[0]["axes"][0]["lines"][0]["y"], reply["frame_scores"],
                                   rtol=0, atol=5e-7)
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        status, reply = _request(port, "POST", "/score?name=Arson002_x264.mp4", b"video")
        assert status == 500 and "matplotlib" in reply["error"]
        assert (tmp_path / "t" / "Arson002_x264_scores.json").exists()
        assert not (tmp_path / "t" / "Arson002_x264_scores.png").exists()
        assert _request(port, "GET", "/stats")[1]["errors"] == 1
