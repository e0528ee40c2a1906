"""The port's network mode against the JAX package on the CPU: hub
downloads of weights and feature zips, ``decode_video_frames(backend=
"decord")``, ``extract_features --hf-dataset``, and W&B logging through
``run``. Nothing is downloaded: both packages import ``huggingface_hub``,
``datasets``, ``wandb`` and ``decord`` inside the functions that use them,
so the same stand-in (``tests/torch_network_fixtures.py``) is installed
into both with ``monkeypatch``.
"""

import ast
import contextlib
import io
import json
import os
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import extract_features as j_extract_features
import run as j_run
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.data import features as jfeatures
from anomaly_detection_on_video_tpu.data import video as jvideo
from anomaly_detection_on_video_tpu.training import loggers as jloggers
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu.utils import hub as jhub
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.data import features as tfeatures
from anomaly_detection_on_video_tpu_torch.data import gt as tgt
from anomaly_detection_on_video_tpu_torch.data import video as tvideo
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d, seeded_init_
from anomaly_detection_on_video_tpu_torch.scripts import parity_check
from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner
from anomaly_detection_on_video_tpu_torch.training import loggers as tloggers
from anomaly_detection_on_video_tpu_torch.utils import hub as thub
from anomaly_detection_on_video_tpu_torch.utils.convert import mgfn_state_dict_from_flax
from test_torch_hub import feature_set, zip_bytes
from test_torch_i3d import NARROW
from test_torch_mgfn import randomize_norms
from torch_network_fixtures import (DatasetsStandIn, DecordStandIn, HubStandIn, StubExtractor,
                                    WandbStandIn, STUB_WIDTH)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = (jhub.WEIGHTS_HUB, "converted_ref_i3d.pt")  # the default i3res50 spec's file
HUB_ERRORS = ("LocalEntryNotFoundError", "RepositoryNotFoundError", "EntryNotFoundError",
              "RevisionNotFoundError", "GatedRepoError", "HfHubHTTPError")
OPTIONAL = ("huggingface_hub", "datasets", "wandb", "decord")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as in tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow_weights(tmp_path_factory):
    """A narrow i3res50 (``NARROW`` stages) with seeded weights, saved as
    the default spec's ``.pt`` state dict: (path, model)."""
    model = seeded_init_(ti3d.I3DResNet(NARROW), seed=3)
    path = str(tmp_path_factory.mktemp("weights") / "narrow_i3d.pt")
    torch.save(model.state_dict(), path)
    return path, model


def write_mjpg(path, n_frames, seed):
    """Seeded RGB noise as an MJPG AVI (intra-frame: decode is deterministic)."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(seed)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (80, 64))
    for _ in range(n_frames):
        writer.write(rng.randint(0, 256, (64, 80, 3), np.uint8))
    writer.release()
    return path


# ------------------------------------------------------------ hub downloads

def test_resolve_weights_downloads_as_jax(monkeypatch, tmp_path):
    """``hf_hub_download`` gets the JAX function's keyword arguments and
    both return its path, with and without a revision and a cache dir."""
    import huggingface_hub

    local = str(tmp_path / "w.pt")
    for spec, filename, revision, cache_dir in (("hf://org/repo@r1/sub/w.pt", "sub/w.pt", "r1",
                                                 "/cache"),
                                                ("hf://org/repo/w.pt", "w.pt", None, None)):
        calls = []
        for resolve in (jhub.resolve_weights, thub.resolve_weights):
            hub = HubStandIn({("org/repo", filename): local})
            monkeypatch.setattr(huggingface_hub, "hf_hub_download", hub)
            assert resolve(spec, cache_dir) == local
            calls.append(hub.calls)
        assert calls[0] == calls[1] == [{"repo_id": "org/repo", "filename": filename,
                                         "revision": revision, "cache_dir": cache_dir}]


@pytest.mark.parametrize("error", HUB_ERRORS)
def test_hub_failures_raise_the_jax_message(error, monkeypatch):
    """Each of the six hub failures becomes the JAX function's
    FileNotFoundError, word for word (no "does not download": the hub ran)."""
    import huggingface_hub
    from huggingface_hub import errors as hub_errors

    def fail(**kwargs):
        raise getattr(hub_errors, error)("nope")

    monkeypatch.setattr(huggingface_hub, "hf_hub_download", fail)
    messages = []
    for resolve in (jhub.resolve_weights, thub.resolve_weights):
        with pytest.raises(FileNotFoundError) as exc:
            resolve("hf://org/repo@v1/w.pt")
        assert type(exc.value.__cause__).__name__ == error
        messages.append(str(exc.value))
    assert messages[0] == messages[1] and "does not download" not in messages[1]


def test_without_huggingface_hub_the_cache_is_read(monkeypatch, tmp_path):
    """Where ``huggingface_hub`` does not import, the port resolves a spec
    in the local cache that the hub stand-in filled as ``hf_hub_download``
    does, and its miss says that it does not download; the JAX function
    fails on the import."""
    (tmp_path / "w.pt").write_bytes(b"w")
    cache = str(tmp_path / "cache")
    snapshot = HubStandIn({("org/repo", "w.pt"): str(tmp_path / "w.pt")}, cache)(
        repo_id="org/repo", filename="w.pt", revision=None, cache_dir=None)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    assert thub.resolve_weights("hf://org/repo/w.pt", cache) == snapshot
    assert Path(snapshot).read_bytes() == b"w"
    with pytest.raises(FileNotFoundError, match="does not download"):
        thub.resolve_weights("hf://org/repo/x.pt", cache)
    with pytest.raises(ImportError):
        jhub.resolve_weights("hf://org/repo/w.pt", cache)


def test_feature_zips_download_as_jax(monkeypatch, tmp_path):
    """``build_feature_dataset(local_path=None)``: the JAX call sequence
    (the zip at ``revision`` into ``cache_dir``; the test split's
    ``ground_truth.json`` with neither) and the JAX arrays bit for bit; a
    file the hub has not cached gives the JAX text; any other hub error
    passes through in both."""
    import huggingface_hub
    from huggingface_hub.errors import RepositoryNotFoundError

    train, test, gt = feature_set(np.random.RandomState(2))
    files = {}
    for name, data in (("train.zip", zip_bytes(train)), ("test.zip", zip_bytes(test)),
                       ("ground_truth.json", json.dumps(gt).encode())):
        (tmp_path / name).write_bytes(data)
        files[tfeatures.DEFAULT_FEATURE_HUB, name] = str(tmp_path / name)
    got = {}
    for name, build in (("jax", jfeatures.build_feature_dataset),
                        ("port", tfeatures.build_feature_dataset)):
        hub = HubStandIn(files)
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", hub)
        kw = dict(cache_dir=str(tmp_path / "cache"), revision="tushar-n")
        train_ds, test_ds = build("train", **kw), build("test", **kw)
        items = []
        for ds in (train_ds["normal"], train_ds["abnormal"], test_ds):
            items += [(ds.filenames[i], key, np.asarray(value))
                      for i in range(len(ds)) for key, value in sorted(ds[i].items())
                      if key != "filename"]
        got[name] = (hub.calls, items)
        missing = HubStandIn({})
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", missing)
        with pytest.raises(FileNotFoundError) as exc:
            build("test", revision="nope")
        got[name] += (str(exc.value),)

        def refuse(**kwargs):
            raise RepositoryNotFoundError("gone")

        monkeypatch.setattr(huggingface_hub, "hf_hub_download", refuse)
        with pytest.raises(RepositoryNotFoundError):
            build("train")
    (jcalls, jitems, jmiss), (tcalls, titems, tmiss) = got["jax"], got["port"]
    assert tcalls == jcalls and [c["filename"] for c in jcalls] == [
        "train.zip", "test.zip", "ground_truth.json"]
    assert jcalls[2] == {"repo_id": tfeatures.DEFAULT_FEATURE_HUB,
                         "filename": "ground_truth.json", "repo_type": "dataset"}
    assert len(titems) == len(jitems) > 0
    for (tf, tk, tv), (jf, jk, jv) in zip(titems, jitems):
        assert (tf, tk) == (jf, jk) and tv.dtype == jv.dtype and np.array_equal(tv, jv)
    assert tmiss == jmiss and "cannot download" in jmiss


# ------------------------------------------------------------------ decord

def test_decord_backend_matches_jax(monkeypatch, tmp_path):
    """``decode_video_frames(backend="decord")`` through one stand-in
    decord: the JAX frames bit for bit (and OpenCV's, which the stand-in
    wraps), and the JAX ValueErrors for an unknown backend and an empty
    decode."""
    monkeypatch.setitem(sys.modules, "decord", DecordStandIn())
    path = write_mjpg(str(tmp_path / "v.avi"), 20, seed=4)
    for start, count in ((0, None), (3, 8), (15, 10)):
        want = jvideo.decode_video_frames(path, start, count, backend="decord")
        got = tvideo.decode_video_frames(path, start, count, backend="decord")
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want)
        assert np.array_equal(got, tvideo.decode_video_frames(path, start, count))
    # parity_check reads the reference's frames through the same function
    assert np.array_equal(parity_check.decode_frames(path, 8, backend="decord"),
                          jvideo.decode_video_frames(path, backend="decord")[:8])
    for kw in (dict(start=0, backend="nope"), dict(start=20, backend="decord")):
        messages = []
        for decode in (jvideo.decode_video_frames, tvideo.decode_video_frames):
            with pytest.raises(ValueError) as exc:
                decode(path, **kw)
            messages.append(str(exc.value))
        assert messages[0] == messages[1]


# ------------------------------------------------ extract_features --hf-dataset

def _hf_run(main, argv, capsys):
    main(argv)
    captured = capsys.readouterr()
    return captured.out, captured.err


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(Path(root).rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("split", [None, "train", "test"])
def test_hf_dataset_cli_matches_jax(split, narrow_weights, monkeypatch, tmp_path, capsys):
    """Both CLIs' ``--hf-dataset`` with each one's extractor replaced by
    ``StubExtractor`` (no I3D is built) and the same hub and ``datasets``
    stand-ins: the same default-weights line, ``load_dataset`` and hub
    calls, printed lines, and ``anomaly_features/<mode>/`` and segment
    trees byte for byte; ``--split`` keeps one mode, and only the train
    split is pooled into segments."""
    import huggingface_hub

    videos = {mode: [write_mjpg(str(tmp_path / "videos" / mode / f"{mode}{i}.avi"), 16 + 8 * i,
                                seed=10 * j + i) for i in range(2)]
              for j, mode in enumerate(("train", "test"))}
    datasets = DatasetsStandIn(videos)
    monkeypatch.setitem(sys.modules, "datasets", datasets)
    monkeypatch.setattr(jextraction, "FeatureExtractor", StubExtractor)
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", StubExtractor)
    results = {}
    for name, main, extra in (("jax", j_extract_features.main, []),
                              ("port", t_extract_features.main, ["--device", "cpu"])):
        hub = HubStandIn({WEIGHTS: narrow_weights[0]})
        monkeypatch.setattr(huggingface_hub, "hf_hub_download", hub)
        outdir = str(tmp_path / name)
        argv = ["--hf-dataset", "org/videos", "--outdir", outdir, "--decode-workers", "1"]
        out, err = _hf_run(main, argv + (["--split", split] if split else []) + extra, capsys)
        defaulted = [line for line in err.splitlines() if line.startswith("--weights not given")]
        printed = [line.replace(outdir, "<outdir>") for line in out.splitlines()
                   if line.startswith(("train:", "test:", "segmented"))]
        results[name] = (defaulted, printed, hub.calls, _tree(outdir))
    (jdef, jprinted, jcalls, jtree), (tdef, tprinted, tcalls, ttree) = (results["jax"],
                                                                        results["port"])
    assert tdef == jdef == [f"--weights not given; defaulting to hf://{'/'.join(WEIGHTS)} "
                            "(reference network-mode flow)"]
    assert tcalls == jcalls == [{"repo_id": WEIGHTS[0], "filename": WEIGHTS[1], "revision": None,
                                 "cache_dir": None}]
    assert datasets.calls == [[["org/videos", "anomaly"], {}]] * 2
    assert tprinted == jprinted
    modes = [split] if split else ["train", "test"]
    want_files = {f"anomaly_features/{m}/{m}{i}_i3d.npy" for m in modes for i in range(2)}
    if "train" in modes:
        want_files |= {f"segment_features_32/train{i}_i3d.npy" for i in range(2)}
        assert f"segmented 2 feature files -> <outdir>/segment_features_32" in tprinted
    assert set(ttree) == set(jtree) == want_files
    assert all(ttree[k] == jtree[k] for k in jtree)
    for m in modes:
        assert f"{m}: extracted 2 new videos -> <outdir>/anomaly_features/{m}" in tprinted
    if "train" in modes:
        seg = np.load(tmp_path / "port" / "segment_features_32" / "train0_i3d.npy")
        assert seg.shape == (10, 32, STUB_WIDTH)


def test_hf_dataset_features_equal_the_videos_run(narrow_weights, monkeypatch, tmp_path,
                                                  capsys):
    """The port's ``--hf-dataset`` (no ``--weights``: the default spec
    through the hub stand-in) and ``--videos`` runs of the same MJPG files
    with the same weights file, through a narrow float32 I3D: features and
    segment files byte-equal; the extractor got the served weights."""
    import huggingface_hub

    train = [write_mjpg(str(tmp_path / "train" / f"Abuse00{i}_x264.avi"), 20 + 12 * i, seed=i)
             for i in range(2)]
    test = [write_mjpg(str(tmp_path / "test" / "Normal_Videos_000_x264.avi"), 18, seed=7)]
    monkeypatch.setitem(sys.modules, "datasets", DatasetsStandIn({"train": train, "test": test}))
    monkeypatch.setattr(huggingface_hub, "hf_hub_download", HubStandIn({WEIGHTS: narrow_weights[0]}))
    built = []

    def factory(**kw):
        kw.pop("model_name")
        kw.pop("device")
        built.append(kw["state_dict"])
        return FeatureExtractor(model=ti3d.I3DResNet(NARROW), resize=64, cropsize=56,
                                device="cpu", **dict(kw, dtype=torch.float32))

    monkeypatch.setattr(t_extract_features, "FeatureExtractor", factory)
    common = ["--device", "cpu", "--batch", "20", "--decode-workers", "1"]
    t_extract_features.main(common + ["--hf-dataset", "org/videos", "--outdir",
                                      str(tmp_path / "hf")])
    for split in ("train", "test"):
        t_extract_features.main(common + ["--videos", str(tmp_path / split), "--split", split,
                                          "--outdir", str(tmp_path / "local"),
                                          "--weights", narrow_weights[0]])
    capsys.readouterr()
    want = narrow_weights[1].state_dict()
    assert len(built) == 3 and all(torch.equal(built[0][k], want[k]) for k in want)
    hf, local = _tree(tmp_path / "hf"), _tree(tmp_path / "local")
    renamed = {k.replace("anomaly_features/", ""): v for k, v in hf.items()}
    assert set(renamed) == set(local) == {
        "train/Abuse000_x264_i3d.npy", "train/Abuse001_x264_i3d.npy",
        "test/Normal_Videos_000_x264_i3d.npy", "segment_features_32/Abuse000_x264_i3d.npy",
        "segment_features_32/Abuse001_x264_i3d.npy"}
    assert all(renamed[k] == local[k] for k in local)
    assert np.load(tmp_path / "hf" / "anomaly_features" / "train" / "Abuse001_x264_i3d.npy"
                   ).shape == (2, 10, 64)  # 32 frames: 2 clips of 16


# ---------------------------------------------------------------- W&B logging

def test_wandb_logger_matches_jax(monkeypatch, tmp_path):
    """Both ``WandbLogger`` classes over one stand-in: login and init,
    scalars, an image, an artifact only under ``log_model`` (a directory
    or a file); without ``wandb`` both warn alike and log nothing."""
    (tmp_path / "ckpt").mkdir()
    (tmp_path / "f.png").write_bytes(b"png")
    calls = {}
    for name, cls in (("jax", jloggers.WandbLogger), ("port", tloggers.WandbLogger)):
        wandb = WandbStandIn()
        monkeypatch.setitem(sys.modules, "wandb", wandb)
        for log_model in (False, True):
            logger = cls(project="p", name="n", key="k", log_model=log_model)
            logger.log({"train_loss": 0.5, "epoch": 1}, step=3)
            logger.log_image("valid/overlay", str(tmp_path / "f.png"), 3)
            logger.log_artifact(str(tmp_path / "ckpt"), "checkpoint-step3")
            logger.log_artifact(str(tmp_path / "f.png"), "file", type="other")
        calls[name] = wandb.calls
    assert calls["port"] == calls["jax"]
    assert [c[1:3] for c in calls["jax"] if c[0] == "log_artifact"] == [
        ["checkpoint-step3", "model"], ["file", "other"]]
    warnings = []
    for cls in (jloggers.WandbLogger, tloggers.WandbLogger):
        monkeypatch.setitem(sys.modules, "wandb", None)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            logger = cls(key="k", log_model=True)
        logger.log({"a": 1.0}, 0)
        logger.log_image("x", "y.png", 0)
        logger.log_artifact(str(tmp_path / "ckpt"), "c")
        warnings.append(err.getvalue())
    assert warnings[0] == warnings[1] and "wandb package is not installed" in warnings[0]


def write_bags(root):
    """The committed bags (``docs/i3d_segments_seed0.npz``) as train
    features, transposed as (32, 10, 2048) test features, and the ground
    truth of one event (frames 160-320) in each abnormal video."""
    bags = np.load(os.path.join(REPO, "docs", "i3d_segments_seed0.npz"))
    train, test = os.path.join(root, "train"), os.path.join(root, "test")
    os.makedirs(train)
    os.makedirs(test)
    lines = []
    for name in bags.files:
        np.save(os.path.join(train, f"{name}_i3d.npy"), bags[name])
        np.save(os.path.join(test, f"{name}_i3d.npy"), bags[name].transpose(1, 0, 2))
        normal = "Normal" in name
        lines.append(f"{name}.mp4  {'Normal' if normal else 'Abuse'}  "
                     f"{'-1  -1' if normal else '160  320'}  -1  -1")
    annotations = os.path.join(root, "annotations.txt")
    with open(annotations, "w") as f:
        f.write("\n".join(lines) + "\n")
    gt = os.path.join(root, "gt.json")
    tgt.save_ground_truth(tgt.build_ground_truth(annotations, test), gt)
    return train, test, gt


def test_run_logs_to_wandb_as_jax_run_py(monkeypatch, tmp_path, capsys):
    """The root ``run.py`` and the port's ``run`` with ``wandb_key``,
    ``trainer/logger=wandb``, ``log_model`` and ``figure_dir``: a tiny MGFN
    at 2048 channels on the committed bags, 2 epochs, from one init with
    random norms. The recorded calls agree: login, project, the run name
    up to its ``%Y%m%d-%H%M%S`` stamp, each logged step's metric keys, the
    values within 1e-4 (losses relative, AUCs absolute; float32 on the
    CPU, no TF32), the figures, one ``checkpoint-step{step}`` model
    artifact per save with that step's directory. Without ``wandb`` the
    port's run prints the JAX logger's warning and still saves its steps."""
    train, test, gt = write_bags(str(tmp_path / "data"))
    common = ["runner=mgfn", f"data.train_path={train}", f"data.test_path={test}",
              f"data.ground_truth_path={gt}", "data.batch_size=3", "data.num_workers=0",
              "trainer.max_epochs=2", "runner.model_config.dims=[16,16,32]",
              "runner.model_config.depths=[1,1,1]", "runner.model_config.dim_head=8",
              "runner.model_config.dropout_rate=0.0", "wandb_key=secret",
              "trainer/logger=wandb", "trainer.logger.log_model=true",
              "trainer.logger.project=anomaly-test"]
    captured = {}
    j_init = jrunner.VideoAnomalyDetectionRunner.init_state

    def jax_init(self, example):
        state = j_init(self, example)
        variables = randomize_norms({"params": state.params, "batch_stats": state.batch_stats},
                                    np.random.RandomState(5))
        captured["sd"] = mgfn_state_dict_from_flax(variables)
        self.state = state.replace(
            params=jax.tree_util.tree_map(jax.numpy.asarray, variables["params"]),
            batch_stats=jax.tree_util.tree_map(jax.numpy.asarray, variables["batch_stats"]))
        return self.state

    t_init = VideoAnomalyDetectionRunner.init_state

    def port_init(self):
        state = t_init(self)
        state.model.load_state_dict(captured["sd"])
        return state

    monkeypatch.setattr(jrunner.VideoAnomalyDetectionRunner, "init_state", jax_init)
    monkeypatch.setattr(VideoAnomalyDetectionRunner, "init_state", port_init)
    calls = {}
    for name, main, extra in (("jax", j_run.main, ["trainer.data_parallel=false"]),
                              ("port", t_run.main, ["device=cpu"])):
        wandb = WandbStandIn()
        monkeypatch.setitem(sys.modules, "wandb", wandb)
        main(common + extra + [f"trainer.log_path={tmp_path}/{name}.jsonl",
                               f"trainer.checkpoint.dirpath={tmp_path}/{name}_wandb",
                               f"trainer.figure_dir={tmp_path}/{name}_figures"])
        calls[name] = wandb.calls
    # without wandb: the port's run warns as the JAX logger does (the root
    # run.py's only W&B step is that logger) and still saves its steps
    monkeypatch.setitem(sys.modules, "wandb", None)
    capsys.readouterr()
    jloggers.WandbLogger(key="secret")
    want_warning = capsys.readouterr().err.splitlines()
    t_run.main(common + ["device=cpu", "trainer.log_path=",
                         f"trainer.checkpoint.dirpath={tmp_path}/port_none"])
    warnings = [line for line in capsys.readouterr().err.splitlines() if "wandb" in line]
    assert warnings == want_warning and len(warnings) == 1
    assert sorted(os.listdir(tmp_path / "port_none")) == ["2", "4", "hparams.json"]

    got, want = calls["port"], calls["jax"]
    assert [c[0] for c in got] == [c[0] for c in want]
    assert got[:1] == want[:1] == [["login", "secret"]]
    stamp = re.compile(r"^default-mgfn-\d{8}-\d{6}$")
    assert got[1][:2] == want[1][:2] == ["init", "anomaly-test"]
    assert stamp.match(got[1][2]) and stamp.match(want[1][2])
    # per epoch: two train steps, the figure, the epoch's metrics, its save
    logs = [(g, w) for g, w in zip(got, want) if g[0] == "log"]
    assert [g[2] for g, _ in logs] == [w[2] for _, w in logs] == [0, 1, 2, 2, 2, 3, 4, 4]
    for g, w in logs:
        assert set(g[1]) == set(w[1])
        for key, value in w[1].items():
            if key in ("train_loss", "train_loss_epoch", "lr-Adam"):
                np.testing.assert_allclose(g[1][key], value, rtol=1e-4)
            elif key == "valid/overlay":
                assert os.path.basename(g[1][key][1]) == os.path.basename(value[1])
            elif key.startswith("valid/"):
                np.testing.assert_allclose(g[1][key], value, atol=1e-4)
            elif key == "epoch":
                assert g[1][key] == value
    images = [(g[1], w[1]) for g, w in zip(got, want) if g[0] == "Image"]
    assert [os.path.basename(g) for g, _ in images] == [os.path.basename(w) for _, w in images] \
        == ["eval_epoch0000.png", "eval_epoch0001.png"]
    artifacts = [(g, w) for g, w in zip(got, want) if g[0] == "log_artifact"]
    assert [g[1:3] for g, _ in artifacts] == [w[1:3] for _, w in artifacts] == [
        ["checkpoint-step2", "model"], ["checkpoint-step4", "model"]]
    for g, w in artifacts:
        assert g[3] == [["dir", str(tmp_path / "port_wandb" / g[1][len("checkpoint-step"):])]]
        assert w[3] == [["dir", str(tmp_path / "jax_wandb" / w[1][len("checkpoint-step"):])]]


# ------------------------------------------------------------ the import rule

def _imports_at_import_time(tree):
    """Modules a file imports when it is imported: every import statement
    outside function bodies (class bodies and module-level ``try``/``if``
    blocks run at import)."""
    names = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                names.extend(alias.name.split(".")[0] for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                names.append(child.module.split(".")[0])
            visit(child)

    visit(tree)
    return names


def test_optional_packages_are_imported_only_where_used():
    """No port module, and not ``chip_smoke.py``, imports ``huggingface_hub``,
    ``datasets``, ``wandb`` or ``decord`` when it is imported; each is
    imported inside the function that uses it."""
    files = sorted((Path(REPO) / "anomaly_detection_on_video_tpu_torch").rglob("*.py"))
    files.append(Path(REPO) / "chip_smoke.py")
    inside = set()
    for path in files:
        tree = ast.parse(path.read_text())
        assert not set(_imports_at_import_time(tree)) & set(OPTIONAL), path
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                inside |= {a.name.split(".")[0] for a in node.names} & set(OPTIONAL)
            elif isinstance(node, ast.ImportFrom) and node.module:
                inside |= {node.module.split(".")[0]} & set(OPTIONAL)
    assert inside == set(OPTIONAL)
