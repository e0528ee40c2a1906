"""The port's Hugging Face cache reader (``utils/hub.py``) and what reads
through it, against the JAX package on the CPU: the spec grammar, cached
weight paths against ``huggingface_hub``'s offline answer, the feature
zips of the reference's dataset repo bit for bit, and the CLIs. The port
reads the cache itself where ``huggingface_hub`` does not import (the
card's machine), so every test here blocks that import in this process
(``tests/test_torch_network_mode.py`` holds the download path).

The JAX side runs ``huggingface_hub`` in a child process that sets
``HF_HUB_OFFLINE=1`` before the import and refuses every socket
connection, over a cache written here in the hub's layout (refs, snapshots
symlinked to blobs).
"""

import hashlib
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.utils import hub as jhub
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.data import features as tfeatures
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models import build_model, i3d as ti3d, seeded_init_
from anomaly_detection_on_video_tpu_torch.utils import hub as thub
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = "jinmang2/ucf_crime_tencrop_i3d_seg32"
C = 64  # feature width of the cached zips
# narrow i3res50 with 2048-wide features, as tests/torch_i3d_variants_fixtures.py
STAGES_2048 = ((8, 1, 1, (3,), (1,)), (8, 1, 2, (1,), (1,)), (8, 1, 1, (1,), (1,)),
               (512, 1, 1, (1,), (1,)))


@pytest.fixture(autouse=True)
def no_huggingface_hub(monkeypatch):
    """The port's reader runs where ``huggingface_hub`` does not import;
    the real package here would also try the network."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as in tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def commit(name: str) -> str:
    return hashlib.sha1(name.encode()).hexdigest()


def put(root, repo_id, revision, relpath, data: bytes, repo_type="model"):
    """``data`` as ``relpath`` of ``repo_id`` at ``revision`` in the hub's
    cache layout: a blob, a snapshot symlink to it, a ref to the commit."""
    storage = os.path.join(root, "--".join([f"{repo_type}s", *repo_id.split("/")]))
    sha = commit(f"{repo_id}@{revision}")
    blob = os.path.join(storage, "blobs", hashlib.sha256(data).hexdigest())
    os.makedirs(os.path.dirname(blob), exist_ok=True)
    with open(blob, "wb") as f:
        f.write(data)
    link = os.path.join(storage, "snapshots", sha, *relpath.split("/"))
    os.makedirs(os.path.dirname(link), exist_ok=True)
    if not os.path.lexists(link):
        os.symlink(os.path.relpath(blob, os.path.dirname(link)), link)
    os.makedirs(os.path.join(storage, "refs"), exist_ok=True)
    with open(os.path.join(storage, "refs", revision), "w") as f:
        f.write(sha)
    return sha


def zip_bytes(arrays: dict) -> bytes:
    import io

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, array in arrays.items():
            item = io.BytesIO()
            np.save(item, array)
            z.writestr(f"features/{name}", item.getvalue())
    return buf.getvalue()


def feature_set(rng):
    train = {}
    for i in range(2):
        train[f"Normal_Videos_{i:03d}_x264_i3d.npy"] = np.abs(rng.randn(10, 32, C)).astype(
            np.float32)
        train[f"Abuse{i:03d}_x264_i3d.npy"] = (np.abs(rng.randn(10, 32, C)) + 0.5).astype(
            np.float32)
    test = {"Normal_Videos_100_x264_i3d.npy": np.abs(rng.randn(3, 10, C)).astype(np.float32),
            "Abuse100_x264_i3d.npy": np.abs(rng.randn(4, 10, C)).astype(np.float32)}
    gt = {"Normal_Videos_100_x264_i3d.npy": [0.0] * 48,
          "Abuse100_x264_i3d.npy": [0.0] * 20 + [1.0] * 44}
    return train, test, gt


@pytest.fixture(scope="module")
def hub_cache(tmp_path_factory):
    """A cache with two model repos and the reference's feature repo (zips
    at ``tushar-n``, the ground truth at ``main``), the weights a narrow
    i3res50 and a tiny MGFN."""
    root = str(tmp_path_factory.mktemp("hub"))
    rng = np.random.RandomState(0)
    i3d = seeded_init_(ti3d.I3DResNet(STAGES_2048), seed=3)

    def saved(state_dict) -> bytes:
        import io

        buf = io.BytesIO()
        torch.save(state_dict, buf)
        return buf.getvalue()

    i3d_bytes = saved(i3d.state_dict())
    _, mgfn = build_model("mgfn", dims=(8, 8, 16), depths=(1, 1, 1), dim_head=4)
    shas = {
        "main": put(root, jhub.WEIGHTS_HUB, "main", "converted_ref_i3d.pt", i3d_bytes),
        "v2": put(root, jhub.WEIGHTS_HUB, "v2", "converted_ref_i3d.pt", b"other"),
    }
    put(root, jhub.WEIGHTS_HUB, "main", "sub/dir/extra.pt", b"extra")
    put(root, "org/scorers", "main", "mgfn_hf.pt", saved(seeded_init_(mgfn, 1).state_dict()))
    train, test, gt = feature_set(rng)
    put(root, FEATURES, "tushar-n", "train.zip", zip_bytes(train), "dataset")
    put(root, FEATURES, "tushar-n", "test.zip", zip_bytes(test), "dataset")
    put(root, FEATURES, "main", "ground_truth.json", json.dumps(gt).encode(), "dataset")
    return {"root": root, "shas": shas, "i3d": i3d, "mgfn": mgfn}


SPECS = [
    "/data/weights/i3res50.pt", "i3res50.pt", "", "HF://org/repo/file.pt",
    "hf://jinmang2/test_video_fe/converted_ref_i3d.pt",
    "hf://org/repo@v1.0/sub/dir/file.pt",
    "hf://org/repo@" + "a" * 40 + "/w.pt",
    "hf://org/repo/a/b/c/d.bin",
    "hf://org/repo", "hf://org//file.pt", "hf:///repo/file.pt",
    "hf://org/@rev/file.pt", "hf://org/repo@/file.pt", "hf://org/repo/",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_matches_jax(spec):
    """``is_hub_spec`` and ``parse_hub_spec`` (its parts or its ValueError
    text) equal the JAX functions for local paths, revisions, 40-hex
    revisions, nested files and malformed specs."""
    assert thub.is_hub_spec(spec) == jhub.is_hub_spec(spec)

    def parsed(fn):
        try:
            return fn(spec)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert parsed(thub.parse_hub_spec) == parsed(jhub.parse_hub_spec)


def test_default_weight_spec_matches_jax():
    assert thub.WEIGHTS_HUB == jhub.WEIGHTS_HUB
    assert thub.DEFAULT_WEIGHT_FILES == jhub.DEFAULT_WEIGHT_FILES
    for name in (*jhub.DEFAULT_WEIGHT_FILES, "nope"):
        try:
            want = jhub.default_weight_spec(name)
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                thub.default_weight_spec(name)
            assert str(got.value) == str(exc)
        else:
            assert thub.default_weight_spec(name) == want
    assert thub.resolve_weights(None) is None and thub.resolve_weights("x.pt") == "x.pt"


# the JAX side, in a child process: huggingface_hub offline, sockets refused
JAX_SIDE = r"""
import json, os, socket, sys

def refuse(self, address, *args, **kwargs):
    if self.family != socket.AF_UNIX:
        raise OSError("network access is refused in this process")
    return _connect(self, address, *args, **kwargs)

_connect = socket.socket.connect
socket.socket.connect = refuse
socket.socket.connect_ex = refuse

import huggingface_hub.constants as constants
if not constants.HF_HUB_OFFLINE:
    sys.exit("HF_HUB_OFFLINE must be set before huggingface_hub is imported")
import numpy as np
from anomaly_detection_on_video_tpu.data.features import build_feature_dataset
from anomaly_detection_on_video_tpu.utils.hub import resolve_weights

job = json.loads(sys.argv[1])
out = {"resolve": []}
for spec, cache_dir in job["specs"]:
    try:
        out["resolve"].append(["ok", resolve_weights(spec, cache_dir)])
    except FileNotFoundError as exc:
        out["resolve"].append(["FileNotFoundError", str(exc)])
arrays = {}
train = build_feature_dataset("train", cache_dir=job["cache"], revision="tushar-n")
test = build_feature_dataset("test", cache_dir=job["cache"], revision="tushar-n")
for split, ds in (("normal", train["normal"]), ("abnormal", train["abnormal"]), ("test", test)):
    out[split] = list(ds.filenames)
    for i in range(len(ds)):
        for key, value in ds[i].items():
            if key != "filename":
                arrays[f"{split}/{i}/{key}"] = np.asarray(value)
for revision in ("main", "nope"):
    try:
        build_feature_dataset("train", cache_dir=job["cache"], revision=revision)
    except FileNotFoundError as exc:
        out.setdefault("misses", []).append(str(exc))
np.savez(job["npz"], **arrays)
with open(job["json"], "w") as f:
    json.dump(out, f)
"""


def cases(root, shas):
    """(spec, cache_dir) pairs: cached ones through HF_HUB_CACHE and
    through ``cache_dir``, then misses."""
    hub = jhub.WEIGHTS_HUB
    cached = [f"hf://{hub}/converted_ref_i3d.pt", f"hf://{hub}/sub/dir/extra.pt",
              f"hf://{hub}@v2/converted_ref_i3d.pt", f"hf://{hub}@{shas['main']}/sub/dir/extra.pt",
              f"hf://{hub}@main/converted_ref_i3d.pt", "hf://org/scorers/mgfn_hf.pt"]
    missing = [f"hf://{hub}@v2/sub/dir/extra.pt", f"hf://{hub}@v3/converted_ref_i3d.pt",
               f"hf://{hub}@{'0' * 40}/converted_ref_i3d.pt", "hf://nobody/nothing/file.pt",
               f"hf://{hub}/missing.pt", f"hf://{hub}@{shas['v2'].upper()}/converted_ref_i3d.pt"]
    return ([(s, None) for s in cached] + [(s, root) for s in cached[:3]]
            + [(s, None) for s in missing] + [(missing[0], root)], len(cached) + 3)


@pytest.fixture(scope="module")
def jax_side(hub_cache, tmp_path_factory):
    """The JAX package's answers over ``hub_cache``, from the child."""
    out = tmp_path_factory.mktemp("jax_side")
    specs, _ = cases(hub_cache["root"], hub_cache["shas"])
    job = {"specs": specs, "cache": hub_cache["root"], "npz": str(out / "items.npz"),
           "json": str(out / "out.json")}
    env = dict(os.environ, HF_HUB_OFFLINE="1", HF_HUB_CACHE=hub_cache["root"],
               HOME=str(out), JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("HF_HOME", None)
    subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(job)], env=env, cwd=REPO,
                   check=True, timeout=240)
    with open(job["json"]) as f:
        answers = json.load(f)
    with np.load(job["npz"]) as npz:
        answers["arrays"] = {k: npz[k] for k in npz.files}
    return answers


def test_resolve_weights_matches_huggingface_hub_offline(hub_cache, jax_side, monkeypatch):
    """Every cached spec resolves to ``hf_hub_download``'s offline path
    (the snapshot symlink) whether the root comes from HF_HUB_CACHE or
    ``cache_dir``; every uncached one raises FileNotFoundError in both,
    the port's text the JAX one's plus that it does not download."""
    monkeypatch.setenv("HF_HUB_CACHE", hub_cache["root"])
    specs, n_cached = cases(hub_cache["root"], hub_cache["shas"])
    for i, ((spec, cache_dir), (kind, want)) in enumerate(zip(specs, jax_side["resolve"])):
        if i < n_cached:
            assert kind == "ok", (spec, want)
            assert thub.resolve_weights(spec, cache_dir) == want
            assert os.path.isfile(want)
        else:
            assert kind == "FileNotFoundError", spec
            with pytest.raises(FileNotFoundError) as got:
                thub.resolve_weights(spec, cache_dir)
            head = want.split(" (")[0]
            assert str(got.value).startswith(head) and spec in str(got.value)
            assert "does not download" in str(got.value)


def test_cache_root_follows_the_hub_order(hub_cache, monkeypatch, tmp_path):
    """cache_dir, HF_HUB_CACHE, HF_HOME/hub, XDG_CACHE_HOME/huggingface/hub,
    ~/.cache/huggingface/hub, read at each call."""
    for name in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert thub.hub_cache_root() == str(tmp_path / "home" / ".cache" / "huggingface" / "hub")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert thub.hub_cache_root() == str(tmp_path / "xdg" / "huggingface" / "hub")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert thub.hub_cache_root() == str(tmp_path / "hf" / "hub")
    monkeypatch.setenv("HF_HUB_CACHE", hub_cache["root"])
    assert thub.hub_cache_root() == hub_cache["root"]
    assert thub.hub_cache_root("elsewhere") == "elsewhere"


def test_cached_features_match_jax(hub_cache, jax_side, monkeypatch):
    """``build_feature_dataset(local_path=None, cache_dir, revision="tushar-n")``:
    the JAX dataset's filenames and items bit for bit, the ground truth
    read at ``main`` of the default root (HF_HUB_CACHE here); a revision
    without the zips raises the JAX text."""
    monkeypatch.setenv("HF_HUB_CACHE", hub_cache["root"])
    kw = dict(cache_dir=hub_cache["root"], revision="tushar-n")
    train = tfeatures.build_feature_dataset("train", **kw)
    test = tfeatures.build_feature_dataset("test", **kw)
    arrays = jax_side["arrays"]
    for split, ds in (("normal", train["normal"]), ("abnormal", train["abnormal"]),
                      ("test", test)):
        assert ds.filenames == jax_side[split] and len(ds) == 2
        for i in range(len(ds)):
            item = ds[i]
            keys = sorted(k for k in item if k != "filename")
            assert keys == sorted(k.split("/")[2] for k in arrays if k.startswith(f"{split}/{i}/"))
            for key in keys:
                want = arrays[f"{split}/{i}/{key}"]
                got = np.asarray(item[key])
                assert got.dtype == want.dtype and np.array_equal(got, want), (split, i, key)
    misses = []
    for revision in ("main", "nope"):
        with pytest.raises(FileNotFoundError) as got:
            tfeatures.build_feature_dataset("train", cache_dir=hub_cache["root"],
                                            revision=revision)
        misses.append(str(got.value))
    assert misses == jax_side["misses"]


def test_local_filename_matches_jax(tmp_path):
    """``local_path`` joined with ``filename``: the JAX dataset's filenames
    and items bit for bit, both splits."""
    from anomaly_detection_on_video_tpu.data import features as jfeatures

    train, test, gt = feature_set(np.random.RandomState(1))
    (tmp_path / "ucf_train.zip").write_bytes(zip_bytes(train))
    (tmp_path / "ucf_test.zip").write_bytes(zip_bytes(test))
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    pairs = []
    for mode, name in (("train", "ucf_train.zip"), ("test", "ucf_test.zip")):
        kw = dict(local_path=str(tmp_path), filename=name,
                  ground_truth_path=str(tmp_path / "gt.json") if mode == "test" else None)
        got = tfeatures.build_feature_dataset(mode, **kw)
        want = jfeatures.build_feature_dataset(mode, **kw)
        pairs += ([(got[k], want[k]) for k in ("normal", "abnormal")] if mode == "train"
                  else [(got, want)])
    for got, want in pairs:
        assert got.filenames == want.filenames and len(got) == len(want) == 2
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b)
            for key in a:
                if key != "filename":
                    x, y = np.asarray(a[key]), np.asarray(b[key])
                    assert x.dtype == y.dtype and np.array_equal(x, y), key


def _narrow_factory(built):
    def factory(**kw):
        kw.pop("model_name")
        kw.pop("device")
        built.append(kw.get("state_dict"))
        return FeatureExtractor(model=ti3d.I3DResNet(STAGES_2048), resize=64, cropsize=56,
                                device="cpu", **dict(kw, dtype=torch.float32))
    return factory


def _write_avi(path, n_frames=20):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.RandomState(1)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (80, 64))
    for _ in range(n_frames):
        writer.write(rng.randint(0, 255, (64, 80, 3), np.uint8))
    writer.release()


def test_clis_take_cached_specs(hub_cache, monkeypatch, tmp_path, capsys):
    """``extract_features --weights hf://...`` writes the features of the
    same file given by path; ``infer``'s ``--torch-weights hf://...``
    builds the scorer that file's path builds; an uncached spec exits with
    one line in each, and a missing local file names the hf:// form."""
    monkeypatch.setenv("HF_HUB_CACHE", hub_cache["root"])
    built = []
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", _narrow_factory(built))
    vids = str(tmp_path / "vids")
    _write_avi(os.path.join(vids, "clip.avi"))
    spec = f"hf://{jhub.WEIGHTS_HUB}/converted_ref_i3d.pt"
    path = thub.resolve_weights(spec)
    common = ["--videos", vids, "--device", "cpu", "--batch", "10", "--decode-workers", "1",
              "--dtype", "float32", "--crops", "center"]
    for out, weights in (("by_path", path), ("by_spec", spec)):
        t_extract_features.main(common + ["--outdir", str(tmp_path / out), "--weights", weights])
    got = np.load(tmp_path / "by_spec" / "clip_i3d.npy")
    assert got.shape == (2, 1, 2048)
    np.testing.assert_array_equal(got, np.load(tmp_path / "by_path" / "clip_i3d.npy"))
    want = hub_cache["i3d"].state_dict()
    assert all(torch.equal(built[-1][k], want[k]) for k in want)

    missing = f"hf://{jhub.WEIGHTS_HUB}@v9/converted_ref_i3d.pt"
    with pytest.raises(SystemExit) as exc:
        t_extract_features.main(common + ["--outdir", str(tmp_path / "x"), "--weights", missing])
    message = str(exc.value.code)
    assert missing in message and "\n" not in message and "does not download" in message
    with pytest.raises(SystemExit):
        t_extract_features.main(common + ["--outdir", str(tmp_path / "x"), "--weights", "no.pt"])
    assert "(or use hf://org/repo/file" in capsys.readouterr().err

    args = dict(model="mgfn", model_config=["dims=[8,8,16]", "depths=[1,1,1]", "dim_head=4"],
                checkpoint=None, official=False, i3d_weights=None, checkpoint_step="latest",
                device="cpu")
    import argparse

    scorer, name = t_infer.build_scorer(argparse.Namespace(
        torch_weights="hf://org/scorers/mgfn_hf.pt", **args))
    want = seeded_init_(build_model("mgfn", dims=(8, 8, 16), depths=(1, 1, 1), dim_head=4)[1],
                        1).state_dict()
    assert name == "mgfn" and all(torch.equal(scorer.state_dict()[k], want[k]) for k in want)
    for flag, value in (("torch_weights", "hf://org/scorers@v2/mgfn_hf.pt"),
                        ("torch_weights", "nope.pt"), ("i3d_weights", "nope.pt")):
        kw = dict(args, torch_weights="hf://org/scorers/mgfn_hf.pt")
        kw[flag] = value
        with pytest.raises(SystemExit) as exc:
            t_infer.build_scorer(argparse.Namespace(**kw))
        message = str(exc.value.code)
        assert value in message and "\n" not in message
        assert ("does not download" if value.startswith("hf://")
                else "(or use hf://org/repo/file)") in message


def test_run_trains_from_the_cache(hub_cache, monkeypatch, tmp_path):
    """``run`` with no local path (the data config's ``revision:
    tushar-n``) trains on the cached zips: per-step losses and AUCs equal
    a run on the same zips by path; an empty cache is a one-line data
    error."""
    monkeypatch.setenv("HF_HUB_CACHE", hub_cache["root"])
    common = ["runner=mgfn", "device=cpu", "data.batch_size=1", "trainer.max_epochs=1",
              "data.num_workers=0", "runner.model_config.dims=[16,16,32]",
              "runner.model_config.depths=[1,1,1]", "runner.model_config.dim_head=8",
              f"runner.model_config.channels={C}", "runner.model_config.dropout_rate=0.0"]
    train = thub.cached_file(FEATURES, "train.zip", "tushar-n", repo_type="dataset")
    test = thub.cached_file(FEATURES, "test.zip", "tushar-n", repo_type="dataset")
    gt = thub.cached_file(FEATURES, "ground_truth.json", repo_type="dataset")
    by_path = common + [f"data.train_path={train}", f"data.test_path={test}",
                        f"data.ground_truth_path={gt}"]
    for name, argv in (("path", by_path), ("cache", common)):
        t_run.main(argv + [f"trainer.log_path={tmp_path}/{name}.jsonl",
                           f"trainer.checkpoint.dirpath={tmp_path}/{name}_ckpt"])

    def records(name):
        with open(tmp_path / f"{name}.jsonl") as f:
            return [json.loads(line) for line in f]

    def untimed(record):
        return {k: v for k, v in record.items() if k != "time" and not k.endswith("_time_s")}

    got, want = records("cache"), records("path")
    assert len(got) == len(want) >= 2
    assert [untimed(g) for g in got] == [untimed(w) for w in want]
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    with pytest.raises(SystemExit) as exc:
        t_run.main(common + ["trainer.log_path=", f"trainer.checkpoint.dirpath={tmp_path}/ckpt"])
    assert str(exc.value.code).startswith("data error: cannot download")
