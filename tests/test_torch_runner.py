"""PyTorch port vs the JAX package: the training slice's data, ground
truth, config composition, checkpointer and loop, the port's ``run`` against
the repository-root ``run.py``, and the extraction layer's repairs (the
K2/K3 shape rule, the crop-protocol pin).

Files are written in ``tmp_path``; both packages read the same files.
"""

import json
import os
import signal
import subprocess
import sys
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import make_gt_ucf as j_make_gt_ucf
import run as j_run
from anomaly_detection_on_video_tpu.config import compose as j_compose
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.data import features as jfeatures
from anomaly_detection_on_video_tpu.data import gt as jgt
from anomaly_detection_on_video_tpu.data import segments as jsegments
from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu_torch import make_gt_ucf as t_make_gt_ucf
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.config import compose, instantiate, locate
from anomaly_detection_on_video_tpu_torch.data import extraction as textraction
from anomaly_detection_on_video_tpu_torch.data import features as tfeatures
from anomaly_detection_on_video_tpu_torch.data import gt as tgt
from anomaly_detection_on_video_tpu_torch.data import segments as tsegments
from anomaly_detection_on_video_tpu_torch.models import (
    MGFN,
    RTFM,
    MGFNConfig,
    RTFMConfig,
    Sultani,
    SultaniConfig,
)
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.training import VideoAnomalyDetectionRunner
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    i3d_state_dict_from_flax,
    mgfn_state_dict_from_flax,
)
from test_torch_i3d import NARROW, _randomize_bn
from test_torch_mgfn import randomize_norms

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
C = 64  # feature width of the narrow runs
NARROW_MGFN = ["runner.model_config.dims=[16,16,32]", "runner.model_config.depths=[1,1,1]",
               "runner.model_config.dim_head=8", f"runner.model_config.channels={C}",
               "runner.model_config.dropout_rate=0.0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_features(root, rng, n_train=4, test_clips=(20, 37, 12, 50)):
    """Train bags (10, 32, C) and test features (n, 10, C) with flow mates,
    a temporal annotation file, and the ground truth built from it."""
    train, test = os.path.join(root, "train"), os.path.join(root, "test")
    os.makedirs(train)
    os.makedirs(test)
    for i in range(n_train):
        for stem, shift in ((f"Normal_Videos_{i:03d}_x264", 0.0), (f"Abuse{i:03d}_x264", 0.8)):
            bag = np.abs(rng.randn(10, 32, C)) * 0.5 + (rng.rand(1, 32, 1) > 0.7) * shift
            np.save(os.path.join(train, f"{stem}_i3d.npy"), bag.astype(np.float32))
            np.save(os.path.join(train, f"{stem}_flow.npy"), rng.rand(10, 32, C).astype(np.float32))
    lines = []
    for i, n in enumerate(test_clips):
        normal = i % 2 == 0
        stem = f"Normal_Videos_{i:03d}_x264" if normal else f"Abuse{i:03d}_x264"
        np.save(os.path.join(test, f"{stem}_i3d.npy"),
                (np.abs(rng.randn(n, 10, C)) * 0.5).astype(np.float32))
        events = "-1  -1" if normal else f"{16 * 3}  {16 * 8}"
        lines.append(f"{stem}.mp4  {'Normal' if normal else 'Abuse'}  {events}  -1  -1")
    annotations = os.path.join(root, "annotations.txt")
    with open(annotations, "w") as f:
        f.write("\n".join(lines) + "\n")
    gt_path = os.path.join(root, "gt.json")
    tgt.save_ground_truth(tgt.build_ground_truth(annotations, test), gt_path)
    return train, test, annotations, gt_path


# ------------------------------------------------ the extraction repairs

STAGE_SETS = {
    "stride1": NARROW,
    "spatial_stride2": ((8, 1, 2, (3,), (1,)),) + NARROW[1:],
    "temporal_stride2": ((8, 1, 1, (3,), (2,)),) + NARROW[1:],
}


@pytest.mark.parametrize("stages", sorted(STAGE_SETS))
@pytest.mark.parametrize("clip", [(16, 224, 224, 3), (8, 224, 224, 3), (16, 256, 256, 3),
                                  (32, 224, 224, 3)], ids=lambda c: "x".join(map(str, c[:3])))
def test_kernel_paths_follow_the_jax_rule(monkeypatch, clip, stages):
    """K2/K3 dispatch: the port's predicate against the JAX model's
    use_fused_stem / use_fused_stage1, read off which Pallas kernels a
    trace of the fused JAX model calls."""
    from anomaly_detection_on_video_tpu.ops.pallas import bottleneck as jbottleneck
    from anomaly_detection_on_video_tpu.ops.pallas import stem as jstem

    called = set()

    def recording(module, name):
        original = getattr(module, name)

        def wrapper(*args, **kwargs):
            called.add(name)
            return original(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    recording(jstem, "stem_conv_pool_h")
    recording(jbottleneck, "bottleneck_block")
    model = ji3d.I3DResNet(stages=STAGE_SETS[stages], fused_stem=True, fused_stage1=True)
    jax.eval_shape(model.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, *clip), jnp.float32))
    expected = ("stem_conv_pool_h" in called, "bottleneck_block" in called)
    assert ti3d.kernel_paths(STAGE_SETS[stages], clip) == expected


def test_eight_frame_clips_run_the_torch_chain_and_match_jax(rng, monkeypatch):
    """An 8-frame clip takes neither K2 nor K3 (their wrappers raise on the
    card for it) and matches the JAX I3DResNet at float32; a 16x224x224
    clip still takes both."""
    model = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32)
    x = rng.randn(2, 8, 224, 224, 3).astype(np.float32)
    variables = _randomize_bn(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    port = ti3d.I3DResNet(stages=NARROW)
    port.load_state_dict(i3d_state_dict_from_flax(variables))
    port.eval()
    originals = {"K2": ti3d.stem_conv_pool, "K3": ti3d.bottleneck_block}
    calls = []

    def refuse(*args):
        raise AssertionError("kernel called on an 8-frame clip")

    def recorder(name):
        return lambda *args: calls.append(name) or originals[name](*args)

    monkeypatch.setattr(ti3d, "stem_conv_pool", refuse)
    monkeypatch.setattr(ti3d, "bottleneck_block", refuse)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    monkeypatch.setattr(ti3d, "stem_conv_pool", recorder("K2"))
    monkeypatch.setattr(ti3d, "bottleneck_block", recorder("K3"))
    with torch.no_grad():
        port(torch.zeros(1, 16, 224, 224, 3))
    assert calls == ["K2", "K3"]


def test_crop_protocol_pin_matches_jax(tmp_path):
    """A center-crop pin written by the JAX package stops the port's
    extract_videos before it writes anything; the port's pin is the JAX
    one byte for byte, and a ten-crop run writes none."""
    pinned = str(tmp_path / "center")
    jextraction.record_crop_protocol(pinned, "center")
    before = {name: open(os.path.join(pinned, name), "rb").read() for name in os.listdir(pinned)}
    with pytest.raises(ValueError, match="center-crop"):
        textraction.extract_videos([str(tmp_path / "missing.avi")], pinned, textraction.FeatureExtractor(
            model=ti3d.I3DResNet(stages=NARROW), dtype=torch.float32, device="cpu"))
    after = {name: open(os.path.join(pinned, name), "rb").read() for name in os.listdir(pinned)}
    assert after == before == {"crops.json": before["crops.json"]}

    ours = str(tmp_path / "ours")
    textraction.record_crop_protocol(ours, "center")
    assert open(os.path.join(ours, "crops.json"), "rb").read() == before["crops.json"]
    ten = str(tmp_path / "ten")
    textraction.record_crop_protocol(ten, "ten")
    assert os.listdir(ten) == []
    np.save(os.path.join(ten, "v_i3d.npy"), np.zeros((1, 10, 4), np.float32))
    for fn in (textraction.record_crop_protocol, jextraction.record_crop_protocol):
        with pytest.raises(ValueError, match="ten-crop"):
            fn(ten, "center")
        fn(ten, "ten")


# ------------------------------------------------------ data and ground truth

def _assert_items_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(ref[key]).dtype, key


@pytest.mark.parametrize("stream", ["rgb", "flow", "both"])
@pytest.mark.parametrize("layout", ["dir", "zip"])
def test_feature_datasets_and_batches_match_jax(rng, tmp_path, layout, stream):
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    if layout == "zip":
        for split in ("train", "test"):
            with zipfile.ZipFile(tmp_path / f"{split}.zip", "w") as z:
                for name in sorted(os.listdir(tmp_path / split)):
                    z.write(tmp_path / split / name, f"{split}/{name}")
        train = test = str(tmp_path)  # a directory holding train.zip / test.zip
    kw = dict(dynamic_load=layout == "dir", stream=stream)
    ref_train = jfeatures.build_feature_dataset("train", local_path=train, **kw)
    got_train = tfeatures.build_feature_dataset("train", local_path=train, **kw)
    for split in ("normal", "abnormal"):
        assert got_train[split].filenames == ref_train[split].filenames
        assert len(got_train[split]) == 4
    for shuffle, epoch in ((False, 0), (True, 0), (True, 1)):
        args = dict(batch_size=3, shuffle=shuffle, seed=2, epoch=epoch)
        ref = list(jfeatures.train_batches(ref_train["normal"], ref_train["abnormal"], **args))
        got = list(tfeatures.train_batches(got_train["normal"], got_train["abnormal"], **args))
        assert len(got) == len(ref) == 1
        for g, r in zip(got, ref):
            _assert_items_equal(g, r)
    if stream == "flow":
        return  # the test split has no flow files
    if stream == "both":
        with pytest.raises(ValueError, match="flow mate"):
            tfeatures.build_feature_dataset("test", local_path=test, **kw)
        return
    ref_test = jfeatures.build_feature_dataset("test", local_path=test,
                                               ground_truth_path=gt_path, **kw)
    got_test = tfeatures.build_feature_dataset("test", local_path=test,
                                               ground_truth_path=gt_path, **kw)
    assert got_test.filenames == ref_test.filenames
    for g, r in zip(tfeatures.eval_batches(got_test), jfeatures.eval_batches(ref_test)):
        _assert_items_equal(g, r)
    names = ["Normal_Videos_003_x264", "RoadAccidents133_x264_i3d.npy", "Abuse028", "7up"]
    assert [tfeatures.video_class(n) for n in names] == [jfeatures.video_class(n) for n in names]
    assert [tfeatures.is_normal(n) for n in names] == [jfeatures.is_normal(n) for n in names]


def test_segments_and_ground_truth_match_jax(rng, tmp_path):
    for n in (1, 7, 32, 45, 200):
        x = rng.randn(n, 10, 6).astype(np.float32)
        got, ref = tsegments.segment_features(x), jsegments.segment_features(x)
        assert got.dtype == ref.dtype and got.shape == (10, 32, 6)
        np.testing.assert_array_equal(got, ref)
    src = tmp_path / "clips"
    src.mkdir()
    for n in (5, 40):
        np.save(src / f"v{n}_i3d.npy", rng.randn(n, 10, 6).astype(np.float32))
    assert tsegments.segment_video_features(str(src), str(tmp_path / "t")) == 2
    assert jsegments.segment_video_features(str(src), str(tmp_path / "j")) == 2
    assert tsegments.segment_video_features(str(src), str(tmp_path / "t")) == 0  # skip existing
    for name in os.listdir(src):
        assert open(tmp_path / "t" / name, "rb").read() == open(tmp_path / "j" / name, "rb").read()

    _, test, annotations, _ = write_features(str(tmp_path / "f"), rng)
    assert tgt.build_ground_truth(annotations, test) == jgt.build_ground_truth(annotations, test)
    with zipfile.ZipFile(tmp_path / "test.zip", "w") as z:
        for name in sorted(os.listdir(test)):
            z.write(os.path.join(test, name), f"test/{name}")
    assert (tgt.build_ground_truth(annotations, str(tmp_path / "test.zip"), 8)
            == jgt.build_ground_truth(annotations, str(tmp_path / "test.zip"), 8))
    args = ["--annotations", annotations, "--features", test]
    t_make_gt_ucf.main(args + ["--out", str(tmp_path / "t.json")])
    j_make_gt_ucf.main(args + ["--out", str(tmp_path / "j.json")])
    assert open(tmp_path / "t.json", "rb").read() == open(tmp_path / "j.json", "rb").read()


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("overrides", [
    [],
    ["runner=mgfn"],
    ["runner=mgfn", "data.batch_size=8", "trainer.max_steps=5", "seed=3", "data.shuffle=true"],
    ["runner=rtfm", "+trainer.extra=1e-3", "~trainer.figure_dir", "runner.optimizer.learning_rate=3e-4"],
    ["runner=mgfn", "++trainer.precision=bf16-mixed", "trainer.preempt_signals=[SIGTERM,SIGINT]",
     "+trainer.name=${runner.model_config.k}-${hydra:runtime.choices.runner}"],
], ids=["defaults", "mgfn", "values", "add_delete", "interpolation"])
def test_compose_matches_jax(overrides):
    assert compose(CONFIGS, "default", overrides) == j_compose(CONFIGS, "default", overrides)


def test_config_names_map_to_port_classes_without_jax():
    """The configs' JAX class names resolve to the port's classes, and the
    composition and lookup import neither jax nor the JAX package; the
    config chip_smoke.py falls back on is the port's composition."""
    cfg = compose(CONFIGS, "default", ["runner=mgfn"])
    assert chip_smoke.MGFN_RUN_CONFIG == cfg
    assert locate(cfg["runner"]["model_class"]) is MGFN
    assert locate(cfg["runner"]["cls"]) is VideoAnomalyDetectionRunner
    config = instantiate(cfg["runner"]["model_config"])
    assert isinstance(config, MGFNConfig) and tuple(config.dims) == (64, 128, 1024)
    for runner, model_cls, config_cls in (("rtfm", RTFM, RTFMConfig),
                                          ("sultani", Sultani, SultaniConfig)):
        cfg = compose(CONFIGS, "default", [f"runner={runner}"])
        assert chip_smoke.RUN_CONFIGS[runner] == cfg
        assert locate(cfg["runner"]["model_class"]) is model_cls
        assert isinstance(instantiate(cfg["runner"]["model_config"]), config_cls)
    with pytest.raises(ImportError):
        locate(f"{cfg['runner']['model_class']}Missing")
    code = ("import sys\n"
            "from anomaly_detection_on_video_tpu_torch.config import compose, instantiate, locate\n"
            f"cfg = compose({CONFIGS!r}, 'default', ['runner=mgfn'])\n"
            "locate(cfg['runner']['model_class'])(instantiate(cfg['runner']['model_config']))\n"
            "locate(cfg['runner']['cls'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'anomaly_detection_on_video_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr


# -------------------------------------------------------------- checkpoints

def _linear_state(step):
    model = torch.nn.Linear(3, 2)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1), step)


def test_checkpointer_retention_and_selection_match_jax(tmp_path):
    """Top-k by metric union latest, over the same save sequence as the
    JAX (orbax) checkpointer: the same steps survive every save, and
    latest / best / exact selections agree."""
    metrics = [0.5, None, 0.7, 0.7, 0.2, None, 0.9, 0.1, None]
    ours = TopKCheckpointer(str(tmp_path / "t"), top_k=3)
    ref = JCheckpointer(str(tmp_path / "j"), top_k=3)
    for i, metric in enumerate(metrics):
        step = (i + 1) * 2
        ours.save(step, _linear_state(step), metric)
        ref.save(step, types.SimpleNamespace(params={"w": np.zeros(3, np.float32)},
                                             batch_stats={"m": np.zeros(1, np.float32)},
                                             opt_state={"n": np.zeros(1, np.float32)},
                                             step=np.int32(step)), metric)
        ref.wait()
        assert ours.all_steps() == sorted(ref.manager.all_steps()), (step, metric)
        for selector in ("latest", "best", None):
            assert ours.resolve_step(selector) == ref.resolve_step(selector)
    for selector in (ours.all_steps()[0], str(ours.all_steps()[-1])):
        assert ours.resolve_step(selector) == ref.resolve_step(selector)
    for ckpt in (ours, ref):
        with pytest.raises(ValueError, match="not found"):
            ckpt.resolve_step(3)
    restored = ours.restore(_linear_state(0), "best")
    assert restored.step == ref.resolve_step("best")
    meta = {"model_name": "mgfn", "seed": 0}
    ours.write_metadata(meta)
    assert TopKCheckpointer.load_metadata(str(tmp_path / "t")) == meta


def _tiny_runner(checkpointer=None, loggers=()):
    config = MGFNConfig(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C)
    return VideoAnomalyDetectionRunner(MGFN(config), checkpointer=checkpointer, loggers=loggers,
                                       device="cpu")


def test_resume_continues_step_and_epoch_counts(rng, tmp_path):
    """As the JAX runner: a resumed run trains only the remaining epochs,
    and one whose budget is spent trains nothing but still evaluates."""
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    datasets = tfeatures.build_feature_dataset("train", local_path=train)
    valid = tfeatures.build_feature_dataset("test", local_path=test, ground_truth_path=gt_path)
    ckpt = TopKCheckpointer(str(tmp_path / "ckpt"))
    runner = _tiny_runner(ckpt)
    runner.fit(datasets, valid_dataset=valid, max_epochs=2, batch_size=2)
    assert runner.state.step == 4 and ckpt.all_steps() == [2, 4]

    def resumed():
        r = _tiny_runner(ckpt)
        r.init_state()
        r.restore(ckpt.restore(r.state))
        return r

    r = resumed()
    assert r.state.step == 4
    torch.testing.assert_close(r.state.model.state_dict(), runner.state.model.state_dict())
    assert r.fit(datasets, valid_dataset=valid, max_epochs=3, batch_size=2) is not None
    assert r.state.step == 6
    r = resumed()
    result = r.fit(datasets, valid_dataset=valid, max_epochs=3, batch_size=2)
    assert r.state.step == 6 and 0.0 <= result.rec_auc <= 1.0


def test_preemption_signal_saves_the_step_reached(rng, tmp_path):
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    datasets = tfeatures.build_feature_dataset("train", local_path=train)

    class Preempt:
        """Delivers SIGTERM to fit's handler after the third step (called
        directly: a real signal would end the process if no handler were
        installed)."""

        def log(self, metrics, step):
            if "train_loss" in metrics and step == 2:
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    ckpt = TopKCheckpointer(str(tmp_path / "ckpt"))
    runner = _tiny_runner(ckpt, [Preempt()])
    previous = signal.getsignal(signal.SIGTERM)
    assert runner.fit(datasets, max_epochs=5, batch_size=2, handle_signals=("SIGTERM",)) is None
    assert signal.getsignal(signal.SIGTERM) == previous
    assert runner.state.step == 3 and ckpt.all_steps() == [2, 3]
    assert ckpt.metrics(3) is None


# ---------------------------------------------------- the slice, end to end

def test_run_matches_jax_run_py(rng, tmp_path, monkeypatch, capsys):
    """The port's run against the repository-root run.py on one feature
    directory and ground truth: 2 epochs, eval every epoch, no shuffle, no
    selection dropout, the same initial weights (randomized norms, injected
    into both runners: the two frameworks draw different initial weights,
    and identity norms tie the top-k). Per-step losses, AUCs and
    hparams.json agree, and eval_only from the port's checkpoint repeats
    its last AUCs."""
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    common = ["runner=mgfn", f"data.train_path={train}", f"data.test_path={test}",
              f"data.ground_truth_path={gt_path}", "data.batch_size=2", "trainer.max_epochs=2",
              "data.num_workers=0"] + NARROW_MGFN
    captured = {}
    j_init = jrunner.VideoAnomalyDetectionRunner.init_state

    def jax_init(self, example):
        state = j_init(self, example)
        variables = randomize_norms({"params": state.params, "batch_stats": state.batch_stats},
                                    np.random.RandomState(5))
        captured["sd"] = mgfn_state_dict_from_flax(variables)
        self.state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                   batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                      variables["batch_stats"]))
        return self.state

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
    capsys.readouterr()
    t_run.main(common + ["device=cpu", "trainer.eval_only=true", "trainer.log_path=",
                         f"trainer.checkpoint.dirpath={tmp_path}/ck_t"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 4
    assert line["valid/rec_auc"] == got[-1]["valid/rec_auc"]
    assert line["valid/pr_auc"] == got[-1]["valid/pr_auc"]
