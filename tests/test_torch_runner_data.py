"""PyTorch port vs the JAX package: the training slice's data, ground
truth and config composition, and the extraction layer's repairs (the
K2/K3 shape rule, the crop-protocol pin).

Files are written in ``tmp_path``; both packages read the same files.
"""

import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import make_gt_ucf as j_make_gt_ucf
from anomaly_detection_on_video_tpu.config import compose as j_compose
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.data import features as jfeatures
from anomaly_detection_on_video_tpu.data import gt as jgt
from anomaly_detection_on_video_tpu.data import segments as jsegments
from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu_torch import make_gt_ucf as t_make_gt_ucf
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
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_from_flax
from test_torch_i3d import NARROW, _randomize_bn
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker
from torch_runner_fixtures import write_features


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
