"""PyTorch port vs the JAX package: the flow stream's extraction and
two-stream extraction and serving.

``adapt_stem_channels`` through the JAX exporter; the flow
``FeatureExtractor`` (host and device backends, ten and center crops)
against the JAX ``FeatureExtractor(stream="flow")``; int8 flow: the
calibration, the int8 stem over two channels bit-equal to the JAX int8
``ConvBN``, and its packed (64, 800) layout; the pins and file names; the
two-stream drivers against the JAX drivers, serial against pooled, chunk
caches, and the thread a device flow runs on; the CLIs' ``--stream``.
Narrow I3D (``I3DResNet(stages=NARROW)``) on 56-pixel crops, CPU, float32.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from anomaly_detection_on_video_tpu.data import extraction as jex
from anomaly_detection_on_video_tpu.data import flow as jdflow
from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.utils.convert import export_i3res50_state_dict
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch.data import extraction as tex
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models import build_model, seeded_init_
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.ops import kernels
from anomaly_detection_on_video_tpu_torch.ops.kernels import int8_conv, pack_int8_conv_weight
from anomaly_detection_on_video_tpu_torch.ops.kernels.int8_conv import (
    conv_output_shape,
    unpack_int8_conv_weight,
)
from anomaly_detection_on_video_tpu_torch.ops.quant import quantize_weight
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_from_flax
from test_torch_extraction import _write_mjpg
from test_torch_flow import textured_scene
from test_torch_i3d import NARROW, _randomize_bn, stem_slab, stem_tap_rows
from test_torch_int8 import _port_conv_bn

RESIZE, CROP, WIDTH = 64, 56, 64  # WIDTH: the narrow model's features per crop
TOL = dict(rtol=1e-4, atol=1e-4)  # the RGB extractor tests' tolerance


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow():
    """A narrow flax I3DResNet (RGB stem) with random BN, and its weights in
    the port's names: the one weight tree both streams start from."""
    model = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32)
    x = jnp.zeros((1, 16, CROP, CROP, 3), jnp.float32)
    variables = _randomize_bn(jax.jit(model.init)(jax.random.PRNGKey(0), x),
                              np.random.RandomState(1))
    return variables, i3d_state_dict_from_flax(variables)


@pytest.fixture
def jax_narrow(monkeypatch):
    """The JAX FeatureExtractor builds the narrow model."""
    monkeypatch.setattr(jex, "build_i3d_feature_extractor",
                        lambda name, dtype=jnp.float32, **kw: ji3d.I3DResNet(
                            stages=NARROW, dtype=dtype, **kw))


def _port(narrow, stream="flow", **kw):
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("batch", 20)
    return FeatureExtractor(model=ti3d.I3DResNet(stages=NARROW, in_channels=3 if stream == "rgb"
                                                 else 2),
                            state_dict=narrow[1], resize=RESIZE, cropsize=CROP, device="cpu",
                            stream=stream, **kw)


def _jax(narrow, stream="flow", **kw):
    kw.setdefault("batch", 20)
    return jex.FeatureExtractor(variables=narrow[0], dtype=jnp.float32, resize=RESIZE,
                                cropsize=CROP, stream=stream, **kw)


def _videos(root, lengths=(24, 24)):
    """Textured scenes moving by a known shift, as MJPG files in class
    subfolders (decode is deterministic)."""
    paths = []
    for i, n in enumerate(lengths):
        folder = ("Abuse", "Normal")[i % 2]
        paths.append(_write_mjpg(os.path.join(str(root), folder, f"v{i}_x264.avi"),
                                 textured_scene(n, 64, 80, seed=i)))
    return paths


# ----------------------------------------------------------- the flow stem

def test_adapt_stem_channels_matches_jax(narrow):
    """The RGB stem's mean over its input channels, repeated and scaled by
    3/2: bit-equal to the JAX function's tree exported to torch names;
    every other weight untouched; a 2-channel stem as it is."""
    variables, sd = narrow
    ref = export_i3res50_state_dict(jex.adapt_stem_channels(variables, 2))
    got = tex.adapt_stem_channels(sd, 2)
    assert got["conv1.weight"].shape == (64, 2, 5, 7, 7)
    np.testing.assert_array_equal(got["conv1.weight"].numpy(), ref["conv1.weight"])
    assert all(got[k] is sd[k] for k in sd if k != "conv1.weight")
    assert tex.adapt_stem_channels(got, 2) is got and sd["conv1.weight"].shape[1] == 3


@pytest.mark.parametrize("crops", ["ten", "center"])
@pytest.mark.parametrize("backend", ["host", "device"])
def test_flow_extractor_matches_jax(narrow, jax_narrow, backend, crops):
    """A textured 40-frame video: each package's flow transform gives the
    same uint8 flow, and the port's features equal the JAX
    FeatureExtractor(stream="flow")'s at the RGB tests' tolerance."""
    if backend == "host":
        pytest.importorskip("cv2")
    frames = textured_scene(40, 64, 80)
    port = _port(narrow, flow_backend=backend, crops=crops)
    ref = _jax(narrow, flow_backend=backend, crops=crops)
    assert (port.channels, port.flow_backend, port.transform_on_device) == (
        2, backend, backend == "device")
    flow = port._host_transform()(frames)
    # a device flow stays on the extractor's device, as a tensor
    assert isinstance(flow, torch.Tensor if backend == "device" else np.ndarray)
    want_flow = ref._host_transform()(frames)
    np.testing.assert_array_equal(np.asarray(flow), want_flow)
    assert flow.shape == (40, 64, 80, 2) and np.asarray(flow).dtype == np.uint8
    got, want = port.extract_frames(flow), ref.extract_frames(want_flow)
    assert got.shape == want.shape == (3, 10 if crops == "ten" else 1, WIDTH)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match=r"takes \(n, H, W, 2\) frames"):
        port.extract_frames(frames)


def test_flow_extractor_defaults_and_checks(narrow):
    """The backend defaults to host on the CPU; a model whose stem takes
    the other stream's channels, or an unknown backend, is refused."""
    assert _port(narrow).flow_backend == "host" and _port(narrow, "rgb").channels == 3
    with pytest.raises(ValueError, match="takes 2 input channels"):
        FeatureExtractor(model=ti3d.I3DResNet(stages=NARROW), device="cpu", stream="flow")
    with pytest.raises(ValueError, match="flow_backend must be host, device, or tvl1"):
        _port(narrow, flow_backend="gpu")
    with pytest.raises(ValueError, match="stream must be rgb or flow"):
        _port(narrow, stream="both")


@pytest.mark.parametrize("n_frames", [16, 40, 70])
def test_device_flow_is_padded_where_it_lies(narrow, n_frames):
    """A device flow's uint8 tensor is loop- and group-padded as a host
    array is, and extracts to the same features without leaving its
    device."""
    flow = np.random.RandomState(n_frames).randint(0, 256, (n_frames, 64, 80, 2), np.uint8)
    port = _port(narrow)
    for group in (1, 2, 4):
        padded = port.pad_frames(torch.from_numpy(flow), group)
        assert isinstance(padded, torch.Tensor)
        np.testing.assert_array_equal(padded.numpy(), port.pad_frames(flow, group))
    np.testing.assert_array_equal(port.extract_frames(torch.from_numpy(flow)),
                                  port.extract_frames(flow))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
def test_float32_extraction_runs_with_tf32_off(narrow, monkeypatch, dtype):
    """The process-wide TF32 flags are off for a float32 extractor's forward
    and calibration whatever another thread left them at, and restored
    after; a bf16 extractor leaves them alone (bf16 convs ignore them)."""
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.cudnn.allow_tf32)
    saved = flags()
    seen = []
    port = _port(narrow, dtype=dtype, quantize=True)
    forward = port.model.forward
    monkeypatch.setattr(port.model, "forward", lambda *a, **k: seen.append(flags()) or forward(
        *a, **k))
    calibrate = tex.calibrate_act_scales
    monkeypatch.setattr(tex, "calibrate_act_scales",
                        lambda *a, **k: seen.append(flags()) or calibrate(*a, **k))
    try:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = True, True
        port.extract_frames(np.zeros((16, 64, 80, 2), np.uint8))
        expect = (False, False) if dtype == torch.float32 else (True, True)
        assert len(seen) == 2 and set(seen) == {expect}  # calibration, then the forward
        assert flags() == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------- int8 flow

def test_int8_flow_calibration_matches_jax(narrow, jax_narrow, tmp_path):
    """The flow stream's int8 scales, calibrated on dequantized flow crops:
    the JAX package's keys, each at rel 1e-5, pinned as the JAX package's
    ``act_scales_flow.json``."""
    flow = jdflow.flow_to_uint8(jdflow.compute_flow(textured_scene(40, 64, 80)))
    port = _port(narrow, quantize=True, flow_backend="host")
    ref = _jax(narrow, quantize=True, flow_backend="host")
    port.pin_calibration(str(tmp_path))
    port._calibrate(flow)
    ref._calibrate(flow)
    assert json.loads((tmp_path / "act_scales_flow.json").read_text()) == port.model.act_scales
    got, want = port.model.act_scales, ref._act_scales
    assert sorted(got) == sorted(want) and "stem" in got
    np.testing.assert_allclose([got[k] for k in sorted(want)], [want[k] for k in sorted(want)],
                               rtol=1e-5)


def test_int8_stem_over_two_channels_matches_jax(rng):
    """The int8 stem conv over 2 channels (K5's plain version on the CPU):
    bit-equal to a flax ConvBN with act_scales, no BN."""
    x = (rng.randn(2, 6, 9, 12, 2) * 1.5).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0 * 0.8  # the top values saturate
    m = ji3d.ConvBN(64, kernel=(5, 7, 7), strides=(2, 2, 2), padding=(2, 3, 3), use_bn=False,
                    dtype=jnp.float32, act_scales={"": act_scale})
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(m.apply(variables, jnp.asarray(x)))
    conv, _ = _port_conv_bn(variables, 2, 64, (5, 7, 7), (2, 2, 2), (2, 3, 3), False)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = ti3d.int8_conv_nd(torch.from_numpy(x).permute(0, 4, 1, 2, 3), conv, act_scale)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)
    # the plain version on the CPU launches nothing, so the stem counts none
    assert kernels.stem_launch_counts() == {2: 0, 3: 0} and kernels.launch_counts()["int8_conv"] == 0


@pytest.mark.parametrize("cin", [2, 3])
def test_stem_packing_over_c_channels(rng, cin):
    """pack_int8_conv_weight's (64, 800) stem operand at C = 2 (and 3):
    ``[kt * C + c]`` per 16-byte tap, zeros after 5C and in the 50th tap;
    it unpacks to the weight, and read as the kernel reads it (two taps
    per k32 step against the slab's vectors) it is the conv, exactly; the
    wrapper's plain version is the same conv."""
    w_q, _ = quantize_weight(torch.from_numpy(rng.randn(64, cin, 5, 7, 7).astype(np.float32)))
    packed = pack_int8_conv_weight(w_q)
    assert packed.shape == (64, 800) and packed.dtype == torch.int8
    taps = packed.reshape(64, 50, 16)
    assert not taps[:, :, 5 * cin:].any() and not taps[:, 49].any()
    torch.testing.assert_close(taps[:, 8, :5 * cin].reshape(64, 5, cin),
                               w_q[:, :, :, 1, 1].permute(0, 2, 1))
    torch.testing.assert_close(unpack_int8_conv_weight(packed, cin, (5, 7, 7)), w_q)
    x = rng.randint(-127, 128, (2, 6, 9, 12, cin)).astype(np.float64)
    xt = torch.from_numpy(x)
    ref = F.conv3d(xt.permute(0, 4, 1, 2, 3), w_q.double(), None, 2, (2, 3, 3))
    ref = ref.permute(0, 2, 3, 4, 1)
    out = conv_output_shape(x.shape[1:4], (5, 7, 7), (2, 2, 2), (2, 3, 3))
    slab = stem_slab(xt)
    rows = [stem_tap_rows(slab, t // 7, t % 7, *out[1:]) for t in range(49)]
    rows.append(rows[48])  # the 50th tap's lanes read tap 48's pixels against zeros
    wt = taps.double()
    got = sum(torch.cat(rows[2 * kp: 2 * kp + 2], -1) @ wt[:, 2 * kp: 2 * kp + 2].reshape(-1, 32).t()
              for kp in range(25))
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    y = int8_conv(xt.to(torch.int8).contiguous(), packed, torch.ones(64), (5, 7, 7), (2, 2, 2),
                  (2, 3, 3), torch.float32)
    torch.testing.assert_close(y.double(), ref, atol=0, rtol=0)


# ---------------------------------------------------------- pins and names

def test_pins_and_names_match_jax(tmp_path, capsys):
    """flow_backend.json byte-equal to the JAX pin with the same message; a
    JAX-written pin stops the port with the JAX message; a re-pin of the
    same backend passes; the _flow file and chunk-cache names."""
    for name, fn in (("jax", jex.record_flow_backend), ("port", tex.record_flow_backend)):
        fn(str(tmp_path / name), "tvl1")
    out = capsys.readouterr().out.replace(str(tmp_path / "jax"), "D").replace(
        str(tmp_path / "port"), "D")
    assert out.splitlines()[0] == out.splitlines()[1] == (
        "flow backend: tvl1 (pinned in D/flow_backend.json)")
    assert ((tmp_path / "port" / "flow_backend.json").read_bytes()
            == (tmp_path / "jax" / "flow_backend.json").read_bytes())
    tex.record_flow_backend(str(tmp_path / "jax"), "tvl1")
    errors = []
    for fn in (jex.record_flow_backend, tex.record_flow_backend):
        with pytest.raises(ValueError) as exc:
            fn(str(tmp_path / "jax"), "device")
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "from the 'tvl1' backend" in errors[0]
    for stream in ("rgb", "flow"):
        assert tex.feature_filename("v", stream) == jex.feature_filename("v", stream)
    assert tex.feature_filename("v") == "v_i3d.npy"


def test_chunk_cache_names(narrow, jax_narrow, tmp_path):
    for stream in ("rgb", "flow"):
        got = _port(narrow, stream).chunk_cache_path(str(tmp_path), "/x/v.avi", 3)
        assert got == _jax(narrow, stream).chunk_cache_path(str(tmp_path), "/x/v.avi", 3)
    assert got == os.path.join(str(tmp_path), "v_flow", "v_flow_3.npy")


# ------------------------------------------------------ two-stream drivers

def test_two_stream_drivers_match_jax_and_each_other(narrow, jax_narrow, tmp_path):
    """Host flow: the port's serial two-stream driver writes the JAX
    serial driver's files (features at the RGB tests' tolerance), the
    pooled driver the serial port's bit for bit, and both pin the backend;
    a second run extracts nothing. The serving helper gives the same
    features as the bulk driver."""
    pytest.importorskip("cv2")
    paths = _videos(tmp_path / "vids", (24, 40))
    dirs = {name: str(tmp_path / name) for name in ("jax", "serial", "pooled")}
    assert jex.extract_videos_two_stream(paths, dirs["jax"], _jax(narrow, "rgb"),
                                         _jax(narrow, flow_backend="host"), progress=False) == 2
    port_rgb, port_flow = _port(narrow, "rgb"), _port(narrow, flow_backend="host")
    assert tex.extract_videos_two_stream(paths, dirs["serial"], port_rgb, port_flow,
                                         progress=False) == 2
    assert tex.extract_videos_pooled(paths, dirs["pooled"], port_rgb, port_flow,
                                     decode_workers=2, progress=False) == 2
    for name in ("v0_x264_i3d.npy", "v0_x264_flow.npy", "v1_x264_i3d.npy", "v1_x264_flow.npy"):
        serial = np.load(os.path.join(dirs["serial"], name))
        np.testing.assert_allclose(serial, np.load(os.path.join(dirs["jax"], name)), **TOL)
        np.testing.assert_array_equal(np.load(os.path.join(dirs["pooled"], name)), serial)
    assert serial.shape == (3, 10, WIDTH)
    for d in dirs.values():
        assert json.load(open(os.path.join(d, "flow_backend.json"))) == {"flow_backend": "host"}
    assert tex.extract_videos_pooled(paths, dirs["pooled"], port_rgb, port_flow,
                                     decode_workers=2, progress=False) == 0
    rgb, flow = tex.extract_video_two_stream(port_rgb, port_flow, paths[1])
    np.testing.assert_array_equal(rgb, np.load(os.path.join(dirs["serial"], "v1_x264_i3d.npy")))
    np.testing.assert_array_equal(flow, serial)
    with pytest.raises(ValueError, match="share a crop protocol"):
        tex.extract_videos_two_stream(paths, dirs["serial"], port_rgb,
                                      _port(narrow, crops="center"))


def test_device_flow_runs_on_the_consumer_thread(narrow, tmp_path, monkeypatch):
    """Pooled two-stream with a device backend: every flow transform runs
    on the dispatching (consumer) thread, never in a decode thread, and
    the files equal the serial driver's; with the host backend the
    transforms run in the decode threads. Large videos keep chunk caches
    per stream (``<stem>_flow/``), and a rebuild from them computes no
    flow and runs no forward."""
    paths = _videos(tmp_path / "vids", (40, 24))
    seen = {"device": [], "host": []}
    device_flow, host_flow = tex.compute_flow_device, tex.compute_flow

    def record(kind, fn):
        def wrapped(*args, **kwargs):
            seen[kind].append(threading.current_thread().name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tex, "compute_flow_device", record("device", device_flow))
    monkeypatch.setattr(tex, "compute_flow", record("host", host_flow))
    monkeypatch.setattr(tex, "is_large_video", lambda path: True)
    rgb, flow = _port(narrow, "rgb"), _port(narrow, flow_backend="device")
    out = {}
    for mode in ("serial", "pooled"):
        out[mode] = str(tmp_path / mode)
        if mode == "serial":
            tex.extract_videos_two_stream(paths, out[mode], rgb, flow, chunk_frames=16,
                                          progress=False)
        else:
            tex.extract_videos_pooled(paths, out[mode], rgb, flow, decode_workers=2,
                                      chunk_frames=16, progress=False)
    consumer = threading.current_thread().name
    assert len(seen["device"]) == 10 and set(seen["device"]) == {consumer}
    for name in sorted(os.listdir(out["serial"])):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(out["pooled"], name)),
                                          np.load(os.path.join(out["serial"], name)))
    assert sorted(os.listdir(os.path.join(out["pooled"], "v0_x264_flow"))) == [
        f"v0_x264_flow_{i}.npy" for i in range(3)]

    # a rebuild from every chunk cache: no flow, no forward
    seen["device"].clear()
    forwards = []
    for ex in (rgb, flow):
        monkeypatch.setattr(ex, "_extract", lambda *a, **k: forwards.append(1))
    for name in os.listdir(out["pooled"]):
        if name.endswith(".npy"):
            os.remove(os.path.join(out["pooled"], name))
    assert tex.extract_videos_pooled(paths, out["pooled"], rgb, flow, decode_workers=2,
                                     chunk_frames=16, progress=False) == 2
    assert not seen["device"] and not forwards
    np.testing.assert_array_equal(np.load(os.path.join(out["pooled"], "v0_x264_flow.npy")),
                                  np.load(os.path.join(out["serial"], "v0_x264_flow.npy")))

    pytest.importorskip("cv2")
    host = _port(narrow, flow_backend="host")
    assert tex.extract_videos_pooled(paths, str(tmp_path / "host"), host, decode_workers=2,
                                     chunk_frames=16, progress=False) == 2
    assert len(seen["host"]) == 5
    assert all(name.startswith("decode-pool") for name in seen["host"])
    assert sorted(f for f in os.listdir(tmp_path / "host") if f.endswith(".npy")) == [
        "v0_x264_flow.npy", "v1_x264_flow.npy"]


# ------------------------------------------------------------------- CLIs

def _factory(narrow, built):
    """The CLIs' FeatureExtractor at the narrow width (weights from the
    narrow tree, the flow stem adapted from it)."""
    def factory(**kw):
        kw = dict(kw, dtype=torch.float32)
        kw.pop("state_dict", None)
        kw.pop("device", None)
        ex = _port(narrow, **kw)
        built.append(ex)
        return ex
    return factory


def test_extract_features_stream_both(narrow, tmp_path, monkeypatch, capsys):
    """extract_features --stream both --split train on a class-subfolder
    tree, pooled and serial: both files per video, equal between the two
    runs, flow_backend.json, and (10, 32, C) segments for both streams;
    --flow-backend with --stream rgb warns as the JAX CLI does."""
    pytest.importorskip("cv2")
    _videos(tmp_path / "vids")
    built = []
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", _factory(narrow, built))
    for workers in ("2", "1"):
        args = ["--videos", str(tmp_path / "vids"), "--outdir", str(tmp_path / f"o{workers}"),
                "--split", "train", "--stream", "both", "--flow-backend", "host",
                "--decode-workers", workers, "--device", "cpu", "--batch", "20"]
        assert t_extract_features.main(args) == 0
    assert [(ex.stream, ex.flow_backend) for ex in built[:2]] == [("rgb", "host"),
                                                                   ("flow", "host")]
    train = tmp_path / "o2" / "train"
    assert sorted(os.listdir(train)) == ["flow_backend.json", "v0_x264_flow.npy",
                                         "v0_x264_i3d.npy", "v1_x264_flow.npy", "v1_x264_i3d.npy"]
    for name in os.listdir(train):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(train / name),
                                          np.load(tmp_path / "o1" / "train" / name))
            seg = np.load(tmp_path / "o2" / "segment_features_32" / name)
            assert seg.shape == (10, 32, WIDTH)
    capsys.readouterr()
    import extract_features as j_extract_features

    warnings = []
    for main in (j_extract_features.main, t_extract_features.main):
        with pytest.raises(SystemExit):
            main(["--videos", str(tmp_path / "none"), "--outdir", "o", "--flow-backend", "tvl1"])
        warnings.append(capsys.readouterr().err.splitlines()[0])
    assert warnings[0] == warnings[1] and "--flow-backend has no effect" in warnings[0]


def _two_stream_checkpoint(path, rng, stream="both", channels=2 * WIDTH):
    """A port checkpoint of a Sultani scorer over ``channels``-wide
    features whose run trained on ``data.stream=stream``."""
    _, model = build_model("sultani", channels=channels, hidden_dims=[32, 16])
    seeded_init_(model, seed=3)
    ckpt = TopKCheckpointer(str(path))
    ckpt.write_metadata({"model_name": "sultani", "model_config": {
        "channels": channels, "hidden_dims": [32, 16]}, "data": {"stream": stream}})
    ckpt.save(1, TrainState(model, adam_with_l2(model.parameters()), step=1))
    return model.eval()


def test_infer_takes_the_stream_from_the_checkpoint(narrow, tmp_path, monkeypatch, rng):
    """infer --checkpoint of a data.stream=both run, no --stream: the
    stream resolves to both, the JSON says so, each stream's features are
    cached (<stem>_i3d.npy, <stem>_flow.npy) and reused, and the clip
    scores are the scorer's on the RGB || flow concatenation; the width
    check names the fix for each mismatch, as the JAX CLI does."""
    pytest.importorskip("cv2")
    monkeypatch.setattr(t_infer, "FEATURE_DIM", WIDTH)
    built = []
    monkeypatch.setattr(t_infer, "FeatureExtractor", _factory(narrow, built))
    paths = _videos(tmp_path / "vids", (24,))
    scorer = _two_stream_checkpoint(tmp_path / "ck", rng)
    feats = tmp_path / "feats"
    argv = ["--videos", str(tmp_path / "vids"), "--checkpoint", str(tmp_path / "ck"),
            "--features-dir", str(feats), "--flow-backend", "host", "--device", "cpu",
            "--batch", "20", "--warmup", "2"]
    for run in ("s1", "s2"):
        assert t_infer.main(argv + ["--outdir", str(tmp_path / run)]) == 0
    assert [(ex.stream, ex.channels) for ex in built] == [("rgb", 3), ("flow", 2)] * 2
    out = json.load(open(tmp_path / "s2" / "v0_x264_scores.json"))
    assert out["stream"] == "both" and out["n_clips"] == 2
    rgb, flow = np.load(feats / "v0_x264_i3d.npy"), np.load(feats / "v0_x264_flow.npy")
    assert rgb.shape == flow.shape == (2, 10, WIDTH)
    assert json.load(open(feats / "flow_backend.json")) == {"flow_backend": "host"}
    want = t_infer.score_features(np.concatenate([rgb, flow], -1), scorer)
    np.testing.assert_allclose(out["clip_scores"], np.round(want, 6), atol=1e-6)
    assert json.load(open(tmp_path / "s1" / "v0_x264_scores.json"))["clip_scores"] == \
        out["clip_scores"]
    rgb_built = built[0]
    np.testing.assert_array_equal(rgb, rgb_built.extract_video(paths[0]))

    cases = (
        ([], "rgb", WIDTH, "--stream rgb extracts 64-d features but the sultani scorer expects "
                           "128-d input; pass --stream both (this scorer was trained on "
                           "concatenated RGB+flow features)"),
        (["--stream", "both"], "both", WIDTH, "--stream both extracts 128-d features but the "
                                              "sultani scorer expects 64-d input; retrain with "
                                              "data.stream=both or pass --model-config "
                                              "channels=128"),
    )
    for extra, stream, channels, message in cases:
        ck = tmp_path / f"ck_{stream}"
        _two_stream_checkpoint(ck, rng, stream, 2 * WIDTH if stream == "rgb" else channels)
        built.clear()
        with pytest.raises(SystemExit) as exc:
            t_infer.main(["--videos", str(tmp_path / "vids"), "--checkpoint", str(ck),
                          "--outdir", str(tmp_path / "o"), "--device", "cpu"] + extra)
        assert str(exc.value) == message and not built
