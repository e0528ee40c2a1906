"""PyTorch port vs the JAX package: int8 extraction.

The kernels' packed operand layouts, a narrow int8 I3DResNet with its
calibration, the int8 FeatureExtractor with its scales sidecar, and the
int8 entry points.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu_torch import extract_features as port_extract_features
from anomaly_detection_on_video_tpu_torch import infer as port_infer
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor, extract_videos
from anomaly_detection_on_video_tpu_torch.data.video import find_videos
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.models import seeded_init_
from anomaly_detection_on_video_tpu_torch.models.mgfn import MGFN, MGFNConfig
from anomaly_detection_on_video_tpu_torch.ops.kernels import pack_int8_conv_weight
from anomaly_detection_on_video_tpu_torch.ops.kernels.int8_conv import conv_output_shape
from anomaly_detection_on_video_tpu_torch.ops.quant import pack_int8_weight_nk, quantize_weight
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    act_scale_key,
    i3d_state_dict_from_flax,
)
from test_torch_i3d import NARROW, _randomize_bn, stem_slab, stem_tap_rows
from test_torch_mgfn import NARROW as MGFN_NARROW
from torch_int8_fixtures import GEOMETRIES, _cosine_rows
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _k5_product(x, packed, cin, kernel, stride, padding):
    """K5's operand evaluated as its kernels read it. Cin % 16 == 0: each
    16-wide piece of K lies in one tap, decoded from its offset as
    (kt, kh, kw, cin). The stem: per-pixel [kt, c] vectors, one k32 step per
    two (kh, kw) taps, the 50th tap's lanes reading tap 48's pixels against
    zero weights."""
    out = conv_output_shape(x.shape[1:4], kernel, stride, padding)
    if cin == 3:
        slab = stem_slab(x)
        taps = packed.double().reshape(packed.shape[0], 50, 16)
        rows = [stem_tap_rows(slab, t // 7, t % 7, *out[1:]) for t in range(49)] + [None]
        rows[49] = rows[48]
        return sum(torch.cat(rows[2 * kp: 2 * kp + 2], -1)
                   @ taps[:, 2 * kp: 2 * kp + 2].reshape(-1, 32).t() for kp in range(25))
    pt, ph, pw = padding
    xp = F.pad(x, (0, 0, pw, pw, ph, ph, pt, pt))
    acc = 0
    for k0 in range(0, packed.shape[1], 16):
        tap, ci = divmod(k0, cin)
        kt, kh, kw = tap // (kernel[1] * kernel[2]), tap // kernel[2] % kernel[1], tap % kernel[2]
        piece = xp[:, kt: kt + stride[0] * (out[0] - 1) + 1: stride[0],
                   kh: kh + stride[1] * (out[1] - 1) + 1: stride[1],
                   kw: kw + stride[2] * (out[2] - 1) + 1: stride[2], ci: ci + 16]
        acc = acc + piece @ packed[:, k0: k0 + 16].double().t()
    return acc


@pytest.mark.parametrize("layout", ["k5", "nk"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_packed_int8_weights_reproduce_conv(rng, geometry, layout):
    """The packed operands are the conv they encode, exactly in float64.
    "nk": K4's (Cout, kt*kh*kw*Cin) operand, rows (kt, kh, kw, cin), in an
    im2col product; for a 1x1x1 conv it is K4's matrix over the (strided)
    activation rows. "k5": ``pack_int8_conv_weight``'s operand read as K5's
    kernels read it (``_k5_product``): the same matrix for Cin % 16 == 0,
    the (64, 800) tap-pair layout for the stem."""
    cin, kernel, stride, padding = GEOMETRIES[geometry]
    cout = 64 if cin == 3 else 8
    x = torch.from_numpy(rng.randint(-127, 128, (2, 6, 9, 11, cin)).astype(np.float64))
    w_q, _ = quantize_weight(torch.from_numpy(rng.randn(cout, cin, *kernel).astype(np.float32)))
    k = int(np.prod(kernel)) * cin
    ref = F.conv3d(x.permute(0, 4, 1, 2, 3), w_q.double(), None, stride, padding)
    ref = ref.permute(0, 2, 3, 4, 1)
    if layout == "k5":
        packed = pack_int8_conv_weight(w_q)
        assert packed.dtype == torch.int8 and packed.is_contiguous()
        assert packed.shape == (cout, 800 if cin == 3 else k)
        torch.testing.assert_close(_k5_product(x, packed, cin, kernel, stride, padding), ref,
                                   atol=0, rtol=0)
        return
    nk = pack_int8_weight_nk(w_q)
    assert nk.shape == (cout, k) and nk.dtype == torch.int8 and nk.is_contiguous()
    pt, ph, pw = padding
    xp = F.pad(x, (0, 0, pw, pw, ph, ph, pt, pt))
    patches = xp.unfold(1, kernel[0], stride[0]).unfold(2, kernel[1], stride[1])
    patches = patches.unfold(3, kernel[2], stride[2])  # (B, To, Ho, Wo, C, kt, kh, kw)
    patches = patches.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(*patches.shape[:4], -1)
    got = patches @ nk.double().t()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
    if kernel == (1, 1, 1):
        rows = x[:, ::stride[0], ::stride[1], ::stride[2]]
        torch.testing.assert_close(rows @ nk.double().t(), got, atol=0, rtol=0)


@pytest.fixture(scope="module")
def narrow_int8():
    """A narrow flax I3DResNet with random BN, its calibration and its int8
    features on a 20 x 16 x 56 x 56 batch (2 clips x 10 crops)."""
    rng = np.random.RandomState(0)
    model = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32)
    x = rng.randn(20, 16, 56, 56, 3).astype(np.float32)
    variables = _randomize_bn(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1])), rng)
    scales = ji3d.calibrate_act_scales(model, variables, jnp.asarray(x))
    quant = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32, act_scales=scales)
    feats = np.asarray(jax.jit(quant.apply)(variables, jnp.asarray(x)))  # one compile
    return {"variables": variables, "x": x, "scales": scales, "feats": feats}


def _port_narrow(variables):
    port = ti3d.I3DResNet(stages=NARROW)
    port.load_state_dict(i3d_state_dict_from_flax(variables))
    return port.eval()


def test_narrow_int8_calibration_matches_jax(narrow_int8):
    port = _port_narrow(narrow_int8["variables"])
    got = ti3d.calibrate_act_scales(port, torch.from_numpy(narrow_int8["x"]))
    ref = narrow_int8["scales"]
    assert sorted(got) == sorted(ref) and len(got) == 9  # stem, 2 x 3 branches, 2 proj
    np.testing.assert_allclose([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)],
                               rtol=1e-5)
    assert port.act_scales is None  # calibration leaves the model unquantized


def test_narrow_int8_features_match_jax(narrow_int8):
    """With JAX's scales given to both, the int8 features agree to cosine
    >= 0.9999 per row (a float32 difference near 1e-6 can flip one int8
    code, so equality is not expected)."""
    port = _port_narrow(narrow_int8["variables"])
    port.act_scales = narrow_int8["scales"]
    with torch.no_grad():
        got = port(torch.from_numpy(narrow_int8["x"])).numpy()
    ref = narrow_int8["feats"]
    assert got.shape == ref.shape == (20, 64) and got.dtype == np.float32
    cos = _cosine_rows(got, ref)
    print(f"narrow int8 vs JAX: min row cosine {cos.min():.8f}, "
          f"max |diff| {np.abs(got - ref).max():.3e}")
    assert cos.min() >= 0.9999


def test_act_scale_keys_cover_every_conv():
    """All 53 convs of i3res50 map to distinct JAX-package scale keys, and
    the int8 model assigns each block its own branches."""
    model = ti3d.build_i3d_feature_extractor("tushar-n-baseline")
    convs = [name for name, m in model.named_modules() if isinstance(m, torch.nn.Conv3d)]
    keys = [act_scale_key(name) for name in convs]
    assert len(keys) == len(set(keys)) == 53
    assert {"stem", "stage1_block0/proj", "stage4_block2/branch_c"} <= set(keys)
    assert act_scale_key("layer2.0.downsample.0") == "stage2_block0/proj"
    model.act_scales = {k: float(i + 1) for i, k in enumerate(keys)}
    assert model.layer3[5].act_scales == {
        b: model.act_scales[f"stage3_block5/{b}"] for b in ("branch_a", "branch_b", "branch_c")}
    model.act_scales = None
    assert all(block.act_scales is None for block in model.layer2)


def _random_narrow(rng):
    """A narrow port I3DResNet with seeded weights and random BN."""
    port = seeded_init_(ti3d.I3DResNet(stages=NARROW), seed=int(rng.randint(1000)))
    with torch.no_grad():
        for bn in port.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                n = bn.num_features
                bn.weight.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5))
                bn.bias.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1))
                bn.running_mean.copy_(torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1))
                bn.running_var.copy_(torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5))
    return port


def _extractors(rng, **kw):
    port = _random_narrow(rng)
    common = dict(dtype=torch.float32, batch=10, resize=64, cropsize=56, device="cpu", **kw)
    base = FeatureExtractor(model=port, state_dict=port.state_dict(), **common)

    def quantized():
        model = ti3d.I3DResNet(stages=NARROW)
        return FeatureExtractor(model=model, state_dict=port.state_dict(), quantize=True, **common)

    return base, quantized


def test_quantized_extractor_matches_full_precision(rng):
    """The int8 extractor calibrates on its first chunk, stays close to the
    float32 extractor on the same weights, and keeps its scales after."""
    frames = rng.randint(0, 256, (3 * 16, 48, 64, 3), np.uint8)
    base, quantized = _extractors(rng)
    quant = quantized()
    assert quant._needs_calibration and quant.model.act_scales is None
    ref = base.extract_frames(frames)
    out = quant.extract_frames(frames)
    assert not quant._needs_calibration and len(quant.model.act_scales) == 9
    assert out.shape == ref.shape == (3, 10, 64)
    cos = float(np.sum(ref * out) / (np.linalg.norm(ref) * np.linalg.norm(out)))
    assert cos > 0.999, cos
    assert not np.array_equal(ref, out)  # quantized, not bypassed
    scales = quant.model.act_scales
    quant.extract_frames(frames)
    assert quant.model.act_scales is scales  # no recalibration on the second chunk


def test_calibration_sidecar_round_trip(rng, tmp_path, narrow_int8):
    """Scales in the JAX package's key format load from the sidecar
    unchanged; an extractor pinned to a directory does not recalibrate."""
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    (jax_dir / "act_scales_rgb.json").write_text(json.dumps(narrow_int8["scales"]))
    _, quantized = _extractors(rng)
    pinned = quantized()
    pinned.pin_calibration(str(jax_dir))
    assert not pinned._needs_calibration
    assert pinned.model.act_scales == narrow_int8["scales"]

    frames_a = rng.randint(0, 256, (2 * 16, 48, 64, 3), np.uint8)
    frames_b = rng.randint(100, 256, (2 * 16, 48, 64, 3), np.uint8)
    first = quantized()
    first.extract_frames(frames_a)  # calibrates on A
    first.pin_calibration(str(tmp_path / "port"))  # calibrated before: writes the sidecar
    written = json.loads((tmp_path / "port" / "act_scales_rgb.json").read_text())
    assert written == first.model.act_scales
    resumed = quantized()
    resumed.pin_calibration(str(tmp_path / "port"))
    assert not resumed._needs_calibration
    np.testing.assert_array_equal(resumed.extract_frames(frames_b), first.extract_frames(frames_b))


def _write_video(path, rng, n_frames=20):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (160, 120))
    for _ in range(n_frames):
        writer.write(rng.randint(0, 256, (120, 160, 3), np.uint8))
    writer.release()


def test_int8_entry_points(rng, tmp_path):
    """extract_videos and process_video with an int8 extractor on a real
    (cv2-written) video; both CLIs' parsers take --dtype int8."""
    videos = tmp_path / "videos"
    videos.mkdir()
    _write_video(videos / "clip.avi", rng)
    paths = find_videos(str(videos))
    _, quantized = _extractors(rng)

    feats_dir = tmp_path / "features"
    extractor = quantized()
    assert extract_videos(paths, str(feats_dir), extractor) == 1
    feats = np.load(feats_dir / "clip_i3d.npy")
    assert feats.shape == (2, 10, 64) and feats.dtype == np.float32
    scales = json.loads((feats_dir / "act_scales_rgb.json").read_text())
    assert scales == extractor.model.act_scales and len(scales) == 9
    assert extract_videos(paths, str(feats_dir), quantized()) == 0  # skip existing

    scorer = seeded_init_(MGFN(MGFNConfig(**MGFN_NARROW)), seed=1).eval()
    out = port_infer.process_video(paths[0], extractor, scorer, str(tmp_path / "scores"))
    assert out["n_clips"] == 2 and all(0.0 <= v <= 1.0 for v in out["frame_scores"])
    assert (tmp_path / "scores" / "clip_scores.json").exists()

    fresh = quantized()
    fresh.ensure_calibrated(str(tmp_path / "pinned"), paths[0])
    assert (tmp_path / "pinned" / "act_scales_rgb.json").exists()
    assert not fresh._needs_calibration

    infer_args = port_infer.build_parser().parse_args(
        ["--videos", str(videos), "--outdir", "o", "--torch-weights", "m.pt", "--dtype", "int8"])
    extract_args = port_extract_features.build_parser().parse_args(
        ["--videos", str(videos), "--outdir", "o", "--dtype", "int8", "--batch", "20"])
    for args in (infer_args, extract_args):
        kw = port_infer.extractor_kwargs(args)
        assert kw["quantize"] and kw["dtype"] == torch.bfloat16
        built = FeatureExtractor(model=ti3d.I3DResNet(stages=NARROW), device="cpu", **kw)
        assert built.quantize and built._needs_calibration and built.dtype == torch.bfloat16
    assert port_infer.extractor_kwargs(extract_args)["batch"] == 20
