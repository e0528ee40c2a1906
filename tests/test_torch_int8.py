"""PyTorch port vs the JAX package: int8 extraction.

The int8 ConvBN of every conv geometry of the i3res50 int8 path, the plain
versions of kernels K4 (int8 matrix product) and K5 (int8 conv) against
the Pallas kernel and the dot_general they replace, the kernels' packed
operand layouts, a narrow int8 I3DResNet with its calibration, the int8
FeatureExtractor with its scales sidecar, and the int8 entry points.
"""

import json
import os
import sys

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
from anomaly_detection_on_video_tpu_torch.ops import kernels
from anomaly_detection_on_video_tpu_torch.ops.kernels import (
    int8_conv,
    int8_conv_plain,
    int8_matmul,
    int8_matmul_plain,
    pack_int8_conv_weight,
)
from anomaly_detection_on_video_tpu_torch.ops.kernels.int8_conv import conv_output_shape
from anomaly_detection_on_video_tpu_torch.ops.quant import pack_int8_weight_nk, quantize_weight
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    act_scale_key,
    i3d_state_dict_from_flax,
)
from test_torch_i3d import NARROW, _randomize_bn, stem_slab, stem_tap_rows
from test_torch_mgfn import NARROW as MGFN_NARROW


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")

# (cin, kernel, stride, padding): every conv geometry of the i3res50 int8 path
GEOMETRIES = {
    "k133_s1": (16, (1, 3, 3), (1, 1, 1), (0, 1, 1)),
    "k133_s2": (16, (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    "k311": (16, (3, 1, 1), (1, 1, 1), (1, 0, 0)),
    "k111": (16, (1, 1, 1), (1, 1, 1), (0, 0, 0)),
    "k111_strided": (16, (1, 1, 1), (1, 2, 2), (0, 0, 0)),
    "stem_k577_s2": (3, (5, 7, 7), (2, 2, 2), (2, 3, 3)),
}


def _cosine_rows(a, b):
    a = a.reshape(a.shape[0], -1).astype(np.float64)
    b = b.reshape(b.shape[0], -1).astype(np.float64)
    return np.sum(a * b, 1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _port_conv_bn(variables, cin, cout, kernel, stride, padding, use_bn):
    conv = torch.nn.Conv3d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
    bn = torch.nn.BatchNorm3d(cout)
    p = variables["params"]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(p["conv"]["kernel"]).transpose(4, 3, 0, 1, 2)))
        if use_bn:
            s = variables["batch_stats"]["bn"]
            for tensor, value in ((bn.weight, p["bn"]["scale"]), (bn.bias, p["bn"]["bias"]),
                                  (bn.running_mean, s["mean"]), (bn.running_var, s["var"])):
                tensor.copy_(torch.from_numpy(np.asarray(value)))
    return conv, bn.eval()


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_int8_conv_bn_matches_jax(rng, geometry, use_bn):
    """The port's int8 ConvBN (K4 / K5 plain on the CPU) against a top-level
    flax ConvBN with act_scales {"": s}: bit-equal without BN."""
    cin, kernel, stride, padding = GEOMETRIES[geometry]
    cout = 8
    x = (rng.randn(2, 6, 9, 11, cin) * 1.5).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0 * 0.8  # the top values saturate
    m = ji3d.ConvBN(cout, kernel=kernel, strides=stride, padding=padding, use_bn=use_bn,
                    dtype=jnp.float32, act_scales={"": act_scale})
    variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if use_bn:
        variables = _randomize_bn(variables, rng)
    ref = np.asarray(m.apply(variables, jnp.asarray(x)))

    conv, bn = _port_conv_bn(variables, cin, cout, kernel, stride, padding, use_bn)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
    with torch.no_grad():
        if use_bn:
            got = ti3d.conv_bn(xt, conv, bn, act_scale)
        else:
            got = ti3d.int8_conv_nd(xt, conv, act_scale)
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == ref.shape
    if use_bn:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_int8", [True, False], ids=["int8_out", "bf16_out"])
def test_int8_conv_plain_matches_pallas_kernel(rng, monkeypatch, out_int8):
    """K5's plain version against the Pallas kernel itself (interpret mode)
    at two (128, 28x28) planes, bit-equal in both epilogues. Pallas rows of
    w are ``tap * C + c_in`` with taps (kh, kw) row-major: K5's (Cout, K)
    operand is its transpose."""
    sys.path.insert(0, SCRIPTS)
    try:
        import int8_pallas_probe as probe
    finally:
        sys.path.remove(SCRIPTS)
    monkeypatch.setattr(probe, "B", 2)
    monkeypatch.setattr(probe, "T", 1)
    c, side = probe.PLANES, probe.H
    x = rng.randint(-8, 9, (2, c, side * side)).astype(np.int8)
    w = rng.randint(-3, 4, (9 * c, c)).astype(np.int8)
    # half the channels at 0.5 put exact halves in the product: round half to even
    s = np.where(np.arange(c) % 2 == 0, 0.5, rng.uniform(0.01, 0.3, c)).astype(np.float32)
    ref = probe.make_conv3x3(out_int8=out_int8, interpret=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s[:, None]))
    ref = np.asarray(ref).astype(np.float32)  # (2, C, F)

    x_cl = torch.from_numpy(x.reshape(2, c, side, side).transpose(0, 2, 3, 1).copy())[:, None]
    out_dtype = torch.int8 if out_int8 else torch.bfloat16
    got = int8_conv(x_cl, torch.from_numpy(w.T.copy()), torch.from_numpy(s), (1, 3, 3), (1, 1, 1),
                    (0, 1, 1), out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 1, side, side, c)
    got = got[:, 0].float().numpy().reshape(2, side * side, c).transpose(0, 2, 1)
    if out_int8:
        assert (np.abs(ref) == 127).any() and (np.abs(ref) < 127).mean() > 0.5
    np.testing.assert_array_equal(got, ref)


def test_int8_matmul_plain_matches_dot_general(rng):
    """K4's plain version against the body of ``probe_raw_matmul``:
    dot_general(w (K, N), x (K, M)) contracting dim 0 into int32."""
    k, n, m = 96, 40, 72
    x = rng.randint(-127, 128, (k, m)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(w), jnp.asarray(x), (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))  # (N, M)
    w_nk = torch.from_numpy(w.T.copy())  # K4's (N, K) operand
    got = int8_matmul(torch.from_numpy(x.T.copy()), w_nk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().T, ref)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, n).astype(np.float32))
    scaled = int8_matmul(torch.from_numpy(x.T.copy()), w_nk, scale, torch.bfloat16)
    np.testing.assert_array_equal(scaled.float().numpy(),
                                  (got.float() * scale).to(torch.bfloat16).float().numpy())


def test_int8_operands_repacked_for_a_new_scale(rng):
    """A conv keeps one packed int8 operand set: reused while its weight and
    input scale stay, replaced (not added to) when the scale changes."""
    conv = torch.nn.Conv3d(16, 8, (1, 3, 3), padding=(0, 1, 1), bias=False)
    x = torch.from_numpy(rng.randn(1, 2, 5, 5, 16).astype(np.float32)).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        first = ti3d.int8_conv_nd(x, conv, 0.02)
        packed = conv._kernel_operands[("int8", x.device)][1]
        ti3d.int8_conv_nd(x, conv, 0.02)
        assert conv._kernel_operands[("int8", x.device)][1] is packed
        second = ti3d.int8_conv_nd(x, conv, 0.05)
    assert len(conv._kernel_operands) == 1
    assert conv._kernel_operands[("int8", x.device)][1] is not packed
    fresh = torch.nn.Conv3d(16, 8, (1, 3, 3), padding=(0, 1, 1), bias=False)
    fresh.load_state_dict(conv.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(second, ti3d.int8_conv_nd(x, fresh, 0.05), atol=0, rtol=0)
    assert not torch.equal(first, second)


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


def test_int8_wrappers_check_inputs_and_count_only_launches(rng):
    a = torch.from_numpy(rng.randint(-5, 6, (6, 32)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-5, 6, (16, 32)).astype(np.int8))  # (N, K)
    x = torch.from_numpy(rng.randint(-5, 6, (1, 2, 5, 5, 16)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-5, 6, (8, 9 * 16)).astype(np.int8))  # (Cout, K)
    s16, s8 = torch.ones(16), torch.ones(8)
    before = kernels.launch_counts()
    assert {"int8_matmul", "int8_conv"} <= set(before)
    torch.testing.assert_close(int8_matmul(a, b, s16, torch.float32),
                               int8_matmul_plain(a, b, s16, torch.float32))
    geo = ((1, 3, 3), (1, 1, 1), (0, 1, 1))
    torch.testing.assert_close(int8_conv(x, w, s8, *geo, torch.int8),
                               int8_conv_plain(x, w, s8, *geo, torch.int8))
    assert kernels.launch_counts() == before
    bad_matmul = [
        (a.float(), b, None, None),  # not int8
        (a, b[:, :8], None, None),  # K mismatch
        (a, b, None, torch.float32),  # out_dtype without a scale
        (a, b, s8, torch.float32),  # scale length
        (a, b, s16.double(), torch.float32),  # scale type
        (a, b, s16, torch.int8),  # out_dtype K4 does not write
    ]
    for args in bad_matmul:
        with pytest.raises(ValueError):
            int8_matmul(*args)
    bad_conv = [
        (x.float(), w, s8, *geo, torch.int8),  # not int8
        (x[0], w, s8, *geo, torch.int8),  # not 5-D
        (x, w[:, :-16], s8, *geo, torch.int8),  # weights do not match the kernel
        (x, w, None, *geo, torch.int8),  # no scale
        (x, w, s16, *geo, torch.int8),  # scale length
        (x, w, s8, *geo, torch.int32),  # out_dtype
        (x, w, s8, (1, 3, 3), (1, 0, 1), (0, 1, 1), torch.int8),  # stride 0
        (x, w, s8, (1, 3, 3), (1, 1), (0, 1, 1), torch.int8),  # two strides
    ]
    for args in bad_conv:
        with pytest.raises(ValueError):
            int8_conv(*args)


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
