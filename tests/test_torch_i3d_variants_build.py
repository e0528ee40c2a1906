"""PyTorch port vs the JAX package: building the other I3D backbones.

The full-width factories and their state-dict names; the S2D stem against
the JAX ``S2DConvBN`` and the port's plain stem; the full-width
calibration keys; K5's packed stem operand at temporal stride 1 as the
conv it encodes; and the extractor and both CLIs taking ``--model`` /
``--i3d-model i3d_8x8_r50`` with ``.pyth`` weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.models import seeded_init_
from anomaly_detection_on_video_tpu_torch.ops import kernels
from anomaly_detection_on_video_tpu_torch.ops.kernels import int8_conv_plain, pack_int8_conv_weight
from anomaly_detection_on_video_tpu_torch.ops.kernels.int8_conv import conv_output_shape
from anomaly_detection_on_video_tpu_torch.ops.quant import quantize_weight
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_to_pytorchvideo
from test_torch_i3d import NARROW, _randomize_bn, stem_tap_rows
from torch_infer_fixtures import NARROW_2048, _port_mgfn_weights, _write_avi
from torch_i3d_variants_fixtures import STAGES_2048, _port_full, narrow_like
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the 224x224 stems want more than one, and the
    test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_factories_and_state_dict_names():
    """Full-width factories: the JAX geometry, the reference names for
    every variant (non-local convs under ``layer{L}.{i}.nl``), and an
    unknown name raising AttributeError."""
    full = {v: _port_full(v) for v in ("i3d_8x8_r50", "i3res50_nl")}
    assert full["i3d_8x8_r50"].stem == ti3d.I3D_8X8_STEM
    assert full["i3d_8x8_r50"].head_pool_kernel == (4, 7, 7)
    assert full["i3d_8x8_r50"].conv1.stride == (1, 2, 2)
    names = set(full["i3res50_nl"].state_dict())
    nl = sorted({k.rsplit(".nl.", 1)[0] for k in names if ".nl." in k})
    assert nl == ["layer2.1", "layer2.3", "layer3.1", "layer3.3", "layer3.5"]
    assert set(full["i3d_8x8_r50"].state_dict()) == set(
        ti3d.build_i3d_feature_extractor("tushar-n-baseline").state_dict())
    flow = ti3d.build_i3d_feature_extractor("i3d_8x8_r50", in_channels=2)
    assert flow.conv1.weight.shape == (64, 2, 5, 7, 7)
    with pytest.raises(AttributeError):
        ti3d.build_i3d_feature_extractor("nope")


@pytest.mark.parametrize("stride", [(2, 2, 2), (1, 2, 2)], ids=["s222", "s122"])
def test_s2d_stem_matches_jax_and_plain_stem(rng, stride):
    """The S2D stem conv + BN against the JAX ``S2DConvBN`` and against the
    port's plain stem ConvBN (atol 1e-5, float32); a padded dim that does
    not divide by the stride raises ValueError in both packages."""
    x = rng.randn(2, 8, 32, 36, 3).astype(np.float32)
    jm = ji3d.S2DConvBN(64, kernel=(5, 7, 7), strides=stride, padding=(2, 3, 3))
    variables = _randomize_bn(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = ti3d.I3DResNet(NARROW, stem_stride=stride, s2d_stem=True)
    with torch.no_grad():
        model.conv1.weight.copy_(torch.from_numpy(
            np.asarray(variables["params"]["conv"]["kernel"]).transpose(4, 3, 0, 1, 2).copy()))
        for name, key, node in (("weight", "scale", "params"), ("bias", "bias", "params"),
                                ("running_mean", "mean", "batch_stats"),
                                ("running_var", "var", "batch_stats")):
            getattr(model.bn1, name).copy_(torch.from_numpy(np.asarray(variables[node]["bn"][key])))
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
        got = ti3d._affine(ti3d.s2d_conv3d(xt, model.conv1.weight, stride, (2, 3, 3)), model.bn1)
        plain = ti3d.conv_bn(xt, model.conv1, model.bn1)
    got, plain = got.permute(0, 2, 3, 4, 1).numpy(), plain.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == ref.shape == plain.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5)
    odd = rng.randn(1, 8, 33, 36, 3).astype(np.float32)  # 33 + 6 = 39 rows: not even
    with pytest.raises(ValueError, match="divisible"):
        jm.apply(variables, jnp.asarray(odd))
    with pytest.raises(ValueError, match="divisible"), torch.no_grad():
        model(torch.from_numpy(odd))


@pytest.mark.parametrize("variant,count", [("i3d_8x8_r50", 53), ("i3res50_nl", 53),
                                           ("i3res50_s2d", 52)])
def test_full_width_calibration_keys(variant, count):
    """At full width, 53 scales (16 blocks x 3 convs, 4 projections and the
    stem) for the 8x8 model and the non-local i3res50, 52 with the S2D
    stem, whose stem stays float (the JAX ``S2DConvBN`` never sows)."""
    model = seeded_init_(_port_full(variant), seed=1).eval()
    scales = ti3d.calibrate_act_scales(model, torch.randn(1, 8, 32, 32, 3))
    assert len(scales) == count and ("stem" in scales) == (count == 53)


def stem_slab(x, st):
    """The int8 stem kernel's per-pixel vectors (csrc/int8_conv.cu) for
    every stem frame at temporal stride ``st``, built with the kernel's own
    frame mapping: the CTA of stem frames 2u, 2u + 1 loads input frames
    2u*st - 2 + f, and element ``kt * C + c`` of frame j's vector comes
    from its frame f = st*j + kt. -> (B, To, H+6, 2, Q, 16), rows from -3
    and columns from -4 split by parity, zeros past 5C and in the padding."""
    b, t, h, w, c = x.shape
    frames_out = (t - 1) // st + 1  # To of k5 p2
    cols = w + 8 + w % 2
    pairs = (frames_out + 1) // 2
    xp = F.pad(x, (0, 0, 4, cols - w - 4, 3, 3, 2, 2 * st * pairs + 8))  # frame i at i + 2
    vectors = []
    for s in range(frames_out):
        u, j = divmod(s, 2)
        vectors.append(torch.stack(
            [xp[:, 2 * st * u - 2 + st * j + e // c + 2, :, :, e % c] for e in range(5 * c)], -1))
    vec = F.pad(torch.stack(vectors, 1), (0, 16 - 5 * c))
    return vec.reshape(b, frames_out, h + 6, cols // 2, 2, 16).transpose(3, 4)


@pytest.mark.parametrize("cin", [3, 2], ids=["rgb", "flow"])
@pytest.mark.parametrize("st", [1, 2], ids=["s122", "s222"])
def test_k5_stem_operand_reproduces_plain(rng, cin, st):
    """K5's (64, 800) stem operand read as the stem kernel reads it (two
    (kh, kw) taps per k32 step, the 50th tap's lanes on tap 48's pixels
    against zero weights) equals ``int8_conv_plain`` exactly at both
    temporal strides, over RGB and the flow stream's two channels."""
    x = torch.from_numpy(rng.randint(-127, 128, (2, 6, 9, 12, cin)).astype(np.float64))
    w_q, _ = quantize_weight(torch.from_numpy(rng.randn(64, cin, 5, 7, 7).astype(np.float32)))
    packed = pack_int8_conv_weight(w_q)
    geo = ((5, 7, 7), (st, 2, 2), (2, 3, 3))
    out = conv_output_shape(x.shape[1:4], *geo)
    assert out[0] == (6 if st == 1 else 3)
    slab = stem_slab(x, st)
    taps = packed.double().reshape(64, 50, 16)
    rows = [stem_tap_rows(slab, t // 7, t % 7, *out[1:]) for t in range(49)]
    rows.append(rows[48])
    got = sum(torch.cat(rows[2 * kp: 2 * kp + 2], -1) @ taps[:, 2 * kp: 2 * kp + 2].reshape(-1, 32).t()
              for kp in range(25))
    ref = int8_conv_plain(x.to(torch.int8), packed, torch.ones(64), *geo, torch.float32)
    assert ref.shape == (2, *out, 64)
    torch.testing.assert_close(got, ref.double(), atol=0, rtol=0)
    kernels.reset_launch_counts()
    assert kernels.stem_stride_launch_counts() == {1: 0, 2: 0}  # the CPU runs no kernel


def _narrow_8x8(seed=5):
    """A seeded narrow i3d_8x8_r50 with 2048-wide features and random BN."""
    model = seeded_init_(narrow_like(ti3d.i3d_8x8_r50(), STAGES_2048), seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm3d):
                n = bn.num_features
                bn.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                bn.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                bn.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                bn.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model.eval()


def test_extractor_builds_the_named_backbone():
    """``FeatureExtractor(model_name=...)``: the 8x8 model for both streams
    (the flow stem over two channels, adapted from RGB weights)."""
    rgb = FeatureExtractor(model_name="i3d_8x8_r50", dtype=torch.float32, device="cpu")
    assert rgb.model.stem == ti3d.I3D_8X8_STEM and rgb.model.head_pool_kernel == (4, 7, 7)
    flow = FeatureExtractor(model_name="i3d_8x8_r50", state_dict=rgb.model.state_dict(),
                            dtype=torch.float32, device="cpu", stream="flow", quantize=True)
    assert flow.model.conv1.weight.shape == (64, 2, 5, 7, 7)
    stem = rgb.model.conv1.weight
    torch.testing.assert_close(flow.model.conv1.weight, stem.mean(1, keepdim=True).repeat(
        1, 2, 1, 1, 1) * 1.5)
    with pytest.raises(AttributeError):
        FeatureExtractor(model_name="nope", device="cpu")


def test_clis_take_i3d_8x8_r50_from_pyth(tmp_path, monkeypatch, rng):
    """``extract_features --model i3d_8x8_r50 --weights x.pyth`` and ``infer
    --i3d-model i3d_8x8_r50 --i3d-weights x.pyth`` on the CPU: the .pyth's
    ``model_state`` goes through the pytorchvideo converter into the named
    backbone (narrowed here; 56-pixel center crops), features equal to the
    model the file was written from, scores in [0, 1]; unknown names exit."""
    model = _narrow_8x8()
    pyth = str(tmp_path / "I3D_8x8_R50.pyth")
    torch.save({"model_state": i3d_state_dict_to_pytorchvideo(model.state_dict()), "epoch": 1},
               pyth)
    _write_avi(tmp_path / "vids" / "clip.avi", rng, n_frames=20)
    built = []

    def factory(**kw):
        name = kw.pop("model_name")
        kw.pop("device")
        built.append(name)
        return FeatureExtractor(model=narrow_like(_port_full(name if name == "tushar-n-baseline"
                                                             else "i3d_8x8_r50"), STAGES_2048),
                                resize=64, cropsize=56, device="cpu", **dict(kw, dtype=torch.float32))

    monkeypatch.setattr(t_extract_features, "FeatureExtractor", factory)
    monkeypatch.setattr(t_infer, "FeatureExtractor", factory)
    vids = str(tmp_path / "vids")
    t_extract_features.main(["--videos", vids, "--outdir", str(tmp_path / "f"), "--model",
                             "i3d_8x8_r50", "--weights", pyth, "--device", "cpu", "--batch", "20",
                             "--decode-workers", "1", "--dtype", "float32", "--crops", "center"])
    feats = np.load(tmp_path / "f" / "clip_i3d.npy")
    direct = FeatureExtractor(model=model, state_dict=model.state_dict(), resize=64, cropsize=56,
                              dtype=torch.float32, batch=20, device="cpu", crops="center")
    np.testing.assert_array_equal(feats, direct.extract_video(os.path.join(vids, "clip.avi")))
    assert feats.shape == (2, 1, 2048) and built == ["i3d_8x8_r50"]

    weights = _port_mgfn_weights(tmp_path / "mgfn.pt", 2048)
    t_infer.main(["--videos", vids, "--outdir", str(tmp_path / "s"), "--torch-weights", weights,
                  "--i3d-model", "i3d_8x8_r50", "--i3d-weights", pyth, "--device", "cpu",
                  "--dtype", "float32", "--batch", "20", "--crops", "center",
                  "--model-config"] + NARROW_2048)
    with open(tmp_path / "s" / "clip_scores.json") as f:
        scores = json.load(f)
    frame_scores = np.asarray(scores["frame_scores"])
    assert scores["n_clips"] == 2 and built == ["i3d_8x8_r50"] * 2
    assert np.isfinite(frame_scores).all() and ((frame_scores >= 0) & (frame_scores <= 1)).all()
    for main, flag in ((t_extract_features.main, "--model"), (t_infer.main, "--i3d-model")):
        with pytest.raises(SystemExit):
            main(["--videos", vids, "--outdir", str(tmp_path / "x"), flag, "nope"])


def test_load_i3d_weights_unwraps_both_layouts(tmp_path):
    """``load_i3d_weights``: a ``.pyth``'s ``model_state`` (converted for
    i3d_8x8_r50) and a ``state_dict`` wrapper (i3res50 names as they are)."""
    sd = _narrow_8x8().state_dict()
    torch.save({"model_state": i3d_state_dict_to_pytorchvideo(sd)}, str(tmp_path / "a.pyth"))
    torch.save({"state_dict": sd}, str(tmp_path / "b.pt"))
    for path, name in (("a.pyth", "i3d_8x8_r50"), ("b.pt", "tushar-n-baseline")):
        got = t_infer.load_i3d_weights(str(tmp_path / path), name)
        assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
