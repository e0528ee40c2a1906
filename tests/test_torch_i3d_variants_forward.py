"""PyTorch port vs the JAX package: the other I3D backbones' forwards.

``i3d_8x8_r50``, the non-local i3res50 and the space-to-depth stem, at
narrow stage widths: one flax init carried across by the port's converter
gives the same features in float64 (1e-10) and float32; K2/K3 dispatch
follows the JAX rule for every variant; int8 calibration gives the JAX
package's keys and values; and the pytorchvideo converters mirror the JAX
ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.utils.convert import (
    export_i3res50_state_dict,
    export_pytorchvideo_resnet_state_dict,
)
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    i3d_state_dict_from_flax,
    i3d_state_dict_from_pytorchvideo,
    i3d_state_dict_to_pytorchvideo,
)
from test_torch_i3d import _randomize_bn
from torch_int8_fixtures import _cosine_rows
from torch_i3d_variants_fixtures import VARIANTS, _port_full, narrow_like
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two intra-op threads: the 224x224 stems want more than one, and the
    test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# four narrow stages: pytorchvideo's layout has four
STAGES_4 = ((4, 1, 1, (3,), (1,)), (4, 1, 2, (1,), (1,)), (4, 2, 2, (3, 1), (1, 1)),
            (8, 1, 2, (1,), (1,)))


@pytest.fixture(scope="module")
def variants():
    """Per variant: the narrow JAX model, its flax init (random BN), a
    seeded input, the JAX float32 features and the port model carrying the
    converted init."""
    out = {}
    for i, (variant, (_, jax_factory, stages, shape)) in enumerate(sorted(VARIANTS.items())):
        rng = np.random.RandomState(10 + i)
        jmodel = dataclasses.replace(jax_factory(), stages=stages)
        x = rng.randn(*shape).astype(np.float32)
        variables = _randomize_bn(jax.jit(jmodel.init)(jax.random.PRNGKey(i), jnp.asarray(x[:1])),
                                  rng)
        port = narrow_like(_port_full(variant), stages)
        port.load_state_dict(i3d_state_dict_from_flax(variables))
        out[variant] = {"jax": jmodel, "variables": variables, "x": x, "port": port.eval(),
                        "ref": np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))}
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_jax_float32(variants, variant):
    """The port's factories carry the JAX factories' geometry: float32
    features at the stem/bottleneck tolerances (atol 2e-5, rtol 1e-5)."""
    v = variants[variant]
    with torch.no_grad():
        got = v["port"](torch.from_numpy(v["x"])).numpy()
    assert got.shape == v["ref"].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, v["ref"], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_matches_jax_float64(variants, variant):
    """In float64 (jax x64) the port and the JAX model agree at 1e-10, as
    tests/test_i3d.py holds the JAX model to its torch oracle."""
    v = variants[variant]
    x = v["x"].astype(np.float64)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["variables"])
        model = dataclasses.replace(v["jax"], dtype=jnp.float64)
        ref = np.asarray(jax.jit(model.apply)(v64, jnp.asarray(x)))
    port = v["port"]
    port.dtype = torch.float64
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
    finally:
        port.dtype = torch.float32
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("clip", [(16, 224, 224, 3), (8, 224, 224, 3), (16, 256, 256, 3)],
                         ids=lambda c: "x".join(map(str, c[:3])))
@pytest.mark.parametrize("variant", ["baseline"] + sorted(VARIANTS))
def test_kernel_paths_follow_the_jax_rule(monkeypatch, variant, clip):
    """K2/K3 dispatch of every variant: ``I3DResNet.kernel_paths`` against
    which Pallas kernels a trace of the fused JAX model calls."""
    from anomaly_detection_on_video_tpu.ops.pallas import bottleneck as jbottleneck
    from anomaly_detection_on_video_tpu.ops.pallas import stem as jstem

    called = set()
    for module, name in ((jstem, "stem_conv_pool_h"), (jbottleneck, "bottleneck_block")):
        original = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _f=original, **k: (
            called.add(_n), _f(*a, **k))[1])
    if variant == "baseline":
        jmodel, port = ji3d.i3res50(), ti3d.build_i3d_feature_extractor()
    else:
        jmodel, port = VARIANTS[variant][1](), _port_full(variant)
    jmodel = dataclasses.replace(jmodel, fused_stem=True, fused_stage1=True)
    jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, *clip), jnp.float32))
    expected = ("stem_conv_pool_h" in called, "bottleneck_block" in called)
    assert port.kernel_paths(clip) == expected
    if clip == (16, 224, 224, 3):
        assert expected == {"baseline": (True, True), "i3res50_nl": (True, True)}.get(
            variant, (False, False))


def test_nonlocal_model_runs_k2_k3_then_its_blocks(monkeypatch, variants):
    """The non-local i3res50 on a 16x224x224 clip takes K2 and K3 (stage 1
    holds no non-local block), then runs its non-local blocks in stages 2
    and 3."""
    calls = []
    for name in ("stem_conv_pool", "bottleneck_block"):
        original = getattr(ti3d, name)
        monkeypatch.setattr(ti3d, name, lambda *a, _n=name, _f=original: (calls.append(_n),
                                                                           _f(*a))[1])
    nl_calls = []
    monkeypatch.setattr(ti3d.NonLocalBlock, "forward", lambda self, x, _f=ti3d.NonLocalBlock.forward:
                        (nl_calls.append(tuple(x.shape)), _f(self, x))[1])
    clip = torch.from_numpy(np.random.RandomState(3).randn(1, 16, 224, 224, 3).astype(np.float32))
    with torch.no_grad():
        variants["i3res50_nl"]["port"](clip)
        assert calls == ["stem_conv_pool", "bottleneck_block"]
    assert nl_calls == [(1, 32, 2, 28, 28), (1, 64, 2, 14, 14)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_calibration_and_int8_match_jax(variants, variant):
    """``calibrate_act_scales``: the JAX package's key set and values (no
    key for the non-local convs, none for the S2D stem); with JAX's scales
    given to both, int8 features at cosine >= 0.9999 per row, as
    tests/test_torch_int8_model.py holds the baseline."""
    v = variants[variant]
    ref = ji3d.calibrate_act_scales(v["jax"], v["variables"], jnp.asarray(v["x"]))
    port = v["port"]
    got = ti3d.calibrate_act_scales(port, torch.from_numpy(v["x"]))
    assert sorted(got) == sorted(ref)
    assert ("stem" in got) == ("s2d" not in variant)
    assert not any("NonLocal" in k or ".nl" in k for k in got)
    np.testing.assert_allclose([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)],
                               rtol=1e-5)
    quant = dataclasses.replace(v["jax"], act_scales=ref)
    qref = np.asarray(jax.jit(quant.apply)(v["variables"], jnp.asarray(v["x"])))
    port.act_scales = ref
    try:
        with torch.no_grad():
            qgot = port(torch.from_numpy(v["x"])).numpy()
    finally:
        port.act_scales = None
    assert _cosine_rows(qgot, qref).min() >= 0.9999
    assert not np.array_equal(qgot, v["ref"])  # quantized, not bypassed


def test_pytorchvideo_converters_mirror_jax(variants):
    """The JAX exporter's pytorchvideo dict loads into the port with the
    tensors of the flax converter; the inverse round-trips; a head (the
    real file's ``blocks.6.proj``) is dropped; other than 4 stages raises.
    The non-local tree converts as the JAX ``export_i3res50_state_dict``."""
    rng = np.random.RandomState(7)
    shapes = jax.eval_shape(dataclasses.replace(ji3d.i3d_8x8_r50(), stages=STAGES_4).init,
                            jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 8, 224, 224, 3),
                                                                        jnp.float32))
    v = jax.tree_util.tree_map(lambda a: rng.randn(*a.shape).astype(np.float32), shapes)
    ref = i3d_state_dict_from_flax(v)
    pyth = dict(export_pytorchvideo_resnet_state_dict(v))
    pyth["blocks.6.proj.weight"] = np.zeros((400, 64), np.float32)
    got = i3d_state_dict_from_pytorchvideo(pyth)
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    back = i3d_state_dict_to_pytorchvideo(ref)
    assert sorted(back) == sorted(k for k in pyth if not k.startswith("blocks.6"))
    again = i3d_state_dict_from_pytorchvideo(back)
    assert all(torch.equal(again[k], ref[k]) for k in ref) and sorted(again) == sorted(ref)
    with pytest.raises(ValueError, match="4 ResNet stages"):
        i3d_state_dict_from_pytorchvideo({k: x for k, x in pyth.items() if "blocks.5." not in k})
    nl = variants["i3res50_nl"]["variables"]
    exported = export_i3res50_state_dict(nl)
    converted = i3d_state_dict_from_flax(nl)
    assert sorted(converted) == sorted(exported) and any(".nl.theta." in k for k in exported)
    for key, value in exported.items():
        np.testing.assert_array_equal(converted[key].numpy(), value, err_msg=key)
    with pytest.raises(KeyError, match="pytorchvideo"):
        i3d_state_dict_to_pytorchvideo(converted)
