"""PyTorch port vs the JAX package: the probes of ``scripts/``, ported.

The JAX probes keep their formulations in closures inside ``main()``, so
each port function is held against the public JAX pieces its JAX
counterpart is built from, on inputs seeded with numpy, at small sizes:
the stem and the conv formulations against ``jax.lax.conv_general_dilated``,
the stages against ``models/i3d.py`` ``Bottleneck`` modules (weights carried
across with ``utils/convert.py``), the eval probe against the JAX
``eval_batches`` / ``eval_bucket``, and the dispatch A/B on a tiny MJPG.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from anomaly_detection_on_video_tpu.data import FeatureDataset as JaxFeatureDataset
from anomaly_detection_on_video_tpu.data import eval_batches as jax_eval_batches
from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.training.runner import eval_bucket as jax_eval_bucket
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from anomaly_detection_on_video_tpu_torch.ops.kernels import pack_int8_conv_weight
from anomaly_detection_on_video_tpu_torch.scripts import (conv2d_probe, eval_probe, overlap_ab,
                                                          stage_probe, stem2d_probe)
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_from_flax
from test_torch_i3d import _randomize_bn
from torch_int8_fixtures import _cosine_rows
from torch_port_fixtures import jax_compile_cache  # noqa: F401  (autouse: one XLA cache per worker)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: torch's default pool contends with the other
    test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ndhwc(y: torch.Tensor) -> np.ndarray:
    return y.permute(0, 2, 3, 4, 1).numpy()


def test_stem_formulations_match_jax(rng):
    """stem3d and stem2d in float32 against the JAX probe's lax conv
    (stride (2,2,2), padding [(2,2),(3,3),(3,3)], NDHWC / DHWIO) at 32 x 32
    frames: atol = rtol = 1e-4."""
    x = rng.randn(2, 16, 32, 32, 3).astype(np.float32)
    w = (rng.randn(5, 7, 7, 3, 64) * 0.1).astype(np.float32)  # DHWIO
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2, 2), [(2, 2), (3, 3), (3, 3)],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy())
    for fn in (stem2d_probe.stem3d, stem2d_probe.stem2d):
        got = _ndhwc(fn(xt, wt))
        assert got.shape == ref.shape == (2, 8, 16, 16, 64)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


# kind -> (input NDHWC, Cout): small shapes of conv2d_probe's two kernels
SMALL_CONVS = {"spatial": ((2, 3, 9, 9, 16), 8), "temporal": ((2, 4, 5, 5, 16), 8)}


def _jax_conv(kind, x, w, **kwargs):
    """The JAX probe's 3-D conv: NDHWC / DHWIO, stride 1."""
    kernel, pad = conv2d_probe.GEOMETRY[kind]
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), [(p, p) for p in pad],
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), **kwargs))


@pytest.mark.parametrize("form", ["3d", "2d"])
@pytest.mark.parametrize("kind", sorted(SMALL_CONVS))
def test_conv_formulations_match_jax(rng, kind, form):
    """conv2d_probe's float32 formulations against the JAX 3-D conv:
    atol = rtol = 1e-5."""
    shape, cout = SMALL_CONVS[kind]
    kernel, _ = conv2d_probe.GEOMETRY[kind]
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(*kernel, shape[-1], cout) * 0.1).astype(np.float32)  # DHWIO
    ref = _jax_conv(kind, x, w)
    fn = conv2d_probe.conv_3d if form == "3d" else conv2d_probe.conv_2d
    got = fn(kind, torch.from_numpy(x), torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(SMALL_CONVS))
def test_int8_conv_formulations_match_jax(rng, kind):
    """conv2d_probe's int8 formulations through K5's plain version, their
    float32 epilogue at scale 1, bit-equal to the JAX int8 conv's int32
    sums (``preferred_element_type=jnp.int32``), as
    tests/test_torch_int8_kernels.py holds K5."""
    shape, cout = SMALL_CONVS[kind]
    kernel, _ = conv2d_probe.GEOMETRY[kind]
    x = rng.randint(-127, 127, shape).astype(np.int8)
    w = rng.randint(-127, 127, (*kernel, shape[-1], cout)).astype(np.int8)  # DHWIO
    ref = _jax_conv(kind, x, w, preferred_element_type=jnp.int32)
    wp = pack_int8_conv_weight(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
    ones = torch.ones(cout)
    for fn in (conv2d_probe.int8_3d, conv2d_probe.int8_2d):
        got = fn(kind, torch.from_numpy(x), wp, ones, torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))


class JaxStageOnly(nn.Module):
    """The JAX stage probes' ``StageOnly`` (a closure of their ``main()``):
    ``models/i3d.py`` ``Bottleneck`` modules named ``block{i}``."""
    planes: int
    blocks: int
    stride: int
    tks: tuple
    act_scales: object = None

    @nn.compact
    def __call__(self, x):
        for i in range(self.blocks):
            x = ji3d.Bottleneck(planes=self.planes, spatial_stride=self.stride if i == 0 else 1,
                                temp_kernel=self.tks[i], has_proj=i == 0, dtype=jnp.float32,
                                act_scales=self.act_scales, name=f"block{i}")(x)
        return x


def _jax_stage(spec, act_scales=None):
    planes, blocks, stride, tks, _ = spec
    return JaxStageOnly(planes, blocks, stride, tuple(tks), act_scales)


def _port_stage(spec, variables) -> stage_probe.StageOnly:
    """The flax stage's variables in the port's ``StageOnly``, through
    ``i3d_state_dict_from_flax`` (its blocks as stage 1 of an I3D with a
    stand-in stem, whose keys are dropped)."""
    def as_stage1(tree):
        return {f"stage1_{k}": v for k, v in tree.items()}

    stem = {"conv": {"kernel": np.zeros((1, 1, 1, 1, 1), np.float32)},
            "bn": {"scale": np.ones(1, np.float32), "bias": np.zeros(1, np.float32)}}
    full = {"params": {"stem": stem, **as_stage1(variables["params"])},
            "batch_stats": {"stem": {"bn": {"mean": np.zeros(1, np.float32),
                                            "var": np.ones(1, np.float32)}},
                            **as_stage1(variables["batch_stats"])}}
    sd = {k[len("layer1."):]: v for k, v in i3d_state_dict_from_flax(full).items()
          if k.startswith("layer1.")}
    stage = stage_probe.StageOnly.from_spec(spec)
    stage.load_state_dict(sd, strict=False)
    missing = set(stage.state_dict()) - set(sd)
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return stage.eval()


# a narrow stage: two blocks, temporal kernels 3 and 1, the first block
# strided with its projection (stages 2-4's pattern; the second, stride 1)
NARROW_SPEC = (8, 2, 2, (3, 1), (32, 2, 9, 9))


@pytest.fixture(scope="module")
def narrow_stage():
    """The JAX stage of ``NARROW_SPEC`` with random BN, and its input."""
    rng = np.random.RandomState(0)
    c, t, h, w = NARROW_SPEC[4]
    x = rng.randn(2, t, h, w, c).astype(np.float32)
    model = _jax_stage(NARROW_SPEC)
    variables = _randomize_bn(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    return model, variables, x


def test_stage_matches_jax(narrow_stage):
    """The narrow port ``StageOnly`` against the JAX stage of ``Bottleneck``
    modules in float32, random BN: atol 2e-5, rtol 1e-5."""
    model, variables, x = narrow_stage
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    stage = _port_stage(NARROW_SPEC, variables)
    with torch.no_grad():
        got = _ndhwc(stage(torch.from_numpy(x).permute(0, 4, 1, 2, 3)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def _jax_stage_cost(spec, batch: int):
    """FLOPs and bytes from the JAX module's shapes alone (``eval_shape``):
    2 x every conv's output positions x its kernel's size, and the
    variables as stored plus a bf16 input and output."""
    model = _jax_stage(spec)
    c, t, h, w = spec[4]
    x = jax.ShapeDtypeStruct((batch, t, h, w, c), jnp.float32)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    out, state = jax.eval_shape(
        lambda v, x: model.apply(v, x, capture_intermediates=True, mutable=["intermediates"]),
        variables, x)
    params = variables["params"]
    flops = 0.0
    blocks = {k: v for k, v in state["intermediates"].items() if k != "__call__"}  # the stage's
    for block, convs in blocks.items():
        for branch, node in convs.items():
            if branch == "__call__":  # the block's own output
                continue
            out_shape = node["conv"]["__call__"][0].shape
            kernel = params[block][branch]["conv"]["kernel"].shape
            flops += 2.0 * np.prod(out_shape[:-1]) * np.prod(kernel)
    stored = sum(leaf.size * leaf.dtype.itemsize for leaf in jax.tree_util.tree_leaves(variables))
    return flops, stored + (np.prod(x.shape) + np.prod(out.shape)) * 2


@pytest.mark.parametrize("stage_idx", sorted(stage_probe.STAGE_SPECS))
def test_stage_cost_matches_jax_shapes(stage_idx):
    """``stage_cost`` at each full-width JAX spec (batch 2) equals the
    counts from the JAX module's parameter and output shapes."""
    spec = stage_probe.STAGE_SPECS[stage_idx]
    flops, nbytes = stage_probe.stage_cost(stage_probe.StageOnly.from_spec(spec), spec[4], 2)
    ref_flops, ref_bytes = _jax_stage_cost(spec, 2)
    assert flops == ref_flops and nbytes == ref_bytes


def test_int8_stage_matches_jax(narrow_stage):
    """The int8 stage: ``StageOnly.calibrate`` against the JAX
    ``calibrate_act_scales`` of the JAX stage (same keys, rtol 1e-5); with
    the JAX scales given to both, the outputs at cosine >= 0.9999 per row
    (the tolerance of tests/test_torch_int8_model.py: a float32 difference
    near 1e-6 can flip one int8 code); the launch rule against the JAX
    stage's 1x1x1 kernels."""
    model, variables, x = narrow_stage
    scales = ji3d.calibrate_act_scales(model, variables, jnp.asarray(x))
    ref = np.asarray(jax.jit(_jax_stage(NARROW_SPEC, scales).apply)(variables, jnp.asarray(x)))
    stage = _port_stage(NARROW_SPEC, variables)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got_scales = stage.calibrate(xt)
    assert sorted(got_scales) == sorted(scales) and stage.act_scales is None
    np.testing.assert_allclose([got_scales[k] for k in sorted(scales)],
                               [scales[k] for k in sorted(scales)], rtol=1e-5)
    stage.act_scales = scales
    with torch.no_grad():
        got = _ndhwc(stage(xt))
    assert got.shape == ref.shape
    assert _cosine_rows(got, ref).min() >= 0.9999
    leaves = jax.tree_util.tree_leaves_with_path(variables["params"])
    kernels = [leaf.shape[:3] for path, leaf in leaves if "kernel" in str(path[-1])]
    pointwise = kernels.count((1, 1, 1))
    assert stage_probe.int8_launches(stage) == {"int8_matmul": pointwise,
                                                "int8_conv": len(kernels) - pointwise}


def test_eval_probe_dataset_matches_jax_eval_batches():
    """``build_dataset``'s videos through the port's and the JAX
    ``eval_batches``: the same features, labels and names."""
    ds = eval_probe.build_dataset(n_videos=4, clips=30)
    jds = JaxFeatureDataset(filenames=list(ds.filenames), _arrays=dict(ds._arrays),
                            labels=dict(ds.labels))
    from anomaly_detection_on_video_tpu_torch.data.features import eval_batches

    pairs = list(zip(eval_batches(ds), jax_eval_batches(jds)))
    assert len(pairs) == 4
    for got, ref in pairs:
        assert got["filename"] == ref["filename"]
        np.testing.assert_array_equal(got["feature"], ref["feature"])
        np.testing.assert_array_equal(np.asarray(got["label"]), np.asarray(ref["label"]))
    assert ds.filenames[:2] == ["Abuse_0_i3d.npy", "Normal_1_i3d.npy"]


def test_eval_probe_assembly_matches_jax():
    """``assemble_only``'s bytes against the JAX probe's assembly (every
    group padded to ``batch_videos``) over the JAX ``eval_batches`` and
    ``eval_bucket``, on videos of two buckets in full groups."""
    rng = np.random.RandomState(0)
    arrays = {f"Abuse_{i}_i3d.npy": rng.randn(n, 10, 2048).astype(np.float32)
              for i, n in enumerate((30, 20, 40, 33))}
    labels = {k: [0.0] * (v.shape[0] * 16) for k, v in arrays.items()}
    from anomaly_detection_on_video_tpu_torch.data.features import FeatureDataset

    ds = FeatureDataset(filenames=list(arrays), _arrays=arrays, labels=labels)
    jds = JaxFeatureDataset(filenames=list(arrays), _arrays=arrays, labels=labels)
    batch_videos, buckets, total = 2, {}, 0
    for batch in jax_eval_batches(jds):
        buckets.setdefault(jax_eval_bucket(batch["feature"].shape[2]), []).append(batch)
    for bucket, items in buckets.items():
        for start in range(0, len(items), batch_videos):
            group = items[start: start + batch_videos]
            total += np.zeros((batch_videos, 10, bucket, group[0]["feature"].shape[3]),
                              np.float32).nbytes
    assert sorted(buckets) == [32, 64]
    assert eval_probe.assemble_only(ds, batch_videos) == total == 2 * 10 * (32 + 64) * 2049 * 4


NARROW_I3D = ((8, 1, 1, (3,), (1,)), (8, 1, 2, (1,), (1,)))


def test_overlap_ab_modes_bit_equal(tmp_path):
    """The serial and pipelined modes over a tiny seeded MJPG through a
    reduced-``stages`` extractor: bit-equal, every run timed."""
    path = str(tmp_path / "v.avi")
    overlap_ab.write_video(path, 48, (48, 64))
    ex = FeatureExtractor(model=I3DResNet(NARROW_I3D), dtype=torch.float32, batch=20, resize=40,
                          cropsize=32, device="cpu")
    record = overlap_ab.overlap_ab(ex, path, 48, chunk_frames=16, reps=2)
    assert record["modes_bit_equal"] and len(record["serial_s"]) == len(record["pipelined_s"]) == 2
    assert set(record) >= {"probe", "serial_s", "pipelined_s", "median_serial_clips_per_sec",
                           "median_pipelined_clips_per_sec", "median_speedup"}
    assert os.path.getsize(path) > 0
