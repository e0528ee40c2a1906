"""PyTorch port vs the JAX package: resize, crops, K1's plain version, metrics.

Inputs are made with numpy from a seed and go through both packages on the
CPU. Integer and uint8 stages are held bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.ops import gtransforms as jgt
from anomaly_detection_on_video_tpu.ops import metrics as jmetrics
from anomaly_detection_on_video_tpu.ops import resize as jresize
from anomaly_detection_on_video_tpu.ops.pallas import ten_crop_standardize_pallas
from anomaly_detection_on_video_tpu_torch.ops import gtransforms as tgt
from anomaly_detection_on_video_tpu_torch.ops import metrics as tmetrics
from anomaly_detection_on_video_tpu_torch.ops import resize as tresize
from anomaly_detection_on_video_tpu_torch.ops.kernels import (
    ten_crop_standardize,
    ten_crop_standardize_plain,
)


@pytest.mark.parametrize("hw", [(240, 320), (320, 240)])
def test_resize_exact_bit_equal(rng, hw):
    frames = rng.randint(0, 256, (2, *hw, 3), np.uint8)
    out_h, out_w = tresize.short_side_size(*hw, 256)
    ref = np.asarray(jresize.resize_bilinear_exact(jnp.asarray(frames), out_h, out_w))
    got = tresize.resize_bilinear_exact(torch.from_numpy(frames), out_h, out_w).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("hw", [(240, 320), (320, 240)])
def test_resize_fast_within_one_lsb(rng, hw):
    """Float rounding may misround a pixel by one LSB; at most 1e-4 of them."""
    frames = rng.randint(0, 256, (2, *hw, 3), np.uint8)
    out_h, out_w = tresize.short_side_size(*hw, 256)
    ref = np.asarray(jresize.resize_bilinear_fast(jnp.asarray(frames), out_h, out_w)).astype(int)
    got = tresize.resize_bilinear_fast(torch.from_numpy(frames), out_h, out_w).numpy().astype(int)
    diff = np.abs(got - ref)
    assert diff.max() <= 1
    assert np.mean(diff > 0) <= 1e-4


@pytest.mark.parametrize("in_size,out_size", [(320, 341), (240, 256), (120, 64), (341, 224)])
def test_resize_coeffs_and_sizes_equal(in_size, out_size):
    np.testing.assert_array_equal(
        tresize.pil_resize_coeffs(in_size, out_size), jresize.pil_resize_coeffs(in_size, out_size)
    )
    for hw in [(240, 320), (320, 240), (120, 160), (256, 256)]:
        assert tresize.short_side_size(*hw, out_size) == jresize.short_side_size(*hw, out_size)


def test_ten_crop_standardize_loop_pad_bit_equal(rng):
    frames = rng.randint(0, 256, (3, 256, 341, 3), np.uint8)
    ref = np.asarray(jgt.ten_crop(jnp.asarray(frames), 224))
    got = tgt.ten_crop(torch.from_numpy(frames), 224).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tgt.standardize(torch.from_numpy(frames)).numpy(),
        np.asarray(jgt.standardize(jnp.asarray(frames))),
    )
    np.testing.assert_array_equal(
        tgt.center_crop(torch.from_numpy(frames)).numpy(),
        np.asarray(jgt.center_crop(jnp.asarray(frames))),
    )
    for n in (1, 15, 16, 20, 33):
        np.testing.assert_array_equal(tgt.loop_pad_indices(n, 16), jgt.loop_pad_indices(n, 16))
    assert tgt.ten_crop_positions(341, 256) == jgt.ten_crop_positions(341, 256)


@pytest.mark.parametrize("hw", [(256, 341), (341, 256)])
def test_crop_norm_plain_matches_pallas(rng, hw):
    """K1's plain version is bit-equal to the Pallas kernel (interpret mode)."""
    gc, fpc = 2, 4
    frames = rng.randint(0, 256, (gc, fpc, *hw, 3), np.uint8)
    ref = np.asarray(ten_crop_standardize_pallas(jnp.asarray(frames), 224, "float32", interpret=True))
    got = ten_crop_standardize_plain(torch.from_numpy(frames), 224, torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_crop_norm_wrapper_on_cpu_takes_plain_and_checks_inputs(rng):
    frames = torch.from_numpy(rng.randint(0, 256, (1, 2, 256, 341, 3), np.uint8))
    before = ten_crop_standardize.launches
    out = ten_crop_standardize(frames, 224, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (10, 2, 224, 224, 3)
    assert torch.equal(out, ten_crop_standardize_plain(frames, 224, torch.bfloat16))
    assert ten_crop_standardize.launches == before  # only a kernel launch counts
    with pytest.raises(ValueError):
        ten_crop_standardize(frames.float(), 224)
    with pytest.raises(ValueError):
        ten_crop_standardize(frames, 224, torch.float16)
    with pytest.raises(ValueError):
        ten_crop_standardize(frames[..., :200, :], 224)


def test_metrics_equal(rng):
    labels = (rng.rand(400) > 0.7).astype(np.float64)
    scores = np.round(rng.rand(400), 2)  # ties exercise the threshold grouping
    assert tmetrics.roc_auc(labels, scores) == jmetrics.roc_auc(labels, scores)
    assert tmetrics.pr_auc(labels, scores) == jmetrics.pr_auc(labels, scores)
    np.testing.assert_array_equal(
        tmetrics.frame_level_scores(scores[:10], 16), jmetrics.frame_level_scores(scores[:10], 16)
    )
