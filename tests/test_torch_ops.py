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
from anomaly_detection_on_video_tpu_torch.ops.gtransforms import MEAN, STD
from anomaly_detection_on_video_tpu_torch.ops.kernels import (
    ten_crop_standardize,
    ten_crop_standardize_plain,
)
from anomaly_detection_on_video_tpu_torch.ops.kernels.crop_norm import (
    GROUP,
    MAX_SEGMENTS,
    MAX_SHARED,
    PAD,
    crop_norm_plan,
)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_train.py: torch's default
    pool contends with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def emulate_crop_norm_kernel(frames: np.ndarray, size: int, dtype: torch.dtype, plan,
                             address: int) -> torch.Tensor:
    """K1's CUDA kernel under ``plan``, step for step, in numpy: each CTA's
    segments staged in 16-byte pieces (whole rows from the segment's start
    rounded down to 16; column spans row by row, each from its own start
    rounded down to 16 into a slot of the segment's pitch), the frames
    placed at byte ``address`` of a flat memory, each thread step's 7-word
    window funnel-shifted to 24 bytes (a flip's read in reverse pixel order),
    and each warp's 32 steps written as one contiguous run, or pixel by pixel
    when the rows are not whole 16-byte vectors."""
    gc, fpc, height, width, _ = frames.shape
    row_bytes = width * 3
    memory = np.zeros(address + frames.size + 16, np.uint8)
    memory[address: address + frames.size] = frames.ravel()
    out = np.full(gc * 10 * fpc * size * size * 3, np.nan, np.float32)
    vals = GROUP * 3
    steps_per_row = -(-size // GROUP)
    crop_stride = fpc * size * size * 3
    for block in range(gc * fpc * plan.n_bands):
        plane, band = divmod(block, plan.n_bands)
        clip, frame = divmod(plane, fpc)
        y0 = band * plan.band
        rows = min(plan.band, size - y0)
        smem = np.zeros(plan.shared_bytes, np.uint8)
        mis = []
        for s, ((lo, hi), (c0, c1)) in enumerate(zip(plan.segments, plan.columns)):
            lo, hi = y0 + lo, min(y0 + hi, height)
            src = address + (plane * height + lo) * row_bytes + 3 * c0
            mis.append(src % 16)
            end = plan.seg_offset[s + 1] if s + 1 < len(plan.segments) else plan.stage_offset - PAD
            if plan.whole_rows:
                chunks = (mis[s] + (hi - lo) * row_bytes + 15) >> 4
                assert plan.seg_offset[s] + 16 * chunks <= end  # the copy fits its capacity
                smem[plan.seg_offset[s]: plan.seg_offset[s] + 16 * chunks] = \
                    memory[src - mis[s]: src - mis[s] + 16 * chunks]
                continue
            for j in range(hi - lo):
                row = src + j * row_bytes
                m = row % 16
                chunks = (m + 3 * (c1 - c0) + 15) >> 4
                dst = plan.seg_offset[s] + j * plan.pitch[s]
                assert 16 * chunks <= plan.pitch[s] and dst + 16 * chunks <= end
                smem[dst: dst + 16 * chunks] = memory[row - m: row - m + 16 * chunks]
        n_steps = rows * steps_per_row
        out_band = ((clip * 10) * fpc + frame) * size * size * 3 + y0 * size * 3
        for q0 in range(0, n_steps, 32):  # one warp's steps
            q = np.minimum(q0 + np.arange(32), n_steps - 1)
            r, g = q // steps_per_row, q % steps_per_row
            for crop in range(10):
                k = crop % 5
                s = plan.crop_segment[k] if crop < 5 else plan.flip_segment[k]
                col = (plan.lefts[k] if crop < 5 else width - GROUP - plan.lefts[k]) \
                    - plan.columns[s][0]
                if plan.whole_rows:
                    row = mis[s] + (plan.crop_row[k] + r) * row_bytes
                else:
                    row = (plan.crop_row[k] + r) * plan.pitch[s] \
                        + (mis[s] + (plan.crop_row[k] + r) * row_bytes) % 16
                a = plan.seg_offset[s] + row + 3 * col + (vals if crop < 5 else -vals) * g
                words = (a & ~3)[:, None] + np.arange(28)
                assert words.min() >= 0 and words.max() < plan.stage_offset
                window = smem[words][np.arange(32)[:, None], (a & 3)[:, None] + np.arange(vals)]
                if crop >= 5:
                    window = window.reshape(32, GROUP, 3)[:, ::-1].reshape(32, vals)
                v = (window.astype(np.float32) - np.float32(MEAN)) * np.float32(1.0 / STD)
                dst = out_band + crop * crop_stride
                if plan.vector:
                    n_valid = min(32, n_steps - q0) * vals
                    idx = dst + q0 * vals + np.arange(n_valid)
                    assert np.isnan(out[idx]).all()  # every value is written once
                    out[idx] = v.ravel()[:n_valid]
                else:
                    x = g[:, None] * GROUP + np.arange(GROUP)
                    live = (q0 + np.arange(32) < n_steps)[:, None] & (x < size)
                    idx = dst + r[:, None] * size * 3 + x * 3
                    for c in range(3):
                        assert np.isnan(out[idx[live] + c]).all()
                        out[idx[live] + c] = v.reshape(32, GROUP, 3)[..., c][live]
    assert not np.isnan(out).any()  # every value is written
    return torch.from_numpy(out).to(dtype).reshape(gc * 10, fpc, size, size, 3)


@pytest.mark.parametrize("hw,size", [((256, 341), 224), ((341, 256), 224), ((256, 455), 224),
                                     ((224, 224), 224), ((257, 301), 224), ((41, 50), 36),
                                     ((256, 8000), 224), ((256, 24576), 224)])
def test_crop_norm_plan_reproduces_plain(rng, hw, size):
    """K1's launch plan and work decomposition, evaluated as the kernel
    evaluates them from misaligned frames, give the plain version's bits:
    under the default plan (one segment of whole rows for the main path's
    frames) and under a 64 KB shared budget (shorter bands, up to three
    segments). Frames wider than three crops (8000 and 24576 pixels, whose
    three input rows pass the 64 KB and the 227 KB budget) stage only the
    columns their crops read: at most five segments, none wider than a crop
    and its flip."""
    frames = rng.randint(0, 256, (1, 2, *hw, 3), np.uint8)
    for dtype in (torch.float32, torch.bfloat16):
        ref = ten_crop_standardize_plain(torch.from_numpy(frames), size, dtype)
        for budget in (MAX_SHARED, 64 * 1024):
            plan = crop_norm_plan(*hw, size, dtype, budget)
            assert len(plan.ints()) == 57 and 1 <= len(plan.segments) <= MAX_SEGMENTS
            assert plan.shared_bytes <= budget and plan.vector == (size % 8 == 0)
            assert (plan.n_bands - 1) * plan.band < size <= plan.n_bands * plan.band
            assert plan.whole_rows == (hw[1] < 3 * size)
            if not plan.whole_rows:
                assert all(c1 - c0 <= size + 1 for c0, c1 in plan.columns)
            assert torch.equal(emulate_crop_norm_kernel(frames, size, dtype, plan, address=7), ref)


# (band, n_bands, segments, shared_bytes) of each main-path frame's plan in
# float32 and bfloat16 under the default and a 64 KB budget, as they were
# before segments could be column spans: whole rows keep them
MAIN_PATH_PLANS = {
    ((256, 341), 224): ((112, 2, ((0, 144),), 171968), (13, 18, ((0, 13), (16, 29), (32, 45)), 64624),
                        (112, 2, ((0, 144),), 159680), (19, 12, ((0, 51),), 64544)),
    ((341, 256), 224): ((112, 2, ((0, 229),), 200528),
                        (16, 14, ((0, 16), (58, 74), (117, 133)), 61552),
                        (112, 2, ((0, 229),), 188240),
                        (23, 10, ((0, 23), (58, 81), (117, 140)), 65392)),
    ((256, 455), 224): ((112, 2, ((0, 144),), 221216), (9, 25, ((0, 9), (16, 25), (32, 41)), 61552),
                        (112, 2, ((0, 144),), 208928),
                        (12, 19, ((0, 12), (16, 28), (32, 44)), 61552)),
    ((224, 224), 224): ((224, 1, ((0, 224),), 175184), (56, 4, ((0, 56),), 62288),
                        (224, 1, ((0, 224),), 162896), (75, 3, ((0, 75),), 62768)),
    ((257, 301), 224): ((112, 2, ((0, 145),), 155600), (15, 15, ((0, 15), (16, 31), (33, 48)), 65344),
                        (112, 2, ((0, 145),), 143312), (25, 9, ((0, 58),), 64752)),
    ((41, 50), 36): ((36, 1, ((0, 41),), 6240),) * 4,
}


@pytest.mark.parametrize("hw,size", list(MAIN_PATH_PLANS))
def test_crop_norm_plan_unchanged_for_main_path_frames(hw, size):
    got = [crop_norm_plan(*hw, size, dtype, budget)
           for dtype in (torch.float32, torch.bfloat16) for budget in (MAX_SHARED, 64 * 1024)]
    assert all(plan.whole_rows and plan.columns == ((0, hw[1]),) * len(plan.segments)
               for plan in got)
    assert [(p.band, p.n_bands, p.segments, p.shared_bytes) for p in got] == \
        list(MAIN_PATH_PLANS[(hw, size)])


def test_metrics_equal(rng):
    labels = (rng.rand(400) > 0.7).astype(np.float64)
    scores = np.round(rng.rand(400), 2)  # ties exercise the threshold grouping
    assert tmetrics.roc_auc(labels, scores) == jmetrics.roc_auc(labels, scores)
    assert tmetrics.pr_auc(labels, scores) == jmetrics.pr_auc(labels, scores)
    np.testing.assert_array_equal(
        tmetrics.frame_level_scores(scores[:10], 16), jmetrics.frame_level_scores(scores[:10], 16)
    )
