"""PyTorch port vs the JAX package: extraction breadth for the RGB stream.

Center-crop features against the JAX composition and against the port's
own ten-crop row 4; int8 center calibration; ``.npy`` files byte-compatible
with the JAX package's; pooled, serial and dispatched extraction bit-equal,
with chunk caches, resume and producer errors; the native decoder against
OpenCV and ``decode_provenance``; the host helpers (``TenCropVideoFrameDataset``,
``preprocess_frames`` and the min-max transforms, the synthetic datasets,
``model_size_bits``, ``prefetch``, ``StageTimer``, ``atomic_write_bytes``);
and the CLIs' ``--split`` segments, ``--crops center`` and ``--profile``.
Narrow I3D (``I3DResNet(stages=NARROW)``) on 56-pixel crops, CPU, float32.
"""

import contextlib
import io
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infer as j_infer
from anomaly_detection_on_video_tpu.data import prefetch as jprefetch
from anomaly_detection_on_video_tpu.data import segments as jsegments
from anomaly_detection_on_video_tpu.data import synthetic as jsynthetic
from anomaly_detection_on_video_tpu.data import video as jvideo
from anomaly_detection_on_video_tpu.models import i3d as ji3d
from anomaly_detection_on_video_tpu.ops import gtransforms as jgt
from anomaly_detection_on_video_tpu.ops.resize import resize_bilinear_exact as j_resize_exact
from anomaly_detection_on_video_tpu.ops.resize import short_side_size
from anomaly_detection_on_video_tpu.utils import model_size as jmodel_size
from anomaly_detection_on_video_tpu.utils import npyio as jnpyio
from anomaly_detection_on_video_tpu.utils import profiling as jprofiling
from anomaly_detection_on_video_tpu_torch import extract_features as t_extract_features
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch.data import extraction as textraction
from anomaly_detection_on_video_tpu_torch.data import framepipe as tframepipe
from anomaly_detection_on_video_tpu_torch.data import prefetch as tprefetch
from anomaly_detection_on_video_tpu_torch.data import synthetic as tsynthetic
from anomaly_detection_on_video_tpu_torch.data import video as tvideo
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from anomaly_detection_on_video_tpu_torch.ops import gtransforms as tgt
from anomaly_detection_on_video_tpu_torch.utils import model_size as tmodel_size
from anomaly_detection_on_video_tpu_torch.utils import npyio as tnpyio
from anomaly_detection_on_video_tpu_torch.utils.convert import i3d_state_dict_from_flax
from anomaly_detection_on_video_tpu_torch.utils.profiling import StageTimer
from test_torch_i3d import NARROW, _randomize_bn
from torch_infer_fixtures import _args, _flax_variables, _save_weights
from torch_network_fixtures import StubExtractor
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

RESIZE, CROP = 64, 56
DECODE_THREADS = ("frame-decode", "decode-pool")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch from
    contending with the other test workers' threads, as in
    tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def narrow():
    """A narrow flax I3DResNet with random BN at the 56-pixel crop and its
    weights in the port's names."""
    model = ji3d.I3DResNet(stages=NARROW, dtype=jnp.float32)
    x = jnp.zeros((1, 16, CROP, CROP, 3), jnp.float32)
    variables = _randomize_bn(jax.jit(model.init)(jax.random.PRNGKey(0), x),
                              np.random.RandomState(1))
    return model, variables, i3d_state_dict_from_flax(variables)


def _extractor(narrow, **kw):
    kw.setdefault("dtype", torch.float32)
    return FeatureExtractor(model=I3DResNet(stages=NARROW), state_dict=narrow[2], resize=RESIZE,
                            cropsize=CROP, device="cpu", **kw)


def _jax_features(narrow, frames, crops="ten"):
    """The JAX composition: loop-pad, exact resize, ten crops or the
    center crop, standardize, the flax forward."""
    model, variables, _ = narrow
    n = frames.shape[0]
    clips = frames[jgt.loop_pad_indices(n, 16)]  # (n_clips, 16, H, W, 3)
    out_h, out_w = short_side_size(frames.shape[1], frames.shape[2], RESIZE)
    resized = j_resize_exact(jnp.asarray(clips), out_h, out_w)
    forward = jax.jit(model.apply)  # one compile instead of op-by-op dispatch
    if crops == "center":
        batch = jgt.standardize(jgt.center_crop(resized, CROP))
        return np.asarray(forward(variables, batch)).reshape(len(clips), 1, -1)
    crops10 = jgt.standardize(jgt.ten_crop(resized, CROP))  # (10, n_clips, 16, c, c, 3)
    batch = jnp.transpose(crops10, (1, 0, 2, 3, 4, 5)).reshape(-1, 16, CROP, CROP, 3)
    return np.asarray(forward(variables, batch)).reshape(len(clips), 10, -1)


def _write_mjpg(path, frames):
    """RGB frames -> an MJPG AVI (intra-frame, so decode is deterministic)."""
    import cv2

    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    height, width = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, (width, height))
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()
    return str(path)


def _structured_frames(n, height=64, width=96):
    """Gradients JPEG keeps well (noise would be destroyed by the codec)."""
    col = np.linspace(0, 200, width, dtype=np.uint8)
    return np.stack([np.stack([np.tile(col + t, (height, 1)), np.tile(col, (height, 1)),
                               np.full((height, width), t * 3, np.uint8)], axis=-1)
                     for t in range(n)])


def _decode_threads():
    return [t for t in threading.enumerate() if t.name.startswith(DECODE_THREADS)]


def _no_decode_threads(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _decode_threads() and time.monotonic() < deadline:
        time.sleep(0.05)
    return not _decode_threads()


# ------------------------------------------------------------- center crops

def test_center_crop_features_match_jax(narrow, rng):
    """crops="center": 60-clip groups at batch 240, (n, 1, C) features
    equal to the JAX composition center_crop -> standardize -> apply."""
    assert _extractor(narrow, batch=240, crops="center").group_clips == 60
    ex = _extractor(narrow, batch=8, crops="center")
    assert (ex.group_clips, ex.n_crops) == (2, 1)
    frames = rng.randint(0, 256, (20, 120, 160, 3), np.uint8)  # 2 clips, tail 4
    feats = ex.extract_frames(frames)
    assert feats.shape == (2, 1, 64) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, _jax_features(narrow, frames, "center"),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="crops"):
        _extractor(narrow, crops="five")


@pytest.mark.parametrize("shape", [(120, 160), (257, 301)])
def test_center_features_equal_ten_crop_row4(narrow, rng, shape):
    """The center crop is ten-crop row 4 bit for bit, at a rounded center
    offset (120x160 -> 64x85) and at odd frame sizes (257x301). batch 80
    gives 20-clip center groups, so the conv batch equals the ten-crop
    run's 2 clips x 10 crops."""
    frames = rng.randint(0, 256, (32, *shape, 3), np.uint8)
    ten = _extractor(narrow, batch=20).extract_frames(frames)
    center = _extractor(narrow, batch=80, crops="center").extract_frames(frames)
    assert center.shape == (2, 1, 64)
    np.testing.assert_array_equal(center, ten[:, 4:5])


def test_int8_center_calibration_matches_jax(narrow, rng, tmp_path):
    """int8 with center crops calibrates on the first chunk's center crops:
    the JAX calibration path's scales (rtol 1e-5, as tests/test_torch_int8_model.py);
    the scales are pinned and the features keep the (n, 1, C) shape."""
    frames = rng.randint(0, 256, (40, 120, 160, 3), np.uint8)
    ex = _extractor(narrow, batch=8, crops="center", quantize=True)
    ex.pin_calibration(str(tmp_path))
    feats = ex.extract_frames(frames)
    assert feats.shape == (3, 1, 64) and np.isfinite(feats).all()
    got = json.loads((tmp_path / "act_scales_rgb.json").read_text())
    assert got == ex.model.act_scales
    # the JAX FeatureExtractor._calibrate body on the same chunk
    model, variables, _ = narrow
    sample = jnp.asarray(frames)
    resized = j_resize_exact(sample, *short_side_size(120, 160, RESIZE))
    crops = jgt.center_crop(resized, CROP)[None]
    clips = jgt.standardize(crops[:, jnp.asarray(jgt.loop_pad_indices(40, 16))])
    ref = ji3d.calibrate_act_scales(model, variables, clips.reshape(-1, 16, CROP, CROP, 3))
    assert sorted(got) == sorted(ref) and len(got) == 9
    np.testing.assert_allclose([got[k] for k in sorted(ref)], [ref[k] for k in sorted(ref)],
                               rtol=1e-5)


# ------------------------------------------------------------- files on disk

def _npy_header(path):
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        header = np.lib.format.read_array_header_1_0(f) if version == (1, 0) else None
        offset = f.tell()
        f.seek(0)
        return version, header, f.read(offset)


def test_npy_files_byte_compatible_with_jax(narrow, rng, tmp_path):
    """extract_videos on a cv2-written MJPG video writes the JAX package's
    file: the same .npy header bytes ('<f4', C order, shape), values at
    1e-4 against JAX features of the same decoded frames saved by the JAX
    atomic_save."""
    path = _write_mjpg(tmp_path / "vids" / "Abuse002_x264.avi",
                       rng.randint(0, 256, (36, 120, 160, 3), np.uint8))
    out = tmp_path / "port"
    assert textraction.extract_videos([path], str(out), _extractor(narrow, batch=20),
                                      progress=False) == 1
    frames = jvideo.decode_video_frames(path)
    jnpyio.atomic_save(str(tmp_path / "jax_i3d.npy"), _jax_features(narrow, frames))
    port_file, jax_file = out / "Abuse002_x264_i3d.npy", tmp_path / "jax_i3d.npy"
    (pv, ph, pbytes), (jv, jh, jbytes) = _npy_header(port_file), _npy_header(jax_file)
    assert pv == jv == (1, 0) and ph == jh == ((3, 10, 64), False, np.dtype("<f4"))
    assert pbytes == jbytes
    assert os.path.getsize(port_file) == os.path.getsize(jax_file)
    np.testing.assert_allclose(np.load(port_file), np.load(jax_file), rtol=1e-4, atol=1e-4)


def _three_videos(root, rng):
    """20, 36 and 52 frames: 2, 3 and 4 clips, 2-4 chunks of 16 frames."""
    return [_write_mjpg(root / f"v{i}.avi", rng.randint(0, 256, (20 + 16 * i, 48, 64, 3), np.uint8))
            for i in range(3)]


def test_pooled_serial_and_dispatched_bit_equal(narrow, rng, tmp_path):
    """extract_videos (whole-video chunks), extract_videos_pooled
    (16-frame chunks assembled in order) and chunk-by-chunk
    dispatch_frames / _cached_chunk give bit-equal files; second runs
    extract nothing."""
    videos = _three_videos(tmp_path / "vids", rng)
    ex = _extractor(narrow, batch=20)
    serial, pooled = tmp_path / "serial", tmp_path / "pooled"
    assert textraction.extract_videos(videos, str(serial), ex, progress=False) == 3
    assert textraction.extract_videos_pooled(videos, str(pooled), ex, decode_workers=2,
                                             chunk_frames=16, progress=False) == 3
    for path in videos:
        name = os.path.basename(path)[:-4] + "_i3d.npy"
        a, b = np.load(serial / name), np.load(pooled / name)
        chunks = list(tvideo.VideoFrameSource(path, 16, native=False))
        handles = [ex.dispatch_frames(chunk) for chunk in chunks]  # all in flight at once
        dispatched = np.vstack([ex.materialize_features(h) for h in handles])
        cached = np.vstack([textraction._cached_chunk(ex, chunk, path, i, None)
                            for i, chunk in enumerate(chunks)])
        assert a.shape[1:] == (10, 64) and len(chunks) > 1
        for other in (b, dispatched, cached):
            np.testing.assert_array_equal(a, other)
        # a call on this thread while a dispatch is in flight waits its turn
        handle = ex.dispatch_frames(chunks[0])
        inline = ex.extract_frames(chunks[1])
        n0 = handle[1]
        np.testing.assert_array_equal(ex.materialize_features(handle), a[:n0])
        np.testing.assert_array_equal(inline, a[n0:n0 + len(inline)])
    request = _extractor(narrow, batch=20)
    request.extract_frames(chunks[0])
    assert request._dispatch_pool is None  # a request runs on the caller's thread
    assert textraction.extract_videos_pooled(videos, str(pooled), ex, progress=False) == 0
    assert textraction.extract_videos(videos, str(serial), ex, progress=False) == 0
    # a later video of the same stem (another folder) is skipped, as serially
    twin = _write_mjpg(tmp_path / "other" / "v0.avi", rng.randint(0, 256, (20, 48, 64, 3), np.uint8))
    assert textraction.extract_videos_pooled(videos + [twin], str(tmp_path / "p2"), ex,
                                             chunk_frames=16, progress=False) == 3
    np.testing.assert_array_equal(np.load(tmp_path / "p2" / "v0_i3d.npy"),
                                  np.load(serial / "v0_i3d.npy"))
    assert _no_decode_threads()


def test_chunk_caches_resume_and_producer_errors(narrow, rng, tmp_path, monkeypatch):
    """A large video (the >1 GB rule patched to hold) keeps per-chunk
    caches: a run that dies at its third dispatch leaves chunk 0 cached
    and no final file, the resumed pooled run dispatches only the other
    chunks, and with every chunk cached a rebuild runs no forward. A
    producer's decode error re-raises in the consumer, and no decode
    thread stays alive in either failure."""
    path = _write_mjpg(tmp_path / "big.avi", rng.randint(0, 256, (40, 48, 64, 3), np.uint8))
    ex = _extractor(narrow, batch=20)
    golden = ex.extract_video(path, chunk_frames=16)
    monkeypatch.setattr(textraction, "is_large_video", lambda p: True)
    outdir = str(tmp_path / "out")
    real = ex.dispatch_frames
    calls = {"n": 0, "fail_after": 2}

    def counting(chunk):
        calls["n"] += 1
        if calls["n"] > calls["fail_after"]:
            raise RuntimeError("simulated mid-run crash")
        return real(chunk)

    monkeypatch.setattr(ex, "dispatch_frames", counting)
    monkeypatch.setattr(textraction, "QUEUE_CHUNKS", 1)  # producers block in put()
    with pytest.raises(RuntimeError, match="simulated"):
        textraction.extract_videos_pooled([path], outdir, ex, decode_workers=3,
                                          chunk_frames=16, progress=False)
    assert _no_decode_threads()
    assert os.path.exists(ex.chunk_cache_path(outdir, path, 0))
    assert ex.chunk_cache_path(outdir, path, 2) == os.path.join(outdir, "big", "big_2.npy")
    assert not os.path.exists(os.path.join(outdir, "big_i3d.npy"))
    calls.update(n=0, fail_after=99)
    assert textraction.extract_videos_pooled([path], outdir, ex, decode_workers=2,
                                             chunk_frames=16, progress=False) == 1
    assert calls["n"] == 2  # chunks 1 and 2; chunk 0 came from its cache
    np.testing.assert_array_equal(np.load(os.path.join(outdir, "big_i3d.npy")), golden)
    # every chunk cached: the rebuild reads them back and runs no forward
    os.remove(os.path.join(outdir, "big_i3d.npy"))
    calls["n"] = 0
    monkeypatch.setattr(ex.model, "forward", lambda x: pytest.fail("forward ran"))
    for run in (lambda: textraction.extract_videos_pooled([path], outdir, ex, chunk_frames=16,
                                                          progress=False),
                lambda: np.save(os.path.join(outdir, "big_i3d.npy"),
                                ex.extract_video(path, 16, cache_dir=outdir))):
        run()
        np.testing.assert_array_equal(np.load(os.path.join(outdir, "big_i3d.npy")), golden)
        os.remove(os.path.join(outdir, "big_i3d.npy"))
    assert calls["n"] == 0
    # a producer's decode error (an unreadable file among good ones)
    bad = tmp_path / "bad.avi"
    bad.write_bytes(b"not a video")
    good = _three_videos(tmp_path / "vids", rng)
    with pytest.raises((FileNotFoundError, ValueError)):
        textraction.extract_videos_pooled(good + [str(bad)], str(tmp_path / "o2"),
                                          _extractor(narrow, batch=20), decode_workers=2,
                                          chunk_frames=16, progress=False)
    assert _no_decode_threads()
    with pytest.raises(ValueError, match=r"extractors must be \(rgb, flow\) in that order"):
        textraction.extract_videos_pooled([path], outdir, ex, flow_extractor=ex)


# ------------------------------------------------------------------ decode

@pytest.fixture(scope="module")
def structured_video(tmp_path_factory):
    frames = _structured_frames(37)
    return _write_mjpg(tmp_path_factory.mktemp("dec") / "v.avi", frames), frames


def test_native_decoder_equals_cv2(structured_video, monkeypatch):
    """The port's framepipe binding decodes bit for bit as OpenCV (both
    FFmpeg); native=True raises and native=None falls back to OpenCV where
    the library is unavailable."""
    path, golden = structured_video
    if not tframepipe.available():
        pytest.skip("libframepipe cannot be built here (no FFmpeg development files)")
    native = list(tvideo.VideoFrameSource(path, 16, native=True))
    fallback = list(tvideo.VideoFrameSource(path, 16, native=False))
    assert [c.shape for c in native] == [c.shape for c in fallback] == [
        (16, 64, 96, 3), (16, 64, 96, 3), (5, 64, 96, 3)]
    for a, b in zip(native, fallback):
        np.testing.assert_array_equal(a, b)
    src = tframepipe.NativeFrameSource(path, chunk_frames=64)
    assert (src.width, src.height) == (96, 64)
    assert np.abs(next(iter(src)).astype(int) - golden.astype(int)).mean() < 20
    src.close()
    src.close()  # idempotent
    with pytest.raises(FileNotFoundError):
        tframepipe.NativeFrameSource(str(path) + ".missing", 16)
    monkeypatch.setattr(tframepipe, "_load_library", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tvideo.VideoFrameSource(path, 16, native=True)
    source = tvideo.VideoFrameSource(path, 16)
    assert source._native is None and [len(c) for c in source] == [16, 16, 5]


def test_decode_provenance_and_video_helpers_match_jax(structured_video):
    path, _ = structured_video
    for kw in ({"chunk_frames": 16}, {"chunk_frames": 10, "max_frames": 25}):
        assert tvideo.decode_provenance(path, **kw) == jvideo.decode_provenance(path, **kw)
    with pytest.raises(ValueError, match="unknown decode backend"):
        tvideo.decode_provenance(path, backend="pyav")
    assert tvideo.video_num_frames(path) == jvideo.video_num_frames(path) == 37
    assert tvideo.LARGE_VIDEO_KB == jvideo.LARGE_VIDEO_KB
    for threshold in (0, 1, tvideo.LARGE_VIDEO_KB):
        assert tvideo.is_large_video(path, threshold) == jvideo.is_large_video(path, threshold)


# ----------------------------------------------------------- host helpers

def test_ten_crop_dataset_and_transforms_match_jax(structured_video, rng):
    path, _ = structured_video
    ours = tvideo.TenCropVideoFrameDataset(path, resize=RESIZE, cropsize=CROP)
    ref = jvideo.TenCropVideoFrameDataset(path, resize=RESIZE, cropsize=CROP)
    assert len(ours) == len(ref) == 3
    for i in (0, 2):
        item = ours[i]
        assert item.shape == (10, 16, CROP, CROP, 3) and item.dtype == np.float32
        np.testing.assert_array_equal(item, ref[i])
    with pytest.raises(IndexError):
        ours[3]
    frames = rng.randint(0, 256, (20, 48, 64, 3), np.uint8)
    np.testing.assert_array_equal(tgt.preprocess_frames(frames, RESIZE, CROP).numpy(),
                                  np.asarray(jgt.preprocess_frames(frames, RESIZE, CROP)))
    for x in (frames, rng.randn(2, 5, 7, 3).astype(np.float32)):
        for fn in ("pixel_minmax", "rgb_channel_minmax"):
            got = getattr(tgt, fn)(torch.from_numpy(x), -1.0, 2.0).numpy()
            np.testing.assert_allclose(got, np.asarray(getattr(jgt, fn)(jnp.asarray(x), -1.0, 2.0)),
                                       rtol=1e-6, atol=1e-6)


def test_synthetic_datasets_bit_equal_jax(tmp_path):
    for seed in (0, 3):
        for t_ds, j_ds in zip(tsynthetic.make_synthetic_train(seed, n_videos=4, t=8, dim=16),
                              jsynthetic.make_synthetic_train(seed, n_videos=4, t=8, dim=16)):
            assert t_ds.filenames == j_ds.filenames
            for name in j_ds.filenames:
                np.testing.assert_array_equal(t_ds._arrays[name], j_ds._arrays[name])
        t_eval = tsynthetic.make_synthetic_eval(seed, n_videos=4, dim=16)
        j_eval = jsynthetic.make_synthetic_eval(seed, n_videos=4, dim=16)
        assert t_eval.filenames == j_eval.filenames and t_eval.labels == j_eval.labels
        for name in j_eval.filenames:
            np.testing.assert_array_equal(t_eval._arrays[name], j_eval._arrays[name])
    t_dirs = tsynthetic.write_synthetic_dataset(str(tmp_path / "t"), seed=1, t=8, dim=16)
    j_dirs = jsynthetic.write_synthetic_dataset(str(tmp_path / "j"), seed=1, t=8, dim=16)
    for t_dir, j_dir in zip(t_dirs[:2], j_dirs[:2]):
        assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir))
        for name in os.listdir(j_dir):
            with open(os.path.join(t_dir, name), "rb") as a, open(os.path.join(j_dir, name), "rb") as b:
                assert a.read() == b.read()
    assert open(t_dirs[2]).read() == open(j_dirs[2]).read()


def test_model_size_bits_matches_jax(narrow):
    _, variables, state_dict = narrow
    ref = jmodel_size.model_size_bits(variables)
    port = I3DResNet(stages=NARROW)
    port.load_state_dict(state_dict)
    assert tmodel_size.model_size_bits(port) == ref
    assert tmodel_size.model_size_bits(port.state_dict()) == ref
    assert tmodel_size.model_size_bits({"w": torch.zeros(3, dtype=torch.int8),
                                        "h": torch.zeros(2, dtype=torch.float16)}) == (5, 56)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = tmodel_size.print_model_size(port)
    assert line == jmodel_size.print_model_size(variables) and out.getvalue() == line + "\n"


def test_prefetch_order_and_errors_match_jax():
    assert list(tprefetch.prefetch(range(50), depth=3)) == list(jprefetch.prefetch(range(50), 3))

    def failing():
        yield 1
        yield 2
        raise KeyError("worker fault")

    for prefetch in (tprefetch.prefetch, jprefetch.prefetch):
        got = []
        with pytest.raises(KeyError, match="worker fault"):
            for item in prefetch(failing(), depth=1):
                got.append(item)
        assert got == [1, 2]
        with pytest.raises(ValueError, match="depth"):
            next(prefetch([1], depth=0))
    stream = tprefetch.prefetch(iter(range(10 ** 6)), depth=2)
    assert next(stream) == 0
    stream.close()  # abandoning stops the worker
    assert not [t for t in threading.enumerate() if t.name == "batch-prefetch" and t.is_alive()]


def test_stage_timer_and_atomic_bytes_match_jax(tmp_path):
    ours, ref = StageTimer(), jprofiling.StageTimer()
    for timer in (ours, ref):
        with timer.stage("decode_wait"):
            pass
        timer.totals.update(decode_wait=1.23456, device_extract=0.5)
        timer.counts.update(decode_wait=3, device_extract=4)
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report() == (
        "decode_wait: 1.23s/3x (411.5ms) | device_extract: 0.50s/4x (125.0ms)")
    tnpyio.atomic_write_bytes(str(tmp_path / "a" / "blob.bin"), b"\x00abc")
    jnpyio.atomic_write_bytes(str(tmp_path / "b" / "blob.bin"), b"\x00abc")
    assert (tmp_path / "a" / "blob.bin").read_bytes() == (tmp_path / "b" / "blob.bin").read_bytes()
    assert os.listdir(tmp_path / "a") == ["blob.bin"]


# -------------------------------------------------------------------- CLIs

def _narrow_factory(narrow, built):
    def factory(**kw):
        kw = dict(kw, dtype=torch.float32)
        kw.pop("state_dict", None)
        kw.pop("device", None)
        ex = _extractor(narrow, **kw)
        built.append(ex)
        return ex
    return factory


def test_extract_features_split_train_writes_jax_segments(narrow, rng, tmp_path, monkeypatch,
                                                         capsys):
    """--split train pooled (--decode-workers 2) and serial with --profile:
    equal features, and the (10, 32, C) segment files the JAX
    segment_video_features writes from the same features; a re-run
    extracts nothing."""
    videos = _three_videos(tmp_path / "vids", rng)
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", _narrow_factory(narrow, []))
    common = ["--videos", str(tmp_path / "vids"), "--split", "train", "--device", "cpu",
              "--batch", "20"]
    t_extract_features.main(common + ["--outdir", str(tmp_path / "a"), "--decode-workers", "2"])
    out = capsys.readouterr().out
    assert f"extracted 3 new videos (3 total) -> {tmp_path / 'a' / 'train'}" in out
    assert f"segmented 3 feature files -> {tmp_path / 'a' / 'segment_features_32'}" in out
    t_extract_features.main(common + ["--outdir", str(tmp_path / "b"), "--decode-workers", "1",
                                      "--profile"])
    out = capsys.readouterr().out
    assert "pipeline stages: decode_wait: " in out and "device_extract: " in out
    jsegments.segment_video_features(str(tmp_path / "a" / "train"), str(tmp_path / "jseg"), 32)
    for path in videos:
        name = os.path.basename(path)[:-4] + "_i3d.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "a" / "train" / name),
                                      np.load(tmp_path / "b" / "train" / name))
        seg = tmp_path / "a" / "segment_features_32" / name
        assert np.load(seg).shape == (10, 32, 64)
        assert seg.read_bytes() == (tmp_path / "jseg" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "a")) == ["segment_features_32", "train"]
    t_extract_features.main(common + ["--outdir", str(tmp_path / "a")])
    assert "extracted 0 new videos (3 total)" in capsys.readouterr().out
    t_extract_features.main(common[:2] + ["--outdir", str(tmp_path / "c"), "--split", "test",
                                          "--device", "cpu", "--batch", "20", "--profile"])
    assert sorted(os.listdir(tmp_path / "c")) == ["test"]
    assert ("--profile forces --decode-workers 1 (serial path)" in capsys.readouterr().err
            ) == (min(8, os.cpu_count() or 1) > 1)


def test_extract_features_center_crops_and_flag_checks(narrow, rng, tmp_path, monkeypatch,
                                                       capsys):
    """--crops center pins crops.json, writes (n, 1, C) features and skips
    the segments with the JAX CLI's message; --batch 0 stops at the parser
    with the JAX wording; without ``datasets`` both CLIs' ``--hf-dataset``
    fail alike; the parser refuses ``--multihost`` with ``--hf-dataset`` as
    the JAX CLI does, and an unknown ``--model``."""
    _three_videos(tmp_path / "vids", rng)
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", _narrow_factory(narrow, []))
    t_extract_features.main(["--videos", str(tmp_path / "vids"), "--outdir", str(tmp_path / "o"),
                             "--crops", "center", "--device", "cpu", "--batch", "8"])
    captured = capsys.readouterr()
    assert json.loads((tmp_path / "o" / "crops.json").read_text()) == {"crops": "center"}
    assert "crop protocol: center (pinned in" in captured.out
    assert ("--crops center is a serving protocol; skipping 32-segment pooling (the training "
            "contract requires ten-crop)") in captured.err
    assert sorted(os.listdir(tmp_path / "o")) == ["crops.json", "v0_i3d.npy", "v1_i3d.npy",
                                                  "v2_i3d.npy"]
    assert np.load(tmp_path / "o" / "v2_i3d.npy").shape == (4, 1, 64)
    import extract_features as j_extract_features

    errors = []
    for main in (j_extract_features.main, t_extract_features.main):
        with pytest.raises(SystemExit) as exc:
            main(["--videos", "v", "--outdir", "o", "--batch", "0"])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1]
    # --hf-dataset where datasets cannot be imported: each CLI (extractor
    # and weights stubbed, no I3D built) stops at the same ModuleNotFoundError;
    # with --multihost both CLIs refuse it in the same words
    from anomaly_detection_on_video_tpu.data import extraction as jextraction

    monkeypatch.setitem(sys.modules, "datasets", None)
    monkeypatch.setattr(jextraction, "FeatureExtractor", StubExtractor)
    monkeypatch.setattr(t_extract_features, "FeatureExtractor", StubExtractor)
    monkeypatch.setattr(j_extract_features, "load_weights", lambda *args, **kw: None)
    monkeypatch.setattr(t_extract_features, "load_i3d_weights", lambda *args, **kw: None)
    errors = []
    for main, device in ((j_extract_features.main, []),
                         (t_extract_features.main, ["--device", "cpu"])):
        with pytest.raises(ModuleNotFoundError) as exc:
            main(["--outdir", str(tmp_path / "hf"), "--hf-dataset", "jinmang2/ucf_crime",
                  "--decode-workers", "1"] + device)
        errors.append((exc.value.name, str(exc.value)))
    assert errors[0] == errors[1] and errors[0][0] == "datasets"
    capsys.readouterr()
    errors = []
    for main in (j_extract_features.main, t_extract_features.main):
        with pytest.raises(SystemExit) as exc:
            main(["--outdir", "o", "--multihost", "--hf-dataset", "jinmang2/ucf_crime"])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "--multihost supports --videos local mode only" in errors[0]
    # --model is ported (i3d_8x8_r50); an unknown backbone stops at the parser
    with pytest.raises(SystemExit) as exc:
        t_extract_features.main(["--videos", "v", "--outdir", "o", "--model", "nope"])
    assert exc.value.code == 2
    assert "invalid choice: 'nope'" in capsys.readouterr().err


def test_infer_center_crops_caches_and_scores_match_jax(narrow, rng, tmp_path, monkeypatch,
                                                        capsys):
    """infer --crops center: the JAX CLI's note, a warm-up over (b, 1, C)
    buckets, <stem>_i3d_center.npy caches of (n, 1, C) features reused on
    a second run, and clip scores equal to the JAX score_features on the
    same features and weights at 1e-5."""
    c = 64
    monkeypatch.setattr(t_infer, "FEATURE_DIM", c)  # the narrow extractor's width
    built = []
    monkeypatch.setattr(t_infer, "FeatureExtractor", _narrow_factory(narrow, built))
    _write_mjpg(tmp_path / "vids" / "Abuse003_x264.avi",
                rng.randint(0, 256, (40, 120, 160, 3), np.uint8))
    config = dict(dims=[16, 16, 32], depths=[1, 1, 1], dim_head=8, channels=c)
    overrides = [f"{k}={json.dumps(v)}".replace(" ", "") for k, v in config.items()]
    weights = _save_weights(tmp_path / "mgfn.pt", "mgfn", _flax_variables("mgfn", config, rng))
    argv = ["--videos", str(tmp_path / "vids"), "--torch-weights", weights, "--crops", "center",
            "--features-dir", str(tmp_path / "feats"), "--warmup", "3", "--device", "cpu",
            "--model-config"] + overrides
    assert t_infer.main(argv + ["--outdir", str(tmp_path / "s1")]) == 0
    captured = capsys.readouterr()
    assert "note: --crops center is the throughput serving mode" in captured.err
    assert "warmup done" in captured.out and built[0].crops == "center"
    cache = tmp_path / "feats" / "Abuse003_x264_i3d_center.npy"
    feats = np.load(cache)
    assert feats.shape == (3, 1, c) and not (tmp_path / "feats" / "Abuse003_x264_i3d.npy").exists()
    apply_fn, variables, eval_step, _, _ = j_infer.build_scorer(
        _args(torch_weights=weights, model_config=overrides))
    want = j_infer.score_features(feats, apply_fn, variables, eval_step)
    out = json.loads((tmp_path / "s1" / "Abuse003_x264_scores.json").read_text())
    np.testing.assert_allclose(out["clip_scores"], want, atol=1e-5)
    monkeypatch.setattr(FeatureExtractor, "extract_video",
                        lambda *a, **k: pytest.fail("extracted again"))
    assert t_infer.main(argv + ["--outdir", str(tmp_path / "s2")]) == 0
    again = json.loads((tmp_path / "s2" / "Abuse003_x264_scores.json").read_text())
    assert again["clip_scores"] == out["clip_scores"]
