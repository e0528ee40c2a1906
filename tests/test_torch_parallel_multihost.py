"""PyTorch port vs the JAX package: scale-out over processes, and the
pieces held in this process.

Two processes of ``extract_features --multihost`` (narrow stages) in
float32 and int8, bit-equal to one process, and two processes of ``run
trainer.multihost=true`` for 2 steps, against one process; each with one
torch thread, a timeout and a store on a port the OS picks. The
tensor-parallel rule, ``build_mesh`` and the extractor's clip-axis split
are held in this process.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_parallel_launch import (
    LAUNCHER,
    RUN_NARROW,
    _extract_argv,
    _finish,
    _jax_variables,
    _popen,
    _write_start_checkpoint,
    _write_videos,
    free_port,
    narrow_extractor,
)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Start two processes each of ``extract_features --multihost`` and
    ``run trainer.multihost=true``, run their one-process references while
    they run, then wait for them. -> a dict of everything the tests read."""
    from anomaly_detection_on_video_tpu_torch import extract_features, run
    from anomaly_detection_on_video_tpu_torch.data.synthetic import write_synthetic_dataset

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("multihost")
    procs, logs = [], []

    def start(cmd, log):
        logs.append(str(root / log))
        procs.append(_popen(cmd, logs[-1]))

    # two processes of extract_features --multihost, float32 then int8
    videos = str(root / "videos")
    _write_videos(videos, np.random.RandomState(0))
    ports = {dtype: free_port() for dtype in ("float32", "int8")}
    for pid in range(2):
        spec = [_extract_argv(videos, str(root / f"multi_{dtype}"), dtype)
                + ["--multihost", "--coordinator", f"127.0.0.1:{ports[dtype]}",
                   "--num-processes", "2", "--process-id", str(pid)]
                for dtype in ("float32", "int8")]
        with open(root / f"extract{pid}.json", "w") as f:
            json.dump(spec, f)
        start([sys.executable, LAUNCHER, "extract", str(root / f"extract{pid}.json")],
              f"extract{pid}.log")
    # two processes of run trainer.multihost=true, resuming the same step-0
    # checkpoint as the one-process run
    train_dir, test_dir, gt = write_synthetic_dataset(str(root / "data"), t=32, dim=64)
    data = [f"data.train_path={train_dir}", f"data.test_path={test_dir}",
            f"data.ground_truth_path={gt}", "trainer.resume=true"]
    for tag in ("p0", "p1", "single"):
        _write_start_checkpoint(str(root / tag / "ckpt"))
    port = free_port()
    for pid in range(2):
        start([sys.executable, "-m", "anomaly_detection_on_video_tpu_torch.run"] + RUN_NARROW
              + data + [f"trainer.log_path={root}/p{pid}/metrics.jsonl",
                        f"trainer.checkpoint.dirpath={root}/p{pid}/ckpt",
                        "trainer.multihost=true", f"trainer.coordinator=127.0.0.1:{port}",
                        "trainer.num_processes=2", f"trainer.process_id={pid}"], f"run{pid}.log")
    try:
        real_extractor = extract_features.FeatureExtractor
        extract_features.FeatureExtractor = narrow_extractor
        try:
            for dtype in ("float32", "int8"):
                extract_features.main(_extract_argv(videos, str(root / f"single_{dtype}"), dtype))
        finally:
            extract_features.FeatureExtractor = real_extractor
        run.main(RUN_NARROW + data + [f"trainer.log_path={root}/single/metrics.jsonl",
                                      f"trainer.checkpoint.dirpath={root}/single/ckpt"])
    finally:
        texts = _finish(procs, logs)
        torch.set_num_threads(threads)
    return {"root": root, "logs": dict(zip(["extract0", "extract1", "run0", "run1"], texts))}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_extract_features_multihost_two_processes(launched, dtype):
    """Two processes of ``extract_features --multihost``: every feature
    file bit-equal to one process; int8 scales pinned once, by process 0,
    before any feature file, equal to one process's; only process 0 writes
    segments."""
    root = launched["root"]
    multi, single = root / f"multi_{dtype}" / "train", root / f"single_{dtype}" / "train"
    names = sorted(n for n in os.listdir(single) if n.endswith("_i3d.npy"))
    assert names == ["v0_i3d.npy", "v1_i3d.npy", "v2_i3d.npy"]
    for n in names:
        np.testing.assert_array_equal(np.load(multi / n), np.load(single / n))
        seg = f"segment_features_32/{n}"
        np.testing.assert_array_equal(np.load(root / f"multi_{dtype}" / seg),
                                      np.load(root / f"single_{dtype}" / seg))
    logs = launched["logs"]
    for pid in range(2):
        assert f"[process {pid}/2] extracted" in logs[f"extract{pid}"]
    assert logs["extract0"].count("segmented 3 feature files") == 2  # float32 and int8
    assert "segmented" not in logs["extract1"]
    if dtype == "int8":
        scales = multi / "act_scales_rgb.json"
        assert json.loads(scales.read_text()) == json.loads((single / "act_scales_rgb.json")
                                                            .read_text())
        assert scales.stat().st_mtime <= min((multi / n).stat().st_mtime for n in names)
    else:
        assert not (multi / "act_scales_rgb.json").exists()


def test_run_multihost_two_processes(launched):
    """Two processes of ``run trainer.multihost=true`` (2 steps, the
    selection dropout on): process 0's losses equal one process's (float32),
    and process 1 writes no metrics, checkpoints or hparams."""
    root = launched["root"]

    def losses(path):
        with open(path) as f:
            return [line["train_loss"] for line in map(json.loads, f) if "train_loss" in line]

    single = losses(root / "single" / "metrics.jsonl")
    assert len(single) == 2
    np.testing.assert_allclose(losses(root / "p0" / "metrics.jsonl"), single, rtol=1e-5)
    assert not (root / "p1" / "metrics.jsonl").exists()
    assert os.listdir(root / "p1" / "ckpt") == ["0"]  # the start checkpoint only
    assert sorted(os.listdir(root / "p0" / "ckpt")) == ["0", "2", "hparams.json"]
    assert "resumed from step 0" in launched["logs"]["run0"]
    assert "resumed from step 0" not in launched["logs"]["run1"]


# ------------------------------------------------------ in this process

def _jax_tp_specs(tree, tp=2):
    import jax
    import jax.numpy as jnp

    from anomaly_detection_on_video_tpu.parallel import make_mesh as j_make_mesh
    from anomaly_detection_on_video_tpu.parallel import tensor_parallel_specs as j_specs

    mesh = j_make_mesh((8 // tp, tp), ("data", "model"))
    specs = j_specs({k: jax.ShapeDtypeStruct(np.shape(v), jnp.float32) for k, v in tree.items()},
                    mesh)
    return {k: (list(s.spec).index("model") if "model" in s.spec else None)
            for k, s in specs.items()}


def _export(name, variables):
    from anomaly_detection_on_video_tpu.utils import convert as jconvert

    return getattr(jconvert, f"export_{name}_state_dict")(variables)


@pytest.mark.parametrize("tree", ["rule", "mgfn", "rtfm", "sultani"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_specs_match_jax(tree, tp):
    """The port's placement of every entry equals the JAX rule's: the
    tree of tests/test_sharding.py, and the state dicts that the JAX
    ``export_*_state_dict`` functions name."""
    from anomaly_detection_on_video_tpu_torch.parallel import Mesh, tensor_parallel_specs

    if tree == "rule":
        state = {"kernel": np.zeros((3, 64, 128)), "bias": np.zeros((128,)),
                 "odd": np.zeros((7, 3)), "scalar": np.zeros(()), "tie": np.zeros((64, 64))}
    else:
        state = _export(tree, _jax_variables()[tree])
    port = tensor_parallel_specs(state, Mesh({"data": 8 // tp, "model": tp}))
    assert port == _jax_tp_specs(state, tp)
    if tree == "rule" and tp == 2:
        assert port == {"kernel": 2, "bias": 0, "odd": None, "scalar": None, "tie": 1}


@pytest.mark.parametrize("cfg", [{"data_parallel": True, "tensor_parallel": 2},
                                 {"tensor_parallel": 4}, {"data_parallel": True},
                                 {"data_parallel": True, "tensor_parallel": 8}, {}],
                         ids=["dp_tp2", "tp4", "dp", "tp8", "none"])
def test_build_mesh_matches_run_py(cfg):
    """``run.mesh_shape`` over 8 devices gives the root ``run.build_mesh``'s
    shapes and axis names (pytest's 8 CPU devices)."""
    import run as j_run

    from anomaly_detection_on_video_tpu_torch import run as t_run

    ref = j_run.build_mesh(cfg)
    got = t_run.mesh_shape(cfg, 8)
    if ref is None:
        assert got is None
    else:
        assert got == (tuple(ref.devices.shape), tuple(ref.axis_names))


def test_build_mesh_does_not_divide_and_one_device():
    import run as j_run

    from anomaly_detection_on_video_tpu_torch import run as t_run

    errors = []
    for fn in (lambda: j_run.build_mesh({"tensor_parallel": 3}),
               lambda: t_run.mesh_shape({"tensor_parallel": 3}, 8)):
        with pytest.raises(SystemExit) as exc:
            fn()
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert t_run.mesh_shape({"data_parallel": True}, 1) is None
    assert t_run.mesh_shape({"data_parallel": True}, 1, distributed=True) == ((1,), ("data",))
    assert t_run.build_mesh({"data_parallel": True}) is None  # no process group here


def _frames(rng, n):
    return rng.randint(0, 256, (n, 72, 96, 3), dtype=np.uint8)


@pytest.mark.parametrize("quantize", [False, True], ids=["float32", "int8"])
def test_feature_extractor_split_over_two_devices_is_bit_equal(quantize):
    """``FeatureExtractor(devices=["cpu", "cpu"])``: every group's clips
    split over two replicas, bit-equal to one device (int8: the leader's
    calibration reaches the replica)."""
    torch.set_num_threads(1)
    frames = _frames(np.random.RandomState(4), 16 * 2 + 3)  # 3 clips, the last short
    one = narrow_extractor(device="cpu", batch=20, quantize=quantize,
                           dtype=torch.bfloat16 if quantize else torch.float32)
    two = narrow_extractor(devices=["cpu", "cpu"], batch=20, quantize=quantize,
                           dtype=torch.bfloat16 if quantize else torch.float32)
    assert two.n_shards == 2 and two.group_clips == 2 * one.group_clips == 4
    want = one.extract_frames(frames)
    if quantize:  # the leader takes one's scales; its replica must take them from it
        two.model.act_scales = one.model.act_scales
    got = two.extract_frames(frames)
    assert got.shape == (3, 10, 64)
    np.testing.assert_array_equal(got, want)
    if quantize:
        assert two._models[1].act_scales == two.model.act_scales == one.model.act_scales


@pytest.mark.parametrize("crops,batch", [("ten", 240), ("center", 240), ("ten", 40)])
def test_group_sizes_match_jax_two_device_mesh(crops, batch):
    """``group_clips`` and the adaptive ladder ``_group_for(n)`` for n in
    1..70 equal the JAX extractor's with a two-device mesh."""
    import jax

    from anomaly_detection_on_video_tpu.data.extraction import FeatureExtractor as JExtractor
    from anomaly_detection_on_video_tpu.parallel import make_mesh as j_make_mesh

    ref = JExtractor(variables={}, batch=batch, crops=crops, adaptive_groups=True,
                     mesh=j_make_mesh((2,), ("data",), jax.devices()[:2]))
    port = narrow_extractor(devices=["cpu", "cpu"], batch=batch, crops=crops,
                            adaptive_groups=True)
    assert port.group_clips == ref.group_clips
    assert [port._group_for(n) for n in range(1, 71)] == [ref._group_for(n) for n in range(1, 71)]
