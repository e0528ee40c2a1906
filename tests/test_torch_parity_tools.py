"""The port's ``parity_check`` and ``dynamics_ab`` tools
(``anomaly_detection_on_video_tpu_torch/scripts``) against the JAX
package's ``scripts/parity_check.py`` and ``scripts/dynamics_ab.py`` on
the CPU: flag checks, decode fingerprints, MGFN score and AUC reports, the
I3D stage check at reduced depth, the A/B's batches and losses.

The JAX scripts are loaded from their files under module names of their
own. Both tools take their comparison side from ``tests/torch_oracles.py``.
"""

import builtins
import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.models.mgfn import MGFNConfig, MGFNForVideoAnomalyDetection
from anomaly_detection_on_video_tpu.utils.convert import convert_mgfn_state_dict
from anomaly_detection_on_video_tpu_torch.models import build_model
from anomaly_detection_on_video_tpu_torch.models.i3d import I3RES50_STAGES
from anomaly_detection_on_video_tpu_torch.scripts import dynamics_ab, parity_check
from torch_oracles import OracleMGFN, TorchI3Res50, randomize_bn_stats
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MGFN = dict(dims=(8, 8, 16), depths=(1, 1, 1), dim_head=4)
# i3res50 with one block per stage (the oracle's layers=(1, 1, 1, 1))
ONE_BLOCK = tuple((p, 1, s, tk[:1], ts[:1]) for p, _, s, tk, ts in I3RES50_STAGES)


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jpc():
    return jax_script("parity_check")


@pytest.fixture(scope="module")
def jdab():
    return jax_script("dynamics_ab")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as in tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_video(path, n_frames=40, size=(96, 64), seed=0):
    import cv2

    rng = np.random.RandomState(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30, size)
    assert writer.isOpened()
    for _ in range(n_frames):
        writer.write(rng.randint(0, 255, (size[1], size[0], 3), np.uint8))
    writer.release()


NO_OP_ARGV = (
    ["--mgfn-weights", "w.pt"],
    ["--videos", "v"],
    ["--i3d-weights", "w.pt"],
    ["--test-features", "f"],
    ["--gt", "g.json"],
    ["--videos", "v", "--mgfn-weights", "w.pt"],
)


@pytest.mark.parametrize("argv", NO_OP_ARGV)
def test_parity_check_flag_errors_match_jax(jpc, argv, capsys):
    """Flag sets that would check nothing exit 2 with the JAX script's
    error text."""
    errors = []
    for main in (jpc.main, parity_check.main):
        with pytest.raises(SystemExit) as exc:
            main(argv + ["--device", "cpu"] if main is parity_check.main else argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1])
    assert errors[0] == errors[1]


def test_decode_provenance_report_matches_jax(jpc, tmp_path, monkeypatch):
    """``cv2`` and ``both`` without decord: the JAX script's report."""
    path = str(tmp_path / "Normal_002_x264.avi")
    write_video(path, n_frames=24)
    assert parity_check.decode_provenance_report(path, 20, "cv2") == \
        jpc.decode_provenance_report(path, 20, "cv2")
    real_import = builtins.__import__

    def no_decord(name, *args, **kwargs):
        if name == "decord":
            raise ImportError("No module named 'decord'")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "decord", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_decord)
    got = parity_check.decode_provenance_report(path, 24, "both")
    assert got == jpc.decode_provenance_report(path, 24, "both")
    assert "chunk_sha256" in got["cv2"] and "error" in got["decord"] and "match" not in got
    np.testing.assert_array_equal(parity_check.decode_frames(path, 20),
                                  jpc.decode_frames(path, 20))


@pytest.fixture(scope="module")
def tiny_mgfn_weights():
    torch.manual_seed(3)
    mgfn = OracleMGFN(**TINY_MGFN)
    randomize_bn_stats(mgfn, seed=4)
    return parity_check.oracle_to_hf_state_dict(mgfn.eval())


def test_mgfn_reports_match_jax(jpc, tiny_mgfn_weights, tmp_path):
    """``mgfn_score_parity`` and ``auc_summary`` on TINY_MGFN: the JAX
    script's numbers within 1e-5 (the port's ``port`` AUC against its
    ``jax`` one); without weights the port's seeded init, named."""
    rng = np.random.RandomState(0)
    features = rng.randn(5, 10, 2048).astype(np.float32)
    config = json.loads(json.dumps(TINY_MGFN))  # lists, as --mgfn-config gives them
    got = parity_check.mgfn_score_parity(features, tiny_mgfn_weights, config, "cpu")
    want = jpc.mgfn_score_parity(features, tiny_mgfn_weights, config)
    assert got["n_clips"] == want["n_clips"] == 5
    assert got["max_abs_diff"] < 1e-5 and abs(got["max_abs_diff"] - want["max_abs_diff"]) < 1e-5

    feat_dir = tmp_path / "test"
    feat_dir.mkdir()
    gt = {}
    for i in range(4):
        name = f"{'Normal_Videos' if i % 2 == 0 else 'Abuse'}{i:03d}_x264_i3d.npy"
        np.save(feat_dir / name, rng.randn(3 + i, 10, 2048).astype(np.float32))
        gt[name[:-8]] = ([0.0] * 16 + [float(i % 2)] * 16 * (2 + i))
    gt_path = tmp_path / "gt.json"
    gt_path.write_text(json.dumps(gt))
    got = parity_check.auc_summary(str(feat_dir), str(gt_path), tiny_mgfn_weights, config, "cpu")
    want = jpc.auc_summary(str(feat_dir), str(gt_path), tiny_mgfn_weights, config)
    for key in ("rec_auc", "pr_auc"):
        assert abs(got["port"][key] - want["jax"][key]) < 1e-5
        assert abs(got["torch"][key] - want["torch"][key]) < 1e-5
    assert got["rec_auc_diff"] < 1e-5 and got["weights"] == "--mgfn-weights"
    seeded = parity_check.auc_summary(str(feat_dir), str(gt_path), None, config, "cpu")
    assert set(seeded) == {"weights", "port"} and "seeded" in seeded["weights"]
    assert 0.0 <= seeded["port"]["rec_auc"] <= 1.0


def test_stage_parity_at_reduced_depth_discriminates(tmp_path):
    """``TorchI3Res50(layers=(1, 1, 1, 1))`` against the port's one-block
    stages on a decoded MJPG clip: every stage and the features within
    1e-4; a perturbed ``layer4`` conv on the oracle's side (the port keeps
    the clean weights) raises the features' difference over 10x."""
    path = str(tmp_path / "Abuse001_x264.avi")
    write_video(path, n_frames=16)
    frames = parity_check.decode_frames(path, 16)
    torch.manual_seed(0)
    oracle = TorchI3Res50(layers=(1, 1, 1, 1))
    randomize_bn_stats(oracle, seed=1)
    sd = oracle.state_dict()
    torch.set_num_threads(2)
    try:
        report, feats = parity_check.i3d_stage_parity(frames, sd, "float32", 1, "cpu",
                                                      stages=ONE_BLOCK)
        perturbed = {k: v.clone() for k, v in sd.items()}
        key = "layer4.0.conv2.weight"
        perturbed[key] += 0.1 * torch.randn(perturbed[key].shape,
                                            generator=torch.Generator().manual_seed(2))
        report2, _ = parity_check.i3d_stage_parity(frames, perturbed, "float32", 1, "cpu",
                                                   stages=ONE_BLOCK, port_state_dict=sd)
    finally:
        torch.set_num_threads(1)
    diffs = report["max_abs_diff"]
    assert sorted(diffs) == ["features", "stage1", "stage2", "stage3", "stage4", "stem"]
    assert all(v < 1e-4 for v in diffs.values()), diffs
    assert report["missing_keys"] == report["unexpected_keys"] == []
    assert feats.shape == (1, 10, 2048) and report["n_clips"] == 1
    assert report2["max_abs_diff"]["stage3"] < 1e-4
    assert report2["max_abs_diff"]["features"] > 10 * max(diffs["features"], 1e-6)


@pytest.mark.slow
def test_parity_check_end_to_end_at_full_width(tmp_path):
    """The whole tool at full i3res50 width on the CPU, float32 and
    float64: stages, pipeline and MGFN scores within the JAX tests'
    bounds (1e-3 and 1e-4; 1e-8 in float64)."""
    videos = tmp_path / "videos"
    videos.mkdir()
    write_video(videos / "Abuse001_x264.avi", n_frames=24)
    torch.manual_seed(0)
    i3d = TorchI3Res50()
    randomize_bn_stats(i3d, seed=1)
    torch.save(i3d.state_dict(), tmp_path / "i3d.pt")
    torch.manual_seed(1)
    mgfn = OracleMGFN(**TINY_MGFN)
    randomize_bn_stats(mgfn, seed=2)
    torch.save(parity_check.oracle_to_hf_state_dict(mgfn.eval()), tmp_path / "mgfn_hf.pt")
    for dtype, bound in (("float32", 1e-3), ("float64", 1e-8)):
        report = parity_check.main([
            "--videos", str(videos), "--i3d-weights", str(tmp_path / "i3d.pt"),
            "--mgfn-weights", str(tmp_path / "mgfn_hf.pt"), "--mgfn-config",
            json.dumps(TINY_MGFN), "--max-clips", "1", "--max-frames", "24", "--dtype", dtype,
            "--device", "cpu", "--out", str(tmp_path / f"{dtype}.json")])
        (video,) = report["i3d"].values()
        assert all(v < bound for v in video["max_abs_diff"].values()), video
        assert video["pipeline"]["max_abs_diff"] < 1e-3
        (scores,) = report["mgfn_scores"].values()
        assert scores["max_abs_diff"] < 1e-4


def test_dynamics_ab_batches_and_losses_match_jax(jdab, tmp_path):
    """``make_batches`` bit-equal to the JAX script's; at tiny widths, 1 + 1
    bags and 3 steps from one init with random norms (identity norms tie
    the top-k in float32), the torch side bit-equal to the JAX script's
    ``run_torch`` and the port's losses within 1e-5 relative of
    ``run_jax``'s. The default ``--out`` is not the JAX package's record."""
    for profile in ("gauss", "i3dlike"):
        got = dynamics_ab.make_batches(profile, 100, 2, batch=1)
        want = jdab.make_batches(profile, 100, 2, batch=1)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    batches = dynamics_ab.make_batches("gauss", 100, 2, batch=1)
    torch.manual_seed(0)
    oracle = OracleMGFN(**TINY_MGFN)
    randomize_bn_stats(oracle, seed=1)
    dynamics_ab.randomize_norms(oracle, seed=5)
    init = {k: v.detach().clone() for k, v in oracle.state_dict().items()}

    def ctor():
        return OracleMGFN(**TINY_MGFN)

    got = dynamics_ab.run_torch(ctor, init, batches, 1e-3, 3, "cpu")
    assert got == jdab.run_torch(ctor, init, batches, 1e-3, 3)
    port = dynamics_ab.run_port(
        lambda: build_model("mgfn", dropout_rate=0.0, **TINY_MGFN)[1],
        parity_check.oracle_to_hf_state_dict(init), batches, 1e-3, 3, "cpu")
    variables = convert_mgfn_state_dict(parity_check.oracle_to_hf_state_dict(init))
    model = MGFNForVideoAnomalyDetection(MGFNConfig(dropout_rate=0.0, **TINY_MGFN))
    want = jdab.run_jax(model, variables, batches, 1e-3, 3)
    assert port["nan_step"] is None and want["nan_step"] is None
    np.testing.assert_allclose(port["losses"], want["losses"], rtol=1e-5)
    assert dynamics_ab.DEFAULT_OUT == "dynamics_ab.json"
    assert not os.path.isabs(dynamics_ab.DEFAULT_OUT)


def test_oracles_and_the_hub_stay_out_of_the_port():
    """No port module imports flax or jax, none imports ``huggingface_hub``
    when it is imported (only inside the functions that download), and only
    the two tools that compare against it name ``tests/torch_oracles.py``."""
    imports = re.compile(r"^\s*(import|from)\s+(flax|jax)\b", re.M)
    at_import = re.compile(r"^(import|from)\s+huggingface_hub\b", re.M)
    naming = []
    for path in (Path(REPO) / "anomaly_detection_on_video_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert not imports.search(text), path
        assert not at_import.search(text), path
        if "torch_oracles" in text:
            naming.append(path.name)
    assert sorted(naming) == ["dynamics_ab.py", "parity_check.py"]
