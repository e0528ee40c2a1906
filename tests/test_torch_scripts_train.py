"""The port's training tools (``anomaly_detection_on_video_tpu_torch/scripts``)
on the CPU: ``demo`` end to end as a process, ``convergence_bench.run_one``
against the JAX script's ``run_one`` for every family, and
``int8_e2e.run_seed`` end to end on narrow extractors with the JAX report's
keys.

``run_one`` is compared from one set of initial weights (the port's seeded
init with random norms, handed to the JAX runner through
``*_state_dict_to_flax``: a fresh MGFN's identity LayerNorms make its
top-k clips ties that float32 rounding picks) and with dropout off in both
(the frameworks' dropout draws cannot be matched), at the tolerances that
tests/test_torch_training_parity.py holds the same runner to.
"""

import argparse
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu_torch.data.extraction import FeatureExtractor
from anomaly_detection_on_video_tpu_torch.models.i3d import I3DResNet
from anomaly_detection_on_video_tpu_torch.scripts import convergence_bench, int8_e2e
from anomaly_detection_on_video_tpu_torch.training import runner as trunner
from anomaly_detection_on_video_tpu_torch.utils import convert as tconvert
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I3D_NARROW = ((8, 1, 1, (3,), (1,)), (16, 1, 2, (1,), (1,)))


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as in tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_demo_runs_training_and_export_as_a_process(tmp_path):
    """``demo --skip-extract --epochs 1 --device cpu``: the port's ``run``
    and ``infer --export`` as processes, to "demo complete" and a
    manifest."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    result = subprocess.run(
        [sys.executable, "-m", "anomaly_detection_on_video_tpu_torch.scripts.demo", "--workdir",
         str(tmp_path / "demo"), "--skip-extract", "--epochs", "1", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stdout[-3000:] + result.stderr[-3000:]
    assert "demo complete" in result.stdout
    assert "final valid/rec_auc=" in result.stdout
    assert (tmp_path / "demo" / "scorer_export" / "manifest.json").is_file()
    assert "anomaly_detection_on_video_tpu_torch.infer" in result.stdout


def _random_norms_(model, seed):
    """Random LayerNorm and BatchNorm affines and statistics (the weights
    keep the seeded init)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, value in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if ("norm" in name and leaf in ("g", "b", "weight", "bias")) or "running_" in leaf:
                low = 0.5 if leaf in ("g", "weight", "running_var") else -0.2
                value.copy_(torch.rand(value.shape, generator=gen) * 0.4 + low)


# MGFN's JAX side compiles its train step for about 30 s on the CPU: the slow
# tier (the same runner's MGFN steps are held to the JAX runner's in
# tests/test_torch_training_parity.py)
@pytest.mark.parametrize("family", [pytest.param("mgfn", marks=pytest.mark.slow), "rtfm",
                                    "sultani"])
def test_convergence_run_one_matches_the_jax_script(family, monkeypatch):
    """Two epochs of ``run_one`` (8 steps each, shuffled, eval every epoch)
    in both packages from the same weights, dropout off: epoch losses at
    rtol 1e-4, AUC curves at atol 1e-4."""
    j_bench = jax_script("convergence_bench")
    no_dropout = dict(convergence_bench.MODELS[family], dropout_rate=0.0)
    monkeypatch.setitem(convergence_bench.MODELS, family, no_dropout)
    monkeypatch.setitem(j_bench.MODELS, family, no_dropout)

    initial = {}
    port_init = trunner.VideoAnomalyDetectionRunner.init_state

    def init_with_random_norms(self):
        state = port_init(self)
        _random_norms_(state.model, 11)
        initial.update({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        return state

    monkeypatch.setattr(trunner.VideoAnomalyDetectionRunner, "init_state", init_with_random_norms)
    got = convergence_bench.run_one(family, seed=1, epochs=2, device="cpu")

    variables = jax.tree_util.tree_map(
        jnp.asarray, getattr(tconvert, f"{family}_state_dict_to_flax")(initial))

    def init_from_port(self, example_batch):
        self.state = jrunner.TrainState.create(self.model, variables, self.tx)
        return self.state

    monkeypatch.setattr(jrunner.VideoAnomalyDetectionRunner, "init_state", init_from_port)
    want = j_bench.run_one(family, seed=1, epochs=2)
    assert len(got.loss) == len(want.loss) == 2 and len(got.auc) == 2
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-4)
    np.testing.assert_allclose(got.auc, want.auc, atol=1e-4)


def _key_tree(node):
    if isinstance(node, dict):
        return {k: _key_tree(v) for k, v in node.items()}
    return type(node).__name__ if not isinstance(node, (int, float)) else "number"


def test_int8_e2e_run_seed_end_to_end_with_the_jax_report_keys(tmp_path, monkeypatch):
    """``run_seed`` on narrow extractors (ten crops and the center crop,
    full precision and int8, one set of weights, scales pinned): finite
    AUCs in [0, 1], a dumped segment file, and the JAX ``run_seed``'s report
    keys (the JAX side run on stand-in extractors, its scorer stubbed: only
    its report's shape is taken). Kept small for the CPU: the extractors
    compute in float32 (bfloat16 convolutions are slow there), on 16-pixel
    crops of the corpus's frames subsampled to 60x80, two videos of one clip."""
    full_size = int8_e2e.synth_video
    monkeypatch.setattr(int8_e2e, "synth_video", lambda n, anomalous, seed: np.ascontiguousarray(
        full_size(n, anomalous, seed)[:, ::4, ::4]))
    torch.manual_seed(3)
    weights = I3DResNet(stages=I3D_NARROW).state_dict()
    extractors = {
        name: FeatureExtractor(model=I3DResNet(stages=I3D_NARROW), state_dict=weights,
                               resize=20, cropsize=16, device="cpu", dtype=torch.float32,
                               quantize=name.endswith("int8"),
                               crops="center" if name.startswith("center") else "ten")
        for name in int8_e2e.VARIANTS}
    for name, extractor in extractors.items():
        extractor.pin_calibration(str(tmp_path / "scales" / name))
    args = argparse.Namespace(n_videos=2, frames=16, steps=2, seeds=[0],
                              dump_segments=str(tmp_path / "segs.npz"), device="cpu")
    report = int8_e2e.run_seed(args, extractors, 0)
    for part in ("tencrop", "center_serving"):
        for key in ("auc_bf16", "auc_int8"):
            assert 0.0 <= report[part][key] <= 1.0
        assert np.isfinite(report[part]["max_abs_score_delta"])
    assert sorted(np.load(args.dump_segments).files) == ["Abuse001_x264", "Normal_Videos000_x264"]
    assert (tmp_path / "scales" / "tencrop_int8" / "act_scales_rgb.json").is_file()

    j_int8 = jax_script("int8_e2e")

    class StandIn:
        def extract_frames(self, frames):
            return np.zeros((frames.shape[0] // 16, 10, 8), np.float32)

    monkeypatch.setattr(j_int8, "train_scorer", lambda segs, steps, seed: None)
    monkeypatch.setattr(j_int8, "score_corpus", lambda state, feats: {
        name: np.linspace(0.1, 0.9, f.shape[0]).astype(np.float32) + i * 0.01
        for i, (name, f) in enumerate(sorted(feats.items()))})
    args.dump_segments = None
    want = j_int8.run_seed(args, {k: StandIn() for k in int8_e2e.VARIANTS}, 0)
    assert _key_tree(report) == _key_tree(want)


def test_bce_loss_gradient_is_bcelosss():
    """Fault 6: the scorers' BCE has torch ``BCELoss``'s gradient, finite
    where a probability is exactly 0 or 1 (autograd through the clamped
    logs gave NaN there; a confident float32 scorer, such as
    ``int8_e2e``'s, reaches it), equal to ``F.binary_cross_entropy``'s in
    float64 at saturated and interior probabilities; the forward values
    are the clamped formula's, as before."""
    from anomaly_detection_on_video_tpu_torch.losses import bce_loss

    probs = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.3, 0.9, 1e-30, 0.5], dtype=torch.float64)
    labels = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 1.0], dtype=torch.float64)
    mine, ref = probs.clone().requires_grad_(True), probs.clone().requires_grad_(True)
    loss = bce_loss(mine, labels)
    want = torch.nn.functional.binary_cross_entropy(ref, labels)
    loss.backward()
    want.backward()
    assert torch.isfinite(mine.grad).all()
    torch.testing.assert_close(loss, want, rtol=1e-12, atol=0)
    # torch's floor is the float32 1e-12 (9.9999999600e-13): 4e-9 apart where it acts
    torch.testing.assert_close(mine.grad, ref.grad, rtol=1e-8, atol=0)
    assert mine.grad[0] == 0 and mine.grad[1] == 0  # a correct saturated probability


@pytest.mark.parametrize("case", ["nan_weights", "finite_weights", "runtime_error"])
def test_full_scale_records_only_a_nan_divergence(case, monkeypatch):
    """``run_full_scale_reference_hparams`` records an eval ValueError as a
    divergence only when the weights are no longer finite; a ValueError on
    finite weights, and any other failure (a device's), propagates. Its
    data, model and ``fit`` are stand-ins here: the full-width run is the
    card's."""
    import types

    def fit(self, *args, **kwargs):
        layer = torch.nn.Linear(2, 1)
        if case == "nan_weights":
            with torch.no_grad():
                layer.weight.fill_(float("nan"))
        self.state = types.SimpleNamespace(model=layer)
        raise (RuntimeError if case == "runtime_error" else ValueError)(
            "x is neither increasing nor decreasing")

    monkeypatch.setattr(convergence_bench, "make_synthetic_train", lambda seed, dim: ([], []))
    monkeypatch.setattr(convergence_bench, "make_synthetic_eval", lambda seed, dim: [])
    monkeypatch.setattr(convergence_bench, "build_model",
                        lambda name: (None, torch.nn.Linear(2, 1)))
    monkeypatch.setattr(convergence_bench.VideoAnomalyDetectionRunner, "fit", fit)
    if case != "nan_weights":
        with pytest.raises(RuntimeError if case == "runtime_error" else ValueError):
            convergence_bench.run_full_scale_reference_hparams(0, device="cpu")
        return
    got = convergence_bench.run_full_scale_reference_hparams(0, device="cpu")
    assert got == {"rec_auc": [], "train_loss_epoch": [], "diverged_at_epoch": 0,
                   "error": "ValueError: x is neither increasing nor decreasing", "finite": False}
