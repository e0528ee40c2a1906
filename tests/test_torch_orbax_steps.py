"""The port's reader of the JAX package's orbax checkpoints, whole steps
(``training/orbax.py``, the checkpointer and the CLIs on top) against the
JAX package's own ``TopKCheckpointer``, ``infer.py`` and ``run.py``, on
narrow JAX checkpoints of every family and on the committed JAX run
directory.
"""

import functools
import glob
import json
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import zstandard

import chip_smoke
import infer as j_infer
from anomaly_detection_on_video_tpu.data import extraction as jextraction
from anomaly_detection_on_video_tpu.models import build_model as j_build_model
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam_with_l2
from anomaly_detection_on_video_tpu.training.runner import TrainState as JTrainState
from anomaly_detection_on_video_tpu_torch import infer as t_infer
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.models import build_model
from anomaly_detection_on_video_tpu_torch.training.checkpoints import TopKCheckpointer
from anomaly_detection_on_video_tpu_torch.training.optim import adam_with_l2
from anomaly_detection_on_video_tpu_torch.training.orbax import (
    is_orbax_step,
    read_checkpoint_metadata,
    read_orbax_metrics,
    read_orbax_step,
)
from anomaly_detection_on_video_tpu_torch.training.runner import TrainState
from anomaly_detection_on_video_tpu_torch.utils import ocdbt, zstd
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    SCORERS_FROM_FLAX,
    train_state_from_orbax,
)
from torch_orbax_fixtures import (
    FIXTURE,
    NARROW,
    _args,
    _jax_restored,
    _jax_state,
    _save,
    assert_trees_bit_equal,
)
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """Narrow JAX checkpoints of every family (random states), written by
    the JAX ``TopKCheckpointer``: MGFN over four steps with metrics, RTFM,
    Sultani, a bfloat16 Sultani and a legacy 2-slot optimizer state."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for name in ("mgfn", "rtfm", "sultani"):
        state = _jax_state(name, rng)
        steps = [(1, 0.5), (2, 0.9), (3, 0.7), (4, None)] if name == "mgfn" else [(5, 0.25)]
        _save(root / name, state, steps, top_k=2 if name == "mgfn" else 10)
        out[name] = (root / name, state)
    state = _jax_state("sultani", rng, dtype=jnp.bfloat16)
    _save(root / "bf16", state, [(6, 0.1)])
    out["bf16"] = (root / "bf16", state)
    legacy_tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-3))
    state = _jax_state("sultani", rng, tx=legacy_tx)
    _save(root / "legacy", state, [(7, 0.3)])
    out["legacy"] = (root / "legacy", _jax_state("sultani", rng))  # a 3-slot template
    return out


# ------------------------------------------------------------------ zstd

def _frames_in(directory):
    """Every zstd frame of an orbax step directory: the bodies of its
    OCDBT manifests and nodes, and its zarr chunks."""
    frames = []
    for path in glob.glob(os.path.join(directory, "**", "manifest.ocdbt"), recursive=True):
        data = open(path, "rb").read()
        frames.append(data[14:-4])
    store_dir = os.path.join(directory, "default")
    store = ocdbt.OcdbtStore(store_dir)
    for key in store.list():
        if not key.endswith(b".zarray"):
            frames.append(store.read(key))
    for ver in store.versions[-1:]:
        node = open(os.path.join(store_dir, ver.root.path), "rb").read()
        frames.append(node[ver.root.offset + 14:ver.root.offset + ver.root.length - 4])
    return frames


def test_zstd_decodes_every_frame_of_the_checkpoints(jax_dirs):
    """Every frame in the committed fixture's steps and a JAX checkpoint
    (node bodies and array chunks) decodes byte-equal to ``zstandard``."""
    frames = []
    for step in (os.path.join(FIXTURE, "run", "2"), os.path.join(FIXTURE, "run", "4"),
                 str(jax_dirs["rtfm"][0] / "5")):
        frames += _frames_in(step)
    assert len(frames) > 400 and all(f.startswith(zstd.MAGIC) for f in frames)
    for frame in frames:
        assert zstd.decompress(frame) == zstandard.ZstdDecompressor().decompressobj().decompress(
            frame)


# ------------------------------------------------------------------ trees

@pytest.mark.parametrize("case", ["mgfn", "rtfm", "sultani", "bf16"])
def test_read_orbax_step_matches_jax_restore(jax_dirs, case):
    """read_orbax_step equals the JAX ``TopKCheckpointer.restore`` leaf by
    leaf, bit for bit: params, batch stats (RTFM and Sultani's empty dict),
    the Adam moments and count, the scalar step; a bfloat16 Sultani's
    leaves come back as torch.bfloat16."""
    directory, state = jax_dirs[case]
    step = max(int(s) for s in os.listdir(directory) if s.isdigit())
    tree = read_orbax_step(str(directory / str(step)))
    assert_trees_bit_equal(tree, _jax_restored(directory, state, step))
    assert tree["opt_state"][0] is None and tree["opt_state"][2][1] is None
    assert tree["step"].shape == () and tree["step"].dtype == np.int32
    if case in ("rtfm", "sultani"):
        assert tree["batch_stats"] == {}
    if case == "bf16":
        assert tree["params"]["fc1"]["kernel"].dtype == torch.bfloat16


def test_read_orbax_step_migrates_a_legacy_optimizer_state(jax_dirs):
    """A 2-slot opt_state (add_decayed_weights, adam) is read as the JAX
    checkpointer restores it: the empty slot 0 prepended, with a warning."""
    directory, template = jax_dirs["legacy"]
    with pytest.warns(UserWarning, match="legacy 2-slot"):
        want = _jax_restored(directory, template, 7)
    with pytest.warns(UserWarning, match="legacy 2-slot"):
        tree = read_orbax_step(str(directory / "7"))
    assert len(tree["opt_state"]) == 3
    assert_trees_bit_equal(tree, want)


def test_checkpointer_sees_orbax_steps_as_the_jax_one(jax_dirs):
    """Steps, metrics and ``resolve_step`` (latest, best, an exact step, a
    missing one) over the JAX checkpointer's retained steps, whose
    retention (top 2 by metric plus the latest) the port's agrees with."""
    directory, _ = jax_dirs["mgfn"]
    ref, ours = JCheckpointer(str(directory), top_k=2), TopKCheckpointer(str(directory), top_k=2)
    assert ours.all_steps() == sorted(ref.manager.all_steps()) == [2, 3, 4]
    for step in ours.all_steps():
        assert ours.is_orbax(step) and is_orbax_step(str(directory / str(step)))
        assert ours.metrics(step) == ref.manager.metrics(step)
    assert read_orbax_metrics(str(directory / "4")) is None
    assert read_checkpoint_metadata(str(directory / "2"))["item_handlers"]
    for selector in ("latest", "best", "3", 2, None):
        assert ours.resolve_step(selector) == ref.resolve_step(selector)
    for checkpointer in (ours, ref):
        with pytest.raises(ValueError, match=r"checkpoint step 1 not found.*\[2, 3, 4\]"):
            checkpointer.resolve_step(1)


@pytest.mark.parametrize("name", ["mgfn", "rtfm", "sultani"])
def test_train_state_from_orbax_relayouts_the_moments(jax_dirs, name):
    """A port ``TrainState`` restored from an orbax step: the model holds
    the family's converted params, and each parameter's exp_avg,
    exp_avg_sq and step are bit-equal to the relayouted mu, nu and count."""
    directory, state = jax_dirs[name]
    step = max(int(s) for s in os.listdir(directory) if s.isdigit())
    _, model = build_model(name, **NARROW[name])
    port = TopKCheckpointer(str(directory)).restore(
        TrainState(model, adam_with_l2(model.parameters())), step=step)
    want = _jax_restored(directory, state, step)
    variables = jax.tree_util.tree_map(np.asarray, {"params": want["params"],
                                                    "batch_stats": want["batch_stats"]})
    convert = SCORERS_FROM_FLAX[name]
    weights = convert(variables)
    adam = jax.tree_util.tree_map(np.asarray, want["opt_state"][2][0])
    mu = convert({"params": adam.mu, "batch_stats": variables["batch_stats"]})
    nu = convert({"params": adam.nu, "batch_stats": variables["batch_stats"]})
    assert port.step == int(want["step"])
    optimizer_state = port.optimizer.state_dict()["state"]
    for i, (key, param) in enumerate(port.model.named_parameters()):
        assert torch.equal(param.detach(), weights[key]), key
        moments = optimizer_state[i]
        assert torch.equal(moments["exp_avg"], mu[key]) and torch.equal(moments["exp_avg_sq"],
                                                                        nu[key]), key
        assert moments["step"].item() == float(adam.count)


def test_bfloat16_step_loads_as_jax_restores_it(jax_dirs):
    """A bfloat16 step into float32 models: the port's weights and moments
    equal the JAX restore into a float32 template (orbax casts), relayouted."""
    directory, _ = jax_dirs["bf16"]
    want = _jax_restored(directory, jax_dirs["sultani"][1], 6)
    assert want["params"]["fc1"]["kernel"].dtype == jnp.float32
    _, model = build_model("sultani", **NARROW["sultani"])
    state = train_state_from_orbax(read_orbax_step(str(directory / "6")), "sultani",
                                   TrainState(model, adam_with_l2(model.parameters())))
    weights = SCORERS_FROM_FLAX["sultani"](jax.tree_util.tree_map(np.asarray,
                                                                  {"params": want["params"]}))
    mu = SCORERS_FROM_FLAX["sultani"]({"params": jax.tree_util.tree_map(
        np.asarray, want["opt_state"][2][0].mu)})
    optimizer_state = state.optimizer.state_dict()["state"]
    for i, (key, param) in enumerate(state.model.named_parameters()):
        assert param.dtype == torch.float32 and torch.equal(param.detach(), weights[key]), key
        assert torch.equal(optimizer_state[i]["exp_avg"], mu[key]), key


# -------------------------------------------------------- the committed fixture

def _fixture_template():
    _, model = j_build_model("mgfn", channels=2048, dims=(8, 8, 16), depths=(1, 1, 1),
                             dim_head=4, dropout_rate=0.0)
    variables = jax.jit(functools.partial(model.init, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 10, 32, 2049)))
    return JTrainState.create(model, variables, j_adam_with_l2())


def test_committed_fixture_reads_as_jax_reads_it():
    """The committed JAX run directory read with both packages: both
    steps' trees bit-equal, 54,997 parameters; the port's restore of step
    4 equals the JAX exporter's ``mgfn_step4.pt`` bit for bit."""
    template = _fixture_template()
    for step in (2, 4):
        tree = read_orbax_step(os.path.join(FIXTURE, "run", str(step)))
        assert_trees_bit_equal(tree, _jax_restored(os.path.join(FIXTURE, "run"), template, step))
    assert sum(a.size for a in jax.tree_util.tree_leaves(tree["params"])) == 54997
    scorer, name = t_infer.build_scorer(_args(checkpoint=os.path.join(FIXTURE, "run")))
    exported = torch.load(os.path.join(FIXTURE, "mgfn_step4.pt"), weights_only=True)
    state = scorer.state_dict()
    assert name == "mgfn" and {k for k, _ in scorer.named_parameters()} <= set(exported)
    for key, value in exported.items():
        assert torch.equal(state[key], value), key


def test_infer_checkpoint_matches_jax_infer(tmp_path, monkeypatch, rng):
    """The port's ``infer --checkpoint --checkpoint-step 2`` and the JAX
    CLI's on the committed JAX run directory (cached features): the same
    files and clip scores within 1e-5 (the latest step is held bit for bit
    to the JAX exporter's file above)."""
    from torch_infer_fixtures import _NoExtractor, _cached_videos

    vids, feats = _cached_videos(tmp_path, rng)
    monkeypatch.setattr(jextraction, "FeatureExtractor", _NoExtractor)
    common = ["--videos", str(vids), "--checkpoint", os.path.join(FIXTURE, "run"),
              "--checkpoint-step", "2", "--features-dir", str(feats)]
    j_infer.main(common + ["--outdir", str(tmp_path / "j")])
    assert t_infer.main(common + ["--outdir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 2
    for name in names:
        ref = json.loads((tmp_path / "j" / name).read_text())
        got = json.loads((tmp_path / "t" / name).read_text())
        assert got["model"] == ref["model"] == "mgfn" and got["n_clips"] == ref["n_clips"]
        np.testing.assert_allclose(got["clip_scores"], ref["clip_scores"], atol=1e-5)


def test_port_resume_keeps_the_jax_steps(tmp_path, capsys):
    """Fault 8: ``run trainer.resume=true`` in a JAX run directory resumes
    at the JAX step (not from scratch), continues its step numbers,
    shuffle order and losses (the committed JAX resumed run's, at 1e-4
    relative), and deletes and overwrites no orbax step that the JAX
    retention policy keeps."""
    with open(os.path.join(FIXTURE, "resume.json")) as f:
        ref = json.load(f)
    data = str(tmp_path / "data")
    chip_smoke.write_training_data(data)
    run = tmp_path / "run"
    shutil.copytree(os.path.join(FIXTURE, "run"), run)
    argv = [o.replace("=data/", f"={data}/") for o in ref["overrides"]]
    capsys.readouterr()
    t_run.main(argv + ["device=cpu", "trainer.resume=true", "trainer.max_epochs=4",
                       f"trainer.log_path={tmp_path}/t.jsonl",
                       f"trainer.checkpoint.dirpath={run}"])
    assert "resumed from step 4" in capsys.readouterr().out
    with open(tmp_path / "t.jsonl") as f:
        got = [json.loads(line) for line in f]
    assert [r["step"] for r in got] == [r["step"] for r in ref["records"]] == [4, 5, 6, 6, 7, 8]
    for g, r in zip(got, ref["records"]):
        for key in ("train_loss", "valid/rec_auc", "valid/pr_auc"):
            if key in r:
                np.testing.assert_allclose(g[key], r[key], rtol=1e-4)
    ckpt = TopKCheckpointer(str(run))
    assert ckpt.all_steps() == [2, 4, 6, 8]
    assert [ckpt.is_orbax(s) for s in ckpt.all_steps()] == [True, True, True, True]
    for step in (2, 4):  # byte for byte the JAX run's
        for path in glob.glob(os.path.join(FIXTURE, "run", str(step), "**"), recursive=True):
            if os.path.isfile(path):
                rel = os.path.relpath(path, os.path.join(FIXTURE, "run"))
                assert (run / rel).read_bytes() == open(path, "rb").read(), rel


# ---------------------------------------------------------- full width (slow)

@pytest.mark.slow
def test_full_width_mgfn_checkpoint_reads_as_jax_reads_it(tmp_path):
    """A full-width MGFN (28.65 M parameters) after two JAX train steps,
    saved by the JAX checkpointer (about 344 MB with the moments): the
    port's tree bit-equal to the JAX restore; prints the read time."""
    from anomaly_detection_on_video_tpu.training.runner import make_train_step

    _, model = j_build_model("mgfn")
    rng = np.random.RandomState(3)
    feats = jnp.asarray(np.abs(rng.randn(4, 10, 32, 2049)).astype(np.float32))
    variables = jax.jit(functools.partial(model.init, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, feats[:2])
    state = JTrainState.create(model, variables, j_adam_with_l2())
    step = make_train_step()
    for i in range(2):
        state, _ = step(state, feats, jnp.zeros((2,)), jnp.ones((2,)), jax.random.PRNGKey(i))
    _save(tmp_path, state, [(2, 0.5)])
    start = time.perf_counter()
    tree = read_orbax_step(str(tmp_path / "2"))
    seconds = time.perf_counter() - start
    assert_trees_bit_equal(tree, _jax_restored(tmp_path, state, 2))
    assert sum(a.size for a in jax.tree_util.tree_leaves(tree["params"])) > 28_000_000
    print(f"read_orbax_step of a full-width MGFN step: {seconds:.2f} s")
