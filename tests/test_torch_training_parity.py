"""PyTorch port vs the JAX package: training and weights parity.

The port's flax msgpack codec against flax's (bytes and values, chunked
leaves, the refusals), ``.msgpack`` I3D weights through ``load_i3d_weights``
and the inverse converter, the runner's prefetching loader and evaluation
(bit-equal to the serial loops, and to the JAX runner at the tolerances of
``tests/test_torch_runner_loop.py``), MGFN's feed-forward dropout (eval mode and
one fixed mask against the JAX model at float32 tolerance, the port's own
draws), ``run -m`` sweeps against the root ``run.py``, ``to_container`` and
``trace``. The port's new modules import no JAX, flax or msgpack.
"""

import glob
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

import run as j_run
from anomaly_detection_on_video_tpu.config import compose as j_compose
from anomaly_detection_on_video_tpu.config import to_container as j_to_container
from anomaly_detection_on_video_tpu.data import features as jfeatures
from anomaly_detection_on_video_tpu.models.mgfn import MGFNConfig as JConfig
from anomaly_detection_on_video_tpu.models.mgfn import MGFNForVideoAnomalyDetection
from anomaly_detection_on_video_tpu.training import runner as jrunner
from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam_with_l2
from anomaly_detection_on_video_tpu.utils import serialization as jserialization
from anomaly_detection_on_video_tpu.utils.convert import convert_i3res50_state_dict
from anomaly_detection_on_video_tpu_torch import run as t_run
from anomaly_detection_on_video_tpu_torch.config import compose, to_container
from anomaly_detection_on_video_tpu_torch.data import features as tfeatures
from anomaly_detection_on_video_tpu_torch.infer import load_i3d_weights
from anomaly_detection_on_video_tpu_torch.models.mgfn import MGFN, MGFNConfig
from anomaly_detection_on_video_tpu_torch.models import i3d as ti3d
from anomaly_detection_on_video_tpu_torch.models.mgfn import model as tmgfn_model
from anomaly_detection_on_video_tpu_torch.training import runner as trunner
from anomaly_detection_on_video_tpu_torch.training.runner import (
    TrainState,
    VideoAnomalyDetectionRunner,
)
from anomaly_detection_on_video_tpu_torch.utils import serialization as tserialization
from anomaly_detection_on_video_tpu_torch.utils.convert import (
    i3d_state_dict_from_flax,
    i3d_state_dict_to_flax,
    mgfn_state_dict_from_flax,
)
from anomaly_detection_on_video_tpu_torch.utils.profiling import trace
from test_torch_mgfn import randomize_norms
from torch_port_fixtures import jax_compile_cache  # autouse: one XLA cache per worker
from torch_runner_fixtures import C, NARROW_MGFN, write_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TINY = dict(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C, dropout_rate=0.0)
ONE_BUCKET = (20, 9, 31, 12)  # test videos' clip counts that share the 32-clip eval bucket


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread, as in tests/test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in key order."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        value = np.asarray(value)
        assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))


# -------------------------------------------------------- msgpack weights

@pytest.fixture(scope="module")
def flax_i3d():
    """Seeded I3D variables in the flax layout: a narrow non-local i3res50
    (stem, branches, projections and ``NonLocalBlock_0`` in stages 2 and 3)
    with random BatchNorm, through the JAX package's
    ``convert_i3res50_state_dict`` (what ``scripts/convert_checkpoint.py
    --kind i3d`` writes; every I3D backbone shares the layout)."""
    torch.manual_seed(20)
    model = ti3d.I3DResNet(((8, 1, 1, (3,), (1,)), (8, 2, 2, (3, 1), (1, 1)),
                            (16, 2, 2, (1, 3), (1, 1))), nonlocal_stages=(1, 2))
    with torch.no_grad():
        for name, value in model.state_dict().items():
            if value.is_floating_point():
                value.copy_(torch.rand_like(value) + 0.5 if name.endswith("running_var")
                            else torch.randn_like(value) * 0.1)
    return jax.tree_util.tree_map(np.asarray, convert_i3res50_state_dict(model.state_dict()))


def test_msgpack_i3d_weights_match_flax(flax_i3d, tmp_path):
    """The JAX ``save_variables`` file read by the port's codec, bit for bit;
    the port's file byte-equal to flax's and read back by the JAX
    ``load_variables``; ``load_i3d_weights`` of the file (its route does not
    depend on the backbone's name) is the JAX route's state dict (``i3d_state_dict_from_flax`` of
    the JAX ``load_variables``); ``i3d_state_dict_to_flax`` inverts
    ``i3d_state_dict_from_flax`` exactly and names a key it has no place for."""
    variables = flax_i3d
    assert "NonLocalBlock_0" in variables["params"]["stage2_block1"]
    jax_file, port_file = str(tmp_path / "jax.msgpack"), str(tmp_path / "port" / "port.msgpack")
    jserialization.save_variables(jax_file, variables)
    assert_trees_equal(tserialization.load_variables(jax_file), variables)
    tserialization.save_variables(port_file, variables)
    with open(jax_file, "rb") as a, open(port_file, "rb") as b:
        assert a.read() == b.read()
    assert_trees_equal(jserialization.load_variables(port_file), variables)

    got = load_i3d_weights(jax_file, "tushar-n-baseline")
    want = i3d_state_dict_from_flax(jserialization.load_variables(jax_file))
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=0, atol=0)

    assert_trees_equal(i3d_state_dict_to_flax(got), variables)
    again = i3d_state_dict_from_flax(i3d_state_dict_to_flax(got))
    assert list(again) == list(got)
    for key, value in got.items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)
    with pytest.raises(KeyError, match="fc.weight"):
        i3d_state_dict_to_flax({**got, "fc.weight": torch.zeros(4, 8)})


def test_msgpack_chunked_leaves_and_refusals(monkeypatch, tmp_path):
    """flax's chunked layout for a leaf over MAX_CHUNK_SIZE reads back
    reassembled, and the port's writer refuses such a leaf, naming it; an
    ext code flax does not write for variables, and a bfloat16 leaf, raise
    ValueError naming them."""
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(tserialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.RandomState(3)
    tree = {"params": {"big": rng.randn(7, 30).astype(np.float32),
                       "small": rng.randn(5).astype(np.float64), "step": np.int32(4)},
            "meta": {"name": "i3d", "lr": 1e-3, "n": -70000, "flag": True, "none": None}}
    data = flax_serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    restored = tserialization.msgpack_restore(data)
    np.testing.assert_array_equal(restored["params"]["big"], tree["params"]["big"])
    assert restored["params"]["step"] == np.int32(4) and type(restored["params"]["step"]) is np.int32
    assert restored["meta"] == tree["meta"]
    with pytest.raises(ValueError, match="/params/big holds 840 bytes"):
        tserialization.msgpack_serialize(tree)
    del tree["params"]["big"]
    assert tserialization.msgpack_serialize(tree) == flax_serialization.msgpack_serialize(tree)

    # a one-entry map {"w": ext type 5, 4 bytes}
    with pytest.raises(ValueError, match="ext type 5"):
        tserialization.msgpack_restore(b"\x81\xa1w\xd6\x05abcd")
    bf16 = flax_serialization.msgpack_serialize({"w": jnp.ones((2,), jnp.bfloat16)})
    with pytest.raises(ValueError, match="bfloat16"):
        tserialization.msgpack_restore(bf16)
    with pytest.raises(ValueError, match="truncated"):
        tserialization.msgpack_restore(data[:-3])


def test_new_modules_import_no_jax_flax_or_msgpack(tmp_path):
    """With jax, flax, msgpack, orbax, tensorstore, zstandard, numcodecs and
    the JAX package made unimportable, the port's new modules import, its
    codec writes and reads a file, and it reads and restores the committed
    orbax run directory (tests/data/orbax_mgfn)."""
    fixture = os.path.join(REPO, "tests", "data", "orbax_mgfn", "run")
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'orbax', 'tensorstore', 'zstandard', 'numcodecs',\n"
        "             'anomaly_detection_on_video_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from anomaly_detection_on_video_tpu_torch import infer, run, extract_features\n"
        "from anomaly_detection_on_video_tpu_torch.config import to_container\n"
        "from anomaly_detection_on_video_tpu_torch.models.mgfn import model\n"
        "from anomaly_detection_on_video_tpu_torch.training import runner\n"
        "from anomaly_detection_on_video_tpu_torch.utils import convert, profiling, serialization\n"
        "tree = {'params': {'w': np.arange(6.0).reshape(2, 3)}, 'n': 3}\n"
        f"serialization.save_variables({str(tmp_path / 'x.msgpack')!r}, tree)\n"
        f"back = serialization.load_variables({str(tmp_path / 'x.msgpack')!r})\n"
        "assert back['n'] == 3 and (back['params']['w'] == tree['params']['w']).all()\n"
        "from anomaly_detection_on_video_tpu_torch.training import checkpoints, orbax\n"
        "from anomaly_detection_on_video_tpu_torch.utils import ocdbt, zarr, zstd\n"
        f"assert int(orbax.read_orbax_step({os.path.join(fixture, '4')!r})['step']) == 4\n"
        "scorer, name = infer.build_scorer(infer.build_parser().parse_args(\n"
        f"    ['--outdir', 'x', '--checkpoint', {fixture!r}, '--device', 'cpu']))\n"
        "assert name == 'mgfn' and scorer.config.channels == 2048\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0 and result.stdout.strip() == "ok", result.stderr


# ------------------------------------------------- prefetch: fit, evaluate

class _Losses:
    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append((step, dict(metrics)))

    def values(self, key):
        return [m[key] for _, m in self.records if key in m]


@pytest.fixture(scope="module")
def tiny_variables():
    """A flax MGFN init at ``TINY`` with randomized norms (no ties in the
    top-k), shared by the runner and dropout tests (the feed-forward
    dropout adds no parameter)."""
    model = MGFNForVideoAnomalyDetection(JConfig(**TINY))
    video = jnp.zeros((2, 10, 32, C + 1), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, randomize_norms(
        jax.jit(model.init)(jax.random.PRNGKey(0), video), np.random.RandomState(5)))


def _port_fit(variables, datasets, valid, num_workers, accumulate=1, **fit_kwargs):
    logger = _Losses()
    runner = VideoAnomalyDetectionRunner(MGFN(MGFNConfig(**TINY)), data_cfg={"num_workers": num_workers},
                                         loggers=[logger], accumulate_grad_batches=accumulate,
                                         device="cpu")
    runner.init_state()
    runner.state.model.load_state_dict(mgfn_state_dict_from_flax(variables))
    result = runner.fit(datasets, valid_dataset=valid, batch_size=2, **fit_kwargs)
    return logger, runner, result


def _assert_same_run(a, b):
    (log_a, runner_a, result_a), (log_b, runner_b, result_b) = a, b
    assert log_a.values("train_loss") == log_b.values("train_loss")
    for key, value in runner_a.state.model.state_dict().items():
        assert torch.equal(value, runner_b.state.model.state_dict()[key]), key
    if result_a is not None:
        assert (result_a.rec_auc, result_a.pr_auc) == (result_b.rec_auc, result_b.pr_auc)
        np.testing.assert_array_equal(result_a.preds, result_b.preds)


def test_fit_prefetch_is_bit_equal_and_matches_jax(rng, tmp_path, tiny_variables):
    """``data.num_workers`` 8 (the config's value: the prefetch thread) and
    0 (the serial loop) give bit-equal losses, parameters and AUCs, and both
    follow the JAX runner (prefetching too) at rtol 1e-4 on the losses and
    atol 1e-4 on the AUCs."""
    train, test, _, gt_path = write_features(str(tmp_path), rng, test_clips=ONE_BUCKET)
    datasets = tfeatures.build_feature_dataset("train", local_path=train)
    valid = tfeatures.build_feature_dataset("test", local_path=test, ground_truth_path=gt_path)
    variables = tiny_variables
    serial = _port_fit(variables, datasets, valid, 0, max_epochs=2)
    prefetched = _port_fit(variables, datasets, valid, 8, max_epochs=2)
    _assert_same_run(serial, prefetched)

    j_logger = _Losses()
    jmodel = MGFNForVideoAnomalyDetection(JConfig(**TINY))
    jr = jrunner.VideoAnomalyDetectionRunner(jmodel, data_cfg={"num_workers": 8}, loggers=[j_logger])
    jr.state = jrunner.TrainState.create(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                                         j_adam_with_l2(1e-3, 5e-4))
    j_result = jr.fit(jfeatures.build_feature_dataset("train", local_path=train),
                      valid_dataset=jfeatures.build_feature_dataset(
                          "test", local_path=test, ground_truth_path=gt_path),
                      max_epochs=2, batch_size=2)
    got = prefetched[0].values("train_loss")
    assert len(got) == 4
    np.testing.assert_allclose(got, j_logger.values("train_loss"), rtol=1e-4)
    np.testing.assert_allclose([prefetched[2].rec_auc, prefetched[2].pr_auc],
                               [j_result.rec_auc, j_result.pr_auc], atol=1e-4)


def test_fit_prefetch_with_accumulation_is_bit_equal(rng, tmp_path, tiny_variables):
    """k = 2 micro-batches per step, stacked on the prefetch thread."""
    train, _, _, _ = write_features(str(tmp_path), rng, n_train=6)
    datasets = tfeatures.build_feature_dataset("train", local_path=train)
    runs = [_port_fit(tiny_variables, datasets, None, workers, accumulate=2, max_epochs=2)
            for workers in (0, 8)]
    assert len(runs[0][0].values("train_loss")) == 4
    _assert_same_run(*runs)


def test_fit_stopping_mid_epoch_leaves_no_prefetch_thread(rng, tmp_path):
    """``max_steps`` stops the first epoch after one of four steps while the
    thread holds the next ones: fit closes the loader, so no
    ``batch-prefetch`` thread outlives it."""
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    datasets = tfeatures.build_feature_dataset("train", local_path=train, dynamic_load=True)
    valid = tfeatures.build_feature_dataset("test", local_path=test, ground_truth_path=gt_path)
    logger = _Losses()
    runner = VideoAnomalyDetectionRunner(MGFN(MGFNConfig(**TINY)), data_cfg={"num_workers": 8},
                                         loggers=[logger], device="cpu")
    runner.fit(datasets, valid_dataset=valid, batch_size=1, max_epochs=3, max_steps=1)
    assert runner.state.step == 1 and len(logger.values("train_loss")) == 1
    assert not [t for t in threading.enumerate() if t.name == "batch-prefetch" and t.is_alive()]


def test_evaluate_prefetch_matches_serial_and_jax(rng, tmp_path, tiny_variables):
    """``prefetch_assembly`` on and off: equal scores and AUCs, both equal
    to the JAX ``evaluate`` at atol 1e-5 (scores) and 1e-6 (AUCs), over
    four groups in two buckets (two in flight before a readback)."""
    _, test, _, gt_path = write_features(str(tmp_path), rng)
    variables = tiny_variables
    port = MGFN(MGFNConfig(**TINY))
    port.load_state_dict(mgfn_state_dict_from_flax(variables))
    state = TrainState(port, None)
    valid = tfeatures.build_feature_dataset("test", local_path=test, ground_truth_path=gt_path)
    on = trunner.evaluate(state, valid, prefetch_assembly=True)
    off = trunner.evaluate(state, valid, prefetch_assembly=False)
    np.testing.assert_array_equal(on.preds, off.preds)
    assert (on.rec_auc, on.pr_auc) == (off.rec_auc, off.pr_auc)

    jmodel = MGFNForVideoAnomalyDetection(JConfig(**TINY))
    jstate = jrunner.TrainState.create(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                                       j_adam_with_l2(1e-3, 5e-4))
    ref = jrunner.evaluate(jstate, jfeatures.build_feature_dataset(
        "test", local_path=test, ground_truth_path=gt_path))
    np.testing.assert_allclose(on.preds, ref.preds, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(on.labels, ref.labels)
    np.testing.assert_allclose([on.rec_auc, on.pr_auc], [ref.rec_auc, ref.pr_auc], atol=1e-6)


# ------------------------------------------------- feed-forward dropout

def _dropout_pair(variables, dropout=0.3):
    cfg = dict(TINY, dropout=dropout)
    port = MGFN(MGFNConfig(**cfg))
    port.load_state_dict(mgfn_state_dict_from_flax(variables))
    return MGFNForVideoAnomalyDetection(JConfig(**cfg)), port


def _video(seed, bs=4, t=16):
    return (np.abs(np.random.RandomState(seed).randn(bs, 10, t, C + 1)) * 0.5).astype(np.float32)


def test_dropout_eval_mode_matches_jax(tiny_variables):
    """dropout 0.3 in eval mode drops nothing: the port's scores equal the
    JAX model's at atol 1e-5 and the port's own at dropout 0 exactly."""
    model, port = _dropout_pair(tiny_variables)
    video = _video(8)
    ref = np.asarray(jax.jit(lambda v, x: model.apply(v, x).scores)(tiny_variables,
                                                                    jnp.asarray(video)))
    plain = MGFN(MGFNConfig(**TINY)).eval()
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(video))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
        assert torch.equal(got, plain(torch.from_numpy(video)))


def test_dropout_train_mode_matches_jax_at_a_fixed_mask(monkeypatch, tiny_variables):
    """Train mode at dropout 0.3 (selection dropout off): the flax run's
    keep masks, read off its captured GELU and Dropout outputs, are handed
    to the port in module order; every block's FFN output and the loss
    then match the JAX model at float32 tolerance (atol 1e-5, rtol 1e-5)."""
    model, port = _dropout_pair(tiny_variables)
    video = _video(9)
    nlabels, alabels = np.zeros(2, np.float32), np.ones(2, np.float32)

    def train_apply(variables, video, key):
        out, state = model.apply(
            variables, video, abnormal_labels=jnp.asarray(alabels),
            normal_labels=jnp.asarray(nlabels), train=True, rngs={"dropout": key},
            capture_intermediates=True, mutable=["batch_stats", "intermediates"])
        return out.loss, state["intermediates"]["backbone"]  # the model's own output is no array

    loss, backbone = jax.jit(train_apply)(tiny_variables, jnp.asarray(video),
                                          jax.random.PRNGKey(4))
    blocks = sorted(k for k in backbone if k.startswith("stage") and "ffn" in backbone[k])
    masks, ffn_outs = [], []
    for name in blocks:
        ffn = backbone[name]["ffn"]
        gelu = jax.nn.gelu(ffn["in_conv"]["__call__"][0], approximate=False)
        dropped = np.asarray(ffn["Dropout_0"]["__call__"][0])
        assert np.all(np.asarray(gelu) != 0)  # so a zero output marks a dropped value
        masks.append(torch.from_numpy(dropped != 0).transpose(1, 2))  # (B, C, T), channels first
        ffn_outs.append(np.asarray(ffn["__call__"][0]))
    keep_share = float(np.mean([m.float().mean() for m in masks]))
    assert 0.5 < keep_share < 0.9  # the masks do drop
    handed = iter(masks)

    def fixed_mask(x, rate, generator, shard=None):
        """``common.dropout``'s rule at the next flax keep mask."""
        keep = next(handed)
        assert tuple(keep.shape) == tuple(x.shape) and rate == 0.3 and shard is None
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    monkeypatch.setattr(tmgfn_model, "dropout", fixed_mask)
    captured = []
    for stage in port.backbone.layers:
        for block in stage:
            if hasattr(block, "ffn"):
                block.ffn.register_forward_hook(lambda m, i, o: captured.append(o.detach()))
    got = port.train().outputs(torch.from_numpy(video), torch.from_numpy(alabels),
                               torch.from_numpy(nlabels), generator=torch.Generator())
    assert next(handed, None) is None and len(captured) == len(blocks) == 3
    for name, mine, ref in zip(blocks, captured, ffn_outs):
        np.testing.assert_allclose(mine.transpose(1, 2).numpy(), ref, atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(float(got.loss.detach()), float(loss), atol=1e-5, rtol=1e-5)


def test_dropout_keep_share_and_generator_draws(tiny_variables):
    """The keep share of a 1000 x 1000 mask at rate 0.3 lies within 0.005 of
    0.7 (about 10 standard deviations); two train-mode runs from one
    generator seed are bit-equal and differ from another seed's; the masks
    need an explicit generator."""
    kept = tmgfn_model.dropout(torch.ones(1000, 1000), 0.3, torch.Generator().manual_seed(0))
    assert abs(float((kept != 0).float().mean()) - 0.7) < 0.005
    _, port = _dropout_pair(tiny_variables)
    port.train()
    video = torch.from_numpy(_video(10))
    labels = torch.zeros(2), torch.ones(2)
    state = {k: v.clone() for k, v in port.state_dict().items()}

    def loss(seed):
        port.load_state_dict(state)  # the BN statistics move in train mode
        return port.outputs(video, labels[1], labels[0],
                            generator=torch.Generator().manual_seed(seed)).loss

    assert torch.equal(loss(1), loss(1))
    assert not torch.equal(loss(1), loss(2))
    with pytest.raises(ValueError, match="Generator"):
        port.outputs(video, labels[1], labels[0])


# -------------------------------------------------------------- multirun

@pytest.mark.parametrize("argv", [
    ["runner=mgfn", "seed=1,2", "data.batch_size=4,8"],
    ["a.b=[1,2]"],
    ["a.b='x,y'"],
    ["runner=mgfn"],
])
def test_expand_multirun_matches_run_py(argv):
    """tests/test_integration.py's grammar cases."""
    assert t_run.expand_multirun(argv) == j_run.expand_multirun(argv)


def test_multirun_sweep_matches_run_py(rng, tmp_path, monkeypatch):
    """A 2-job sweep through the port's ``run.main([..., "-m",
    "device=cpu"])``: the jobs the root ``run.py`` launches for the same
    arguments (its processes replaced by a recorder) get the same overrides
    and writer paths, and ``multirun.jsonl`` holds the same lines. Job 0
    runs as a process (job 1 is recorded: each job imports torch); it logs
    its AUCs to its own ``metrics.jsonl``, and its losses equal a direct
    port run with ``seed=1``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    train, test, _, gt_path = write_features(str(tmp_path), rng)
    common = ["runner=mgfn", f"data.train_path={train}", f"data.test_path={test}",
              f"data.ground_truth_path={gt_path}", "data.batch_size=2", "trainer.max_epochs=1",
              "trainer.data_parallel=false"] + NARROW_MGFN
    sweep = ["-m", "seed=1,2", f"trainer.checkpoint.dirpath={tmp_path}/ckpt"]

    launched = {"jax": [], "port": []}
    real_run = subprocess.run

    def recorder(cmd, **kwargs):
        launched["jax"].append(cmd[2:])  # after the interpreter and run.py
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", recorder)
    j_run.main(common + sweep + ["--multirun-dir", str(tmp_path / "sweep")])

    def port_jobs(cmd, **kwargs):
        launched["port"].append(cmd[3:])  # after the interpreter, -m and the module
        if len(launched["port"]) == 1:
            return real_run(cmd, **kwargs)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", port_jobs)
    os.rename(tmp_path / "sweep", tmp_path / "jax_sweep")
    t_run.main(common + sweep + ["device=cpu", "--multirun-dir", str(tmp_path / "sweep")])
    monkeypatch.setattr(subprocess, "run", real_run)

    assert [cmd[-1] for cmd in launched["port"]] == ["device=cpu"] * 2
    assert [cmd[:-1] for cmd in launched["port"]] == launched["jax"]
    assert any(arg == f"trainer.log_path={tmp_path}/sweep/0/metrics.jsonl"
               for arg in launched["port"][0])

    def lines(root):
        with open(root / "multirun.jsonl") as f:
            return [json.loads(line) for line in f]

    jobs = lines(tmp_path / "sweep")
    want = [dict(j, dir=j["dir"].replace("jax_sweep", "sweep")) for j in lines(tmp_path / "jax_sweep")]
    assert jobs == want and [j["returncode"] for j in jobs] == [0, 0]
    with open(os.path.join(jobs[0]["dir"], "metrics.jsonl")) as f:
        job0 = [json.loads(line) for line in f]
    assert any("valid/rec_auc" in r for r in job0)
    t_run.main(common + ["seed=1", "device=cpu", f"trainer.log_path={tmp_path}/direct.jsonl",
                         f"trainer.checkpoint.dirpath={tmp_path}/direct_ckpt"])
    with open(tmp_path / "direct.jsonl") as f:
        direct = [json.loads(line) for line in f]
    losses = [[r["train_loss"] for r in m if "train_loss" in r] for m in (job0, direct)]
    assert losses[0] == losses[1] and len(losses[0]) == 2


# ------------------------------------------------- to_container, trace

def test_to_container_matches_jax_and_is_a_copy():
    cfg = compose(CONFIGS, "default", ["runner=mgfn"])
    got = to_container(cfg)
    assert got == j_to_container(j_compose(CONFIGS, "default", ["runner=mgfn"]))
    got["runner"]["model_config"]["dims"].append(7)
    got["data"]["batch_size"] = -1
    assert cfg["runner"]["model_config"]["dims"] == [64, 128, 1024]
    assert cfg["data"]["batch_size"] == 16


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """``trace`` records one MGFN scoring call and writes a Chrome trace
    whose events name the convolutions it ran."""
    port = MGFN(MGFNConfig(**TINY)).eval()
    with trace(str(tmp_path / "trace")) as prof:
        with torch.no_grad():
            port(torch.from_numpy(_video(11, bs=1)))
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv1d" in names
    assert any(e.key == "aten::conv1d" for e in prof.key_averages())
