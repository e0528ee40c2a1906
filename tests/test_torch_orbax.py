"""The port's reader of the JAX package's orbax checkpoints
(``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/zarr.py``,
``training/orbax.py``, the checkpointer and the CLIs on top) against the
libraries orbax writes with (``zstandard``, ``tensorstore``) and the JAX
package's own ``TopKCheckpointer``, ``infer.py`` and ``run.py``."""

import argparse
import functools
import glob
import json
import os
import shutil
import struct
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

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
from anomaly_detection_on_video_tpu_torch.utils.zarr import read_array

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_mgfn")
C = 64
NARROW = {"mgfn": dict(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C,
                       dropout_rate=0.0),
          "rtfm": dict(channels=C, hidden_dims=(32, 16)),
          "sultani": dict(channels=C, hidden_dims=(32, 16))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(**kw):
    defaults = dict(model=None, model_config=None, checkpoint=None, torch_weights=None,
                    official=False, i3d_weights=None, checkpoint_step="latest", device="cpu")
    return argparse.Namespace(**dict(defaults, **kw))


def _random_like(tree, rng):
    """Every array leaf of ``tree`` replaced by seeded random values of
    its shape and dtype (counts and steps by small integers)."""
    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return jnp.asarray(rng.randint(1, 50, a.shape).astype(a.dtype))
        return jnp.asarray(rng.randn(*a.shape).astype(np.float32)).astype(a.dtype)
    return jax.tree_util.tree_map(leaf, tree)


def _jax_state(name, rng, dtype=jnp.float32, tx=None):
    """A JAX ``TrainState`` of a narrow ``name`` whose params, batch stats,
    Adam moments and step are all random (so no leaf is zero or default)."""
    _, model = j_build_model(name, **NARROW[name])
    variables = jax.jit(functools.partial(model.init, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 10, 8, C + 1)))
    params = jax.tree_util.tree_map(lambda a: a.astype(dtype), variables["params"])
    state = JTrainState.create(model, dict(variables, params=params), tx or j_adam_with_l2())
    return state.replace(params=_random_like(state.params, rng),
                         batch_stats=_random_like(state.batch_stats, rng),
                         opt_state=_random_like(state.opt_state, rng),
                         step=jnp.asarray(rng.randint(1, 1000), jnp.int32))


def _save(directory, state, steps_metrics, top_k=10):
    ckpt = JCheckpointer(str(directory), top_k=top_k)
    for step, metric in steps_metrics:
        ckpt.save(step, state, metric)
    ckpt.wait()
    return ckpt


def _named_leaves(tree):
    """{dotted key path: numpy array} of a JAX pytree or of the port's
    nested dicts and lists (bfloat16 tensors as their int16 bits)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                        for p in path)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.view(torch.int16).numpy()
        elif np.asarray(leaf).dtype == jnp.bfloat16:
            leaf = np.asarray(leaf).view(np.int16)
        out[name] = np.asarray(leaf)
    return out


def assert_trees_bit_equal(got, want):
    got, want = _named_leaves(got), _named_leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def _jax_restored(directory, state, step):
    restored = JCheckpointer(str(directory)).restore(state, step=step)
    return {"params": restored.params, "batch_stats": restored.batch_stats,
            "opt_state": restored.opt_state, "step": restored.step}


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


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["float32", "zeros", "json"])
def test_zstd_matches_zstandard(level, kind):
    """Frames zstandard writes, with and without the content size (the
    streaming route), decode byte-equal."""
    rng = np.random.RandomState(level)
    data = {"float32": rng.randn(70000).astype(np.float32).tobytes(),
            "zeros": bytes(300001),
            "json": json.dumps({"k": rng.randint(0, 9, 3000).tolist()}).encode()}[kind]
    with_size = zstandard.ZstdCompressor(level=level).compress(data)
    stream = zstandard.ZstdCompressor(level=level, write_content_size=False).compress(data)
    assert zstd.decompress(with_size) == zstd.decompress(stream) == data


def test_zstd_decodes_a_large_streamed_frame():
    """A 6 MB frame written in 64 KiB pieces with no content size (as
    tensorstore writes a large chunk): the decoder takes input into its
    own buffer ahead of its output."""
    data = np.random.RandomState(4).randn(1_500_000).astype(np.float32).tobytes()
    writer = zstandard.ZstdCompressor(level=1).compressobj()
    frame = b"".join(writer.compress(data[i:i + 65536]) for i in range(0, len(data), 65536))
    frame += writer.flush()
    assert zstd.decompress(frame) == data
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[:-100])


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=5000), st.integers(1, 19), st.booleans())
def test_zstd_matches_zstandard_on_any_bytes(data, level, size):
    frame = zstandard.ZstdCompressor(level=level, write_content_size=size).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_refuses_what_is_not_a_frame():
    frame = zstandard.ZstdCompressor(level=3).compress(b"abc" * 1000)
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\x00" + frame)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frame[: len(frame) // 2])


# ----------------------------------------------------------------- OCDBT

def _tensorstore_db(path, commits=20, keys_per_commit=8):
    """A database written through tensorstore's ocdbt driver with nodes of
    at most 256 bytes (interior b-tree nodes) and ``commits`` commits (more
    than 16: a version tree of more than one node), some values above the
    16-byte inline limit."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.RandomState(1)
    for c in range(commits):
        for _ in range(keys_per_commit):
            key = f"key{c:03d}/{rng.randint(0, 1000):04d}"
            kv.write(key, bytes(rng.randint(0, 256, rng.randint(0, 64)).astype(np.uint8))).result()
    return kv


def _assert_store_equal(path, kv=None):
    kv = kv or ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    store = ocdbt.OcdbtStore(str(path))
    want = kv.list().result()
    assert store.list() == sorted(want)
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    return store


@pytest.mark.parametrize("db", ["fixture_root", "fixture_process", "tensorstore"])
def test_ocdbt_matches_tensorstore(db, tmp_path):
    """``list()`` and every ``read()`` equal tensorstore's on an orbax
    step's root database (its values in ``ocdbt.process_0/``), the process
    database (values above the 1 KiB inline limit, in data files), and a
    database of 20 commits with 256-byte nodes (interior nodes, and a
    version tree with nodes of its own)."""
    if db == "tensorstore":
        kv = _tensorstore_db(str(tmp_path))
        store = _assert_store_equal(str(tmp_path), kv)
        assert store.latest.root_height >= 2 and len(store.versions) == 161
        assert [v.generation for v in store.versions] == list(range(1, 162))
        return
    default = os.path.join(FIXTURE, "run", "4", "default")
    path = default if db == "fixture_root" else os.path.join(default, "ocdbt.process_0")
    store = _assert_store_equal(path)
    sizes = [len(store.read(k)) for k in store.list()]
    assert max(sizes) > store.config.max_inline_value_bytes == 1024


def test_ocdbt_checks_every_file(tmp_path):
    """One flipped byte in a manifest or a node fails its CRC32C; an
    absent key raises KeyError."""
    _tensorstore_db(str(tmp_path / "db"), commits=3)
    for victim in ("manifest.ocdbt", "node"):
        db = tmp_path / victim.replace(".", "_")
        shutil.copytree(tmp_path / "db", db)
        store = ocdbt.OcdbtStore(str(db))
        loc = store.latest.root
        path, offset = (db / "manifest.ocdbt", 20) if victim == "manifest.ocdbt" else (
            db / loc.path, loc.offset + 20)
        data = bytearray(path.read_bytes())
        data[offset] ^= 0x01
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="CRC32C"):
            ocdbt.OcdbtStore(str(db)).list()
    with pytest.raises(KeyError):
        ocdbt.OcdbtStore(str(tmp_path / "db")).read("no such key")
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# ------------------------------------------------------------------ zarr

@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "<u4", "|b1", "|u1", "bfloat16"])
def test_zarr_arrays_match_tensorstore(dtype, tmp_path):
    """zarr v2 arrays tensorstore writes into an OCDBT store: a 5x7 array
    in 2x3 chunks (edge chunks padded), zstd and uncompressed, one chunk
    never written (read as fill_value, or zeros when it is null), and a
    0-d array."""
    rng = np.random.RandomState(2)
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    wants = {}
    for name, shape, chunks, compressor, fill in (
            ("a", [5, 7], [2, 3], {"id": "zstd", "level": 1}, None),
            ("b", [5, 7], [2, 3], None, True if dtype == "|b1" else 1),
            ("s", [], [], {"id": "zstd", "level": 3}, None)):
        spec = {"driver": "zarr", "kvstore": dict(base, path=f"{name}/"),
                "metadata": {"shape": shape, "chunks": chunks, "dtype": dtype,
                             "compressor": compressor, "fill_value": fill}}
        arr = ts.open(spec, create=True).result()
        values = np.asarray(rng.randn(*shape) * 5).astype(arr.dtype.numpy_dtype)
        if shape:
            arr[2:, :] = values[2:]
        else:
            arr[...] = values
        wants[name] = np.asarray(arr.read().result())
    kv = ts.KvStore.open(base).result()
    keys = {k.decode() for k in kv.list().result()}
    assert "a/0.0" not in keys and "a/2.2" in keys
    for name, want in wants.items():
        got = read_array(lambda k: kv.read(k).result().value, keys, name)
        if dtype == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name


def test_zarr_refuses_fortran_order():
    meta = {"zarr_format": 2, "shape": [2, 2], "chunks": [2, 2], "dtype": "<f4",
            "compressor": None, "fill_value": None, "filters": None, "order": "F"}
    with pytest.raises(ValueError, match="order 'F'"):
        read_array(lambda k: json.dumps(meta).encode(), set(), "x")


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
    from test_torch_infer import _NoExtractor, _cached_videos

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


def test_ocdbt_header_layout():
    """The fixed header the reader checks: magic (big-endian), the file's
    length, a version and compression byte before the zstd body."""
    data = open(os.path.join(FIXTURE, "run", "4", "default", "manifest.ocdbt"), "rb").read()
    assert struct.unpack(">I", data[:4])[0] == ocdbt.MANIFEST_MAGIC
    assert struct.unpack("<Q", data[4:12])[0] == len(data) and data[12:14] == b"\x00\x01"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ocdbt.decode_file(data, ocdbt.MANIFEST_MAGIC, "manifest")
    with pytest.raises(ValueError, match="magic"):
        ocdbt.decode_file(data, ocdbt.BTREE_MAGIC, "manifest")
