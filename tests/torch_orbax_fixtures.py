"""Helpers of the port's orbax tests (``tests/test_torch_orbax_*.py``):
narrow JAX train states with random leaves, the JAX checkpointer's save
and restore, and a bit-for-bit comparison of two trees. Not a test module.
"""

import argparse
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from anomaly_detection_on_video_tpu.models import build_model as j_build_model
from anomaly_detection_on_video_tpu.training.checkpoints import TopKCheckpointer as JCheckpointer
from anomaly_detection_on_video_tpu.training.optim import adam_with_l2 as j_adam_with_l2
from anomaly_detection_on_video_tpu.training.runner import TrainState as JTrainState


HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_mgfn")
C = 64
NARROW = {"mgfn": dict(dims=(16, 16, 32), depths=(1, 1, 1), dim_head=8, channels=C,
                       dropout_rate=0.0),
          "rtfm": dict(channels=C, hidden_dims=(32, 16)),
          "sultani": dict(channels=C, hidden_dims=(32, 16))}


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
