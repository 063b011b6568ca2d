"""Writes ``tests/data/orbax_jax_tiny/``: an orbax checkpoint written by
the JAX package's ``save_checkpoint_orbax``, and ``expected.npz`` of its
leaves (keys: the leaf's key path joined by "/").

The tree is G1's slice of a JAX ``TrainState`` after one train step of
``tests/test_engine.py``'s tiny configuration cut to ngf 1 (a whole state
needs ~120 KB of files even then, 36 KB of it ``_METADATA``): ``step``,
G1's parameters and BatchNorm statistics, optax's chain (the
``ScaleByAdamState`` with its ``count`` and the moments of G1's stem conv,
then the schedule's ``count``), ``k1``, ``k2`` and ``softadapt=None``, so
it holds every key kind the full state has (attribute, dict, sequence,
named-tuple field, a None leaf), int32 and float32 arrays, and zstd
frames of trained floats.

Run from the repository root (JAX on the CPU)::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/orbax_fixture.py
"""
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_jax_tiny")
STEP = 1


def g1_slice(state) -> dict:
    adam, sched = state.opt_g

    def stem(moments):
        return {"g1": {"ConvReflect_0": moments["g1"]["ConvReflect_0"]}}

    return {"step": state.step,
            "g_params": {"g1": state.g_params["g1"]},
            "batch_stats": {"g1": state.batch_stats["g1"]},
            "opt_g": (adam._replace(mu=stem(adam.mu), nu=stem(adam.nu)),
                      sched),
            "k1": state.k1, "k2": state.k2, "softadapt": None}


def flat(tree) -> dict:
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", k))))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, HERE)
    from test_engine import make_batch, setup, tiny_cfg

    from shadow_removal_istd_tpu.engine import checkpoint as ckpt
    from shadow_removal_istd_tpu.engine import make_train_step

    cfg = tiny_cfg(ngf=1, ndf=1, nn_upconv=True)
    models, state = setup(cfg)
    state, _ = make_train_step(models, cfg)(state, make_batch(),
                                            jax.random.key(1))
    tree = jax.device_get(g1_slice(state))
    shutil.rmtree(FIXTURE, ignore_errors=True)
    ckpt.save_checkpoint_orbax(tree, FIXTURE, step=STEP,
                               host={"best_loss": 2.5}, wait=True)
    np.savez_compressed(os.path.join(FIXTURE, "expected.npz"), **flat(tree))


if __name__ == "__main__":
    main()
