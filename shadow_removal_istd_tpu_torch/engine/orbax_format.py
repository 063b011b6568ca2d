"""The orbax ``StandardCheckpointer`` directory of a JAX ``TrainState``,
read and written without orbax.

A ``step_N`` directory holds ``_METADATA`` (JSON: the tree's key paths and
value types, ``use_ocdbt: true``, ``use_zarr3: false``),
``_CHECKPOINT_METADATA`` (JSON: the handler and the init and commit
times), and an OCDBT database (``utils/ocdbt.py``) whose keys are zarr v2
arrays (``utils/zarr2.py``), one per array leaf, named by the leaf's keys
joined with ".".

Key paths are JAX's, not flax's state-dict names: orbax flattens
``TrainState`` by attribute (``step``, ``g_params``, ..., ``softadapt``),
optax's chain by sequence index (``opt_g``, ``0``), ``ScaleByAdamState``
and ``SoftAdaptState`` by field (``count``/``mu``/``nu``,
``weights``/``prev_loss``, in field order) and flax's dicts by sorted key.
``_METADATA`` marks a sequence key with ``key_type`` 1 and every other
key with 2. Leaves without arrays stay in the tree with
``skip_deserialize``: an empty dict (the batch statistics of a network
without BatchNorm) as ``Dict``; optax's ``EmptyState`` (the constant
rate's stage under the plateau schedule, ``{}`` in the flax tree) and a
``softadapt`` of None as ``None``.

:func:`write_step` and :func:`read_step` carry the flax tree of
``tools/convert.py::train_state_to_flax`` (numpy leaves, ``"0"``/``"1"``
for the chain's stages) to and from such a directory. :func:`write_step`
stages the directory under ``step_N.orbax-checkpoint-tmp-<n>``, which
``latest_orbax_step`` on either side skips, and renames it to ``step_N``
once every file is written.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from collections.abc import Mapping

import numpy as np

from shadow_removal_istd_tpu_torch.utils import ocdbt, zarr2

HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
TMP_MARK = ".orbax-checkpoint-tmp-"
_DICT, _SEQUENCE = 2, 1
_OPTS = ("opt_g", "opt_d")

Path = tuple[tuple[str, int], ...]


def _flatten(node, path: Path, out: list) -> None:
    if isinstance(node, Mapping):
        if not node:
            # optax's EmptyState is orbax's "None"; an empty dict is "Dict"
            empty_state = (len(path) == 2 and path[0][0] in _OPTS)
            out.append((path, "None" if empty_state else "Dict"))
            return
        seq = len(path) == 1 and path[0][0] in _OPTS
        for k, v in node.items():
            _flatten(v, path + ((str(k), _SEQUENCE if seq else _DICT),), out)
    elif node is None:
        out.append((path, "None"))
    else:
        out.append((path, np.asarray(node)))


def leaves(tree: Mapping) -> list[tuple[Path, object]]:
    """``(key path, leaf)`` in orbax's order; a leaf is a numpy array or
    the value type of a leaf without one (``"Dict"``, ``"None"``)."""
    out: list = []
    for k, v in tree.items():
        _flatten(v, ((k, _DICT),), out)
    return out


def metadata(tree: Mapping) -> dict:
    """The ``_METADATA`` orbax writes for ``tree``."""
    tm = {}
    for path, leaf in leaves(tree):
        array = not isinstance(leaf, str)
        tm[str(tuple(k for k, _ in path))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": {
                "value_type": "np.ndarray" if array else leaf,
                "skip_deserialize": not array}}
    return {"tree_metadata": tm, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}


def write_step(path: str, tree: Mapping) -> None:
    """Write ``tree`` as the orbax checkpoint directory ``path``
    (``.../step_N``), replacing one that exists, through a staged
    directory renamed on commit."""
    path = os.path.abspath(path)
    t_init = time.time_ns()
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}{TMP_MARK}{t_init}"
    os.makedirs(tmp)
    try:
        items: dict[str, bytes] = {}
        for p, leaf in leaves(tree):
            if not isinstance(leaf, str):
                items.update(zarr2.encode(".".join(k for k, _ in p), leaf))
        ocdbt.write(tmp, items)
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump(metadata(tree), f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": t_init,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _insert(tree: dict, keys: list[str], leaf) -> None:
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = leaf


def read_step(path: str) -> dict:
    """The flax tree of the orbax checkpoint directory ``path``: nested
    dicts of numpy arrays, ``{}`` for an empty state or dict, None for a
    ``None`` leaf at the top."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{path}: only OCDBT + zarr v2 checkpoints are "
                         "supported")
    store = ocdbt.Reader(path)

    def get(key):
        return store.get(key) if key in store else None

    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind == "None":
            leaf = None if len(keys) == 1 else {}
        elif kind == "Dict":
            leaf = {}
        elif entry["value_metadata"].get("skip_deserialize"):
            raise ValueError(f"{path}: leaf {keys} of type {kind!r} is not "
                             "supported")
        else:
            leaf = zarr2.read(get, ".".join(keys))
        _insert(tree, keys, leaf)
    return tree
