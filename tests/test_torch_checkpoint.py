"""Weight and checkpoint files between the two packages
(``utils/msgpack_codec.py``, ``tools/convert.py``'s train-state map,
``engine/checkpoint.py``).

The codec is held to the ``msgpack`` package and flax's serializer byte
for byte. JAX state (MNet ngf 4, PatchGAN ndf 4, random weights, BN
statistics and Adam moments, count 3) is written by the JAX package and
read by the port: every leaf equal after the layout map, G1 -> G2 within
1e-5 of the JAX forward on the same input. The port's state after two
CPU training steps is written by the port and read by the JAX package:
every leaf equal, and the JAX package writes the same bytes back.
"""
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from shadow_removal_istd_tpu.engine import checkpoint as jck
from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import TrainState as JState
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.state import (
    make_optimizers as j_optimizers,
)
from shadow_removal_istd_tpu.engine.steps import make_infer_step
from shadow_removal_istd_tpu_torch.engine import checkpoint as ck
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.state import init_state
from shadow_removal_istd_tpu_torch.engine.steps import infer_step, train_step
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    load_train_state,
    torch_to_flax_tree,
    train_state_to_flax,
)
from shadow_removal_istd_tpu_torch.utils import msgpack_codec as mc

from test_torch_train_models import random_variables

NETS = ("g1", "g2", "d1", "d2")
IN_CH = {"g1": 3, "g2": 4, "d1": 4, "d2": 7}
CFG = dict(ngf=4, ndf=4, droprate=0.0, batch_size=2, image_size=64,
           aug_method="shear")


# ------------------------------------------------------------------ codec

def _flax_packb(tree) -> bytes:
    """flax's writer, keys in the tree's order (``to_bytes``, as the
    JAX package's checkpoint writer calls it)."""
    return serialization.to_bytes(tree)


def _equal(a, b) -> None:
    """Recursive equality: arrays by value, dtype and shape."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), (a, b)
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, (np.ndarray, np.generic, jax.Array, torch.Tensor)):
        if isinstance(b, torch.Tensor) or isinstance(a, torch.Tensor):
            to = lambda t: np.asarray(  # noqa: E731
                t.float() if isinstance(t, torch.Tensor) else
                np.asarray(t, np.float32))
            np.testing.assert_array_equal(to(a), to(b))
            return
        a_, b_ = np.asarray(a), np.asarray(b)
        assert a_.dtype == b_.dtype and a_.shape == b_.shape
        np.testing.assert_array_equal(a_, b_)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _checkpoint_types():
    """Every type and width a flax checkpoint carries."""
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        "epoch": 3,
        "ints": {str(i): v for i, v in enumerate(ints)},
        "floats": {"a": 0.5, "b": float("inf"), "c": -1e300},
        "strs": {str(n): "x" * n for n in (0, 31, 32, 255, 256, 65536)},
        "bins": {str(n): bytes(range(256)) * (n // 256) + b"\0" * (n % 256)
                 for n in (0, 1, 255, 256, 65536)},
        "flags": {"t": True, "f": False, "none": None},
        "arrays": {
            "f32": rng.standard_normal((3, 4, 2, 5)).astype(np.float32),
            "f64": rng.standard_normal(7),
            "i32_0d": np.asarray(3, np.int32),
            "f32_0d": np.zeros((), np.float32),
            "u8": rng.integers(0, 256, (2, 3, 1), np.uint8),
            "bool": np.array([True, False]),
            "i64": np.arange(5, dtype=np.int64),
            "f16": np.ones((2, 2), np.float16),
            "empty": np.zeros((0, 3), np.float32),
            "one": np.ones((1,), np.float32),            # fixext 16 payload
        },
        "scalars": {"f32": np.float32(1.5), "i32": np.int32(-7),
                    "f64": np.float64(2.25), "b": np.bool_(True)},
        "big_map": {f"k{i}": i for i in range(70000)},
        "empty_map": {},
    }


def test_codec_writes_the_bytes_flax_writes():
    tree = _checkpoint_types()
    data = _flax_packb(tree)
    assert mc.to_bytes(tree) == data
    _equal(mc.from_bytes(data), tree)
    _equal(serialization.msgpack_restore(mc.to_bytes(tree)), tree)


def test_codec_bfloat16_both_ways():
    vals = np.array([[1.0, -2.5, 3.140625], [0.0, 1e-3, 65280.0]],
                    np.float32)
    flax_bytes = _flax_packb({"w": jnp.asarray(vals, jnp.bfloat16)})
    got = mc.from_bytes(flax_bytes)["w"]
    assert got.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    port_bytes = mc.to_bytes({"w": torch.from_numpy(vals).bfloat16()})
    assert port_bytes == flax_bytes
    back = serialization.msgpack_restore(port_bytes)["w"]
    assert back.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back, np.float32), want)


def test_codec_lists_match_the_msgpack_package():
    obj = [[1, -1, [2 ** 40, "s" * 40]], list(range(20)),
           list(range(70000)), b"\x01" * 300, 1.25]
    data = msgpack.packb(obj, use_bin_type=True)
    assert mc.to_bytes(obj) == data
    assert mc.unpackb(data) == msgpack.unpackb(data)
    assert msgpack.unpackb(mc.to_bytes(obj)) == obj
    # float32 (the msgpack package's use_single_float)
    single = msgpack.packb([0.5, 2.0], use_single_float=True)
    assert mc.unpackb(single) == [0.5, 2.0]


def test_codec_reads_chunked_arrays(monkeypatch):
    """flax splits arrays of 2**30 bytes or more into chunk maps; shrink
    the limit to write that form from a small array."""
    arr = np.arange(300, dtype=np.float32).reshape(3, 10, 10)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    data = _flax_packb({"params": {"big": arr, "small": arr[0, 0]}})
    raw = msgpack.unpackb(data, ext_hook=lambda c, d: None)
    assert raw["params"]["big"]["__msgpack_chunked_array__"] is True
    got = mc.from_bytes(data)
    np.testing.assert_array_equal(got["params"]["big"], arr)
    np.testing.assert_array_equal(got["params"]["small"], arr[0, 0])
    monkeypatch.setattr(mc, "MAX_CHUNK_SIZE", 256)
    with pytest.raises(ValueError, match="chunked form"):
        mc.to_bytes({"big": arr})


def test_codec_rejects_malformed_input():
    data = mc.to_bytes({"a": np.zeros(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        mc.from_bytes(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        mc.from_bytes(data + b"\x00")
    with pytest.raises(ValueError, match="ext type 2"):
        mc.from_bytes(msgpack.packb(msgpack.ExtType(2, b"ab")))
    with pytest.raises(TypeError):
        mc.to_bytes({"a": object()})


_leaf = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    st.binary(max_size=300),
    st.builds(lambda shape, seed: np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32),
        st.lists(st.integers(0, 3), max_size=3).map(tuple),
        st.integers(0, 2 ** 16)))
_trees = st.recursive(
    _leaf, lambda kids: st.dictionaries(st.text(max_size=20), kids,
                                        max_size=20), max_leaves=40)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(max_size=20), _trees, max_size=8))
def test_codec_round_trips_nested_dicts(tree):
    data = _flax_packb(tree)
    assert mc.to_bytes(tree) == data
    _equal(mc.from_bytes(data), serialization.msgpack_restore(data))


# ---------------------------------------------------------- train state

def _rand_like(rng, tree, positive=False):
    def leaf(a):
        r = rng.standard_normal(np.shape(a)).astype(np.float32)
        return jnp.asarray(np.abs(r) if positive else r)
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def jax_side():
    """JAX models and a state with random weights, BN statistics and
    Adam moments at count 3 (shaped by ``eval_shape``: nothing
    compiles)."""
    jcfg = JConfig(**CFG)
    models = j_build(jcfg)
    v = {k: random_variables(getattr(models, k), IN_CH[k], seed=i, size=64)
         for i, k in enumerate(NETS)}
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    g = to_j({k: v[k]["params"] for k in ("g1", "g2")})
    d = to_j({k: v[k]["params"] for k in ("d1", "d2")})
    rng = np.random.default_rng(5)
    count = jnp.asarray(3, jnp.int32)

    def opt(tx, params):
        adam, sched = tx.init(params)
        return (adam._replace(count=count, mu=_rand_like(rng, params),
                              nu=_rand_like(rng, params, positive=True)),
                sched._replace(count=count))

    tx_g, tx_d = j_optimizers(jcfg)
    state = JState(step=count, g_params=g, d_params=d,
                   batch_stats=to_j({k: v[k]["batch_stats"] for k in NETS}),
                   opt_g=opt(tx_g, g), opt_d=opt(tx_d, d),
                   k1=jnp.zeros((), jnp.float32),
                   k2=jnp.zeros((), jnp.float32))
    return models, state


def _port_state(seed=0):
    cfg = TrainConfig(**CFG, use_visual_loss=False)
    return init_state(cfg, torch.Generator().manual_seed(seed), device="cpu")


def _trained_port_state():
    state = _port_state(seed=1)
    g = torch.Generator().manual_seed(2)
    batch = tuple(torch.rand(2, c, 64, 64, generator=g) * 2 - 1
                  for c in (3, 1, 3))
    train_step(state, batch)
    train_step(state, batch)
    return state


def _jax_tree(state):
    return serialization.to_state_dict(jax.device_get(state))


def _assert_trees_equal(got, want):
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert fg.keys() == fw.keys()
    for path in fw:
        if fw[path] is None:
            assert fg[path] is None
            continue
        a, b = np.asarray(fg[path]), np.asarray(fw[path])
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))


def test_jax_checkpoint_loads_into_the_port(tmp_path, jax_side):
    models, jstate = jax_side
    path = str(tmp_path / "checkpoint.msgpack")
    jck.save_checkpoint(jstate, path, epoch=7, host={"best_loss": 0.625})
    state = _port_state()
    epoch, host = ck.load_checkpoint(state, path)
    assert (epoch, host, state.step) == (7, {"best_loss": 0.625}, 3)
    # weights, BN statistics and both Adam states, leaf for leaf
    _assert_trees_equal(train_state_to_flax(state), _jax_tree(jstate))
    # the stacked forward agrees with the JAX package's
    x = np.random.default_rng(9).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        jm, jy = make_infer_step(models)(jstate.g_params,
                                         jstate.batch_stats, jnp.asarray(x))
    g1, g2 = state.models.g1.eval(), state.models.g2.eval()
    with torch.no_grad():
        m, y = infer_step(g1, g2, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(m.permute(0, 2, 3, 1).numpy(), np.asarray(jm),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0)


def test_port_checkpoint_loads_into_jax(tmp_path, jax_side):
    _, jstate = jax_side
    state = _trained_port_state()
    path = str(tmp_path / "port.msgpack")
    ck.save_checkpoint(state, path, epoch=2, host={"best_loss": 1.5})
    restored, epoch, host = jck.load_checkpoint(jstate, path)
    assert (epoch, host, int(restored.step)) == (2, {"best_loss": 1.5}, 2)
    _assert_trees_equal(_jax_tree(restored), train_state_to_flax(state))
    # the JAX package writes the same state back as the same bytes
    again = str(tmp_path / "jax.msgpack")
    jck.save_checkpoint(restored, again, epoch=2, host={"best_loss": 1.5})
    with open(path, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()


def test_weight_files_cross_both_ways(tmp_path, jax_side):
    models, jstate = jax_side
    jck.save_model_weights(jstate, models, str(tmp_path / "jax"), "best")
    state = _port_state()
    for net in ("G1", "G2", "D1", "D2"):
        ck.load_model_weights(state, net,
                              str(tmp_path / "jax" /
                                  ck.net_filename(state, net, "best")))
    for k, group in (("g1", "g_params"), ("g2", "g_params"),
                     ("d1", "d_params"), ("d2", "d_params")):
        got = torch_to_flax_tree(getattr(state.models, k))
        _assert_trees_equal(got, {
            "params": jax.device_get(getattr(jstate, group)[k]),
            "batch_stats": jax.device_get(jstate.batch_stats[k])})
    # the reverse: the port writes, JAX restores
    trained = _trained_port_state()
    written = ck.save_model_weights(trained, str(tmp_path / "port"))
    assert [p.rsplit("/", 1)[1] for p in written] == [
        "G1_MNet_latest.msgpack", "G2_MNet_latest.msgpack",
        "D1_PatchGAN_latest.msgpack", "D2_PatchGAN_latest.msgpack"]
    restored = jstate
    for net, path in zip(("G1", "G2", "D1", "D2"), written):
        restored = jck.load_model_weights(restored, net, path)
    for k, group in (("g1", "g_params"), ("g2", "g_params"),
                     ("d1", "d_params"), ("d2", "d_params")):
        _assert_trees_equal(
            {"params": jax.device_get(getattr(restored, group)[k]),
             "batch_stats": jax.device_get(restored.batch_stats[k])},
            torch_to_flax_tree(getattr(trained.models, k)))
    with pytest.raises(ValueError, match="does not match"):
        ck.load_model_weights(state, "D1", written[0])   # a G1 file


def test_adam_step_restored_as_torch_creates_it(tmp_path, jax_side):
    """Every parameter's Adam ``step`` is the count, with the type,
    dtype, device and shape torch's own step gives it; count 0 leaves a
    fresh optimizer's empty state."""
    _, jstate = jax_side
    ref = _trained_port_state()
    p_ref = next(iter(ref.models.g1.parameters()))
    want = ref.opt_g.state[p_ref]["step"]
    path = str(tmp_path / "c.msgpack")
    jck.save_checkpoint(jstate, path)
    state = _port_state()
    ck.load_checkpoint(state, path)
    for opt, nets in ((state.opt_g, ("g1", "g2")),
                      (state.opt_d, ("d1", "d2"))):
        params = [p for k in nets
                  for p in getattr(state.models, k).parameters()]
        assert len(opt.state) == len(params)
        for p in params:
            s = opt.state[p]
            assert type(s["step"]) is type(want)
            assert (s["step"].dtype, s["step"].device, s["step"].shape) == (
                want.dtype, want.device, want.shape)
            assert float(s["step"]) == 3.0
            assert s["exp_avg"].dtype == p.dtype
            assert s["exp_avg"].device == p.device
    tree = train_state_to_flax(_port_state())
    fresh = _port_state(seed=4)
    load_train_state(tree, fresh)
    assert fresh.step == 0 and len(fresh.opt_g.state) == 0


def test_missing_fields_keep_their_values_and_bad_trees_raise():
    """The JAX forward-compatibility rule, BEGAN's k1/k2 and a SoftAdapt
    state carried both ways, and nothing written before a fault is
    found."""
    src = _trained_port_state()
    dst = _port_state(seed=3)
    before = train_state_to_flax(dst)
    tree = train_state_to_flax(src)
    partial = {k: v for k, v in tree.items()
               if k not in ("batch_stats", "k1", "k2", "softadapt")}
    load_train_state(partial, dst)
    after = train_state_to_flax(dst)
    _assert_trees_equal(after["batch_stats"], before["batch_stats"])
    for key in ("g_params", "d_params", "opt_g", "opt_d"):
        _assert_trees_equal(after[key], tree[key])
    assert dst.step == 2

    def refused(mutate, exc, match):
        bad = train_state_to_flax(src)
        mutate(bad)
        fresh = _port_state(seed=6)
        snapshot = train_state_to_flax(fresh)
        with pytest.raises(exc, match=match):
            load_train_state(bad, fresh)
        _assert_trees_equal(train_state_to_flax(fresh), snapshot)

    # BEGAN's k1/k2 and a SoftAdapt state load as they are and come back
    rich = train_state_to_flax(src)
    rich.update(k1=np.asarray(0.25, np.float32),
                k2=np.asarray(0.75, np.float32),
                softadapt={"weights": np.array([.5, .3, .2], np.float32),
                           "prev_loss": np.array([1., 2., 3.], np.float32)})
    fresh = _port_state(seed=6)
    load_train_state(rich, fresh)
    assert float(fresh.k1) == 0.25 and float(fresh.k2) == 0.75
    _assert_trees_equal(train_state_to_flax(fresh), rich)

    refused(lambda t: t.update(softadapt={"w": np.ones(3, np.float32)}),
            ValueError, "softadapt")
    refused(lambda t: t["opt_d"]["1"].update(count=np.asarray(9, np.int32)),
            ValueError, "counts differ")
    refused(lambda t: t["opt_g"]["0"]["nu"]["g2"].pop("Upsample_0"),
            ValueError, "missing")
    refused(lambda t: t["d_params"]["d2"]["ConvReflect_0"]["Conv_0"].update(
        kernel=np.zeros((3, 3, 1, 1), np.float32)), ValueError, "shape")
