"""The orbax checkpoint backend of the port on the CPU: its zstd decoder
(``csrc/zstd_decode.cpp`` through ``utils/zstd.py``) against the
``zstandard`` package, its OCDBT store (``utils/ocdbt.py``) and zarr v2
arrays (``utils/zarr2.py``) against ``tensorstore``, and its checkpoint
directories (``engine/orbax_format.py``, ``engine/checkpoint.py``)
against the JAX package's ``save_checkpoint_orbax`` /
``load_checkpoint_orbax`` on ``tests/test_engine.py``'s tiny
configuration (MNet ngf 4, PatchGAN ndf 4), both ways, bit for bit; the
JAX package's own orbax cases in the port; a save that returns before its
commit keeps the state it was given; the committed JAX fixture
(``tests/data/orbax_jax_tiny``, ``tests/orbax_fixture.py``).
"""
import json
import os
import shutil
import signal
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from flax import serialization

from shadow_removal_istd_tpu.engine import checkpoint as jck
from shadow_removal_istd_tpu.engine.config import TrainConfig as JConfig
from shadow_removal_istd_tpu.engine.state import build_models as j_build
from shadow_removal_istd_tpu.engine.state import init_state as j_init
from shadow_removal_istd_tpu_torch.data.synthetic import synthetic_triplets
from shadow_removal_istd_tpu_torch.engine import checkpoint as ck
from shadow_removal_istd_tpu_torch.engine import orbax_format
from shadow_removal_istd_tpu_torch.engine.config import TrainConfig
from shadow_removal_istd_tpu_torch.engine.loop import RunConfig, Trainer
from shadow_removal_istd_tpu_torch.engine.state import init_state
from shadow_removal_istd_tpu_torch.engine.steps import train_step
from shadow_removal_istd_tpu_torch.tools.convert import (
    flatten_tree,
    train_state_to_flax,
)
from shadow_removal_istd_tpu_torch.utils import ocdbt, zarr2, zstd

import orbax_fixture

# test_engine.py's tiny_cfg, without its steps_per_epoch (the port's
# trainer derives it)
TINY = dict(ngf=4, ndf=4, image_size=32, batch_size=2,
            use_visual_loss=False, droprate=0.0)


# ------------------------------------------------------------------ zstd

def _payloads() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    words = [b"shadow", b"removal", b"\x00\x00\x80\x3f", b"istd", b"tpu"]
    text = b" ".join(words[i] for i in rng.integers(0, 5, 60000))
    floats = rng.standard_normal(300_000).astype(np.float32).tobytes()
    return {
        "empty": b"",
        "one_byte": b"\x7f",
        "100KB": rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes(),
        # >1 MB: many blocks, Huffman literals and matches at long range
        "over_1MB": floats[:600_000] + text + floats[:500_000],
        "rle_run": b"\xab" * 700_000,
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("checksum", [False, True],
                         ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("name", list(PAYLOADS))
@pytest.mark.parametrize("level", [1, 3, 19])
def test_decoder_matches_zstandard(level, name, checksum):
    data = PAYLOADS[name]
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=checksum).compress(data)
    assert zstd.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompressobj().decompress(
        frame) == data


def test_decoder_streamed_frames_without_content_size():
    """A streamed frame (window descriptor, no content size) of several
    flushed blocks, and zstd's own single-block forms."""
    data = PAYLOADS["over_1MB"]
    obj = zstandard.ZstdCompressor(level=3).compressobj()
    frame = b"".join(obj.compress(data[i:i + 70_000])
                     + obj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                     for i in range(0, len(data), 70_000)) + obj.flush()
    assert frame[4] & 0xC0 == 0         # no content size field
    assert zstd.decompress(frame) == data


def test_decoder_concatenated_and_skippable_frames():
    a, b = PAYLOADS["100KB"], PAYLOADS["rle_run"][:5000] + b"tail"
    c = zstandard.ZstdCompressor(level=3)
    skippable = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    assert zstd.decompress(c.compress(a) + skippable + c.compress(b)) \
        == a + b


@pytest.mark.parametrize("damage", ["flipped_byte", "truncated",
                                    "bad_checksum", "bad_magic",
                                    "trailing_garbage"])
def test_decoder_raises_on_a_corrupt_frame(damage):
    data = PAYLOADS["over_1MB"][:400_000]
    frame = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(data))
    if damage == "flipped_byte":
        frame[len(frame) // 2] ^= 0x5A
    elif damage == "truncated":
        frame = frame[:len(frame) - 100]
    elif damage == "bad_checksum":
        frame[-1] ^= 1
    elif damage == "bad_magic":
        frame[0] ^= 1
    else:
        frame += b"\x01\x02"
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(frame))


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 65_792,
                                  300_000])
def test_frame_raw_is_a_valid_frame(size):
    data = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    frame = zstd.frame_raw(data)
    assert zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=max(size, 1)) == data
    assert zstd.decompress(frame) == data


def test_no_fallback_when_the_build_fails(monkeypatch):
    """Without a compiler the decoder raises; nothing reaches for
    another zstd."""
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        zstd.decompress(zstandard.ZstdCompressor().compress(b"x"))


# ----------------------------------------------------------------- OCDBT

def _ts_items(path) -> dict[str, bytes]:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}"}).result()
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


def _ts_store(path, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                            "config": config}).result()


def test_reader_follows_interior_nodes_and_many_versions(tmp_path):
    """Small nodes (a b-tree of several levels, prefix-compressed keys,
    inline and indirect values) over 40 commits (a version tree beside
    the manifest's newest versions): the newest version's every key."""
    rng = np.random.default_rng(1)
    kv = _ts_store(tmp_path, max_decoded_node_bytes=256,
                   max_inline_value_bytes=24)
    for i in range(40):
        with ts.Transaction() as txn:
            for j in range(i * 5, i * 5 + 5):
                kv.with_transaction(txn).write(
                    f"a/{j:04d}/x" if j % 3 else f"b{j}",
                    rng.integers(0, 256, j % 50, dtype=np.uint8).tobytes()
                ).result()
    kv.delete_range(ts.KvStore.KeyRange("a/0010", "a/0020")).result()
    reader = ocdbt.Reader(tmp_path)
    assert dict(reader.items()) == _ts_items(tmp_path)
    assert reader.generation > 40


def test_writer_is_read_by_tensorstore(tmp_path):
    items = {"x/.zarray": b"{}", "x/0": os.urandom(5000),
             "y": b"v" * ocdbt.MAX_INLINE, "yy": b"w" * (ocdbt.MAX_INLINE
                                                           + 1),
             "z/empty": b""}
    ocdbt.write(tmp_path, items)
    assert _ts_items(tmp_path) == items
    assert dict(ocdbt.Reader(tmp_path).items()) == items
    with pytest.raises(FileExistsError):
        ocdbt.write(tmp_path, items)


@pytest.mark.parametrize("where", ["manifest", "node"])
def test_reader_checks_every_file(tmp_path, where):
    ocdbt.write(tmp_path, {"k": b"value"})
    path = (tmp_path / "manifest.ocdbt" if where == "manifest" else
            next(p for p in (tmp_path / "d").iterdir()))
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1
    path.write_bytes(bytes(data))
    with pytest.raises(ocdbt.OcdbtError, match="checksum"):
        ocdbt.Reader(tmp_path)


# ------------------------------------------------------------------ zarr

@pytest.mark.parametrize("sep,compressor,fill", [
    (".", {"id": "zstd", "level": 5}, None),
    ("/", None, 1.5)])
def test_zarr_edge_and_missing_chunks(tmp_path, sep, compressor, fill):
    """tensorstore's zarr v2 on OCDBT, chunks that do not divide the
    shape and one chunk never written: the port reads what tensorstore
    reads."""
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}",
                        "path": "arr/"},
            "metadata": {"shape": [5, 7], "chunks": [2, 3],
                         "dtype": "<f4", "compressor": compressor,
                         "fill_value": fill, "dimension_separator": sep},
            "create": True}
    arr = ts.open(spec).result()
    data = np.arange(35, dtype=np.float32).reshape(5, 7) - 7
    arr[:4, :].write(data[:4]).result()
    arr[4:, :3].write(data[4:, :3]).result()   # chunks (2, 1), (2, 2) absent
    want = arr.read().result()
    store = ocdbt.Reader(tmp_path)
    got = zarr2.read(lambda k: store.get(k) if k in store else None, "arr")
    np.testing.assert_array_equal(got, want)
    assert "arr/2" + sep + "2" not in store


def test_zarr_encode_is_orbax_form():
    for arr in (np.asarray(3, np.int32), np.ones((2, 3), np.float32),
                np.zeros((0, 3), np.float32)):
        items = zarr2.encode("leaf", arr)
        meta = json.loads(items["leaf/.zarray"])
        assert meta["compressor"] == {"id": "zstd", "level": 1}
        assert meta["shape"] == list(arr.shape)
        assert meta["chunks"] == [max(d, 1) for d in arr.shape]
        got = zarr2.read(items.get, "leaf")
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)


# ------------------------------------------------------------ the state

def _jax_state(cfg_kw: dict | None = None, seed: int = 0):
    """A JAX ``TrainState`` of the tiny configuration with random leaves
    of its shapes (``eval_shape``: nothing compiles); counts 3."""
    jcfg = JConfig(**TINY, **(cfg_kw or {}))
    models = j_build(jcfg)
    shapes = jax.eval_shape(lambda: j_init(jax.random.key(0), jcfg, models))
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.dtype == jnp.int32:
            return jnp.full(s.shape, 3, jnp.int32)
        return jnp.asarray(rng.standard_normal(s.shape).astype(np.float32))
    return jax.tree.map(leaf, shapes)


def _port_state(cfg_kw: dict | None = None, seed: int = 0):
    cfg = TrainConfig(**TINY, aug_method="shear", **(cfg_kw or {}))
    return init_state(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")


def _batch(seed: int):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(2, c, 32, 32, generator=g) * 2 - 1
                 for c in (3, 1, 3))


def _trained_port_state(cfg_kw=None):
    state = _port_state(cfg_kw, seed=1)
    train_step(state, _batch(2))
    train_step(state, _batch(3))
    return state


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


CONFIGS = {"default": None, "softadapt": {"softadapt": True},
           "began": {"net_d": "began"}, "plateau": {"lr_schedule": "plateau"}}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_metadata_is_what_jax_writes(tmp_path, name):
    """The port's ``_METADATA`` for its state is the JAX package's for the
    same configuration, byte for byte (key paths, key kinds, order, the
    value types of the leaves without arrays)."""
    jck.save_checkpoint_orbax(_jax_state(CONFIGS[name]), str(tmp_path), 1)
    want = (tmp_path / "step_1" / "_METADATA").read_text()
    got = json.dumps(orbax_format.metadata(
        train_state_to_flax(_port_state(CONFIGS[name]))))
    assert got == want


def test_jax_orbax_checkpoint_loads_into_the_port(tmp_path):
    """JAX's zstd-compressed OCDBT + zarr directories, read by the port's
    decoder: the state equals JAX's own restore, bit for bit, from the
    root (latest), with ``step=`` and from one ``step_N``."""
    jstate = _jax_state()
    jck.save_checkpoint_orbax(jstate, str(tmp_path), 5,
                              host={"best_loss": 1.25})
    jck.save_checkpoint_orbax(_jax_state(seed=1), str(tmp_path), 9)
    assert ck.latest_orbax_step(str(tmp_path)) == 9
    target = _jax_state(seed=2)
    for where, kw, step in ((str(tmp_path), {}, 9),
                            (str(tmp_path), {"step": 5}, 5),
                            (str(tmp_path / "step_5"), {}, 5)):
        restored, epoch, host = jck.load_checkpoint_orbax(target, where,
                                                          **kw)
        state = _port_state()
        assert ck.load_checkpoint_orbax(state, where, **kw) == (epoch, host)
        assert epoch == step and state.step == 3
        _assert_trees_equal(train_state_to_flax(state),
                            serialization.to_state_dict(restored))
    assert host == {"best_loss": 1.25}


@pytest.mark.parametrize("name", ["default", "softadapt", "plateau"])
def test_port_orbax_checkpoint_loads_into_jax(tmp_path, name):
    state = _trained_port_state(CONFIGS[name])
    ck.save_checkpoint_orbax(state, str(tmp_path), 2,
                             host={"best_loss": 0.5})
    assert (jck.latest_orbax_step(str(tmp_path))
            == ck.latest_orbax_step(str(tmp_path)) == 2)
    restored, epoch, host = jck.load_checkpoint_orbax(
        _jax_state(CONFIGS[name]), str(tmp_path))
    assert (epoch, host, int(restored.step)) == (2, {"best_loss": 0.5}, 2)
    _assert_trees_equal(serialization.to_state_dict(restored),
                        train_state_to_flax(state))


def test_orbax_roundtrip_in_the_port(tmp_path):
    """JAX ``tests/test_engine.py``'s orbax round trip, on the port."""
    state = _trained_port_state()
    ck.save_checkpoint_orbax(state, str(tmp_path), step=5,
                             host={"best_loss": 1.25})
    fresh = _port_state(seed=9)
    epoch, host = ck.load_checkpoint_orbax(fresh, str(tmp_path), step=5)
    assert epoch == 5 and host["best_loss"] == 1.25
    _assert_trees_equal(train_state_to_flax(fresh),
                        train_state_to_flax(state))
    ck.save_checkpoint_orbax(state, str(tmp_path), step=9)
    assert ck.latest_orbax_step(str(tmp_path)) == 9
    assert ck.load_checkpoint_orbax(fresh, str(tmp_path))[0] == 9
    assert ck.load_checkpoint_orbax(fresh, str(tmp_path / "step_5"))[0] == 5
    # a staged directory is not a checkpoint
    os.makedirs(tmp_path / f"step_12{orbax_format.TMP_MARK}1")
    assert ck.latest_orbax_step(str(tmp_path)) == 9
    assert jck.latest_orbax_step(str(tmp_path)) == 9


def test_save_returns_with_the_state_copied(tmp_path, monkeypatch):
    """The commit is held until a train step has updated the parameters
    in place; the directory holds the state as it was at ``save``."""
    state = _trained_port_state()
    before = jax.tree.map(np.array, train_state_to_flax(state))   # copies
    go = threading.Event()
    real = orbax_format.write_step

    def held(path, tree):
        assert go.wait(60)
        real(path, tree)
    monkeypatch.setattr(orbax_format, "write_step", held)
    ckptr = ck.make_orbax_checkpointer()
    ck.save_checkpoint_orbax(state, str(tmp_path), 2, checkpointer=ckptr)
    assert not (tmp_path / "step_2").exists()
    train_step(state, _batch(4))
    go.set()
    ckptr.wait_until_finished()
    assert len(ckptr.commit_ms) == 1
    fresh = _port_state(seed=9)
    ck.load_checkpoint_orbax(fresh, str(tmp_path))
    _assert_trees_equal(train_state_to_flax(fresh), before)
    assert state.step == 3


def test_a_failed_commit_raises_at_the_drain(tmp_path, monkeypatch):
    def broken(path, tree):
        raise OSError("disk full")
    monkeypatch.setattr(orbax_format, "write_step", broken)
    ckptr = ck.make_orbax_checkpointer()
    ck.save_checkpoint_orbax(_port_state(), str(tmp_path), 1,
                             checkpointer=ckptr)
    with pytest.raises(OSError, match="disk full"):
        ckptr.wait_until_finished()
    ckptr.wait_until_finished()          # raised once


def _trainer(tmp_path, tag, backend="msgpack"):
    run = RunConfig(seed=0, allow_missing_vgg=True,
                    weights_dir=str(tmp_path / f"w{tag}"),
                    logs_dir=str(tmp_path / f"l{tag}"),
                    checkpoint_path=str(tmp_path / (
                        f"orbax{tag}" if backend == "orbax"
                        else f"ck{tag}.msgpack")),
                    checkpoint_backend=backend, device_cache=True)
    return Trainer(TrainConfig(**TINY, aug_method="shear"), run,
                   train_streams=synthetic_triplets(4, 32, 32, seed=3),
                   device="cpu")


def test_resumed_equals_uninterrupted_orbax(tmp_path):
    """JAX ``tests/test_engine.py``'s resume case, on the port: 3 epochs
    against 2, an async save, a drain, a load of the backend's
    directory and the third epoch."""
    tr_a = _trainer(tmp_path, "a")
    tr_a.train(3)
    tr_b = _trainer(tmp_path, "b", "orbax")
    tr_b.train(2)
    tr_b.save(2)
    tr_c = _trainer(tmp_path, "c", "orbax")
    tr_b._drain_async_saves()
    tr_c.load(tr_b.run.checkpoint_path)
    assert tr_c.start_epoch == 2
    tr_c.train(3)
    _assert_trees_equal(train_state_to_flax(tr_c.state),
                        train_state_to_flax(tr_a.state))


def test_sigterm_save_is_committed_when_train_returns(tmp_path,
                                                      monkeypatch):
    """A SIGTERM during epoch 0 of an orbax run: ``train`` returns True
    with ``step_1`` committed (the commit is slowed, so only the drain at
    the end of ``train`` can have waited for it)."""
    tr = _trainer(tmp_path, "p", "orbax")
    real_epoch, real_write = tr.run_train_epoch, orbax_format.write_step

    def epoch(*a, **k):
        out = real_epoch(*a, **k)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    def slow(path, tree):
        time.sleep(1.0)
        real_write(path, tree)
    monkeypatch.setattr(tr, "run_train_epoch", epoch)
    monkeypatch.setattr(orbax_format, "write_step", slow)
    assert tr.train(3) is True
    root = tr.run.checkpoint_path
    assert ck.latest_orbax_step(root) == 1
    fresh = _trainer(tmp_path, "q", "orbax")
    fresh.load(root)
    assert fresh.start_epoch == 1
    _assert_trees_equal(train_state_to_flax(fresh.state),
                        train_state_to_flax(tr.state))


# --------------------------------------------------------------- fixture

def test_committed_jax_fixture_reads_alike():
    """``tests/data/orbax_jax_tiny`` (written by the JAX package, see
    ``tests/orbax_fixture.py``) through JAX's own orbax and through the
    port's reader: both equal ``expected.npz``."""
    fixture = orbax_fixture.FIXTURE
    expected = dict(np.load(os.path.join(fixture, "expected.npz")))
    step = os.path.join(fixture, f"step_{orbax_fixture.STEP}")
    port = {"/".join(k): v for k, v in
            flatten_tree(orbax_format.read_step(step)).items()
            if v is not None}
    jcfg = JConfig(**{**TINY, "ngf": 1, "ndf": 1, "nn_upconv": True})
    shapes = jax.eval_shape(
        lambda: j_init(jax.random.key(0), jcfg, j_build(jcfg)))
    target = orbax_fixture.g1_slice(shapes)
    restored, epoch, host = jck.load_checkpoint_orbax(target, fixture)
    assert (epoch, host) == (orbax_fixture.STEP, {"best_loss": 2.5})
    jax_flat = orbax_fixture.flat(restored)
    assert port.keys() == jax_flat.keys() == expected.keys()
    for k, want in expected.items():
        for got in (port[k], jax_flat[k]):
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_fixture_copy_is_independent(tmp_path):
    """The fixture read from a copy elsewhere (paths inside the store
    are relative to its root)."""
    src = os.path.join(orbax_fixture.FIXTURE, f"step_{orbax_fixture.STEP}")
    shutil.copytree(src, tmp_path / "step_1")
    a = flatten_tree(orbax_format.read_step(src))
    b = flatten_tree(orbax_format.read_step(str(tmp_path / "step_1")))
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is not None:
            np.testing.assert_array_equal(a[k], b[k])
