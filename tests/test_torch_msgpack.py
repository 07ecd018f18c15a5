"""The port's msgpack reader and writer (``utils/msgpack_io.py``, no flax)
against ``flax.serialization``, both ways, exactly: every dtype of a
variable file, nested dicts, scalars, and flax's chunked arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import test_torch_common  # noqa: F401  (sets torch to 1 thread)
from dvd_tpu_torch.utils import msgpack_io


def _tree(seed: int = 0):
    rng = np.random.RandomState(seed)
    return {
        "params": {
            "dense": {"kernel": rng.randn(3, 4).astype(np.float32),
                      "bias": rng.randn(4).astype(np.float32)},
            "half": rng.randn(2, 5).astype(np.float16),
            "bf16": np.asarray(jnp.asarray(rng.randn(3, 2), jnp.bfloat16)),
            "deep": {"a": {"b": {"c": rng.randint(-9, 9, (2, 2, 2))
                                 .astype(np.int32)}}},
            "i64": np.array([-2 ** 40, 7, 0], np.int64),
            "u8": (rng.rand(6) * 255).astype(np.uint8),
            "flags": rng.rand(4) > 0.5,
            "empty": np.zeros((0, 3), np.float32),
            "scalar_array": np.array(1.25, np.float32),
        },
        "batch_stats": {"bn": {"mean": rng.randn(8).astype(np.float32),
                               "var": rng.rand(8).astype(np.float32)}},
        "step": 123456, "neg": -5, "big_neg": -70000, "lr": 2.5e-4,
        "on": True, "off": False, "none": None, "name": "x" * 40,
        "np_scalar": np.float32(0.5),
    }


def _assert_same(got, want, path=""):
    """``got`` (the port's: tensors, Python scalars) equals ``want``
    (flax's: numpy) bit for bit, in dtype and shape too."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, torch.Tensor), path
        assert str(got.dtype).split(".")[-1] == want.dtype.name, path
        assert tuple(got.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    elif isinstance(want, np.generic):
        assert got == want.item(), path
    else:
        assert type(got) is type(want) and got == want, path


def test_flax_file_reads_back_equal():
    tree = _tree()
    _assert_same(msgpack_io.msgpack_restore(
        serialization.msgpack_serialize(tree)), tree)


def test_port_file_reads_back_equal_in_flax():
    tree = _tree(1)
    port_tree = msgpack_io.msgpack_restore(
        serialization.msgpack_serialize(tree))
    back = serialization.msgpack_restore(
        msgpack_io.msgpack_serialize(port_tree))
    _assert_same(port_tree, back)
    # numpy arrays and scalars written by the port directly
    back = serialization.msgpack_restore(msgpack_io.msgpack_serialize(tree))
    _assert_same(msgpack_io.msgpack_restore(
        serialization.msgpack_serialize(back)), tree)


@pytest.mark.parametrize("writer", ["flax", "port"])
def test_chunked_arrays(monkeypatch, writer):
    """Arrays over MAX_CHUNK_SIZE bytes go as flax's chunked dicts, in
    both directions (the limit lowered to 64 bytes)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(2)
    tree = {"params": {"big": rng.randn(7, 9).astype(np.float32),
                       "bigbf": np.asarray(jnp.asarray(rng.randn(50),
                                                       jnp.bfloat16)),
                       "small": rng.randn(3).astype(np.float32)}}
    if writer == "flax":
        raw = serialization.msgpack_serialize(tree)
    else:
        raw = msgpack_io.msgpack_serialize(tree)
    assert raw.count(b"__msgpack_chunked_array__") == 2
    _assert_same(msgpack_io.msgpack_restore(raw), tree)
    restored = serialization.msgpack_restore(raw)
    for k, v in tree["params"].items():
        assert restored["params"][k].dtype == v.dtype
        np.testing.assert_array_equal(restored["params"][k], v)


def test_unsupported_input_raises_naming_it():
    raw = serialization.msgpack_serialize({"x": np.zeros(3, np.float64)})
    with pytest.raises(ValueError, match="float64"):
        msgpack_io.msgpack_restore(raw)
    with pytest.raises(ValueError, match="trailing"):
        msgpack_io.msgpack_restore(serialization.msgpack_serialize({}) + b"\0")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.msgpack_restore(serialization.msgpack_serialize(
            {"x": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="complex"):
        msgpack_io.msgpack_serialize({"x": torch.zeros(2, dtype=torch.cfloat)})
