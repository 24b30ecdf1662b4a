"""utils/msgpack_subset.py against the ``msgpack`` package: the fixture
checkpoint and hypothesis-drawn trees decode to equal values, with flax's
ndarray and numpy-scalar extensions through convert.py's hook, and what
lies outside the subset raises ``ValueError`` naming the byte offset."""

from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from snn_object_detectionddp_tpu_torch import convert
from snn_object_detectionddp_tpu_torch.utils import msgpack_subset

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "fixtures/hard_nano_ckpt.pt"


def _hook(code, data):
    """The flax ext hook over the msgpack package."""
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
    return arr[()] if code == 3 else arr


def _reference(data: bytes):
    return msgpack.unpackb(data, ext_hook=_hook, raw=False, strict_map_key=False)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, float) and a != a:
        return isinstance(b, float) and b != b
    return type(a) is type(b) and a == b


def test_fixture_checkpoint_decodes_as_msgpack_does():
    data = CKPT.read_bytes()
    got = msgpack_subset.unpackb(data, ext_hook=convert._ext_hook)
    assert _equal(got, _reference(data))
    assert sum(isinstance(v, np.ndarray) for v in _leaves(got)) >= 130


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


scalars = (st.none() | st.booleans() | st.integers(-(2**63), 2**64 - 1)
           | st.floats(allow_nan=True, width=64) | st.text(max_size=40) | st.binary(max_size=40))
arrays = st.builds(
    lambda shape, dtype, seed: np.random.RandomState(seed).standard_normal(shape).astype(dtype),
    st.lists(st.integers(0, 4), max_size=3).map(tuple),
    st.sampled_from(["float32", "float16", "int32", "int8", "uint8", "float64", "bool"]),
    st.integers(0, 2**31 - 1),
)
np_scalars = st.builds(lambda v, t: np.dtype(t).type(v), st.integers(-100, 100),
                       st.sampled_from(["int32", "int64", "float32", "float64"]))
trees = st.recursive(
    scalars | arrays | np_scalars,
    lambda kids: st.lists(kids, max_size=4) | st.dictionaries(st.text(max_size=8), kids, max_size=4),
    max_leaves=25,
)


@settings(max_examples=60, deadline=None)
@given(trees)
def test_drawn_trees_decode_as_msgpack_does(tree):
    data = serialization.msgpack_serialize(tree) if isinstance(tree, dict) else msgpack.packb(
        tree, default=serialization._msgpack_ext_pack, strict_types=True)
    assert _equal(msgpack_subset.unpackb(data, ext_hook=convert._ext_hook), _reference(data))


@pytest.mark.parametrize("data,match", [
    (b"\xc1", "0xc1 at byte 0"),
    (b"\x92\x01", "runs past the end"),
    (b"\xa3ab", "runs past the end"),
    (b"\x01\x02", "trailing bytes"),
    (b"\xa2\xff\xfe", "invalid UTF-8 in the str at byte 0"),
    (b"\x81\x91\x01\x02", "map key at byte 1"),
    (b"\xd4\x05\x00", "extension type 5 at byte 0"),
    (b"\x91" * 300 + b"\xc0", "nesting deeper"),
])
def test_outside_the_subset_raises(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack_subset.unpackb(data, ext_hook=convert._ext_hook if b"\xd4" not in data else None)


def test_unknown_flax_extension_raises():
    with pytest.raises(ValueError, match="unsupported msgpack extension 5"):
        msgpack_subset.unpackb(b"\xd4\x05\x00", ext_hook=convert._ext_hook)


def test_load_flax_params_needs_no_msgpack(monkeypatch):
    """With the msgpack package unimportable, the checkpoint still loads."""
    import builtins

    real_import = builtins.__import__

    def no_msgpack(name, *args, **kwargs):
        if name == "msgpack" or name.startswith("msgpack."):
            raise ImportError("no msgpack here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_msgpack)
    params = convert.load_flax_params(CKPT)
    assert "backbone" in params and "head" in params
