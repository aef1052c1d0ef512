"""The port's channels (``ray_tpu_torch/experimental``) against
``ray_tpu.experimental`` on the CPU.

Tolerance: none. Every value that crosses a channel, in either direction
between the packages, must come back bit for bit.
"""

import multiprocessing
import pickle
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.experimental import channel as ref_channel
from ray_tpu.experimental.device_channel import DeviceChannel as RefDC
from ray_tpu_torch.experimental import (Channel, ChannelClosed,
                                        ChannelTimeout, DeviceChannel)
from ray_tpu_torch.experimental.channel import dtype_name

import torch_channel_peer

# six xdist workers share the machine's cores
torch.set_num_threads(2)


def _bits(x):
    """The raw bytes of a numpy array, jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _rng_f32(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --- the byte format, both directions ---

def test_reference_writes_port_reads():
    """numpy f32 and int64, jax f32 and bf16, numpy bf16 and a pickled
    value written by ray_tpu's Channel, read by the port's from the same
    file with device="cpu": numpy stays numpy, device arrays come back as
    CPU tensors, bf16 (which numpy lacks) as a CPU tensor."""
    ref = ref_channel.Channel(num_readers=1, capacity=1 << 16)
    port = Channel(ref.path, device="cpu")
    try:
        a = _rng_f32(0, (3, 5))
        i64 = np.arange(-7, 5, dtype=np.int64).reshape(3, 4)
        jf = jnp.asarray(_rng_f32(1, (4, 6)))
        jb = jnp.asarray(_rng_f32(2, (7, 3))).astype(jnp.bfloat16)
        nb = _rng_f32(3, (5,)).astype(ml_dtypes.bfloat16)
        for value, kind, dtype in (
                (a, np.ndarray, "float32"), (i64, np.ndarray, "int64"),
                (jf, torch.Tensor, "torch.float32"),
                (jb, torch.Tensor, "torch.bfloat16"),
                (nb, torch.Tensor, "torch.bfloat16")):
            ref.write(value)
            got = port.read(0, timeout=10)
            assert isinstance(got, kind)
            assert str(got.dtype) == dtype
            assert tuple(got.shape) == tuple(value.shape)
            assert _bits(got) == _bits(value)
            if kind is torch.Tensor:
                assert got.device.type == "cpu"
        ref.write({"step": 3, "ok": [1, 2]})
        assert port.read(0, timeout=10) == {"step": 3, "ok": [1, 2]}
    finally:
        port.close()
        ref.close()
        ref.unlink()


def test_port_writes_reference_reads():
    """numpy f32, torch f32 and torch bf16 (and an int32 0-d tensor) written
    by the port's Channel, read by ray_tpu's: numpy stays numpy, tensors
    come back as jax arrays (the device flag), bf16 included."""
    port = Channel(num_readers=1, capacity=1 << 16)
    ref = ref_channel.Channel(port.path)
    try:
        a = _rng_f32(4, (2, 3, 4))
        tf = torch.from_numpy(_rng_f32(5, (6, 2)))
        tb = torch.from_numpy(_rng_f32(6, (3, 3))).to(torch.bfloat16)
        ti = torch.tensor(-123456, dtype=torch.int32)
        for value, dtype in ((a, "float32"), (tf, "float32"),
                             (tb, "bfloat16"), (ti, "int32")):
            port.write(value)
            got = ref.read(0, timeout=10)
            if isinstance(value, np.ndarray):
                assert type(got) is np.ndarray
            else:
                assert isinstance(got, jax.Array)
            assert str(got.dtype) == dtype
            assert tuple(got.shape) == tuple(value.shape)
            assert _bits(got) == _bits(value)
        port.write([1, "two", 3.0])
        assert ref.read(0, timeout=10) == [1, "two", 3.0]
    finally:
        ref.close()
        port.close()
        port.unlink()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_tensor_and_a_jax_array_write_the_same_bytes(tmp_path, dtype):
    """The same values written as a torch tensor by the port and as a jax
    array by the reference leave byte-identical channel files."""
    x = _rng_f32(7, (4, 9))
    files = []
    for name, write in (
            ("port", lambda p: Channel(p, create=True, capacity=4096).write(
                torch.from_numpy(x).to(getattr(torch, dtype)))),
            ("ref", lambda p: ref_channel.Channel(
                p, create=True, capacity=4096).write(
                    jnp.asarray(x).astype(getattr(jnp, dtype))))):
        p = str(tmp_path / name)
        write(p)
        files.append(open(p, "rb").read())
    assert files[0] == files[1]


def test_dtype_names_are_numpys_and_ml_dtypes():
    for dtype in (torch.float32, torch.int64, torch.bool, torch.bfloat16,
                  torch.float16, torch.uint8):
        name = dtype_name(dtype)
        assert np.dtype(name) == np.dtype(
            getattr(ml_dtypes, name, None) or name)
    with pytest.raises(TypeError):
        dtype_name(torch.quint8)


# --- the channel's own semantics, as tests/test_dag.py holds ray_tpu's ---

def test_capacity_overflow_raises():
    ch = Channel(num_readers=1, capacity=128)
    try:
        with pytest.raises(ValueError, match="exceeds capacity"):
            ch.write(b"x" * 1024)
        with pytest.raises(ValueError, match="exceeds capacity"):
            ch.write(torch.zeros(64))           # 256 bytes + header
        ch.write(torch.zeros(16))               # 64 bytes + header fits
        assert torch.equal(Channel(ch.path, device="cpu").read(0),
                           torch.zeros(16))
    finally:
        ch.close()
        ch.unlink()


def test_close_write_raises_channel_closed():
    ch = Channel(num_readers=1)
    try:
        ch.write(1)
        assert ch.read(0) == 1
        ch.close_write()
        with pytest.raises(ChannelClosed):
            ch.read(0)
    finally:
        ch.close()
        ch.unlink()


def test_read_and_write_time_out():
    ch = Channel(num_readers=1, capacity=1 << 12)
    try:
        with pytest.raises(ChannelTimeout):
            ch.read(0, timeout=0.1)
        ch.write(1)
        with pytest.raises(ChannelTimeout):      # the reader never took 1
            ch.write(2, timeout=0.1)
        assert ch.read(0, timeout=1) == 1
    finally:
        ch.close()
        ch.unlink()


def test_reduce_remaps_the_file():
    """A pickled channel reopens its file: the header's reader count and
    capacity, the reader's device, and the same data lane for each
    reader slot."""
    ch = Channel(num_readers=2, capacity=1 << 12, device="cpu")
    try:
        other = pickle.loads(pickle.dumps(ch))
        assert isinstance(other, Channel)
        assert (other.path, other.num_readers, other.capacity,
                other.device) == (ch.path, 2, 1 << 12, "cpu")
        ch.write(torch.arange(5))
        for slot in (0, 1):
            assert torch.equal(other.read(slot, timeout=5), torch.arange(5))
    finally:
        ch.close()
        ch.unlink()


def test_backpressure_across_threads_keeps_order():
    ch = Channel(num_readers=1, capacity=1 << 12, device="cpu")
    got = []

    def reader():
        for _ in range(20):
            got.append(ch.read(0, timeout=10))

    t = threading.Thread(target=reader)
    t.start()
    for i in range(20):
        ch.write(torch.full((3,), i), timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    assert [int(g[0]) for g in got] == list(range(20))
    ch.close()
    ch.unlink()


def test_a_read_tensor_survives_the_next_write():
    """The reader copies before it releases its slot: a tensor read is not
    a view of the mapped buffer that the next write overwrites."""
    ch = Channel(num_readers=1, capacity=1 << 12, device="cpu")
    try:
        ch.write(torch.arange(16, dtype=torch.float32))
        first = ch.read(0)
        ch.write(torch.full((16,), -1.0))
        assert torch.equal(first, torch.arange(16, dtype=torch.float32))
        assert torch.equal(ch.read(0), torch.full((16,), -1.0))
    finally:
        ch.close()
        ch.unlink()


# --- DeviceChannel: tests/test_dag.py::test_device_channel_cross_process
# on both packages ---

def _produce(ch, make, n):
    for i in range(n):
        ch.write(make(i), timeout=30)
    ch.close_write()


def test_reference_device_channel_cases():
    """The reference's cases on ray_tpu's DeviceChannel, producer and
    consumer in one process (its transfer server serves itself): 4
    writes of {f32, bf16}, ChannelClosed after, inline payloads, the
    TypeError for mixed trees, slot != 0."""
    ch = RefDC()
    try:
        t = threading.Thread(target=_produce, args=(ch, lambda i: {
            "x": jnp.arange(8, dtype=jnp.float32) + i,
            "w": jnp.full((2, 2), i, jnp.bfloat16)}, 4))
        t.start()
        reader = RefDC(ch.path)
        out = []
        for i in range(4):
            v = reader.read(timeout=60)
            assert isinstance(v["x"], jax.Array)
            assert str(v["w"].dtype) == "bfloat16"
            assert _bits(v["w"]) == _bits(jnp.full((2, 2), i, jnp.bfloat16))
            out.append(float(np.asarray(v["x"])[0]))
        with pytest.raises(ref_channel.ChannelClosed):
            reader.read(timeout=5)
        t.join(timeout=30)
        assert not t.is_alive()
        assert out == [0.0, 1.0, 2.0, 3.0]
        _check_inline_mixed_and_slot(RefDC, jnp.ones(2), np.ones(2))
    finally:
        ch.close()
        ch.unlink()


def _check_inline_mixed_and_slot(cls, tensor, host_array, **reader_kw):
    ch = cls()
    try:
        reader = cls(ch.path, **reader_kw)
        ch.write({"error": "boom", "n": 3}, timeout=5)
        assert reader.read(timeout=5) == {"error": "boom", "n": 3}
        ch.write(None, timeout=5)
        assert reader.read(timeout=5) is None
        for mixed in ({"x": tensor, "step": 1}, [tensor, host_array],
                      {"h": host_array}):
            with pytest.raises(TypeError, match="ALL"):
                ch.write(mixed, timeout=5)
        with pytest.raises(ValueError, match="slot 0"):
            reader.read(slot=1, timeout=5)
    finally:
        ch.close()
        ch.unlink()


def test_port_device_channel_inline_mixed_and_slot():
    _check_inline_mixed_and_slot(DeviceChannel, torch.ones(2), np.ones(2),
                                 device="cpu")
    ch = DeviceChannel()
    try:
        # tensors on two devices do not share a lane
        with pytest.raises(TypeError, match="all on the card"):
            ch.write({"a": torch.ones(2), "b": torch.ones(2, device="meta")})
    finally:
        ch.close()
        ch.unlink()


def test_port_device_channel_cross_process():
    """The reference's cross-process case on the port over CPU tensors:
    a spawned reader takes 4 {f32, bf16} trees through the host lane, bit
    for bit and as tensors on its device, then ChannelClosed. Each side
    counts the host lane's bytes and no IPC transfer."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    ch = DeviceChannel(device="cpu")
    DeviceChannel.ipc_transfers = DeviceChannel.host_lane_bytes = 0
    proc = ctx.Process(target=torch_channel_peer.read_trees,
                       args=(ch.path, 4, "cpu", out), daemon=True)
    proc.start()
    try:
        _produce(ch, torch_channel_peer.tree, 4)
        got = out.get(timeout=120)
        proc.join(timeout=30)
        assert not proc.is_alive()
    finally:
        if proc.is_alive():
            proc.terminate()
        ch.close()
        ch.unlink()
    assert "error" not in got, got
    assert got["firsts"] == [0.0, 1.0, 2.0, 3.0]
    assert got["dtypes"] == ["torch.bfloat16"] * 4
    assert got["placed"] == [True] * 4
    assert got["equal"] == [True] * 4
    assert got["closed"]
    nbytes = 4 * (8 * 4 + 4 * 2)
    assert got["host_lane_bytes"] == nbytes and got["ipc_transfers"] == 0
    assert DeviceChannel.host_lane_bytes == nbytes
    assert DeviceChannel.ipc_transfers == 0


def test_port_device_channel_snapshots_at_write():
    """A tensor mutated after write returns does not change what is read,
    and what is read is the reader's own memory."""
    ch = DeviceChannel(device="cpu")
    try:
        reader = DeviceChannel(ch.path, device="cpu")
        x = torch.arange(6, dtype=torch.float32)
        w = torch.ones(2, 2, dtype=torch.bfloat16)
        ch.write({"x": x, "w": [w]}, timeout=5)
        x.fill_(-1.0)
        w.mul_(3)
        got = reader.read(timeout=30)
        assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))
        assert torch.equal(got["w"][0], torch.ones(2, 2, dtype=torch.bfloat16))
        assert got["x"].untyped_storage().data_ptr() != \
            x.untyped_storage().data_ptr()
        got["x"].zero_()
        assert torch.equal(x, torch.full((6,), -1.0))
    finally:
        ch.close()
        ch.unlink()


def test_port_device_channel_tree_structure_and_device_flag():
    """Nested dicts, lists and tuples keep their structure and dtypes;
    a reader unpickled from the writer keeps its device."""
    ch = DeviceChannel(device="cpu")
    try:
        reader = pickle.loads(pickle.dumps(ch))
        assert reader.device == "cpu" and reader.path == ch.path
        tree = {"b": [torch.tensor(True), (torch.arange(3),)],
                "a": {"k": torch.zeros(0, 4), "v": torch.ones(1, 1,
                                                             dtype=torch.int8)}}
        ch.write(tree, timeout=5)
        got = reader.read(timeout=30)
        assert sorted(got) == ["a", "b"] and isinstance(got["b"][1], tuple)
        for g, want in ((got["b"][0], tree["b"][0]),
                        (got["b"][1][0], tree["b"][1][0]),
                        (got["a"]["k"], tree["a"]["k"]),
                        (got["a"]["v"], tree["a"]["v"])):
            assert g.dtype == want.dtype and torch.equal(g, want)
    finally:
        ch.close()
        ch.unlink()


def test_port_device_channel_read_is_freed_without_the_cyclic_collector():
    """What a reader took is freed when its last reference goes: the read
    path makes no reference cycle, which would keep each payload (a
    compiled DAG stage's 16.8 MB hidden on the card) until the cyclic
    collector happened to run."""
    import gc
    import weakref

    ch = DeviceChannel(device="cpu")
    enabled = gc.isenabled()
    gc.disable()
    try:
        reader = DeviceChannel(ch.path, device="cpu")
        ch.write({"a": torch.ones(3), "b": [torch.zeros(2)]}, timeout=5)
        got = reader.read(timeout=30)
        refs = [weakref.ref(got["a"]), weakref.ref(got["b"][0])]
        del got
        assert [r() for r in refs] == [None, None]
    finally:
        if enabled:
            gc.enable()
        ch.close()
        ch.unlink()
