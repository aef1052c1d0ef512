"""``ray_tpu_torch.data.iter_device_batches`` against
``ray_tpu.data.Dataset.iter_jax_batches`` on the CPU.

The reference method runs unbound on a stub that has only
``iter_batches``, so that no cluster is needed. Tolerance: none; the
same batches, in the same order and count, with the same bits.
"""

import jax
import numpy as np
import pytest
import torch

from ray_tpu.data.dataset import Dataset
from ray_tpu_torch.data import iter_device_batches

# six xdist workers share the machine's cores
torch.set_num_threads(2)


class _Stub:
    """What ``iter_jax_batches`` reads of a Dataset: ``iter_batches``."""

    def __init__(self, batches):
        self._batches = batches

    def iter_batches(self, *, batch_size=None, batch_format="numpy",
                     drop_last=False):
        return iter(self._batches)


def _batches(seed, n, rows, last_rows):
    """n seeded batches of image, label, mask and score columns; the last
    one ragged."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = rows if i < n - 1 else last_rows
        out.append({
            "images": rng.standard_normal((b, 4, 4, 3)).astype(np.float32),
            "labels": rng.integers(0, 10, b).astype(np.int32),
            "mask": rng.random(b) < 0.5,
            "half": rng.standard_normal((b, 2)).astype(np.float16)})
    return out


@pytest.mark.parametrize("n,rows,last_rows", [(5, 8, 3), (1, 4, 4),
                                              (3, 6, 6)])
def test_same_batches_order_count_and_values(n, rows, last_rows):
    batches = _batches(n * 7 + rows, n, rows, last_rows)
    want = list(Dataset.iter_jax_batches(_Stub(batches)))
    got = list(iter_device_batches(iter(batches), device="cpu"))
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            wk = np.asarray(w[k])
            assert g[k].numpy().dtype == wk.dtype
            assert g[k].shape == wk.shape
            assert g[k].numpy().tobytes() == wk.tobytes()


def test_no_batches_yield_nothing():
    assert list(Dataset.iter_jax_batches(_Stub([]))) == []
    assert list(iter_device_batches(iter([]), device="cpu")) == []


def test_the_port_keeps_64_bit_dtypes_where_jax_narrows_them():
    """A deliberate divergence: jax.device_put makes int64 into int32 and
    float64 into float32 (64-bit mode off), the port keeps both. The
    values agree where they are representable in 32 bits."""
    assert not jax.config.jax_enable_x64
    batch = {"ids": np.array([-3, 0, 7, 2 ** 31 - 1], dtype=np.int64),
             "score": np.array([0.5, -1.25, 3.0, 1e-3], dtype=np.float64)}
    (want,) = Dataset.iter_jax_batches(_Stub([batch]))
    (got,) = iter_device_batches([batch], device="cpu")
    assert str(want["ids"].dtype) == "int32"
    assert str(want["score"].dtype) == "float32"
    assert got["ids"].dtype == torch.int64
    assert got["score"].dtype == torch.float64
    np.testing.assert_array_equal(got["ids"].numpy(),
                                  np.asarray(want["ids"]))
    np.testing.assert_array_equal(got["score"].numpy().astype(np.float32),
                                  np.asarray(want["score"]))


def test_cpu_batches_are_the_numpy_arrays():
    """On the CPU a column is torch.from_numpy of its array: no copy."""
    batch = {"x": np.arange(6, dtype=np.float32)}
    (got,) = iter_device_batches([batch], device="cpu")
    batch["x"][0] = 42.0
    assert got["x"][0].item() == 42.0
