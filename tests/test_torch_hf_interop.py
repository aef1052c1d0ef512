"""ray_tpu_torch's HF checkpoint interop against ray_tpu's (CPU).

``models/hf_interop.py``: files cross-load bit for bit both ways (each
side writes, the other loads) in bf16 and f32, and the port writes the
reference's bytes; sharded directories with an index; tied embeddings
become a copy, not a view; the config mapping; the host-int8 load against
ray_tpu's; a ``transformers`` checkpoint (``save_pretrained``) gives
``LlamaForCausalLM``'s logits, and ``transformers`` loads the port's
export. Weights are made by ray_tpu's or the port's seeded init; the port
runs with ``device="cpu"``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import hf_interop as jhf
from ray_tpu.models import init_params as j_init

from ray_tpu_torch._private.tree import tree_leaves, unstack_layers
from ray_tpu_torch.models import (LLAMA_CONFIGS, config_from_hf,
                                  config_to_hf, forward, init_params,
                                  load_hf_checkpoint, params_from_jax,
                                  params_to_numpy, save_hf_checkpoint)
from ray_tpu_torch.models import hf_interop
from ray_tpu_torch.ops.quant import quantize_params

# six xdist workers share the machine's cores
torch.set_num_threads(2)

TINY = LLAMA_CONFIGS["tiny"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _jax_params(seed, jdtype):
    jcfg = dataclasses.replace(J_CONFIGS["tiny"], dtype=jdtype)
    return jcfg, j_init(jax.random.PRNGKey(seed), jcfg)


def _assert_bit_equal(got, want):
    """Two port trees: same paths, dtypes and bits."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for path in w:
        assert g[path].dtype == w[path].dtype, path
        assert torch.equal(g[path], w[path]), path


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ray_tpu_writes_the_port_loads_bit_equal(tmp_path, dt):
    tdtype, jdtype = DTYPES[dt]
    jcfg, jp = _jax_params(1, jdtype)
    jhf.save_hf_checkpoint(jp, jcfg, str(tmp_path))
    got, cfg = load_hf_checkpoint(str(tmp_path), dtype=tdtype, device="cpu")
    assert cfg == dataclasses.replace(TINY, dtype=tdtype, remat=True)
    _assert_bit_equal(got, params_from_jax(jax.tree.map(np.asarray, jp),
                                           device="cpu"))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_the_port_writes_ray_tpu_loads_bit_equal(tmp_path, dt):
    """ray_tpu loads the port's file bit for bit, and the port's file is
    byte for byte the one ray_tpu writes for the same values."""
    tdtype, jdtype = DTYPES[dt]
    cfg = dataclasses.replace(TINY, dtype=tdtype)
    params = init_params(cfg, seed=2, device="cpu")
    save_hf_checkpoint(params, cfg, str(tmp_path / "port"))
    loaded, jcfg = jhf.load_hf_checkpoint(str(tmp_path / "port"),
                                          dtype=jdtype)
    want = params_to_numpy(params)
    for path, w in _leaves(jax.tree.map(np.asarray, loaded)):
        g = want
        for k in path:
            g = g[k]
        assert w.dtype == (np.float32 if dt == "f32" else ml_dtypes.bfloat16)
        np.testing.assert_array_equal(w.astype(np.float32), g,
                                      err_msg=str(path))
    jhf.save_hf_checkpoint(loaded, jcfg, str(tmp_path / "ref"))
    for name in ("model.safetensors", "config.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name


def test_safetensors_io_cross_reads_every_dtype(tmp_path):
    """Each side's reader takes the other's file, for every dtype both
    know, an empty tensor among them. (The reference's writer stores a 0-d
    array as shape [1], ``np.ascontiguousarray``'s; the port keeps [].)"""
    rng = np.random.default_rng(0)
    arrays = {
        "f64": rng.normal(size=(3, 2)),
        "f32": rng.normal(size=(5,)).astype(np.float32),
        "f16": rng.normal(size=(2, 2)).astype(np.float16),
        "bf16": rng.normal(size=(4, 3)).astype(ml_dtypes.bfloat16),
        "i64": rng.integers(-9, 9, (2,)), "i32": np.arange(6, dtype=np.int32),
        "i16": np.arange(3, dtype=np.int16), "i8": np.arange(-4, 4,
                                                             dtype=np.int8),
        "u8": np.arange(7, dtype=np.uint8),
        "bool": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
    }
    jhf.write_safetensors(arrays, str(tmp_path / "ref.safetensors"))
    got = hf_interop.read_safetensors(str(tmp_path / "ref.safetensors"))
    assert list(got) == list(arrays)
    tensors = {}
    for name, a in arrays.items():
        g = got[name]
        assert tuple(g.shape) == a.shape, name
        if a.dtype == ml_dtypes.bfloat16:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          a.astype(np.float32))
            tensors[name] = g
        else:
            np.testing.assert_array_equal(g.numpy(), a, err_msg=name)
            tensors[name] = torch.from_numpy(a.copy())
    hf_interop.write_safetensors(tensors, str(tmp_path / "port.safetensors"))
    assert ((tmp_path / "port.safetensors").read_bytes()
            == (tmp_path / "ref.safetensors").read_bytes())
    hf_interop.write_safetensors({"scalar": torch.tensor(2.5)},
                                 str(tmp_path / "scalar.safetensors"))
    scalar = hf_interop.read_safetensors(str(tmp_path / "scalar.safetensors"))
    assert scalar["scalar"].shape == () and float(scalar["scalar"]) == 2.5
    # the tensors read are copy-on-write: writing one leaves the file
    got["f32"].add_(1.0)
    again = jhf.read_safetensors(str(tmp_path / "ref.safetensors"))
    np.testing.assert_array_equal(again["f32"], arrays["f32"])


def test_sharded_directory_with_an_index(tmp_path):
    """A checkpoint split into two shards by an index loads as the
    single-file one does."""
    cfg = TINY
    params = init_params(cfg, seed=3, device="cpu")
    save_hf_checkpoint(params, cfg, str(tmp_path / "one"))
    tensors = hf_interop.read_safetensors(
        str(tmp_path / "one" / "model.safetensors"))
    shard_of = {name: ("model-00001-of-00002.safetensors"
                       if ".layers.1." not in name
                       else "model-00002-of-00002.safetensors")
                for name in tensors}
    sharded = tmp_path / "sharded"
    sharded.mkdir()
    for shard in set(shard_of.values()):
        hf_interop.write_safetensors(
            {n: t for n, t in tensors.items() if shard_of[n] == shard},
            str(sharded / shard))
    (sharded / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": shard_of}))
    (sharded / "config.json").write_text(
        (tmp_path / "one" / "config.json").read_text())
    got, _ = load_hf_checkpoint(str(sharded), dtype=cfg.dtype, device="cpu")
    _assert_bit_equal(got, params)


def test_tied_embeddings_become_a_copy(tmp_path):
    """A checkpoint without lm_head (tie_word_embeddings) loads lm_head as
    embed.T in storage of its own: updating one leaves the other."""
    cfg = TINY
    params = init_params(cfg, seed=4, device="cpu")
    save_hf_checkpoint(params, cfg, str(tmp_path))
    path = str(tmp_path / "model.safetensors")
    tensors = hf_interop.read_safetensors(path)
    del tensors["lm_head.weight"]
    hf_interop.write_safetensors(tensors, path + ".tmp")
    os.replace(path + ".tmp", path)
    hf_cfg = json.loads((tmp_path / "config.json").read_text())
    hf_cfg["tie_word_embeddings"] = True
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg))
    got, _ = load_hf_checkpoint(str(tmp_path), dtype=cfg.dtype, device="cpu")
    assert torch.equal(got["lm_head"], got["embed"].T)
    assert got["lm_head"].is_contiguous()
    assert (got["lm_head"].untyped_storage().data_ptr()
            != got["embed"].untyped_storage().data_ptr())
    before = got["lm_head"].clone()
    got["embed"].add_(1.0)
    assert torch.equal(got["lm_head"], before)
    # and as ray_tpu ties them
    want, _ = jhf.load_hf_checkpoint(str(tmp_path), dtype=jnp.float32)
    np.testing.assert_array_equal(before.numpy(),
                                  np.asarray(want["lm_head"]))


def test_config_mapping_is_inverse_and_the_reference_s():
    cfg = LLAMA_CONFIGS["8b"]
    hf = config_to_hf(cfg)
    assert hf == jhf.config_to_hf(J_CONFIGS["8b"])
    # Meta-Llama-3-8B's config.json widths
    assert (hf["vocab_size"], hf["hidden_size"], hf["num_hidden_layers"],
            hf["num_attention_heads"], hf["num_key_value_heads"],
            hf["intermediate_size"], hf["rope_theta"]) == (
        128256, 4096, 32, 32, 8, 14336, 500000.0)
    assert config_from_hf(hf) == cfg
    want = jhf.config_from_hf(hf, max_seq=1024)
    got = config_from_hf(hf, max_seq=1024, dtype=torch.float32)
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.float32


def test_int8_load_matches_ray_tpu_s(tmp_path):
    """quantize="int8" rounds to the storage dtype, then quantizes on the
    host: every int8 value and scale equals ray_tpu's int8 load, and
    equals quantize_params over the port's own bf16 load."""
    jcfg, jp = _jax_params(5, jnp.float32)
    jhf.save_hf_checkpoint(jp, jcfg, str(tmp_path))
    want, _ = jhf.load_hf_checkpoint(str(tmp_path), dtype=jnp.bfloat16,
                                     quantize="int8")
    got, _ = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16,
                                quantize="int8", device="cpu")
    _assert_bit_equal(got, params_from_jax(jax.tree.map(np.asarray, want),
                                           device="cpu"))
    assert got["layers"]["wq"]["q"].dtype == torch.int8
    bf16, cfg = load_hf_checkpoint(str(tmp_path), dtype=torch.bfloat16,
                                   device="cpu")
    _assert_bit_equal(got, quantize_params(bf16, cfg))
    with pytest.raises(ValueError, match="quantize"):
        load_hf_checkpoint(str(tmp_path), quantize="int4", device="cpu")


def test_save_takes_the_trainer_s_per_layer_tree(tmp_path):
    cfg = TINY
    params = init_params(cfg, seed=6, device="cpu")
    save_hf_checkpoint(params, cfg, str(tmp_path / "stacked"))
    save_hf_checkpoint(unstack_layers(params), cfg, str(tmp_path / "split"))
    assert ((tmp_path / "stacked" / "model.safetensors").read_bytes()
            == (tmp_path / "split" / "model.safetensors").read_bytes())


def test_moe_save_raises(tmp_path):
    cfg = dataclasses.replace(TINY, n_experts=4)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        save_hf_checkpoint(params, cfg, str(tmp_path))


def _hf_model(seed, tie=False):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=tie,
        attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.mark.parametrize("tie", [False, True])
def test_transformers_checkpoint_gives_its_logits(tmp_path, tie):
    """A LlamaForCausalLM written by save_pretrained: the port's forward
    on its load gives transformers' logits (f32, eager) to 1e-4."""
    model = _hf_model(0 if not tie else 1, tie)
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    tokens = torch.tensor([[1, 5, 9, 2, 77, 31, 8, 64]])
    with torch.no_grad():
        want = model(tokens).logits
        params, cfg = load_hf_checkpoint(str(tmp_path), dtype=torch.float32,
                                         device="cpu")
        got = forward(params, tokens, cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_transformers_loads_the_port_s_export(tmp_path):
    transformers = pytest.importorskip("transformers")
    cfg = TINY
    params = init_params(cfg, seed=7, device="cpu")
    save_hf_checkpoint(params, cfg, str(tmp_path))
    model = transformers.AutoModelForCausalLM.from_pretrained(
        str(tmp_path), torch_dtype=torch.float32,
        attn_implementation="eager").eval()
    tokens = torch.tensor([[2, 4, 6, 8]])
    with torch.no_grad():
        want = model(tokens).logits
        got = forward(params, tokens, cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_loaded_params_serve_like_the_saved_ones(tmp_path):
    """Round trip, then the forward: the logits of the loaded tree equal
    the saved tree's exactly (bf16), and every leaf is a fresh tensor."""
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    params = init_params(cfg, seed=8, device="cpu")
    save_hf_checkpoint(params, cfg, str(tmp_path))
    got, cfg2 = load_hf_checkpoint(str(tmp_path), device="cpu")
    assert cfg2.dtype == torch.bfloat16
    toks = torch.tensor([[9, 8, 7, 6, 5]])
    with torch.no_grad():
        assert torch.equal(forward(got, toks, cfg2), forward(params, toks,
                                                             cfg))
    ptrs = [t.untyped_storage().data_ptr() for t in tree_leaves(got)]
    assert len(set(ptrs)) == len(ptrs)
    assert all(t.is_contiguous() for t in tree_leaves(got))
