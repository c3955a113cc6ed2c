"""The port's shard store against the JAX package's, both ways, on the CPU.

- A store written by the JAX ``save_shards`` loads in the port's
  ``load_shards`` with equal arrays (int8 codes, float32 scales and
  bfloat16 / float32 tensors equal to the bit), and a store written by the
  port loads in the JAX ``load_shards`` alike: raw and npz storage, no
  quantization, int8 and int4, 1 and 3 shards.  The parsed manifests are
  equal and raw shard files are byte-identical (same packing, order,
  alignment, codes and CRC32s).
- ``reconstruct`` dequantizes to the same bits; the same params load alike
  from 1 shard and from 3.
- A flipped byte raises ``IOError`` (CRC32), a missing shard
  ``FileNotFoundError``.
- A manifest without ``pack_axis`` (stores written before it was recorded)
  decodes -1, as in the reference, and quantized serving refuses such an
  int4 store with ``NotImplementedError``.
- ``pack_greedy`` and ``crc32`` agree with the JAX package's.
- The loaders take ``device=None`` as CUDA and raise without it.

llama-tiny width (4 layers, d_model 64) with vocab 512.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_llms_tpu import native
from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.checkpoint.quantize import QuantizedTensor as JaxQT
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.parallel.stages import pack_greedy as jax_pack_greedy
from distributed_llms_tpu_torch.checkpoint import quantize as quant_lib
from distributed_llms_tpu_torch.checkpoint import store as tstore
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.checkpoint.quantize import QuantizedTensor
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.models.presets import get_preset
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine


def _weights(dtype):
    cfg_j = jax_preset("llama-tiny", vocab_size=512, dtype=dtype)
    cfg_t = get_preset("llama-tiny", vocab_size=512, dtype=dtype)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.fixture(scope="module")
def bf16():
    return _weights("bfloat16")


def _bits(a) -> np.ndarray:
    """An array's raw bits, from a numpy/JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _assert_same_tree(jtree, ttree):
    jl, tl = _leaves(jtree), _leaves(ttree)
    assert sorted(jl) == sorted(tl)
    for name, j in jl.items():
        t = tl[name]
        if isinstance(j, JaxQT):
            assert isinstance(t, QuantizedTensor), name
            assert (t.bits, t.pack_axis, tuple(t.orig_shape)) == (
                j.bits, j.pack_axis, tuple(j.orig_shape)), name
            np.testing.assert_array_equal(_bits(t.data), _bits(j.data))
            np.testing.assert_array_equal(_bits(t.scale).view(np.int32),
                                          _bits(j.scale).view(np.int32))
        else:
            assert not isinstance(t, QuantizedTensor), name
            jb, tb = _bits(j), _bits(t)
            assert jb.dtype == tb.dtype and jb.shape == tb.shape, name
            np.testing.assert_array_equal(tb, jb)


def _save_both(weights, tmp_path, **kw):
    cfg_j, cfg_t, pj, pt = weights
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save_shards(pj, jdir, model_config=cfg_j, **kw)
    tstore.save_shards(pt, tdir, model_config=cfg_t, **kw)
    return jdir, tdir


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("storage", ["raw", "npz"])
def test_stores_load_both_ways(bf16, tmp_path, storage, quant, shards):
    jdir, tdir = _save_both(bf16, tmp_path, num_shards=shards,
                            quantization=quant, storage=storage)
    assert tstore.load_manifest(tdir) == jstore.load_manifest(jdir)
    if storage == "raw":
        for i in range(shards):
            assert filecmp.cmp(os.path.join(jdir, f"shard_{i}.bin"),
                               os.path.join(tdir, f"shard_{i}.bin"),
                               shallow=False), f"shard {i} differs"
    # JAX wrote -> the port reads; the port wrote -> JAX reads.
    _assert_same_tree(jstore.load_shards(jdir),
                      tstore.load_shards(jdir, device="cpu"))
    _assert_same_tree(jstore.load_shards(tdir),
                      tstore.load_shards(tdir, device="cpu"))


def test_float32_store_loads_both_ways(tmp_path):
    jdir, tdir = _save_both(_weights("float32"), tmp_path, num_shards=3,
                            quantization="int4")
    for i in range(3):
        assert filecmp.cmp(os.path.join(jdir, f"shard_{i}.bin"),
                           os.path.join(tdir, f"shard_{i}.bin"), shallow=False)
    _assert_same_tree(jstore.load_shards(tdir),
                      tstore.load_shards(jdir, device="cpu"))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_reconstruct_and_shard_subsets_match(bf16, tmp_path, quant):
    """``reconstruct`` matches the JAX package's, and a store split over 3
    shards loads the same tree as the same params in 1 shard."""
    jdir, _ = _save_both(bf16, tmp_path, num_shards=3, quantization=quant)
    _assert_same_tree(jstore.reconstruct(jdir, dtype=jnp.bfloat16),
                      tstore.reconstruct(jdir, dtype=torch.bfloat16,
                                         device="cpu"))
    _assert_same_tree(jstore.reconstruct(jdir),
                      tstore.reconstruct(jdir, device="cpu"))
    _assert_same_tree(jstore.reconstruct(jdir, dtype=jnp.float32),
                      tstore.reconstruct(jdir, dtype="float32", device="cpu"))
    one = str(tmp_path / "one")
    tstore.save_shards(bf16[3], one, num_shards=1, quantization=quant)
    _assert_same_tree(jstore.load_shards(jdir),
                      tstore.load_shards(one, device="cpu"))


def test_flipped_byte_raises_ioerror(bf16, tmp_path):
    _, tdir = _save_both(bf16, tmp_path, num_shards=1, quantization="int8")
    meta = tstore.load_manifest(tdir)["arrays"]["blocks/attn/wq.q"]
    path = os.path.join(tdir, "shard_0.bin")
    with open(path, "r+b") as f:
        f.seek(meta["offset"] + meta["nbytes"] // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x10]))
    with pytest.raises(IOError, match="checksum mismatch"):
        tstore.load_shards(tdir, device="cpu")


def test_arrays_load_over_partial_reads(bf16, tmp_path, monkeypatch):
    """One ``read`` returns at most ~2 GiB on Linux, so an array of a
    large store (Mixtral-8x7B's expert stacks: 7.5 GB) arrives over
    several: a file object that returns 1000 bytes a call loads the same
    tree; a truncated shard still raises."""
    import io

    _, tdir = _save_both(bf16, tmp_path, num_shards=1, quantization="int8")
    want = jstore.load_shards(tdir)

    class Chunky(io.FileIO):
        def readinto(self, b):
            return super().readinto(memoryview(b)[:1000])

    monkeypatch.setattr(tstore, "open", lambda path, mode="r", buffering=-1:
                        Chunky(path, "rb"), raising=False)
    _assert_same_tree(want, tstore.load_shards(tdir, device="cpu"))
    # The store reads through the native reader now; the plain reader it is
    # held against still loops over partial reads.
    path = os.path.join(tdir, "shard_0.bin")
    for meta in tstore.load_manifest(tdir)["arrays"].values():
        buf = tstore._read_checked(path, meta["offset"], meta["nbytes"],
                                   meta["crc32"])
        assert len(buf) == meta["nbytes"]
    os.truncate(path, os.path.getsize(path) - 1)
    with pytest.raises(IOError, match="short read"):
        tstore.load_shards(tdir, device="cpu")


@pytest.mark.parametrize("storage", ["raw", "npz"])
def test_missing_shard_raises(bf16, tmp_path, storage):
    _, tdir = _save_both(bf16, tmp_path, num_shards=3, storage=storage)
    os.remove(os.path.join(tdir, f"shard_2.{'bin' if storage == 'raw' else 'npz'}"))
    with pytest.raises(FileNotFoundError, match="shard 2"):
        tstore.load_shards(tdir, device="cpu")


def test_manifest_without_pack_axis_decodes_minus_one(bf16, tmp_path):
    _, tdir = _save_both(bf16, tmp_path, num_shards=1, quantization="int4")
    mpath = os.path.join(tdir, tstore.MANIFEST)
    manifest = tstore.load_manifest(tdir)
    for entry in manifest["params"].values():
        entry.pop("pack_axis", None)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    got = _leaves(tstore.load_shards(tdir, device="cpu"))
    want = _leaves(jstore.load_shards(tdir))
    quantized = [n for n, leaf in got.items() if isinstance(leaf, QuantizedTensor)]
    assert quantized and all(got[n].pack_axis == -1 == want[n].pack_axis
                             for n in quantized)
    # Served now: a store that really packed its pairs along the last axis
    # (what such a manifest meant) is repacked at load onto each weight's
    # contracted axis, exactly, and the dequant-matmul reads it.
    cfg_j, _, pj, _ = bf16
    legacy = {k: (quant_lib_j_legacy(v) if k == "blocks" else v)
              for k, v in pj.items()}
    ldir = str(tmp_path / "legacy")
    jstore.save_shards(legacy, ldir, model_config=cfg_j)
    mpath = os.path.join(ldir, tstore.MANIFEST)
    manifest = tstore.load_manifest(ldir)
    manifest["quantization"] = "int4"
    for entry in manifest["params"].values():
        entry.pop("pack_axis", None)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    eng = InferenceEngine.from_store(ldir, rt=RuntimeConfig(serve_quantized=True),
                                     device="cpu")
    attn = eng.params["blocks"]["attn"]
    assert (attn["wq"].pack_axis, attn["wo"].pack_axis) == (-3, -2)
    read = _leaves(tstore.load_shards(ldir, device="cpu"))
    for name in ("wq", "wo"):
        assert read[f"blocks/attn/{name}"].pack_axis == -1
        assert torch.equal(quant_lib.dequantize(attn[name]),
                           quant_lib.dequantize(read[f"blocks/attn/{name}"]))


def quant_lib_j_legacy(blocks):
    """The JAX package's int4 quantization of every block matrix with its
    pairs along the LAST axis (the layout before ``pack_axis`` existed)."""
    from distributed_llms_tpu.checkpoint import quantize as jq

    if isinstance(blocks, dict):
        return {k: quant_lib_j_legacy(v) for k, v in blocks.items()}
    if blocks.ndim < 3:
        return blocks
    return jq.quantize(blocks, bits=4, pack_axis=-1)


def test_pack_greedy_and_crc32_agree_with_jax():
    rng = np.random.default_rng(0)
    sizes = {f"leaf{i}": int(s) for i, s in
             enumerate(rng.choice([64, 128, 4096, 4096, 9000], 40))}
    for bins in (1, 2, 3, 7):
        assert tstore.pack_greedy(sizes, bins) == jax_pack_greedy(sizes, bins)
    for n in (0, 1, 63, 4097):
        arr = rng.integers(0, 256, n).astype(np.uint8)
        assert tstore.crc32(arr) == native.crc32(arr)


def test_loaders_default_to_cuda(bf16, tmp_path, monkeypatch):
    _, tdir = _save_both(bf16, tmp_path, num_shards=1, quantization="int8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (tstore.load_shards, tstore.reconstruct):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(tdir)


def test_manifest_model_config_builds_the_ports_config():
    """``ModelConfig(**manifest["model_config"])`` takes every field the
    JAX package's ``dataclasses.asdict`` writes, for every preset."""
    import dataclasses

    from distributed_llms_tpu.models.presets import PRESETS as JAX_PRESETS
    from distributed_llms_tpu_torch.core.config import ModelConfig

    for name, cfg in JAX_PRESETS.items():
        fields = json.loads(json.dumps(dataclasses.asdict(cfg)))
        assert dataclasses.asdict(ModelConfig(**fields)) == fields, name
        assert ModelConfig(**fields) == get_preset(name), name
