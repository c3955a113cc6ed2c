"""The port's native segment reader (``native/``: threaded ``pread`` with
the CRC32 in the same pass, built from the port's own ``csrc/dlt_io.cpp``
into ``build/native/``) against the plain reader (``checkpoint/store.py``
``_read_checked``) and zlib, and legacy int4 stores served through the
dequant-matmul after their exact repack.

- the same bytes and CRC32s as the plain reader over every array of a
  raw store, and a store load through it equal to the JAX package's;
- a corrupt segment raises (a CRC mismatch at load, a short read), and a
  failed build raises — no quiet fallback;
- the library is the port's own build, not the JAX package's
  ``native/_cache``;
- a legacy int4 store (pairs along the last axis) repacks exactly
  (dequantized values unchanged) and serves the reference's logits.
"""

import json
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from distributed_llms_tpu.checkpoint import quantize as jq
from distributed_llms_tpu.checkpoint import store as jstore
from distributed_llms_tpu.core.config import RuntimeConfig as JRuntimeConfig
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llms_tpu_torch import native
from distributed_llms_tpu_torch.checkpoint import quantize as tq
from distributed_llms_tpu_torch.checkpoint import store as tstore
from distributed_llms_tpu_torch.core.config import RuntimeConfig
from distributed_llms_tpu_torch.ops import quant_matmul as tqm
from distributed_llms_tpu_torch.runtime.engine import InferenceEngine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raw_store(tmp_path_factory):
    cfg = jax_preset("llama-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(0), cfg)
    path = str(tmp_path_factory.mktemp("native_store"))
    jstore.save_shards(params, path, num_shards=3, model_config=cfg)
    return path, params


def _tasks(path):
    man = tstore.load_manifest(path)
    return man, [(os.path.join(path, f"shard_{m['shard']}.bin"), m["offset"],
                  m["nbytes"]) for m in man["arrays"].values()]


def test_native_reads_equal_plain_reads(raw_store):
    path, _ = raw_store
    man, tasks = _tasks(path)
    bufs, crcs = native.read_segments(tasks, threads=4)
    for (p, off, nb), buf, crc, meta in zip(tasks, bufs, crcs,
                                            man["arrays"].values()):
        plain = tstore._read_checked(p, off, nb, meta["crc32"])
        assert np.array_equal(buf, plain)
        assert crc == meta["crc32"] == zlib.crc32(plain) & 0xFFFFFFFF
        assert native.crc32(buf) == crc


def test_reads_land_in_given_buffers(raw_store):
    path, _ = raw_store
    _, tasks = _tasks(path)
    out = [torch.empty(nb, dtype=torch.uint8) for _, _, nb in tasks[:3]]
    bufs, _ = native.read_segments(tasks[:3], out=out)
    assert bufs[0] is out[0]
    plain, _ = native.read_segments(tasks[:3])
    for a, b in zip(out, plain):
        assert np.array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="byte"):
        native.read_segments(tasks[:1], out=[torch.empty(1, dtype=torch.uint8)])


def test_store_loads_through_it_as_the_reference(raw_store):
    path, params = raw_store
    got = tstore.load_shards(path, device="cpu")
    want = jstore.load_shards(path)

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
            return
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))

    walk(got, want)


def test_corrupt_segment_raises(raw_store, tmp_path):
    path, _ = raw_store
    bad = str(tmp_path / "corrupt")
    import shutil

    shutil.copytree(path, bad)
    man = tstore.load_manifest(bad)
    meta = next(iter(man["arrays"].values()))
    shard = os.path.join(bad, f"shard_{meta['shard']}.bin")
    with open(shard, "r+b") as f:
        f.seek(meta["offset"])
        byte = f.read(1)
        f.seek(meta["offset"])
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(IOError, match="checksum mismatch"):
        tstore.load_shards(bad, device="cpu")
    with pytest.raises(IOError, match="native read failed"):
        native.read_segments([(shard, os.path.getsize(shard) - 4, 64)])
    with pytest.raises(IOError, match="native read failed"):
        native.read_segments([(str(tmp_path / "missing.bin"), 0, 8)])


def test_library_is_the_ports_own_build():
    so = native.library_path()
    assert so.parent.name == "native" and so.parent.parent.name == "build"
    assert "distributed_llms_tpu/" not in str(so).replace(
        "distributed_llms_tpu_torch", "")
    assert native.SRC.parent.parent.name == "native"
    assert native.SRC.is_file() and native.get_lib()._name == str(so)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native reader build failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.tmp.so"))


# -- legacy int4 stores ---------------------------------------------------------

@pytest.mark.parametrize("shape,k_lead,axis", [
    ((64, 96), 1, -1), ((4, 16, 32), 2, -1), ((32, 4, 16), 1, -1)])
def test_repack_is_exact(shape, k_lead, axis):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    legacy = tq.quantize(w, bits=4, block=16, pack_axis=axis)
    fixed = tqm.repack_legacy_int4(legacy, k_lead)
    assert fixed.pack_axis == k_lead - 1 - len(shape)
    assert torch.equal(tq.dequantize(fixed), tq.dequantize(legacy))
    tqm.check_pack_axis(fixed, k_lead)
    assert tqm.repack_legacy_int4(fixed, k_lead) is fixed
    with pytest.raises(ValueError, match="repack_legacy_int4"):
        tqm.check_pack_axis(legacy, k_lead)


def test_legacy_int4_store_serves_the_reference_logits(tmp_path):
    """A store written with the pairs on the last axis and no pack_axis in
    its manifest: the port repacks at load and serves through the
    dequant-matmul; its greedy tokens and first-step logits equal the
    reference's (which dequantizes such leaves) and the same store in the
    current layout."""
    cfg = jax_preset("llama-tiny", vocab_size=512)
    params = jm.init_params(jax.random.key(0), cfg)

    def quantize(tree, path, axis):
        if isinstance(tree, dict):
            return {k: quantize(v, f"{path}/{k}", axis) for k, v in tree.items()}
        if not path.startswith("/blocks") or tree.ndim < 3:
            return tree
        plan_axis = axis or jq.leaf_plan(path.lstrip("/"), tree[0])[1]
        return jq.quantize(tree, bits=4, block=32, pack_axis=plan_axis)

    paths = {}
    for name, axis in (("legacy", -1), ("current", None)):
        q = {k: (quantize(v, f"/{k}", axis) if k == "blocks" else v)
             for k, v in params.items()}
        paths[name] = str(tmp_path / name)
        jstore.save_shards(q, paths[name], num_shards=2, model_config=cfg)
        man_path = os.path.join(paths[name], "manifest.json")
        man = json.load(open(man_path))
        man["quantization"] = "int4"
        if name == "legacy":
            for entry in man["params"].values():
                entry.pop("pack_axis", None)
        json.dump(man, open(man_path, "w"))
    ref = JEngine.from_store(paths["legacy"], rt=JRuntimeConfig(
        max_decode_steps=6, serve_quantized=True))
    want = ref.generate_text(["legacy int4"], max_new_tokens=6).tokens.tolist()
    for name in ("legacy", "current"):
        eng = InferenceEngine.from_store(
            paths[name], rt=RuntimeConfig(max_decode_steps=6,
                                          serve_quantized=True),
            device="cpu")
        wq = eng.params["blocks"]["attn"]["wq"]
        assert isinstance(wq, tq.QuantizedTensor) and wq.pack_axis == -3
        assert eng.generate_text(["legacy int4"],
                                 max_new_tokens=6).tokens.tolist() == want
    toks = np.asarray([[5, 6, 7, 8]], np.int32)
    jlogits = np.asarray(jm.forward(ref.params, cfg, toks)[0])
    from distributed_llms_tpu_torch.models import model as tm

    eng = InferenceEngine.from_store(
        paths["legacy"], rt=RuntimeConfig(serve_quantized=True), device="cpu")
    logits, _ = tm.forward(eng.params, eng.cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=1e-4)
