"""Sharded checkpoint store (PyTorch port of
``distributed_llms_tpu/checkpoint/store.py``).

The on-disk layout is the JAX package's ``format_version`` 2, so a store
written by either stack loads in the other:

    <dir>/manifest.json   {params: {name: {shard, shape, dtype[, bits,
                           pack_axis]}}, arrays: {name: {shard[, offset,
                           nbytes, crc32, dtype, shape]}}, storage,
                           num_shards, model_config, quantization,
                           tokenizer}
    <dir>/shard_<i>.bin   storage="raw" (default): arrays concatenated at
                          64-byte-aligned offsets, a CRC32 per array
    <dir>/shard_<i>.npz   storage="npz": numpy archives (v1 compatibility)

Param names join the tree's keys with "/"; leaves are visited in sorted
key order (the JAX pytree order), bfloat16 is stored as a uint16 view, and
a quantized leaf writes ``<name>.q`` (int8 codes) and ``<name>.scale``
(float32).  Leaves are assigned to shards by greedy largest-first byte
packing, so both stacks put every array in the same shard at the same
offset: raw shards are byte-identical.

:func:`save_shards` quantizes, moves to the host and writes ONE leaf at a
time, and :func:`load_shards` reads, checks and moves to ``device`` one
leaf at a time, so a full-width model never sits on the host twice.  Reads
are plain ``readinto`` calls checked with ``zlib.crc32`` (the polynomial
the JAX package's native reader uses); a mismatch raises ``IOError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.device import resolve_device
from ..core.observability import get_logger
from ..models.model import torch_dtype
from . import quantize as quant_lib
from .quantize import QuantizedTensor
from ..parallel.stages import pack_greedy

SEP = "/"
MANIFEST = "manifest.json"
ALIGN = 64  # raw storage: array offsets aligned for mmap/DMA friendliness

# HF tokenizer files copied into the store, so serving decodes with the
# model's own vocabulary.
TOKENIZER_DIR = "tokenizer"
_TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "vocab.json",
    "merges.txt",
    "special_tokens_map.json",
    "tokenizer.model",
    "added_tokens.json",
    "vocab.txt",
    "spiece.model",
)


def crc32(arr: np.ndarray) -> int:
    """CRC32 of an array's bytes, checksummed in place."""
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).reshape(-1)) \
        & 0xFFFFFFFF


def _read_checked(path: str, offset: int, nbytes: int, crc: int) -> np.ndarray:
    """``nbytes`` bytes of ``path`` from ``offset`` into a fresh uint8
    buffer, held to their CRC32.  The buffer fills over as many reads as
    the OS returns (one ``read`` stops near 2 GiB on Linux; an expert
    stack of Mixtral-8x7B's store is 7.5 GB).  A file that ends early or
    a mismatch raises ``IOError``."""
    buf = np.empty(nbytes, dtype=np.uint8)
    view = memoryview(buf)
    got = 0
    with open(path, "rb", buffering=0) as f:
        f.seek(offset)
        while got < nbytes:
            n = f.readinto(view[got:])
            if not n:
                break
            got += n
    if got != nbytes:
        raise IOError(f"short read from {path} @ {offset} ({got}/{nbytes})")
    if crc32(buf) != crc:
        raise IOError(
            f"checksum mismatch in {path} @ {offset} (expected {crc:#010x}, "
            f"got {crc32(buf):#010x}) — store corrupt?")
    return buf


def _flatten(params: Any, prefix: str = "") -> dict[str, Any]:
    """{"/"-joined name: leaf} in sorted key order (the JAX pytree order)."""
    if isinstance(params, dict):
        flat: dict[str, Any] = {}
        for k in sorted(params):
            flat.update(_flatten(params[k], f"{prefix}{k}{SEP}"))
        return flat
    return {prefix[:-1]: params}


def _unflatten(flat: dict[str, Any]) -> dict[str, Any]:
    tree: dict[str, Any] = {}
    for name, leaf in flat.items():
        node = tree
        parts = name.split(SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _quantized_nbytes(shape: Sequence[int], bits: int, block: int) -> int:
    """Bytes of a leaf once quantized (codes + float32 scales), from its
    shape alone."""
    numel = int(np.prod(shape))
    scales = numel // quant_lib.quant_block(shape[-1], block)
    return (numel // 2 if bits == 4 else numel) + 4 * scales


def _copy_tokenizer(tokenizer_src: str, out_dir: str) -> str | None:
    found = [f for f in _TOKENIZER_FILES
             if os.path.isfile(os.path.join(tokenizer_src, f))]
    if not found:
        get_logger("store").warning(
            "tokenizer_src %r contains no recognized tokenizer files; "
            "store will fall back to byte-level ids at serve time",
            tokenizer_src,
        )
        return None
    tok_dir = os.path.join(out_dir, TOKENIZER_DIR)
    # A reused store dir may hold another model's tokenizer files, which
    # could win the tokenizer's file preference: clear before copying.
    shutil.rmtree(tok_dir, ignore_errors=True)
    os.makedirs(tok_dir, exist_ok=True)
    for f in found:
        shutil.copy2(os.path.join(tokenizer_src, f), os.path.join(tok_dir, f))
    return TOKENIZER_DIR


def save_shards(
    params: Any,
    out_dir: str,
    num_shards: int = 1,
    model_config: ModelConfig | None = None,
    quantization: str | None = None,  # None | "int8" | "int4"
    quant_block: int = 128,
    storage: str = "raw",  # "raw" (aligned blobs + CRC32) | "npz" (v1)
    tokenizer_src: str | None = None,  # checkpoint dir whose tokenizer
    #                                    files are copied into the store
) -> dict:
    """Write ``params`` (tensors on any device, optionally quantizing
    first) into a sharded store.  Returns the manifest dict."""
    if storage not in ("raw", "npz"):
        raise ValueError(f"unknown storage {storage!r}; raw|npz")
    bits = {"int8": 8, "int4": 4}[quantization] if quantization else None
    os.makedirs(out_dir, exist_ok=True)
    tokenizer_rel = (_copy_tokenizer(tokenizer_src, out_dir)
                     if tokenizer_src is not None else None)

    flat = _flatten(params)
    plans: dict[str, tuple[bool, int]] = {}  # tensors to quantize
    sizes: dict[str, int] = {}
    for name, leaf in flat.items():
        if isinstance(leaf, QuantizedTensor):
            sizes[name] = leaf.data.numel() + leaf.scale.numel() * 4
            continue
        plans[name] = (quant_lib.leaf_plan(name, leaf) if bits
                       else (False, -2))
        sizes[name] = (_quantized_nbytes(leaf.shape, bits, quant_block)
                       if plans[name][0]
                       else leaf.numel() * leaf.element_size())
    assignment = pack_greedy(sizes, num_shards)

    entries: dict[str, dict] = {}

    def arrays_of(name: str) -> list[tuple[str, np.ndarray]]:
        """One leaf's arrays on the host, its manifest entry recorded."""
        leaf = flat[name]
        shard = assignment[name]
        should, pack_axis = plans.get(name, (False, -2))
        if should:
            leaf = quant_lib.quantize(leaf, bits=bits, block=quant_block,
                                      pack_axis=pack_axis)
        if isinstance(leaf, QuantizedTensor):
            entries[name] = {"shard": shard, "shape": list(leaf.orig_shape),
                             "dtype": "quantized", "bits": leaf.bits,
                             "pack_axis": leaf.pack_axis}
            return [(name + ".q", _to_numpy(leaf.data)),
                    (name + ".scale", _to_numpy(leaf.scale))]
        arr = _to_numpy(leaf)
        entries[name] = {"shard": shard, "shape": list(arr.shape),
                         "dtype": ("bfloat16" if leaf.dtype == torch.bfloat16
                                   else str(arr.dtype))}
        return [(name, arr)]

    arrays_meta: dict[str, dict] = {}
    for i in range(num_shards):
        names = [n for n in flat if assignment[n] == i]
        if storage == "npz":
            arrays = dict(a for n in names for a in arrays_of(n))
            np.savez(os.path.join(out_dir, f"shard_{i}.npz"), **arrays)
            arrays_meta.update({aname: {"shard": i} for aname in arrays})
            continue
        with open(os.path.join(out_dir, f"shard_{i}.bin"), "wb") as f:
            for name in names:
                for aname, arr in arrays_of(name):
                    arr = np.ascontiguousarray(arr)
                    f.write(b"\0" * ((-f.tell()) % ALIGN))
                    offset = f.tell()
                    arr.tofile(f)
                    arrays_meta[aname] = {
                        "shard": i, "offset": offset,
                        "nbytes": int(arr.nbytes), "crc32": crc32(arr),
                        "dtype": str(arr.dtype), "shape": list(arr.shape),
                    }

    manifest = {
        "format_version": 2,
        "storage": storage,
        "num_shards": num_shards,
        "quantization": quantization,
        "params": {name: entries[name] for name in flat},
        "arrays": arrays_meta,
        "model_config": (dataclasses.asdict(model_config)
                         if model_config else None),
        "tokenizer": tokenizer_rel,  # store-relative dir of tokenizer files
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_manifest(store_dir: str) -> dict:
    with open(os.path.join(store_dir, MANIFEST)) as f:
        return json.load(f)


class _Arrays:
    """A store's arrays.  Raw shards are read through the native segment
    reader (``native/``: threaded ``pread`` with the CRC32 in the same
    pass), a batch of arrays at a time (:meth:`prefetch`); npz shards one
    at a time.  When the arrays go to a GPU they land in one pinned host
    arena, allocated once and reused by every batch, so a batch's arrays
    must be copied out before the next :meth:`prefetch`."""

    def __init__(self, store_dir: str, manifest: dict, pin: bool = False):
        self.dir = store_dir
        self.manifest = manifest
        self.raw = manifest.get("storage", "npz") == "raw"
        self.pin = pin
        self._arena: torch.Tensor | None = None
        self.npz: dict[int, Any] = {}
        self._ready: dict[str, Any] = {}
        for i in range(manifest["num_shards"]):
            path = self._shard_path(i)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"manifest lists shard {i} but {path} is missing")

    def _shard_path(self, i: int) -> str:
        ext = "bin" if self.raw else "npz"
        return os.path.join(self.dir, f"shard_{i}.{ext}")

    def prefetch(self, anames: list[str]) -> None:
        """Read these raw arrays in one parallel pass, each held to its
        CRC32 (a mismatch raises ``IOError``)."""
        if not self.raw:
            return
        from .. import native

        metas = [self.manifest["arrays"][a] for a in anames]
        tasks = [(self._shard_path(m["shard"]), m["offset"], m["nbytes"])
                 for m in metas]
        out = None
        if self.pin:
            total = sum(m["nbytes"] for m in metas)
            if self._arena is None or self._arena.numel() < total:
                self._arena = None
                self._arena = torch.empty(total, dtype=torch.uint8,
                                          pin_memory=True)
            out, at = [], 0
            for m in metas:
                out.append(self._arena[at:at + m["nbytes"]])
                at += m["nbytes"]
        bufs, crcs = native.read_segments(tasks, out=out)
        for a, m, buf, crc in zip(anames, metas, bufs, crcs):
            if crc != m["crc32"]:
                raise IOError(
                    f"checksum mismatch in {self._shard_path(m['shard'])} @ "
                    f"{m['offset']} (expected {m['crc32']:#010x}, got "
                    f"{crc:#010x}) — store corrupt?")
            self._ready[a] = buf

    def __getitem__(self, aname: str) -> np.ndarray:
        meta = self.manifest["arrays"][aname]
        if not self.raw:
            z = self.npz.get(meta["shard"])
            if z is None:
                z = self.npz[meta["shard"]] = np.load(
                    self._shard_path(meta["shard"]))
            return z[aname]
        if aname not in self._ready:
            self.prefetch([aname])
        buf = self._ready.pop(aname)
        if isinstance(buf, torch.Tensor):
            buf = buf.numpy()
        return buf.view(np.dtype(meta["dtype"])).reshape(meta["shape"])

    def close(self) -> None:
        for z in self.npz.values():
            z.close()


# Bytes of raw arrays read in one parallel pass of the native reader.
PREFETCH_BYTES = 1 << 30


def _batches(manifest: dict, names: list[str]) -> list[list[str]]:
    """The store's array names in read batches of about PREFETCH_BYTES (an
    npz store's in one: its shards load whole)."""
    if manifest.get("storage", "npz") != "raw":
        return [[a for n in names for a in (
            [n + ".q", n + ".scale"]
            if manifest["params"][n]["dtype"] == "quantized" else [n])]]
    out: list[list[str]] = [[]]
    size = 0
    for name in names:
        meta = manifest["params"][name]
        arrays = ([name + ".q", name + ".scale"]
                  if meta["dtype"] == "quantized" else [name])
        nbytes = sum(manifest["arrays"][a]["nbytes"] for a in arrays)
        if out[-1] and size + nbytes > PREFETCH_BYTES:
            out.append([])
            size = 0
        out[-1].extend(arrays)
        size += nbytes
    return out


def load_shards(
    store_dir: str,
    dequantize: bool = False,
    dtype: "str | torch.dtype | None" = None,
    device: "str | torch.device | None" = None,
    place: Any = None,
) -> dict[str, Any]:
    """Load every param of the store, each leaf moved to ``device`` (None
    means CUDA; see ``core.device``) as soon as it is read.  Returns the
    nested param tree: tensors, and :class:`QuantizedTensor` leaves unless
    ``dequantize`` (then dequantized to ``dtype``, default float32).
    ``dtype`` also casts the unquantized leaves.  ``place(name, leaf)``
    (a mesh rank's cut, ``parallel/specs.py``) transforms each leaf on the
    host before it moves; a leaf it returns None for is not kept (a
    pipeline stage's share of the head)."""
    device = resolve_device(device)
    manifest = load_manifest(store_dir)
    dtype = torch_dtype(dtype) if dtype is not None else None
    arrays = _Arrays(store_dir, manifest, pin=device.type == "cuda")
    names = list(manifest["params"])
    flat: dict[str, Any] = {}

    try:
        for batch in _batches(manifest, names):
            arrays.prefetch(batch)
            for name in dict.fromkeys(a if a in manifest["params"]
                                      else a.rsplit(".", 1)[0]
                                      for a in batch):
                meta = manifest["params"][name]
                if meta["dtype"] == "quantized":
                    leaf = QuantizedTensor(
                        data=torch.from_numpy(arrays[name + ".q"]),
                        scale=torch.from_numpy(arrays[name + ".scale"]),
                        bits=meta["bits"],
                        orig_shape=tuple(meta["shape"]),
                        # Stores written before pack_axis was recorded
                        # packed int4 pairs along the LAST axis: a missing
                        # key decodes as -1, not the modern default of -2.
                        pack_axis=meta.get("pack_axis", -1),
                    )
                    if dequantize:
                        # Dequantized where it will live, then cut there.
                        leaf = quant_lib.dequantize(leaf.to(device),
                                                    dtype or torch.float32)
                        if place is not None:
                            leaf = place(name, leaf)
                        if leaf is not None:
                            flat[name] = leaf
                        continue
                else:
                    arr = arrays[name]
                    if meta["dtype"] == "bfloat16":
                        leaf = torch.from_numpy(arr.view(np.int16)).view(
                            torch.bfloat16)
                    else:
                        leaf = torch.from_numpy(np.asarray(arr))
                    if dtype:
                        leaf = leaf.to(device).to(dtype)
                # Cut on the host (only the rank's block crosses to the
                # device), then moved.
                if place is not None:
                    leaf = place(name, leaf)
                if leaf is not None:
                    flat[name] = leaf.to(device)
    finally:
        arrays.close()
    return _unflatten(flat)


def reconstruct(store_dir: str, dtype: "str | torch.dtype | None" = None,
                device: "str | torch.device | None" = None,
                place: Any = None) -> dict[str, Any]:
    """Merge every shard back into a full (dequantized) param tree on
    ``device`` (None means CUDA); ``place`` as in :func:`load_shards`."""
    return load_shards(store_dir, dequantize=True, dtype=dtype, device=device,
                       place=place)
