"""Weight and int8 KV quantization of the PyTorch port against the JAX
package.

Weights: ``quantize`` / ``dequantize`` / ``quantize_tree`` must be
BIT-exact with the JAX package's (int8 codes, float32 scales and the
dequantized values equal to the last bit), because the two stacks' shard
stores must hold the same bytes: int8 and int4, pack axes -2 and -3,
stacked ``[L, ...]`` leaves and their per-layer slices, widths whose scale
block shrinks to a gcd, bfloat16 inputs, and ``leaf_plan``'s decisions on
a llama tree (norms and 1-d leaves stay, wq/wk/wv pack along -3).

``kv_quantize`` must be BIT-exact (int8 data and float32 scales equal to
the last bit) on the same numpy inputs: the prefix-cache digests are
salted by the KV width, so an int8 page has to hold the same bytes in both
stacks.  Covered: random float32 and bfloat16 vectors, all-zero vectors
(scale 1), and values exactly half a quantization step apart (round half
to even).  ``kv_dequantize`` is float32(data) * scale in both, cast to the
target dtype — also bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ml_dtypes

import jax

from distributed_llms_tpu.checkpoint import quantize as jq
from distributed_llms_tpu.models import model as jm
from distributed_llms_tpu.models.presets import get_preset as jax_preset
from distributed_llms_tpu_torch.checkpoint import quantize as tq
from distributed_llms_tpu_torch.checkpoint.from_jax import params_from_numpy
from distributed_llms_tpu_torch.models.presets import get_preset


def _both(x: np.ndarray):
    dj, sj = jq.kv_quantize(jnp.asarray(x))
    if x.dtype == ml_dtypes.bfloat16:
        xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        xt = torch.from_numpy(x)
    dt, st = tq.kv_quantize(xt)
    return (np.asarray(dj), np.asarray(sj)), (dt.numpy(), st.numpy())


def _assert_bit_exact(x):
    (dj, sj), (dt, st) = _both(x)
    assert dt.dtype == np.int8 and st.dtype == np.float32
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(st.view(np.int32), sj.view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(4, 3, 2, 16), (7, 128)])
def test_kv_quantize_is_bit_exact(dtype, shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1] + (1,)))
    _assert_bit_exact(x.astype(dtype))


def test_all_zero_vectors_get_scale_one():
    x = np.zeros((3, 2, 8), np.float32)
    x[1, 1] = np.linspace(-1, 1, 8)
    _assert_bit_exact(x)
    _, st = tq.kv_quantize(torch.from_numpy(x))
    assert st[0, 0] == 1.0 and st[2, 1] == 1.0


def test_half_step_ties_round_to_even():
    # absmax 127 -> scale 1: x / scale lands exactly on k + 0.5.
    ties = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]],
                    np.float32)
    # absmax 254 -> scale 2: 5 -> 2.5, 7 -> 3.5.
    ties2 = np.array([[254.0, 5.0, 7.0, -5.0, -7.0, 1.0, 3.0, -1.0]],
                     np.float32)
    for x in (ties, ties2):
        _assert_bit_exact(x)
    dt, _ = tq.kv_quantize(torch.from_numpy(ties))
    assert dt[0].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_dequantize_matches(dtype):
    rng = np.random.default_rng(1)
    data = rng.integers(-127, 128, (5, 2, 16)).astype(np.int8)
    scale = rng.uniform(0.001, 2.0, (5, 2)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jq.kv_dequantize(jnp.asarray(data), jnp.asarray(scale),
                                       jdt)).astype(np.float32)
    got = tq.kv_dequantize(torch.from_numpy(data), torch.from_numpy(scale),
                           dtype).float().numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_round_trip_is_stable():
    """Quantizing a dequantized vector reproduces the data and scale (the
    reference's round-trip property, held by the port too)."""
    x = np.random.default_rng(2).standard_normal((6, 4, 32)).astype(np.float32)
    d, s = tq.kv_quantize(torch.from_numpy(x))
    d2, s2 = tq.kv_quantize(tq.kv_dequantize(d, s, torch.float32))
    assert torch.equal(d, d2) and torch.equal(s, s2)


# -- weights ------------------------------------------------------------------

def _assert_qt_equal(jqt, tqt):
    assert (tqt.bits, tqt.pack_axis, tuple(tqt.orig_shape)) == (
        jqt.bits, jqt.pack_axis, tuple(jqt.orig_shape))
    assert tuple(tqt.unpacked_shape) == tuple(jqt.unpacked_shape)
    np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(tqt.scale.numpy().view(np.int32),
                                  np.asarray(jqt.scale).view(np.int32))


def _assert_dequantized_equal(jqt, tqt):
    want = np.asarray(jq.dequantize(jqt)).view(np.int32)
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy().view(np.int32),
                                  want)
    want16 = np.asarray(jq.dequantize(jqt, jnp.bfloat16)).view(np.uint16)
    got16 = tq.dequantize(tqt, torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got16.view(np.uint16), want16)


WEIGHT_CASES = [
    # shape, bits, pack_axis, block
    ((256, 96), 8, -2, 128),       # block capped at the width, 96
    ((256, 96), 4, -2, 128),
    ((64, 4, 16), 4, -3, 128),     # wq layout, block = head dim 16
    ((4, 16, 64), 4, -2, 128),     # wo layout
    ((3, 64, 176), 8, -2, 128),    # stacked [L, D, F], gcd(176, 128) = 16
    ((3, 64, 176), 4, -2, 128),
    ((2, 64, 2, 16), 4, -3, 128),  # stacked wq
    ((8, 40), 8, -2, 16),          # gcd(40, 16) = 8
]


@pytest.mark.parametrize("shape,bits,pack_axis,block", WEIGHT_CASES)
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_weight_quantize_is_bit_exact(shape, bits, pack_axis, block, dtype):
    rng = np.random.default_rng(len(shape) + bits)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 5, shape[:-1] + (1,)))
    x = x.astype(dtype)
    xt = torch.from_numpy(x.astype(np.float32))
    if dtype == ml_dtypes.bfloat16:
        xt = xt.to(torch.bfloat16)
    jqt = jq.quantize(jnp.asarray(x), bits=bits, block=block,
                      pack_axis=pack_axis)
    tqt = tq.quantize(xt, bits=bits, block=block, pack_axis=pack_axis)
    _assert_qt_equal(jqt, tqt)
    _assert_dequantized_equal(jqt, tqt)


def test_stacked_layer_slices_dequantize_alike():
    """A per-layer slice of a stacked leaf carries a stale orig_shape; its
    shapes come from data and scale, in both stacks."""
    x = np.random.default_rng(3).standard_normal((3, 64, 2, 16)).astype(
        np.float32)
    jqt = jq.quantize(jnp.asarray(x), bits=4, pack_axis=-3)
    tqt = tq.quantize(torch.from_numpy(x), bits=4, pack_axis=-3)
    for i in range(3):
        layer_j = jq.QuantizedTensor(jqt.data[i], jqt.scale[i], 4,
                                     jqt.orig_shape, -3)
        layer_t = tqt[i]
        assert layer_t.unpacked_shape == (64, 2, 16)
        assert layer_t.orig_shape == (3, 64, 2, 16)  # stale, by design
        _assert_qt_equal(layer_j, layer_t)
        _assert_dequantized_equal(layer_j, layer_t)


def test_int4_extremes_and_odd_axis():
    """Codes -7..7 survive the nibble packing; an odd pack axis raises."""
    x = np.tile(np.arange(-7, 8, dtype=np.float32), (2, 1)).T  # [15, 2]
    x = np.concatenate([x, x[:1]], axis=0)  # 16 rows, absmax 7 -> scale 1
    tqt = tq.quantize(torch.from_numpy(x), bits=4, block=2)
    _assert_qt_equal(jq.quantize(jnp.asarray(x), bits=4, block=2), tqt)
    assert torch.equal(tq.dequantize(tqt), torch.from_numpy(x))
    with pytest.raises(ValueError, match="even"):
        tq.quantize(torch.ones(3, 4), bits=4)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize(torch.ones(4, 4), bits=2)


def test_leaf_plan_and_quantize_tree_match_jax():
    cfg_j = jax_preset("llama-tiny", vocab_size=512, qkv_bias=True)
    pj = jm.init_params(jax.random.key(0), cfg_j)
    pt = params_from_numpy(jax.tree.map(np.asarray, pj),
                           get_preset("llama-tiny", vocab_size=512,
                                      qkv_bias=True), device="cpu")
    paths = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + "/")
            else:
                paths[name] = v

    walk(pt)
    jflat = {"/".join(str(p.key) for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(pj)[0]}
    plans = {n: tq.leaf_plan(n, t) for n, t in paths.items()}
    assert plans == {n: jq.leaf_plan(n, jflat[n]) for n in paths}
    assert plans["blocks/attn/wq"] == (True, -3)
    assert plans["blocks/mlp/w_down"] == (True, -2)
    assert plans["blocks/ln1/scale"][0] is False  # [L, D] but a norm
    assert plans["blocks/attn/bq"][0] is False    # a bias
    assert plans["final_norm/scale"][0] is False
    for bits in (8, 4):
        jtree = jq.quantize_tree(pj, bits=bits)
        ttree = tq.quantize_tree(pt, bits=bits)
        for name, jleaf in jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=lambda x: isinstance(x, jq.QuantizedTensor))[0]:
            key = [str(p.key) for p in name]
            tleaf = ttree
            for k in key:
                tleaf = tleaf[k]
            if isinstance(jleaf, jq.QuantizedTensor):
                _assert_qt_equal(jleaf, tleaf)
            else:
                assert not isinstance(tleaf, tq.QuantizedTensor)
        assert tq.tree_bytes(ttree) == jq.tree_bytes(jtree)
        deq = tq.dequantize_tree(ttree, torch.float32)
        assert not isinstance(deq["blocks"]["attn"]["wq"], tq.QuantizedTensor)
