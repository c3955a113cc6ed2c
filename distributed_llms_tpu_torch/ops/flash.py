"""Flash attention: blockwise causal attention that never builds the
``[Tq, S]`` score matrix in the forward (PyTorch/CUDA port of
``distributed_llms_tpu/ops/flash.py``).

:func:`flash_attention` takes q ``[B, Tq, H, D]`` and k/v ``[B, S, KVH, D]``
(KVH divides H; query head h reads KV head ``h // (H / KVH)``) and returns
``[B, Tq, H, D]`` in q's dtype.  Two kernels, as in the JAX package:

- K3, the static-causal kernel (``_kernel_static``): taken exactly when
  the call is causal with no position or validity vector and ``Tq == S``
  — the training forward and the no-cache prefill.  Query row i attends
  keys ``j <= i`` (and ``j > i - window`` with a window: index space);
  the key tiles above the diagonal or below the window are never read.
- K4, the dynamic kernel (``_kernel_dynamic``): every other call.  Query
  row i at position ``q_positions[b, i]`` attends slot j where
  ``k_valid[b, j]``, ``k_positions[b, j] <= q_positions[b, i]`` if causal,
  and ``k_positions[b, j] > q_positions[b, i] - window`` with a window
  (position space).  Absent vectors default to ``arange(Tq)``,
  ``arange(S)`` and all-valid.  A pre-pass (:func:`tile_summary`) sums up
  each key tile's validity and position range; the kernel never loads a
  tile that this summary shows holds no live pair for its query rows.

The device decides the implementation:

- CUDA tensors launch the hand-written Hopper kernels
  (``csrc/flash_attn.cu``: two consumer warpgroups of 64 query rows keep
  scores, softmax state and accumulator in registers and run ``wgmma``
  products over a TMA-filled ring of K/V tiles), or raise — bfloat16
  only, head dims in :data:`HEAD_DIMS`, there is no fallback;
- CPU tensors take the plain version, :func:`flash_reference`: the
  kernels' numerics written out densely (float32 scores, a row with no
  live key outputs zeros, probabilities rounded to v's dtype before the
  value product).

Differentiable through :class:`_FlashFn`, as the JAX package's
``custom_vjp``: the backward recomputes :func:`dense_reference` (the
mirror of the JAX ``_dense_reference``) under autograd from the saved q,
k, v and masks — a dense O(Tq * S) recompute, not a kernel, as in the
reference.  Launch counts: ``flash_attention.static_launches`` (K3),
``flash_attention.dynamic_launches`` (K4) and ``tile_summary.launches``
(K4's pre-pass).
"""

from __future__ import annotations

import ctypes

import torch

from ..models.layers import repeat_kv
from . import build
from .decode_attn import _route

SOURCE = "flash_attn.cu"
HEAD_DIMS = (64, 128, 256)  # head dims the kernels are built for
# Key slots per tile of each head dim's kernel (``Tiles<D>::kBK``); K4's
# tile summary is cut at the same tiles.
KEY_TILE = {64: 128, 128: 128, 256: 64}

_NEG_INF = torch.finfo(torch.float32).min
# Score elements one plain-version chunk holds (1 GiB of float32): the
# plain versions walk the query rows in chunks of at most this many scores,
# so a 32k-slot cache is checked on the card without a 34 GB matrix.  Rows
# are independent, so the chunking changes no value.
_CHUNK_SCORES = 1 << 28

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "dlt_flash_attention_static": [_P] * 4 + [_I] * 6 + [_F, _P],
    "dlt_flash_tile_summary": [_P] * 3 + [_I] * 3 + [_P],
    "dlt_flash_attention_dynamic": [_P] * 8 + [_I] * 9 + [_F, _P],
    "dlt_flash_resources": [_I, _I, _P],
}
_INT32_MIN, _INT32_MAX = -2**31, 2**31 - 1


def _mask(b, tq, s, device, q_positions, k_positions, k_valid, causal,
          window, rows=slice(None)):
    """Boolean [B, 1, rows, S] mask of live (query row, key slot) pairs."""
    qp = (torch.arange(tq, device=device).expand(b, tq) if q_positions is None
          else q_positions.to(device))[:, rows].long()
    kp = (torch.arange(s, device=device).expand(b, s) if k_positions is None
          else k_positions.to(device)).long()
    if causal:
        mask = kp[:, None, None, :] <= qp[:, None, :, None]
    else:
        mask = torch.ones(b, 1, qp.shape[1], s, dtype=torch.bool, device=device)
    if k_valid is not None:
        mask = mask & k_valid.to(device).bool()[:, None, None, :]
    if window is not None:
        mask = mask & (kp[:, None, None, :] > qp[:, None, :, None] - window)
    return mask


def _row_chunks(tq: int, b: int, h: int, s: int):
    step = max(1, _CHUNK_SCORES // max(1, b * h * s))
    for r0 in range(0, tq, step):
        yield slice(r0, min(tq, r0 + step))


def flash_reference(q, k, v, q_positions=None, k_positions=None, k_valid=None,
                    causal=True, window=None):
    """The plain version of both kernels, with THEIR numerics (the JAX
    kernels' ``_accumulate`` / ``_finish``): scores ``(q . k) * D**-0.5``
    in float32 from the input dtype, masked entries at ``finfo(f32).min``;
    a row whose keys are all masked takes a shift of 0 and outputs zeros;
    ``p = exp(s - max)`` in float32 sums into ``l`` and is rounded to v's
    dtype before the value product, which accumulates in float32; the
    output is ``acc / max(l, 1e-37)`` in q's dtype."""
    b, tq, h, d = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    kf = repeat_kv(k, g).float()
    vf = repeat_kv(v, g)
    out = torch.empty_like(q)
    for rows in _row_chunks(tq, b, h, s):
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, rows].float(), kf) * d ** -0.5
        keep = _mask(b, tq, s, q.device, q_positions, k_positions, k_valid,
                     causal, window, rows)
        sc = torch.where(keep, sc, _NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        safe = torch.where(m <= _NEG_INF * 0.5, 0.0, m)
        p = torch.exp(sc - safe)
        del sc
        l = p.sum(dim=-1).clamp(min=1e-37)  # [B, H, rows]
        acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf.float())
        out[:, rows] = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out


def dense_reference(q, k, v, q_positions=None, k_positions=None, k_valid=None,
                    causal=True, window=None):
    """The exact mirror of the JAX package's ``_dense_reference`` — the
    target of the backward pass: float32 scores, ``softmax`` over the
    masked row (a fully masked row averages uniformly), probabilities cast
    to v's dtype before the value product, output in q's dtype."""
    b, tq, h, d = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    kf = repeat_kv(k, g)
    vf = repeat_kv(v, g)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * d ** -0.5
    mask = _mask(b, tq, s, q.device, q_positions, k_positions, k_valid,
                 causal, window)
    probs = torch.softmax(torch.where(mask, logits, _NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), vf).to(q.dtype)


def tile_summary_reference(k_positions, k_valid, bk):
    """The plain version of K4's pre-pass: for each batch row and key tile
    of ``bk`` slots (the last one cut at S; slots past S are invalid), an
    int32 ``[flags, min, max, 0]`` with flags bit 0 = some slot valid,
    bit 1 = every slot valid, and min / max the positions over the valid
    slots (``INT32_MAX`` / ``INT32_MIN`` without one).  ``[B, ceil(S /
    bk), 4]``."""
    b, s = k_valid.shape
    n = -(-s // bk)
    pad = n * bk - s
    valid = torch.nn.functional.pad(k_valid != 0, (0, pad)).view(b, n, bk)
    pos = torch.nn.functional.pad(k_positions.to(torch.int64),
                                  (0, pad)).view(b, n, bk)
    flags = valid.any(-1).int() | (valid.all(-1).int() << 1)
    lo = torch.where(valid, pos, _INT32_MAX).amin(-1)
    hi = torch.where(valid, pos, _INT32_MIN).amax(-1)
    return torch.stack([flags.long(), lo, hi, torch.zeros_like(lo)],
                       -1).to(torch.int32)


def tile_summary(k_positions, k_valid, bk):
    """K4's pre-pass (``flash_kernel_tile_summary``) on int32 ``[B, S]``
    positions and validity: :func:`tile_summary_reference`'s table,
    computed on the card for CUDA tensors (one launch, counted in
    ``tile_summary.launches``) and by the plain version on the CPU."""
    if _route("tile_summary", [k_positions, k_valid]) == "cpu":
        return tile_summary_reference(k_positions, k_valid, bk)
    kp, kv = (t.to(torch.int32).contiguous() for t in (k_positions, k_valid))
    b, s = kv.shape
    summary = torch.empty(b, -(-s // bk), 4, dtype=torch.int32,
                          device=kv.device)
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    err = build.entry(SOURCE, "dlt_flash_tile_summary",
                      _ARGTYPES["dlt_flash_tile_summary"])(
        kp.data_ptr(), kv.data_ptr(), summary.data_ptr(), b, s, bk, stream)
    if err != 0:
        raise RuntimeError(
            f"flash tile summary kernel launch failed (cudaError {err})")
    tile_summary.launches += 1
    return summary


def flash_kernel_resources(d: int, dynamic: bool) -> dict:
    """What the K3 (``dynamic=False``) or K4 kernel of head dim ``d`` takes
    on the current card: threads, query rows and key slots a tile, ring
    stages, dynamic shared memory, resident blocks per SM, registers and
    local (spill) bytes per thread, and the pre-pass's registers."""
    info = (ctypes.c_int * 9)()
    err = build.entry(SOURCE, "dlt_flash_resources",
                      _ARGTYPES["dlt_flash_resources"])(
        d, int(dynamic), ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"dlt_flash_resources failed ({err})")
    keys = ("threads", "query_tile", "key_tile", "stages", "smem_bytes",
            "blocks_per_sm", "registers", "local_bytes",
            "summary_registers")
    return dict(zip(keys, info))


def is_static(q, k, q_positions, k_positions, k_valid, causal) -> bool:
    """Whether a call takes the static-causal kernel K3 (the reference's
    ``static_causal``): causal, no position or validity vector, and as
    many query rows as key slots."""
    return (causal and q_positions is None and k_positions is None
            and k_valid is None and q.shape[1] == k.shape[1])


def _forward(q, k, v, q_positions, k_positions, k_valid, causal, window):
    """One kernel launch (CUDA) or the plain version (CPU)."""
    b, tq, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    static = is_static(q, k, q_positions, k_positions, k_valid, causal)
    vectors = [t for t in (q_positions, k_positions, k_valid) if t is not None]
    if _route("flash_attention", [q, k, v, *vectors]) == "cpu":
        return flash_reference(q, k, v, q_positions, k_positions, k_valid,
                               causal, window)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(
            "the CUDA flash kernels take bfloat16 q/k/v, got "
            f"{q.dtype} / {k.dtype} / {v.dtype}"
        )
    if d not in HEAD_DIMS or b > 65535 or h > 65535:
        raise ValueError(
            f"the CUDA flash kernels take head_dim in {HEAD_DIMS} and B, H "
            f"<= 65535; got D={d}, B={b}, H={h}"
        )
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if tq == 0 or s == 0:  # nothing to attend: rows with no live key are 0
        return out.zero_()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the CUDA flash kernels need 16-byte aligned q/k/v")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    win = min(window or 0, 2**31 - 1)  # 0: no window
    if static:
        err = build.entry(SOURCE, "dlt_flash_attention_static",
                          _ARGTYPES["dlt_flash_attention_static"])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, tq, h, kvh, d, win, float(d) ** -0.5, stream)
        counter = "static_launches"
    else:
        qp = (torch.arange(tq, device=q.device).expand(b, tq)
              if q_positions is None else q_positions)
        kp = (torch.arange(s, device=q.device).expand(b, s)
              if k_positions is None else k_positions)
        kv = (torch.ones(b, s, dtype=torch.int32, device=q.device)
              if k_valid is None else k_valid)
        qp, kp, kv = (t.to(torch.int32).contiguous() for t in (qp, kp, kv))
        if not (qp.shape == (b, tq) and kp.shape == kv.shape == (b, s)):
            raise ValueError(
                f"positions must be [B, Tq] / [B, S] and k_valid [B, S]; got "
                f"{tuple(qp.shape)} / {tuple(kp.shape)} / {tuple(kv.shape)}"
            )
        bk = KEY_TILE[d]
        summary = tile_summary(kp, kv, bk)
        err = build.entry(SOURCE, "dlt_flash_attention_dynamic",
                          _ARGTYPES["dlt_flash_attention_dynamic"])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
            kp.data_ptr(), kv.data_ptr(), summary.data_ptr(), out.data_ptr(),
            b, tq, s, h, kvh, d, bk, int(causal), win, float(d) ** -0.5,
            stream)
        counter = "dynamic_launches"
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (cudaError {err})")
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return out


class _FlashFn(torch.autograd.Function):
    """The kernel forward with the reference's dense-recompute backward
    (JAX ``_flash_fwd`` / ``_flash_bwd``): only q, k, v and the mask
    vectors are saved; the backward differentiates
    :func:`dense_reference` on them."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, k_valid, causal,
                window):
        ctx.save_for_backward(q, k, v, q_positions, k_positions, k_valid)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, q_positions, k_positions, k_valid, causal,
                        window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, q_positions, k_positions, k_valid = ctx.saved_tensors
        with torch.enable_grad():
            q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
            out = dense_reference(q_, k_, v_, q_positions, k_positions,
                                  k_valid, ctx.causal, ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q_, k_, v_), grad)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Tq, H, D]
    k: torch.Tensor,  # [B, S, KVH, D] (KVH divides H)
    v: torch.Tensor,  # [B, S, KVH, D]
    q_positions: torch.Tensor | None = None,  # [B, Tq] int global positions
    k_positions: torch.Tensor | None = None,  # [B, S] int global positions
    k_valid: torch.Tensor | None = None,  # [B, S] bool — False masks the slot
    causal: bool = True,
    window: int | None = None,  # sliding window: keys in (p - window, p]
) -> torch.Tensor:
    """See the module docstring.  Returns [B, Tq, H, D] in q's dtype."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, Tq, H, D] and k/v matching [B, S, KVH, D]; got "
            f"{tuple(q.shape)} / {tuple(k.shape)} / {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(
            f"head shapes disagree: q {tuple(q.shape)}, k/v {tuple(k.shape)}"
        )
    return _FlashFn.apply(q, k, v, q_positions, k_positions, k_valid, causal,
                          window)


flash_attention.static_launches = 0
flash_attention.dynamic_launches = 0
tile_summary.launches = 0
