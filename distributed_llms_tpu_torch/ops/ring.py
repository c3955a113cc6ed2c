"""Ring attention and the sequence-sharded decode over a ``seq`` mesh line
(PyTorch port of ``distributed_llms_tpu/ops/ring.py``).

Each rank of a 'seq' line holds one contiguous block of the sequence: its
queries, keys and values, and their global positions.

- :func:`ring_attention`: the local key block is attended first, then
  the K/V block (with its positions and validity) moves one hop around
  the ring ``S - 1`` times (:meth:`core.mesh.Mesh.shift`, the reference's
  ``ppermute``), and each visiting block folds into an online softmax
  (running max, numerator, denominator).  Causality is by global
  position, so a block wholly in a query's future contributes nothing,
  and a query row with no live key at all gives 0, never NaN (the
  reference's finite ``_NEG_INF`` and its safe-max rule).
- :func:`seq_cached_decode_attention`: one query token against a cache
  whose prompt region is sharded over the line and whose decode region
  every rank holds whole.  Each rank computes the softmax statistics of
  its prompt block; one max and one sum over the line merge them, and
  the decode region's statistics merge locally.

The reference computes both with ``einsum`` outside any Pallas kernel; so
does the port (``torch.einsum``), float32 scores, probabilities rounded to
v's dtype before the value product.  The functions run inside a
sequence-parallel forward of ``parallel/api.py``'s ``ParallelModel``,
which binds the line (``parallel/plan.py`` ``Plan.seq``), or on an
explicit ``mesh``; without either they raise the reference's
``RuntimeError``.
"""

from __future__ import annotations

import torch

from ..parallel import plan as plan_lib

_NEG_INF = torch.finfo(torch.float32).min


def seq_mesh(axis_name: str, what: str, mesh=None):
    """The mesh whose ``axis_name`` line a sequence-parallel op runs on:
    ``mesh`` when given, else the one of the running sequence-parallel
    forward; the reference's ``RuntimeError`` outside one."""
    if mesh is not None:
        return mesh
    plan = plan_lib.current()
    if plan is None or plan.seq is None:
        raise RuntimeError(
            f"{what} needs a bound {axis_name!r} mesh axis — call it inside "
            "a sequence-parallel forward (e.g. via ParallelModel with "
            f"MeshConfig(seq=N)); attn_impl={what.split()[0]!r} is set "
            "internally by that path, not by user config"
        )
    return plan.mesh


def _block_scores(q, k, q_pos, k_pos, k_valid, causal: bool,
                  q_per_kv: int) -> torch.Tensor:
    """Masked float32 logits [B, H, Tq, Tk] of q [B, Tq, H, D] against one
    key block k [B, Tk, KVH, D] (GQA-aware)."""
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    qf, kf = q.float(), k.float()
    if q_per_kv > 1:
        qg = qf.reshape(b, tq, kvh, q_per_kv, d)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf).reshape(
            b, h, tq, tk)
    else:
        logits = torch.einsum("bqhd,bshd->bhqs", qf, kf)
    logits.mul_(d ** -0.5)
    mask = k_valid[:, None, None, :]
    if causal:
        mask = mask & (k_pos[:, None, None, :] <= q_pos[:, None, :, None])
    return logits.masked_fill_(~mask, _NEG_INF)


def _block_pv(probs: torch.Tensor, v: torch.Tensor,
              q_per_kv: int) -> torch.Tensor:
    """probs [B, H, Tq, Tk] @ v [B, Tk, KVH, D] -> [B, Tq, H, D] in v's
    dtype (GQA-aware)."""
    if q_per_kv > 1:
        b, h, tq, tk = probs.shape
        pg = probs.to(v.dtype).reshape(b, h // q_per_kv, q_per_kv, tq, tk)
        out = torch.einsum("bkgqs,bskd->bqkgd", pg, v)
        return out.reshape(b, tq, h, v.shape[-1])
    return torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)


def _safe(mx: torch.Tensor) -> torch.Tensor:
    """A running max with the unseeded (all-masked) rows at 0, so that
    their masked entries underflow to exp(_NEG_INF) = 0."""
    return torch.where(mx <= _NEG_INF * 0.5, torch.zeros_like(mx), mx)


def _stats(q, k, v, q_pos, k_pos, k_valid, causal, q_per_kv):
    """(numerator [B, Tq, H, D] float32, denominator [B, H, Tq], max
    [B, H, Tq]) of one key block, exponentiated against its own max."""
    logits = _block_scores(q, k, q_pos, k_pos, k_valid, causal, q_per_kv)
    mx = logits.amax(dim=-1)
    probs = logits.sub_(_safe(mx)[..., None]).exp_()
    num = _block_pv(probs, v, q_per_kv).float()
    return num, probs.sum(dim=-1), mx


def ring_attention(
    q: torch.Tensor,  # [B, Tq_local, H, D] — this rank's sequence block
    k: torch.Tensor,  # [B, Tk_local, KVH, D]
    v: torch.Tensor,  # [B, Tk_local, KVH, D]
    q_positions: torch.Tensor,  # [B, Tq_local] global positions
    k_positions: torch.Tensor,  # [B, Tk_local] global positions
    axis_name: str = "seq",
    causal: bool = True,
    k_valid: torch.Tensor | None = None,  # [B, Tk_local] bool
    mesh=None,  # core.mesh.Mesh; None: the running sequence-parallel forward's
) -> torch.Tensor:
    """Attention of this rank's query block over the whole sequence of the
    ``axis_name`` line.  Returns [B, Tq_local, H, D] in q's dtype.  Any
    KVH dividing H; one step's scores are [B, H, Tq/S, Tk/S]."""
    mesh = seq_mesh(axis_name, "ring attention", mesh)
    n = mesh.size(axis_name)
    q_per_kv = q.shape[2] // k.shape[2]
    if k_valid is None:
        k_valid = torch.ones(k_positions.shape, dtype=torch.bool,
                             device=k.device)

    b, tq, h, d = q.shape

    def accumulate(acc, k_blk, v_blk, kpos, kvalid):
        num, den, mx = acc
        logits = _block_scores(q, k_blk, q_positions, kpos, kvalid, causal,
                               q_per_kv)
        new_mx = torch.maximum(mx, logits.amax(dim=-1))
        safe = _safe(new_mx)
        probs = logits.sub_(safe[..., None]).exp_()
        # Rescales the old sums (0 while the row is unseeded).
        alpha = torch.exp(mx - safe)
        num = (num * alpha[..., None].transpose(1, 2)
               + _block_pv(probs, v_blk, q_per_kv).float())
        return num, den * alpha + probs.sum(dim=-1), new_mx

    acc = (torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device),
           torch.zeros((b, h, tq), dtype=torch.float32, device=q.device),
           torch.full((b, h, tq), _NEG_INF, dtype=torch.float32,
                      device=q.device))
    # The local block first, then S - 1 hops: no discarded last shift.  K
    # and V travel as one tensor, positions and validity as another.
    acc = accumulate(acc, k, v, k_positions, k_valid)
    kv = torch.stack([k, v])
    meta = torch.stack([k_positions.to(torch.int32), k_valid.to(torch.int32)])
    for _ in range(n - 1):
        kv = mesh.shift(kv, axis_name)
        meta = mesh.shift(meta, axis_name)
        acc = accumulate(acc, kv[0], kv[1], meta[0], meta[1].bool())
    num, den, _ = acc
    den = den.transpose(1, 2)[..., None]  # [B, Tq, H, 1]
    return (num / torch.clamp(den, min=1e-37)).to(q.dtype)


def seq_cached_decode_attention(
    q: torch.Tensor,  # [B, 1, H, D] — every rank of the line holds it
    ck_local: torch.Tensor,  # [B, S_loc, KVH, D] — this rank's prompt block
    cv_local: torch.Tensor,
    dk: torch.Tensor,  # [B, N, KVH, D] — the decode region, whole
    dv: torch.Tensor,
    mask_local: torch.Tensor,  # [B, S_loc] bool — this rank's key mask
    mask_dec: torch.Tensor,  # [B, N] bool
    axis_name: str = "seq",
    mesh=None,
) -> torch.Tensor:
    """One-token decode over the sequence-sharded cache: the K/V stay
    where they are; each rank's prompt-block statistics merge over the
    line with one max and one sum (numerator and denominator in one
    buffer), then with the decode region's.  Returns [B, 1, H, D], the
    same on every rank of the line."""
    mesh = seq_mesh(axis_name, "ring attention", mesh)
    q_per_kv = q.shape[2] // ck_local.shape[2]

    # Local prompt block -> the line's prompt statistics.
    num_l, den_l, mx_l = _stats(q, ck_local, cv_local, None, None, mask_local,
                                False, q_per_kv)
    mx_p = mesh.all_reduce(mx_l, axis_name, op="max")
    scale_l = torch.exp(mx_l - _safe(mx_p))  # 0 for a wholly masked block
    b, _, h, d = num_l.shape
    packed = torch.cat([
        (num_l * scale_l[..., None].transpose(1, 2)).reshape(b, -1),
        (den_l * scale_l).reshape(b, -1)], dim=1)
    packed = mesh.all_reduce(packed, axis_name, op="sum")
    num_p = packed[:, :h * d].reshape(b, 1, h, d)
    den_p = packed[:, h * d:].reshape(b, h, 1)

    # The decode region, alike on every rank.
    num_d, den_d, mx_d = _stats(q, dk, dv, None, None, mask_dec, False,
                                q_per_kv)

    safe = _safe(torch.maximum(mx_p, mx_d))
    a_p, a_d = torch.exp(mx_p - safe), torch.exp(mx_d - safe)
    num = (num_p * a_p[..., None].transpose(1, 2)
           + num_d * a_d[..., None].transpose(1, 2))
    den = (den_p * a_p + den_d * a_d).transpose(1, 2)[..., None]
    return (num / torch.clamp(den, min=1e-37)).to(q.dtype)


def ring_self_attention(mesh, q, k, v, positions, causal: bool = True,
                        seq_axis: str = "seq") -> torch.Tensor:
    """Host-level counterpart of the reference's wrapper: q/k/v
    [B, T, (KV)H, D] and positions [B, T] are the whole sequence on every
    rank; each rank attends its contiguous block through
    :func:`ring_attention` on ``mesh``, and the blocks are gathered over
    the line, so every rank returns the whole [B, T, H, D]."""
    s, r = mesh.size(seq_axis), mesh.coord(seq_axis)
    t = q.shape[1]
    if t % s:
        raise ValueError(f"sequence length {t} not divisible by seq axis {s}")
    lo, hi = r * t // s, (r + 1) * t // s
    out = ring_attention(q[:, lo:hi], k[:, lo:hi], v[:, lo:hi],
                         positions[:, lo:hi], positions[:, lo:hi],
                         axis_name=seq_axis, causal=causal, mesh=mesh)
    return mesh.all_gather(out, 1, seq_axis)
