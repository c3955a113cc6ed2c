"""Ulysses sequence parallelism: attention by an all-to-all head scatter
(PyTorch port of ``distributed_llms_tpu/ops/ulysses.py``).

Where ring attention keeps the sequence sharded and moves K/V blocks
around the line, Ulysses re-shards once each way per attention call::

    [B, T/S, H, D]  --all_to_all-->  [B, T, H/S, D]
      (sequence sharded)               (heads sharded)

so each rank of the 'seq' line attends the whole sequence for its share
of the heads, through the port's flash attention at the gathered global
positions (``ops/flash.py``: on CUDA the dynamic kernel K4 after its
tile-summary pre-pass, on the CPU its plain version), and the inverse
all-to-all restores the sequence sharding.  Both head counts must divide
by the line's size (use ring attention otherwise).  The all-to-alls are
:meth:`core.mesh.Mesh.all_to_all`; the positions and the key validity
are all-gathered.
"""

from __future__ import annotations

import torch

from . import flash
from .ring import seq_mesh


def ulysses_attention(
    q: torch.Tensor,  # [B, T_local, H, D] — this rank's sequence block
    k: torch.Tensor,  # [B, T_local, KVH, D]
    v: torch.Tensor,  # [B, T_local, KVH, D]
    q_positions: torch.Tensor,  # [B, T_local] global positions
    axis_name: str = "seq",
    causal: bool = True,
    k_valid: torch.Tensor | None = None,  # [B, T_local] bool
    mesh=None,  # core.mesh.Mesh; None: the running sequence-parallel forward's
) -> torch.Tensor:
    """Attention of this rank's block over the whole sequence of the
    ``axis_name`` line.  Returns [B, T_local, H, D] in q's dtype."""
    mesh = seq_mesh(axis_name, "ulysses attention", mesh)
    s = mesh.size(axis_name)
    h, kvh = q.shape[2], k.shape[2]
    if h % s or kvh % s:
        raise ValueError(
            f"ulysses needs num_heads ({h}) and num_kv_heads ({kvh}) divisible "
            f"by the seq axis ({s}); use attn_impl='ring' for small-KV GQA"
        )

    # Head scatter / sequence gather: [B, T/S, H, D] -> [B, T, H/S, D].
    def a2a(x: torch.Tensor) -> torch.Tensor:
        return mesh.all_to_all(x, 2, 1, axis_name)

    qg, kg, vg = a2a(q), a2a(k), a2a(v)
    pos = mesh.all_gather(q_positions, 1, axis_name)
    kv_full = (None if k_valid is None else mesh.all_gather(
        k_valid.to(torch.int32), 1, axis_name).bool())
    out = flash.flash_attention(qg, kg, vg, q_positions=pos, k_positions=pos,
                                k_valid=kv_full, causal=causal)
    # Inverse: sequence scatter / head gather back to [B, T/S, H, D].
    return mesh.all_to_all(out, 1, 2, axis_name)
