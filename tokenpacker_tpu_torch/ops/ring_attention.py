"""Ring attention: exact attention over a sequence split across ranks
(counterpart of `tokenpacker_tpu/ops/ring_attention.py`).

Each rank of a mesh axis holds its shard [N, T/n, H, D] of q, k and v. The
k/v shards travel around the ring (`parallel/comm.ring`, JAX's
`ppermute`) while every rank accumulates its queries' online softmax over
each block it holds in turn (`_block_accum`, with JAX's causal offsets);
a row that saw no key gets JAX's `l_safe` result. Memory per rank stays
O(T/n · T/n) and the activations are never gathered.

JAX computes this with `einsum`s inside a `shard_map` (no Pallas kernel),
so the port is plain PyTorch products. The ring takes n - 1 steps: JAX's
scan also rotates after the last block and drops the result.
"""

from __future__ import annotations

import torch

from tokenpacker_tpu_torch.parallel import comm
from tokenpacker_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _block_accum(q, k, v, scale, q_offset, k_offset, causal, m, l, acc):
    """One k/v block's contribution to the online softmax: q [N, Tq, H, D],
    k/v [N, Tk, H, D]; m, l [N, H, Tq, 1] and acc [N, H, Tq, D] in fp32."""
    s = torch.einsum("nqhd,nkhd->nhqk", q, k).float() * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(kpos <= qpos, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("nhqk,nkhd->nhqd", p.to(v.dtype), v).float()
    return m_new, l_new, acc_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = "data", causal: bool = True) -> torch.Tensor:
    """q/k/v: this rank's [N, T/n, H, D] shards of a sequence split over
    the mesh axis `axis`, in the axis's rank order. Returns this rank's
    shard of the attention output, [N, T/n, H, D] in q's dtype."""
    ax = mesh.axis(axis)
    n, idx = ax.size, ax.index
    nq, t_local, h, d = q.shape
    scale = d ** -0.5
    m = torch.full((nq, h, t_local, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((nq, h, t_local, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((nq, h, t_local, d), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for r in range(n):
        src = (idx - r) % n  # the block this rank holds at step r came from rank src
        m, l, acc = _block_accum(q, k_cur, v_cur, scale, idx * t_local, src * t_local, causal,
                                 m, l, acc)
        if r < n - 1:
            k_cur, v_cur = comm.ring(ax, k_cur, v_cur)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l_safe).to(q.dtype).transpose(1, 2)
