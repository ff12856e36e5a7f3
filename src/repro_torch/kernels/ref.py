"""Plain PyTorch oracles for the port's kernels (the correctness contracts).

Each mirrors the reference's ``repro.kernels.ref`` function of the same name
over padded arrays: ``a``/``ca`` ascending with an INT32_MAX tail, ``par``
with a -1 tail, ``nd`` with a 0 tail.  ``elca_segsum_ref`` is the dense
``[MI, MJ]`` mask contraction, for small test inputs only.
``decode_attention_ref`` is the masked softmax over a repeated-head cache;
it returns the mean of ``v`` for a row with ``cache_len == 0`` (a softmax
over all -1e30), where the kernel returns zeros.
"""
from __future__ import annotations

import torch


def membership_ref(
    a_padded: torch.Tensor, q_padded: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(found, pos) of each query in a sorted padded array (searchsorted)."""
    ma = a_padded.shape[0]
    pos = torch.searchsorted(a_padded, q_padded, side="left")
    pos_c = pos.clamp(max=ma - 1)
    found = a_padded[pos_c] == q_padded
    return found, torch.where(found, pos_c, 0).to(torch.int32)


def searchsorted_ref(a_padded: torch.Tensor, q_padded: torch.Tensor) -> torch.Tensor:
    """#elements of A strictly below each query (searchsorted left)."""
    return torch.searchsorted(a_padded, q_padded, side="left").to(torch.int32)


def elca_segsum_ref(
    ca_padded: torch.Tensor, par_padded: torch.Tensor, nd_padded: torch.Tensor
) -> torch.Tensor:
    """child_sum[k, i] = sum of nd[k, j] where par[j] == ca[i] (dense oracle)."""
    eq = par_padded[None, :] == ca_padded[:, None]  # [MI, MJ]
    return torch.einsum("ij,kj->ki", eq.to(torch.int32), nd_padded)


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, hd]
    k: torch.Tensor,  # [B, T, Hk, hd]
    v: torch.Tensor,  # [B, T, Hk, hd]
    cache_len: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """Plain masked softmax attention for one token (decode oracle)."""
    b, h, hd = q.shape
    n_rep = h // k.shape[2]
    kf = k.repeat_interleave(n_rep, dim=2).float()  # [B,T,H,hd]
    vf = v.repeat_interleave(n_rep, dim=2).float()
    logits = torch.einsum("bhd,bthd->bht", q.float(), kf) / (hd**0.5)
    mask = torch.arange(k.shape[1], device=k.device)[None, None, :] < cache_len[:, None, None]
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bthd->bhd", probs, vf).to(q.dtype)
