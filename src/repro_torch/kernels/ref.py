"""Plain PyTorch oracles for the chained kernels (the correctness contracts).

Each mirrors the reference's ``repro.kernels.ref`` function of the same name
over padded arrays: ``a``/``ca`` ascending with an INT32_MAX tail, ``par``
with a -1 tail, ``nd`` with a 0 tail.  ``elca_segsum_ref`` is the dense
``[MI, MJ]`` mask contraction, for small test inputs only.  The oracle of
the decode-attention kernel comes with that kernel's port.
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
