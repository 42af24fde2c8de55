"""Memory banks and the count-weighted NCE (counterpart of
hcmoco_tpu/contrast/memory.py, bank mode).

Behavioural spec: pycontrast/memory/mem_bank.py (CMCMem3), with
AliasMethod negative sampling over uniform probabilities.  The loss depends
on the draw only through how often each bank row was drawn, so negatives
are kept as (bsz, n_data) counts and the NCE is a count-weighted logsumexp
over the dense score matrix s = f @ bank.T (cmc3_losses_counts).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

# (query feat index, bank index) for the six CMCMem3 directions
# 12, 21, 23, 32, 13, 31 (mem_bank.py:176-191)
CMC3_DIRS = ((0, 1), (1, 0), (1, 2), (2, 1), (0, 2), (2, 0))


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def init_memory(generator: torch.Generator, n_modal: int, n_data: int,
                dim: int = 128, device=None) -> torch.Tensor:
    """(n_modal, n_data, dim) banks: randn rows, L2-normalised
    (mem_bank.py:164-171).  `generator` must live on `device`."""
    banks = torch.randn((n_modal, n_data, dim), generator=generator,
                        device=device, dtype=torch.float32)
    return _l2norm(banks)


def sample_negative_counts(generator: torch.Generator, bsz: int, n_data: int,
                           k: int, device=None) -> torch.Tensor:
    """(bsz, n_data) f32 counts of k uniform draws per row, i.e.
    Multinomial(k, uniform): the draws' bincount.  The counts are integers
    below 2^24, so the f32 scatter-add is exact and the result does not
    depend on the order of the adds, on CUDA too."""
    idx = torch.randint(0, n_data, (bsz, k), generator=generator,
                        device=device)
    counts = torch.zeros((bsz, n_data), dtype=torch.float32, device=device)
    return counts.scatter_add_(1, idx, torch.ones(idx.shape, device=device))


def cmc3_losses_counts(feats: torch.Tensor, banks: torch.Tensor,
                       y: torch.Tensor, k: int, temperature: float,
                       counts: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-sample (ce, correct) for the six CMCMem3 directions.

    With c the negatives' counts and the positive added once at y,
    ce = logsumexp_n(s[b, n] + log c_total[b, n]) - s[b, y]: exactly the
    reference's CE-to-column-0 over the drawn logits (mem_bank.py:176-193).
    correct = s[b, y] >= max over drawn negatives (the positive at column 0
    wins ties under argmax).  Banks get no gradient."""
    banks = banks.detach()
    n_data = banks.shape[1]
    if counts is None:
        if generator is None:
            raise ValueError("cmc3_losses_counts: pass counts or a generator")
        counts = sample_negative_counts(generator, y.shape[0], n_data, k,
                                        device=banks.device)
    c = counts.detach().float()
    y = y.long()
    c_total = c.scatter_add(1, y[:, None], torch.ones_like(c[:, :1]))
    log_c = torch.log(c_total)  # -inf where a row was not drawn
    out = []
    for qi, bi in CMC3_DIRS:
        s = (feats[qi].float() @ banks[bi].t()) / temperature
        pos = s.gather(1, y[:, None])[:, 0]
        ce = torch.logsumexp(s + log_c, dim=-1) - pos
        max_neg = s.masked_fill(c <= 0, float("-inf")).amax(dim=-1)
        out.append((ce, (pos >= max_neg).float()))
    return out


@torch.no_grad()
def update_memory(bank: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  m: float) -> torch.Tensor:
    """EMA + renormalise + write back, IN PLACE on `bank`
    (BaseMem._update_memory, mem_bank.py:15-28).

    Rows of duplicate indices are all computed from the old row; the last
    occurrence in y wins, as torch index_copy_ on the CPU and the JAX scatter
    do.  The winner is chosen explicitly and every occurrence of an index
    writes the winner's row, so the write does not depend on its order (on
    CUDA too) and needs no host sync."""
    y = y.long()
    w_new = _l2norm(m * bank[y] + (1.0 - m) * x.detach().float())
    pos = torch.arange(y.shape[0], device=y.device)
    last = torch.full((bank.shape[0],), -1, dtype=torch.long, device=y.device)
    last.scatter_reduce_(0, y, pos, reduce="amax")
    bank.index_copy_(0, y, w_new[last[y]])
    return bank
