"""Memory banks and the six-way bank NCE (counterpart of
hcmoco_tpu/contrast/memory.py, bank mode).

Behavioural spec: pycontrast/memory/mem_bank.py (CMCMem3), with
AliasMethod negative sampling over uniform probabilities.  Two forms of
one estimator:

  * the counts form (cmc3_losses_counts): the loss depends on the draw
    only through how often each bank row was drawn, so negatives are kept
    as (bsz, n_data) counts and the NCE is a count-weighted logsumexp over
    the dense score matrix s = f @ bank.T;
  * the index form (cmc3_forward): K+1 drawn indices a row, the positive
    in column 0 (sample_negative_indices), and the (bsz, K+1) logits of
    the reference, in one of three formulations of the same math:
    'dense' (scores + torch.gather; its backward scatter-adds), 'hybrid'
    (scores + gather forward, a chunked bank-row gather backward, no
    scatter) and 'gather' (chunked bank-row gather + bmm both ways, the
    reference's index_select + bmm, whose memory does not grow with
    n_data).

Bank rows carry no gradient (torch buffers in the reference).

Under data parallelism (parallel/mesh.py) the banks are replicated: the
negatives are drawn for the global batch from a generator seeded alike on
every rank, each rank keeping its rows, and the bank update takes the
features and indices of all the ranks in global row order, so every rank
applies the update one process would, duplicates across ranks included.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..parallel.mesh import my_rows, world_size

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


def sample_negative_indices(generator: torch.Generator, y: torch.Tensor,
                            n_data: int, k: int) -> torch.Tensor:
    """(bsz, K+1) int64 uniform draws from `generator` (on y's device) with
    the positive forced into column 0 (mem_bank.py:68-70:
    `idx.select(1, 0).copy_(y)`).  Under data parallelism the draw is the
    global batch's and this rank keeps its rows."""
    rows = y.shape[0] * world_size()
    idx = torch.randint(0, n_data, (rows, k + 1), generator=generator,
                        device=y.device)[my_rows(rows)]
    idx[:, 0] = y.long()
    return idx


def sample_negative_counts(generator: torch.Generator, bsz: int, n_data: int,
                           k: int, device=None) -> torch.Tensor:
    """(bsz, n_data) f32 counts of k uniform draws per row, i.e.
    Multinomial(k, uniform): the draws' bincount.  The counts are integers
    below 2^24, so the f32 scatter-add is exact and the result does not
    depend on the order of the adds, on CUDA too.  Under data parallelism
    the draw is the global batch's and this rank keeps its bsz rows."""
    rows = bsz * world_size()
    idx = torch.randint(0, n_data, (rows, k), generator=generator,
                        device=device)[my_rows(rows)]
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


def memory_logits(x: torch.Tensor, bank: torch.Tensor, idx: torch.Tensor,
                  temperature: float, dense_scores: bool = True
                  ) -> torch.Tensor:
    """(bsz, K+1) logits against one bank: logits[b, k] =
    <bank[idx[b, k]], x[b]> / T (BaseMem._compute_logit,
    mem_bank.py:30-40).  dense_scores: the score matrix x @ bank.T, then a
    scalar gather; else the rows bank[idx] and a bmm."""
    bank = bank.detach()
    x = x.float()
    if dense_scores:
        logits = (x @ bank.t()).gather(1, idx)
    else:
        logits = torch.bmm(bank[idx], x[:, :, None])[:, :, 0]
    return logits / temperature


def _gathered_rows(banks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(n_modal, bsz, c, dim) bank rows at idx (bsz, c): one index_select
    shared by every bank."""
    b, c = idx.shape
    return banks.index_select(1, idx.reshape(-1)).view(
        banks.shape[0], b, c, banks.shape[2])


def _rows_grad(banks: torch.Tensor, idx: torch.Tensor, g: torch.Tensor,
               chunk: int) -> torch.Tensor:
    """df[q, b] = sum over the directions (q, bank) and k of
    g[d, b, k] * banks[bank, idx[b, k]]: the features' gradient of the six
    (bsz, K+1) logit matrices, gathered chunk columns of idx at a time
    (one (3, bsz, chunk, dim) gather live), with no scatter."""
    g = g.float()
    df = torch.zeros((3, idx.shape[0], banks.shape[2]), dtype=torch.float32,
                     device=banks.device)
    for start in range(0, idx.shape[1], chunk):
        w = _gathered_rows(banks, idx[:, start:start + chunk])
        gc = g[:, :, start:start + chunk]
        for d, (qi, bi) in enumerate(CMC3_DIRS):
            df[qi] += torch.bmm(gc[d][:, None, :], w[bi])[:, 0]
    return df


class _CMC3LogitsHybrid(torch.autograd.Function):
    """Six un-scaled (bsz, K+1) logit matrices, stacked (6, bsz, K+1):
    forward by the dense scores f @ bank.T and a scalar gather, backward
    by one chunked bank-row gather shared by all six directions, so that
    nothing scatters (the JAX package's custom VJP _cmc3_logits_hybrid)."""

    @staticmethod
    def forward(ctx, feats, banks, idx, chunk):
        f = feats.float()
        ctx.save_for_backward(banks, idx)
        ctx.chunk = chunk
        ctx.feats_dtype = feats.dtype
        return torch.stack([(f[qi] @ banks[bi].t()).gather(1, idx)
                            for qi, bi in CMC3_DIRS])

    @staticmethod
    def backward(ctx, g):
        banks, idx = ctx.saved_tensors
        df = _rows_grad(banks, idx, g, ctx.chunk)
        return df.to(ctx.feats_dtype), None, None, None


class _CMC3LogitsGather(_CMC3LogitsHybrid):
    """Six un-scaled (bsz, K+1) logit matrices, stacked, by the
    reference's bank-row gather + bmm (mem_bank.py:176-191), chunk columns
    of idx at a time so that one (3, bsz, chunk, dim) gather is live; the
    backward (the hybrid form's) gathers the rows again instead of
    keeping them (the JAX package's _cmc3_logits_gather under
    jax.checkpoint)."""

    @staticmethod
    def forward(ctx, feats, banks, idx, chunk):
        f = feats.float()
        out = torch.empty((6,) + tuple(idx.shape), dtype=torch.float32,
                          device=banks.device)
        for start in range(0, idx.shape[1], chunk):
            w = _gathered_rows(banks, idx[:, start:start + chunk])
            for d, (qi, bi) in enumerate(CMC3_DIRS):
                out[d, :, start:start + chunk] = torch.bmm(
                    w[bi], f[qi][:, :, None])[:, :, 0]
        ctx.save_for_backward(banks, idx)
        ctx.chunk = chunk
        ctx.feats_dtype = feats.dtype
        return out


def cmc3_forward(banks: torch.Tensor, feats: torch.Tensor, y: torch.Tensor,
                 all_feats: torch.Tensor, all_y: torch.Tensor, k: int,
                 temperature: float, m: float = 0.5,
                 generator: Optional[torch.Generator] = None,
                 dense_scores: bool = True,
                 neg_idx: Optional[torch.Tensor] = None,
                 mode: Optional[str] = None, chunk: int = 1024
                 ) -> Tuple[Tuple[torch.Tensor, ...], Callable[[], None]]:
    """CMCMem3.forward (mem_bank.py:172-205): the six cross-modal logit
    matrices with the positive in column 0, and the EMA update of all
    three banks from (all_feats, all_y).

    neg_idx pins the (bsz, K+1) draw (positive in column 0); else it is
    drawn from `generator`.  mode: 'dense' | 'hybrid' | 'gather' (the same
    math; the last two gather bank rows `chunk` columns of the draw at a
    time); None takes 'dense' if dense_scores else 'hybrid', as the JAX
    package does.

    Returns (logits, commit).  The banks are updated in place, so the
    update is deferred: call commit() after the loss's backward, whose
    graph holds the banks as they were (the JAX package returns new
    banks)."""
    if neg_idx is None:
        if generator is None:
            raise ValueError("cmc3_forward: pass neg_idx or a generator")
        idx = sample_negative_indices(generator, y, banks.shape[1], k)
    else:
        idx = neg_idx.long()
    if mode is None:
        mode = "dense" if dense_scores else "hybrid"
    if mode == "dense":
        logits = tuple(memory_logits(feats[qi], banks[bi], idx, temperature)
                       for qi, bi in CMC3_DIRS)
    elif mode in ("hybrid", "gather"):
        fn = _CMC3LogitsHybrid if mode == "hybrid" else _CMC3LogitsGather
        stacked = fn.apply(feats, banks.detach(), idx, chunk)
        logits = tuple((stacked / temperature).unbind(0))
    else:
        raise ValueError(f"cmc3_forward: unknown mode {mode!r}")

    def commit() -> None:
        for i in range(banks.shape[0]):
            update_memory(banks[i], all_feats[i], all_y, m)

    return logits, commit
