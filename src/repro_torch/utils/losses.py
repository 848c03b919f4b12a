"""Loss functions of the LM training path.

The port's counterpart of the JAX package's ``utils/losses.py``.  The JAX
version picks the gold logit with an iota-compare-select reduction so that
a vocabulary sharded over the mesh needs no all-gather; the port's LM runs
on one device, so it gathers the gold logit (the same value: every other
term of that sum is zero).

``chunked_softmax_xent`` never holds the whole (B, S, V_pad) logits: each
sequence chunk's logits are built inside a non-reentrant
``torch.utils.checkpoint`` and recomputed in the backward pass, so one
chunk's (B, c, V_pad) block is live at a time, as JAX's
``jax.checkpoint`` over a ``lax.scan`` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

MASKED = -1e30   # the padded vocabulary tail's logit, in f32


def _masked_f32(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    lg = logits.to(torch.float32)
    v_pad = lg.shape[-1]
    if v_pad > vocab_size:
        vocab_ids = torch.arange(v_pad, device=lg.device)
        lg = torch.where(vocab_ids < vocab_size, lg, MASKED)
    return lg


def softmax_xent_sums(logits: torch.Tensor, labels: torch.Tensor, *, vocab_size: int):
    """(sum_nll, n_valid) — the unreduced building block for chunking.

    ``logits`` (B, S, V_pad) in any float dtype, ``labels`` (B, S) int with
    negative ids masked.  The padded vocabulary tail is excluded.
    """
    lg = _masked_f32(logits, vocab_size)
    lse = torch.logsumexp(lg, dim=-1)
    safe = labels.clamp(min=0).long()
    gold = lg.gather(-1, safe[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return ((lse - gold) * valid).sum(), valid.sum()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *, vocab_size: int):
    """Returns (mean_nll, n_valid).  Padded vocab tail is excluded."""
    nll, valid = softmax_xent_sums(logits, labels, vocab_size=vocab_size)
    n_valid = torch.clamp(valid, min=1.0)
    return nll / n_valid, n_valid


def _chunk_sums(xc, w, lc, vocab_size: int):
    return softmax_xent_sums(xc @ w, lc, vocab_size=vocab_size)


def chunked_softmax_xent(
    x: torch.Tensor,            # (B, S, D) final hidden states
    w: torch.Tensor,            # (D, V_pad) output projection
    labels: torch.Tensor,       # (B, S)
    *,
    vocab_size: int,
    chunk: int = 512,
):
    """Cross-entropy without materializing the full (B, S, V) logits.

    The sequence is cut into chunks of ``c = min(chunk, S)``, halved until
    it divides S; each chunk's logits are recomputed for the backward pass
    (only while grad is enabled), and the sums accumulate in chunk order.
    Returns (mean_nll, n_valid).
    """
    b, s, d = x.shape
    c = min(chunk, s)
    while s % c:
        c //= 2
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    n_valid = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for i in range(s // c):
        xc, lc = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if remat:
            nll, valid = checkpoint(_chunk_sums, xc, w, lc, vocab_size, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            nll, valid = _chunk_sums(xc, w, lc, vocab_size)
        nll_sum = nll_sum + nll
        n_valid = n_valid + valid
    n_valid = torch.clamp(n_valid, min=1.0)
    return nll_sum / n_valid, n_valid
