"""Loss functions of the LM training path.

The port's counterpart of the JAX package's ``utils/losses.py``.  The JAX
version picks the gold logit with an iota-compare-select reduction so that
a vocabulary sharded over the mesh needs no all-gather.  On whole logits
the port gathers the gold logit (the same value: every other term of that
sum is zero).  On vocab-sharded logits (``shards``: each rank holds its
``V_pad/|model|`` columns, ``P(batch, None, model)``) the max and the
log-sum-exp reduce over ``model``, and the gold logit is selected on the
shard that owns it and summed over ``model``, JAX's local select and tiny
all-reduce; the (B, S, V) logits are never gathered.  Across cards the
sums and counts of :func:`softmax_xent_sums` are summed over the batch
shards before the mean (``parallel.sharding.batch_sum``): the mean of the
shards' means is another number when their valid counts differ.

``chunked_softmax_xent`` never holds the whole (B, S, V_pad) logits: each
sequence chunk's logits are built inside a non-reentrant
``torch.utils.checkpoint`` and recomputed in the backward pass, so one
chunk's (B, c, V_pad) block is live at a time, as JAX's
``jax.checkpoint`` over a ``lax.scan`` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import batch_sum

MASKED = -1e30   # the padded vocabulary tail's logit, in f32


def _masked_f32(logits: torch.Tensor, vocab_size: int, offset: int = 0) -> torch.Tensor:
    """``logits`` in f32, the columns of ids past ``vocab_size`` masked;
    column 0 is id ``offset``."""
    lg = logits.to(torch.float32)
    v_loc = lg.shape[-1]
    if offset + v_loc > vocab_size:
        vocab_ids = offset + torch.arange(v_loc, device=lg.device)
        lg = torch.where(vocab_ids < vocab_size, lg, MASKED)
    return lg


def softmax_xent_sums(logits: torch.Tensor, labels: torch.Tensor, *, vocab_size: int,
                      shards: shd.ModelShards | None = None):
    """(sum_nll, n_valid) — the unreduced building block for chunking.

    ``logits`` (B, S, V_pad) in any float dtype, or with ``shards`` this
    rank's (B, S, V_pad/|model|) columns; ``labels`` (B, S) int with
    negative ids masked.  The padded vocabulary tail is excluded.
    """
    safe = labels.clamp(min=0).long()
    valid = (labels >= 0).to(torch.float32)
    if shards is None:
        lg = _masked_f32(logits, vocab_size)
        lse = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, safe[..., None])[..., 0]
        return ((lse - gold) * valid).sum(), valid.sum()
    v_loc = logits.shape[-1]
    lg = _masked_f32(logits, vocab_size, shards.index * v_loc)
    top = shd.model_max(lg.amax(dim=-1), shards)
    lse = top + torch.log(shd.model_sum(torch.exp(lg - top[..., None]).sum(dim=-1), shards))
    local = safe - shards.index * v_loc
    own = (local >= 0) & (local < v_loc)
    gold = shd.model_sum(torch.where(own, lg.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0], 0.0), shards)
    return ((lse - gold) * valid).sum(), valid.sum()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *, vocab_size: int):
    """Returns (mean_nll, n_valid).  Padded vocab tail is excluded."""
    nll, valid = softmax_xent_sums(logits, labels, vocab_size=vocab_size)
    n_valid = torch.clamp(valid, min=1.0)
    return nll / n_valid, n_valid


def _chunk_sums(xc, w, lc, vocab_size: int, shards=None):
    return softmax_xent_sums(xc @ w, lc, vocab_size=vocab_size, shards=shards)


def chunked_softmax_xent(
    x: torch.Tensor,            # (B, S, D) final hidden states
    w: torch.Tensor,            # (D, V_pad) output projection
    labels: torch.Tensor,       # (B, S)
    *,
    vocab_size: int,
    chunk: int = 512,
    shards: shd.ModelShards | None = None,
):
    """Cross-entropy without materializing the full (B, S, V) logits.

    With ``shards`` ``w`` is this rank's (D, V_pad/|model|) columns and
    ``x`` every position of its batch shard, the same on every rank of
    ``model`` (:func:`softmax_xent_sums`).

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
            nll, valid = checkpoint(_chunk_sums, xc, w, lc, vocab_size, shards, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            nll, valid = _chunk_sums(xc, w, lc, vocab_size, shards)
        nll_sum = nll_sum + nll
        n_valid = n_valid + valid
    nll_sum, n_valid = batch_sum(nll_sum), batch_sum(n_valid)
    n_valid = torch.clamp(n_valid, min=1.0)
    return nll_sum / n_valid, n_valid
