"""The LM train step: loss, gradients, AdamW.  The counterpart of
``repro.train.step``, with its names and objective:

  * chunked cross-entropy: logits are made (B, C, Vp) at a time along
    the sequence, each chunk under ``torch.utils.checkpoint``, never (B,
    S, Vp) with its backward (padded vocabulary rows at -1e30);
  * per-block remat (``TrainConfig.remat``: ``lm.forward(remat=True)``);
  * gradient accumulation over ``TrainConfig.grad_accum`` micro-batches,
    summed into f32 zeros and divided at the end, as the reference's scan;
  * the MoE aux loss (``0.01 * moe_aux``) and deepseek's MTP head
    (``0.3 * mtp_ce``) in the objective; frames for audio, patches for
    vlm with the loss on the text positions only.

Under a ``ParallelContext`` (simulated ranks on one device,
``core/parallel.py``) the forward looks the tokens up through the
row-wise sharded embedding bag and runs the MoE layers expert-parallel
(``models/lm.py``); the embedding's gradient flows back through the
row-wise partial lookups' autograd.  The reference's sharding
constraints on the chunks and their logits are layouts: the port
computes the same sums without them.  The gradients land in a tree of
``.grad`` buffers like the parameters, kept across steps
(``TrainStep.grads``), and the update writes the parameters and moments
in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.parallel import ParallelContext
from repro_torch.models import lm
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.utils.tree import leaves, map_leaves


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------

def _chunk_count(n_tokens: int, per_dev: int, target: int = 16384) -> int:
    """Largest chunk count that divides per-device tokens, chunks >= target."""
    want = max(1, n_tokens // target)
    best = 1
    for d in range(1, per_dev + 1):
        if per_dev % d == 0 and d <= want:
            best = max(best, d)
    return best


def _chunk_nll(hb, head, yb, mb, vmask):
    logits = (hb @ head).float()                          # (B, C, Vp)
    logits = logits.masked_fill(~vmask, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yb.long()[..., None])[..., 0]
    return torch.sum((lse - ll) * mb)


def softmax_xent_chunked(hidden: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, vocab: int,
                         ctx: Optional[ParallelContext] = None,
                         mask: Optional[torch.Tensor] = None,
                         chunk_tokens: int = 16384) -> torch.Tensor:
    """Mean NLL of ``labels`` under logits = hidden @ head.

    hidden (B, S, d); head (d, Vp); labels (B, S) with Vp >= vocab (padded
    rows masked out of the softmax).  ``mask`` (B, S) optionally excludes
    positions.  Chunks along the sequence (``_chunk_count``), summed in
    order; each chunk's f32 logits under ``torch.utils.checkpoint`` when
    grad is enabled.  ``ctx`` changes no value (the reference's
    constraints under it are layouts)."""
    lm.check_context(ctx)
    B, S, d = hidden.shape
    Vp = head.shape[1]
    m = (torch.ones((B, S), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.float())
    nc = _chunk_count(B * S, S, chunk_tokens)
    C = S // nc
    vmask = torch.arange(Vp, device=hidden.device) < vocab
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, C):
        args = (hidden[:, lo:lo + C], head, labels[:, lo:lo + C],
                m[:, lo:lo + C], vmask)
        total = total + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else _chunk_nll(*args))
    return total / torch.clamp(m.sum(), min=1.0)


# ---------------------------------------------------------------------------
# LM objective (CE + MoE aux + MTP)
# ---------------------------------------------------------------------------

def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[ParallelContext],
            tc: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): ``ce``, for MoE ``moe_aux`` and ``moe_dropped``,
    with ``cfg.mtp_depth`` ``mtp_ce``, and ``loss``.  Under ``ctx`` the
    forward's and the MTP head's embeddings go through the sharded bag
    and the MoE layers are expert-parallel (``lm.forward``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patches"] = batch["patches"]
    hidden, aux = lm.forward(params, tokens, cfg, ctx, remat=tc.remat, **kw)

    if cfg.family == "vlm":                     # loss only on text positions
        hidden = hidden[:, cfg.vision_tokens:]
    head = params["embed"][0].T if cfg.tie_embeddings else params["head"]
    ce = softmax_xent_chunked(hidden, head, labels, cfg.vocab_size, ctx)
    loss = ce
    metrics = {"ce": ce}

    if cfg.is_moe:
        loss = loss + 0.01 * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
        metrics["moe_dropped"] = aux["moe_dropped"].float()

    if cfg.mtp_depth:                           # deepseek multi-token predict
        mtp = params["mtp"]
        emb_next = lm.embed_tokens(params, labels, cfg, ctx)
        hn = lm._norm(hidden, lm.layer(mtp["norm_h"], 0), cfg)
        en = lm._norm(emb_next, lm.layer(mtp["norm_e"], 0), cfg)
        h2 = torch.cat([hn, en], dim=-1) @ mtp["proj"]
        B, S2 = h2.shape[:2]
        pos = torch.arange(S2, device=h2.device).expand(B, S2)
        h2, _ = lm._dense_block(lm.layer(mtp["block"], 0), h2, pos, cfg)
        # target: the token at t+2 == labels shifted left by one
        mtp_ce = softmax_xent_chunked(h2[:, :-1], head, labels[:, 1:],
                                      cfg.vocab_size, ctx)
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce

    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tc: TrainConfig, tp_size: int = 1, dtype=None,
                     device=None) -> Dict[str, Any]:
    """``{"params", "opt"}``: ``lm.init_params`` from ``gen`` on ``device``
    (None: the card), the vocabulary padded to a multiple of ``tp_size``
    (the reference's), and ``adamw_init``."""
    params = lm.init_params(gen, cfg, tp_size=tp_size, dtype=dtype,
                            device=device)
    return {"params": params, "opt": adamw_init(params, tc)}


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)``: the reference's
    step on one device, under ``ctx`` when one is given.  ``state`` is
    updated in place and returned; ``batch`` holds tensors on the state's
    device.  ``grads`` keeps the gradient buffers (the parameters'
    dtypes, made at the first call): after a step at ``grad_accum`` 1,
    the gradient the update took."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 ctx: Optional[ParallelContext] = None):
        self.cfg, self.tc, self.ctx = cfg, tc, lm.check_context(ctx)
        self.grads = None

    def grad(self, params, mb) -> Dict[str, torch.Tensor]:
        """Zero ``grads`` (made at the first call), backprop ``lm_loss`` of
        ``mb`` into them (the parameters aliased as leaves that need a
        gradient, each with its buffer as ``.grad`` before the forward,
        which is what sends ``lm.layer``'s slices of a stack through
        ``lm._LayerSlice``); returns the metrics, detached."""
        if self.grads is None:
            self.grads = map_leaves(torch.zeros_like, params)
        for g in leaves(self.grads):
            g.zero_()

        def alias(p, g):
            a = p.detach().requires_grad_(True)
            a.grad = g
            return a

        with torch.enable_grad():
            leafs = map_leaves(alias, params, self.grads)
            loss, metrics = lm_loss(leafs, mb, self.cfg, self.ctx, self.tc)
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def __call__(self, state, batch):
        params, tc = state["params"], self.tc
        if tc.grad_accum > 1:
            n = tc.grad_accum
            acc = map_leaves(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            ms = []
            for i in range(n):
                mb = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                ms.append(self.grad(params, mb))
                for a, g in zip(leaves(acc), leaves(self.grads)):
                    a.add_(g)
            for a in leaves(acc):
                a.div_(n)
            grads = acc
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        else:
            metrics = self.grad(params, batch)
            grads = self.grads
        params, opt, om = adamw_update(grads, state["opt"], params, tc)
        metrics.update(om)
        return {"params": params, "opt": opt}, metrics


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    ctx: Optional[ParallelContext] = None) -> TrainStep:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``ctx``
    anything but None or a ``ParallelContext`` raises ``TypeError``."""
    return TrainStep(cfg, tc, ctx)
