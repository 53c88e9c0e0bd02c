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

Under a ``ProcessContext`` (each rank of the model axis a process, its
state drawn by :func:`init_train_state` with the context, or cut from a
whole one by ``utils/convert.lm_train_state_for_rank``) every rank runs
the step on the same batch and computes the same loss; the rank
collectives carry the gradient back to each rank's share (its rows of
the vocabulary, its experts).  After the backward, the gradients of the
replicated leaves each rank used on its own tokens only -- the MoE
routers and shared experts (``utils/convert.token_slice_leaf``) -- are
summed over the ranks (one all-reduce in f32, the group's order); every other
replicated leaf's gradient is the whole batch's on every rank.

With a state spec tree (``TrainStep(specs=)``, ``launch/specs.
state_spec_tree``: the reference's placement) a rank holds only its
piece of every leaf, its gradient and both moments: the forward reads
each cut parameter as a ``comm.Placed`` piece, all-gathered just before
its layer runs (``lm._run_block``, inside the layer's checkpoint), and
the gather's backward adds the piece's gradient into its buffer, summed
over the mesh as the leaf needs (so the sums below leave those leaves
out).  A gradient is kept at its moments' layout: an int8 moment is
whole along a last dim the parameter is cut on, and the update then
writes the parameter's columns of its whole rows
(``optim/adamw.adamw_update(columns=)``).  With a
data axis whose ``dp_size`` divides the batch, each data group runs its
samples over its model axis and computes only their head and
cross-entropy; the loss is the global token mean on every rank (the
cross-entropy's numerator and its mask count each summed over the data
axis, not each group's mean averaged), and after the model axis's sums
every leaf's gradient is summed over the data axis, once, in f32
(:meth:`TrainStep.sum_over_data`).  The clip takes the whole model's norm
(``optim/adamw.global_norm`` with the context, each leaf counted once),
and each rank updates its own share.  A tied head
(``tie_embeddings``, which no shipped config sets) is the table itself,
as in the reference's tree: a rank holds its rows as ``embed`` (its
``RankShard``) and the table whole as ``head``, which the logits read.
The head is no leaf of the gradients, the moments or a checkpoint
(:func:`rank_tensors` with the config); the rows of its gradient in the
rank's range are added to the shard's before the sums over the data
axis, and after each update the model axis all-gathers the rows back
into ``head`` (:func:`sync_tied_head`).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import comm
from repro_torch.core.embedding_bag import RankShard
from repro_torch.core.parallel import (ParallelContext, ProcessContext,
                                       data_split)
from repro_torch.models import lm
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.launch import specs as S
from repro_torch.utils.convert import token_slice_leaf
from repro_torch.utils.tree import flatten_with_paths, leaves, map_leaves


# the f32 elements of one data-axis all-reduce of the gradients
DATA_BUCKET_ELEMS = 1 << 26

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
    total, count = _xent_sums(hidden, head, labels, vocab, mask,
                              chunk_tokens)
    return total / torch.clamp(count, min=1.0)


def _data_xent(hidden, head, labels, vocab, ctx) -> torch.Tensor:
    """The global token mean of a data group's rows' NLL: its sum and its
    token count each summed over the data axis."""
    total, count = _xent_sums(hidden, head, labels, vocab)
    return comm.data_all_reduce(total, ctx=ctx) / torch.clamp(
        comm.data_all_reduce(count, ctx=ctx), min=1.0)


def _xent_sums(hidden, head, labels, vocab, mask=None, chunk_tokens=16384):
    """(the NLL summed over the unmasked positions, their count)."""
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
    return total, m.sum()


# ---------------------------------------------------------------------------
# LM objective (CE + MoE aux + MTP)
# ---------------------------------------------------------------------------

def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            ctx: Optional[ParallelContext],
            tc: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics): ``ce``, for MoE ``moe_aux`` and ``moe_dropped``,
    with ``cfg.mtp_depth`` ``mtp_ce``, and ``loss``.  Under ``ctx`` the
    forward's and the MTP head's embeddings go through the sharded bag
    and the MoE layers are expert-parallel (``lm.forward``).  Under a
    ``ProcessContext`` whose data groups split the batch, this group's
    samples over its model axis, each cross-entropy the global token mean
    (its sum and count summed over the data axis) and ``aux`` as
    ``lm.data_aux`` makes it."""
    split = data_split(ctx, batch["tokens"].shape[0])
    inner = ctx                     # what the samples run under
    if split is not None:
        rows, inner = split
        batch = {k: v[rows] for k, v in batch.items()}
    tokens, labels = batch["tokens"], batch["labels"]
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = batch["frames"]
    if cfg.family == "vlm":
        kw["patches"] = batch["patches"]
    hidden, aux = lm.forward(params, tokens, cfg, inner, remat=tc.remat,
                             **kw)
    if split is not None:
        aux = lm.data_aux(aux, ctx)

    def xent(h, head, y):
        if split is not None:
            return _data_xent(h, head, y, cfg.vocab_size, ctx)
        return softmax_xent_chunked(h, head, y, cfg.vocab_size, ctx)

    if cfg.family == "vlm":                     # loss only on text positions
        hidden = hidden[:, cfg.vision_tokens:]
    head = lm._head(params, cfg)
    ce = xent(hidden, head, labels)
    loss = ce
    metrics = {"ce": ce}

    # the load-balance term is a mean over the MoE layers that ran: a
    # model cut in depth to its first_k_dense dense layers has none.  A
    # difference on purpose: the reference's mean over no layer is NaN
    # there, so its loss too
    if cfg.is_moe and "moe_aux" in aux:
        loss = loss + 0.01 * aux["moe_aux"]
        metrics["moe_aux"] = aux["moe_aux"]
        metrics["moe_dropped"] = aux["moe_dropped"].float()

    if cfg.mtp_depth:                           # deepseek multi-token predict
        mtp = comm.gathered(params["mtp"])
        emb_next = lm.embed_tokens(params, labels, cfg, inner)
        hn = lm._norm(hidden, lm.layer(mtp["norm_h"], 0), cfg)
        en = lm._norm(emb_next, lm.layer(mtp["norm_e"], 0), cfg)
        h2 = torch.cat([hn, en], dim=-1) @ mtp["proj"]
        B, S2 = h2.shape[:2]
        pos = torch.arange(S2, device=h2.device).expand(B, S2)
        h2, _ = lm._dense_block(lm.layer(mtp["block"], 0), h2, pos, cfg)
        # target: the token at t+2 == labels shifted left by one
        mtp_ce = xent(h2[:, :-1], head, labels[:, 1:])
        loss = loss + 0.3 * mtp_ce
        metrics["mtp_ce"] = mtp_ce

    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     tc: TrainConfig, tp_size: int = 1, dtype=None,
                     device=None, ctx: Optional[ProcessContext] = None,
                     specs=None) -> Dict[str, Any]:
    """``{"params", "opt"}``: ``lm.init_params`` from ``gen`` on ``device``
    (None: the card), the vocabulary padded to a multiple of ``tp_size``
    (the reference's), and ``adamw_init``.  With ``ctx`` (a
    ``ProcessContext``) this rank's state, drawn piece by piece
    (``lm.init_params`` with the context): what
    ``utils/convert.lm_train_state_for_rank`` cuts from the whole one,
    under ``specs`` (a state spec tree, ``launch/specs.state_spec_tree``
    under ``ctx``: the placement) or, with None, the cuts every rank
    holds whatever the placement.  The moments are built at the
    moments' spec: an int8 moment whole along a last dim the parameter
    is cut on."""
    params = lm.init_params(gen, cfg, tp_size=tp_size, dtype=dtype,
                            device=device, ctx=ctx,
                            specs=None if specs is None else specs["params"])
    tensors = rank_tensors(params, cfg)
    if ctx is None:
        return {"params": params, "opt": adamw_init(tensors, tc)}
    place = placement(cfg, tc, ctx, specs)
    like = _map_paths(lambda path, t: SimpleNamespace(
        shape=place.grad_shape(path, tuple(t.shape)), device=t.device),
        tensors)
    return {"params": params, "opt": adamw_init(like, tc)}


def placement(cfg: ModelConfig, tc: TrainConfig, ctx: ProcessContext,
              specs=None) -> S.Placement:
    """The ``launch/specs.Placement`` of a rank's state under ``specs`` (a
    state spec tree), or, with None, of the cuts every rank holds
    whatever the placement (``launch/specs.rank_cut_tree``)."""
    if specs is None:
        specs = S.rank_cut_tree(S.state_spec_tree(cfg, tc, ctx)[1], cfg)
    return S.Placement.of(specs, cfg, ctx)


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of tensors, in a tree of its
    shape."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def rank_tensors(params, cfg: Optional[ModelConfig] = None
                 ) -> Dict[str, Any]:
    """``params`` with a rank's ``RankShard`` of the vocabulary replaced by
    its ``local`` rows, and with ``cfg.tie_embeddings`` without the whole
    table a rank keeps as ``"head"``: the tree of tensors the gradients,
    the moments and a checkpoint are laid out like (the reference's tree,
    which has no head when it is tied)."""
    embed = params.get("embed")
    if cfg is not None and cfg.tie_embeddings and "head" in params:
        params = {k: v for k, v in params.items() if k != "head"}
    if isinstance(embed, RankShard):
        return {**params, "embed": embed.local}
    return params


def _tied_rank_head(params, cfg: ModelConfig) -> bool:
    """Whether ``params`` are a rank's with a tied head: its rows a
    ``RankShard``, the whole table its ``"head"``."""
    return (cfg.tie_embeddings and "head" in params
            and isinstance(params.get("embed"), RankShard))


def sync_tied_head(params, cfg: ModelConfig, ctx: ProcessContext) -> None:
    """A rank's tied ``"head"`` (the whole table, ``(d, Vp)``) set from
    the ranks' rows of it, all-gathered over the model axis: after an
    update or a restore has written this rank's rows.  Nothing without a
    tied head over processes."""
    if not _tied_rank_head(params, cfg):
        return
    with torch.no_grad():
        rows = comm.all_gather(params["embed"].local[0], axis=0, tiled=True,
                               ctx=ctx)
        params["head"].copy_(rows.T)


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)``: the reference's
    step on one device, under ``ctx`` when one is given.  ``state`` is
    updated in place and returned; ``batch`` holds tensors on the state's
    device.  ``grads`` keeps the gradient buffers (the parameters'
    dtypes, made at the first call; a rank's pieces under a
    ``ProcessContext``, at the layout of ``specs``, a state spec tree,
    when given: :func:`placement`): after a step at ``grad_accum`` 1, the
    gradient the update took."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 ctx: Optional[ParallelContext | ProcessContext] = None,
                 specs=None):
        self.cfg, self.tc, self.ctx = cfg, tc, lm.check_context(ctx)
        self.ranks = self.ctx if isinstance(ctx, ProcessContext) else None
        self.grads = None
        # by path: the axes each gradient is cut over, and the columns of
        # a parameter whose gradient is whole along its last dim
        self.sharded: Dict[str, Tuple[str, ...]] = {}
        self.columns: Dict[str, Tuple[int, int]] = {}
        self.place = None if self.ranks is None else placement(
            cfg, tc, self.ranks, specs)
        # whether the data groups split the last micro-batch
        self.split = False

    def grad(self, params, mb) -> Dict[str, torch.Tensor]:
        """Zero ``grads`` (made at the first call), backprop ``lm_loss`` of
        ``mb`` into them (the parameters aliased as leaves that need a
        gradient, each with its buffer as ``.grad`` before the forward,
        which is what sends ``lm.layer``'s slices of a stack through
        ``lm._LayerSlice``; a rank's ``RankShard`` around its aliased
        rows), then, over processes, sum the token-sliced leaves'
        gradients over the ranks and, when the data groups split ``mb``,
        every gradient over the data axis; returns the metrics,
        detached."""
        tensors = rank_tensors(params, self.cfg)
        place = self.place
        if self.grads is None:
            self._make_grads(tensors)
        for g in leaves(self.grads):
            g.zero_()
        if self.ranks is not None:
            self.split = data_split(self.ranks,
                                    mb["tokens"].shape[0]) is not None

        def alias(path, p):
            g = self._grad(path)
            a = p.detach().requires_grad_(True)
            lp = None if place is None else place.params[path]
            if lp is None or not lp.gathered:
                a.grad = g
                return a
            return comm.Placed(a, lp.gather, lp.grad, self.ranks, buffer=g,
                               summed=token_slice_leaf(path),
                               split=self.split)

        tied = _tied_rank_head(params, self.cfg)
        with torch.enable_grad():
            leafs = _map_paths(alias, tensors)
            if isinstance(params.get("embed"), RankShard):
                leafs["embed"] = dataclasses.replace(params["embed"],
                                                     local=leafs["embed"])
            if tied:
                leafs["head"] = params["head"].detach().requires_grad_(True)
            loss, metrics = lm_loss(leafs, mb, self.cfg, self.ctx, self.tc)
            loss.backward()
        if tied:
            # the head's gradient (d, Vp), the batch's on every rank of the
            # model axis: its rows in this rank's range into the shard's
            n, r = params["embed"].local.shape[1], self.ranks.rank
            with torch.no_grad():
                self.grads["embed"][0].add_(
                    leafs["head"].grad.T[r * n:(r + 1) * n])
        if self.ranks is not None:
            self._sum_token_slices()
            if self.split:
                self.sum_over_data()
        return {k: v.detach() for k, v in metrics.items()}

    def _make_grads(self, tensors) -> None:
        """The gradient buffers, zeros in the parameters' dtypes at the
        gradients' layout (``launch/specs.Placement.grad_shape``: a
        parameter's piece, whole along a last dim its int8 moments keep
        whole), and by path the axes each is cut over and the columns of
        a parameter whose gradient is wider than its piece."""
        place = self.place
        if place is None:
            self.grads = map_leaves(torch.zeros_like, tensors)
            return
        self.grads = _map_paths(lambda path, t: torch.zeros(
            place.grad_shape(path, tuple(t.shape)), dtype=t.dtype,
            device=t.device), tensors)
        for path, t in flatten_with_paths(tensors):
            if place.cuts(path):
                self.sharded[path] = place.cuts(path)
            cols = place.columns(path, t.shape[-1])
            if cols is not None:
                self.columns[path] = cols

    def _grad(self, path: str) -> torch.Tensor:
        node = self.grads
        for k in path.split("/"):
            node = node[k]
        return node

    def _summed_in_backward(self, path: str) -> bool:
        """Whether the gradient of the parameter at ``path`` came out of
        its gather's backward summed over the mesh (``comm.Placed``)."""
        return self.place is not None and self.place.params[path].gathered

    def _sum_token_slices(self) -> None:
        """The routers' and shared experts' gradients summed over the
        ranks, in one all-reduce in f32 (a bf16 leaf's sum rounds once),
        and when the data groups split the batch (``split``) over the data
        axis too, in the same f32 sum (a placed leaf's backward summed
        it)."""
        gs = [g for p, g in flatten_with_paths(self.grads)
              if token_slice_leaf(p) and not self._summed_in_backward(p)]
        if not gs:
            return
        with torch.no_grad():
            flat = comm.all_reduce(torch.cat([g.reshape(-1).float()
                                              for g in gs]), ctx=self.ranks)
            if self.split:
                flat = comm.data_all_reduce(flat, ctx=self.ranks)
            for g, part in zip(gs, flat.split([g.numel() for g in gs])):
                g.copy_(part.view_as(g))

    def sum_over_data(self) -> None:
        """Every other leaf's gradient, each data group's share of the
        batch's, summed over the data axis once, in f32 (a bf16 leaf's sum
        rounds once): in buckets of up to :data:`DATA_BUCKET_ELEMS`
        elements a collective, so that the f32 staging stays a bucket's
        size.  Every data group then holds the same gradient, and the
        clip's norm counts each leaf once."""
        gs = [g for p, g in flatten_with_paths(self.grads)
              if not token_slice_leaf(p) and not self._summed_in_backward(p)]
        with torch.no_grad():
            while gs:
                n, k = 0, 0
                while k < len(gs) and (k == 0 or n + gs[k].numel()
                                       <= DATA_BUCKET_ELEMS):
                    n += gs[k].numel()
                    k += 1
                bucket, gs = gs[:k], gs[k:]
                flat = comm.data_all_reduce(torch.cat(
                    [g.reshape(-1).float() for g in bucket]), ctx=self.ranks)
                for g, part in zip(bucket, flat.split(
                        [g.numel() for g in bucket])):
                    g.copy_(part.view_as(g))

    def __call__(self, state, batch):
        params, tc = state["params"], self.tc
        if tc.grad_accum > 1:
            n = tc.grad_accum
            acc = None
            ms = []
            for i in range(n):
                mb = {k: v.reshape((n, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                ms.append(self.grad(params, mb))
                if acc is None:
                    acc = map_leaves(lambda g: torch.zeros(
                        g.shape, dtype=torch.float32, device=g.device),
                        self.grads)
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
        _, opt, om = adamw_update(grads, state["opt"],
                                  rank_tensors(params, self.cfg), tc,
                                  ctx=self.ranks, sharded=self.sharded,
                                  columns=self.columns)
        if self.ranks is not None:
            sync_tied_head(params, self.cfg, self.ranks)
        metrics.update(om)
        return {"params": params, "opt": opt}, metrics


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    ctx: Optional[ParallelContext | ProcessContext] = None,
                    specs=None) -> TrainStep:
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``ctx``
    anything but None, a ``ParallelContext`` or a ``ProcessContext``
    raises ``TypeError`` (``lm.check_context``).  Under a
    ``ProcessContext`` the state is this rank's
    (``utils/convert.lm_train_state_for_rank``), placed by ``specs`` (a
    state spec tree, ``launch/specs.state_spec_tree``) when given."""
    return TrainStep(cfg, tc, ctx, specs)
