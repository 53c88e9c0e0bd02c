"""Mixture-of-Experts FFN: the counterpart of ``repro.models.moe``.

``moe_ffn(p, x, cfg)`` computes the reference's single-device function
(a scan over all E experts with a masked combine) in a routed form:

  1. ``router_topk``: f32 logits, the k largest (ties to the lower
     expert id, as ``jax.lax.top_k``), a softmax over the k kept values;
  2. ``routing.fixed_capacity_bucket`` of the assignments by expert id,
     at a capacity of the largest expert load, so nothing is dropped
     (``moe_dropped`` is 0, as in the reference's single-device path).
     Reading that load is one host sync.  Steps 2-5 run over at most
     ``CHUNK_ROWS`` tokens at a time, each chunk with its own capacity:
     the buckets hold E * cap rows, and a skewed routing pads them (at
     moonshot's full width on random weights layer 1's largest load was
     4.7x the mean on 2,048 tokens, and 16,384 tokens' buckets did not
     fit on an 80 GB card beside the weights and a 2-slot KV cache);
  3. three ``torch.bmm`` over the ``(E, cap, d)`` buckets: gate, up, down;
  4. ``routing.gather_from_buckets`` back to the assignments;
  5. the reference's combine order.  The reference carries ``out`` in
     ``x.dtype`` and adds ``y_e * w_e.astype(x.dtype)`` for e = 0 ... E-1;
     adding the zero rows of the experts a token did not choose is exact,
     so that is a sequential sum over the token's k chosen experts in
     ascending expert id, the weight cast to ``x.dtype`` before the
     product.  Here each token's choices are sorted by expert id and
     accumulated k times in ``x.dtype``;
  6. the shared experts' output, added last.

The scan over all experts costs about E / k times the routed form's
FLOP (8.5e14 against 8e13 per forward of moonshot-v1-16b-a3b at 16,384
tokens).

``moe_ffn_ep(p, x, cfg)`` is the reference's expert-parallel path over
the E ranks of the model axis, simulated on one device with the ranks
stacked on a leading axis (``core/comm.py``): ``x (E, N, d)`` holds each
rank's tokens, and rank r owns experts ``[r E_x/E, (r + 1) E_x/E)``.
Each rank routes its tokens; the load statistics are summed over the
ranks (the reference's ``psum``), so ``moe_aux`` is the global one.
Every GEMM runs at a rank's shapes (its N rows for the router and the
shared experts, its experts' buckets), one rank after another, so the
simulated ranks compute what ranks as processes compute, bit for bit on
a card too.
Level 1 buckets each rank's assignments by owner rank at ``cap1 =
ceil(N k / E * cf)`` (empty slots tagged with the discard expert
``E_x/E``), and one all-to-all moves the hidden vectors and their local
expert ids; level 2 buckets each rank's received rows by local expert at
``cap2 = ceil(N k / (E_x/E) * cf)`` with the discard bucket, each
rank's expert GEMMs run over its buckets (rank r's local expert j is
expert r E_x/E + j: the buckets are in expert order), and the inverse
all-to-all and the f32 weighted combine return each assignment to its
token.  Assignments over a capacity are dropped (they contribute zero),
and ``moe_dropped`` is their count summed over ranks.  The combine adds a
token's k contributions in assignment order, as the reference's
``segment_sum`` does, in a loop over k: no atomics, so the card's result
does not vary from run to run.

``moe_ffn_ep_rank(p, x, cfg, ctx)`` is the same dispatch for one rank of
a ``ProcessContext``: ``x`` (N, d) this rank's tokens, ``p`` its own
experts; the load statistics and the drops go through the group's
all-reduce and the rows through its all-to-all (``core/comm.py``).  Both
run the same bucketing and expert helpers, over E stacked ranks or one.

Under grad a rank's tokens have three uses -- the router, the dispatch,
the shared experts -- and their cotangents meet in ``x``'s gradient.
Autograd adds them in the order its engine delivers them, which is not
the same over the stacked ranks as in a rank's process, and in bf16
each addition rounds (on moonshot's layers the token cotangents then
differed by ~3e-3 relative L2, and everything upstream with them).  So
both paths take the tokens through :class:`_FanOut`, whose backward adds
the uses' cotangents in f32 in one fixed order and rounds once.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import comm

from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.models import layers

# tokens per dispatch of the routed form (module docstring, step 2)
CHUNK_ROWS = 4096

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_moe_params(gen: torch.Generator, n_layers: int, cfg: ModelConfig,
                    dtype=torch.float32, device=None, keep=None):
    """Stacked (n_layers, ...) MoE block params, the reference's layout:
    ``router`` (n, d, E) in float32 whatever ``dtype`` (drawn in ``dtype``
    first, as the reference rounds it), ``gate``/``up`` (n, E, d, f),
    ``down`` (n, E, f, d) and ``shared.{gate, up, down}`` at
    f * num_shared_experts.  ``keep`` maps a leaf's name (``"shared"``
    to such a mapping) to the part of each layer kept
    (``layers.stacked_init``): a rank's experts, from the whole stacks'
    draws."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    k = keep or {}
    ks = k.get("shared") or {}

    def stack(shape, fan_in, keep=None):
        # one layer's f32 temporary at most: (E, d, f), 0.74 GB at moonshot
        return layers.stacked_init(gen, n_layers, shape, fan_in,
                                   dtype=dtype, device=device, keep=keep)

    p = {"router": stack((d, E), d, k.get("router")).float(),
         "gate": stack((E, d, f), d, k.get("gate")),
         "up": stack((E, d, f), d, k.get("up")),
         "down": stack((E, f, d), f, k.get("down"))}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"gate": stack((d, fs), d, ks.get("gate")),
                       "up": stack((d, fs), d, ks.get("up")),
                       "down": stack((fs, d), fs, ks.get("down"))}
    return p


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def router_topk(x: torch.Tensor, router_w: torch.Tensor, k: int):
    """Returns (weights (N, k) f32, ids (N, k) int32, (top1_count,
    prob_sum, n)), the load-balance statistics as sums, as the
    reference's.  The top k come from a stable descending sort, so equal
    logits go to the lower expert id first, as in ``jax.lax.top_k``."""
    logits = x.float() @ router_w                                # (N, E)
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    w = torch.softmax(topv, dim=-1)                              # renormalise
    top1 = torch.bincount(topi[:, 0], minlength=E).float()
    n = torch.full((), x.shape[0], dtype=torch.float32, device=x.device)
    stats = (top1, probs.sum(0), n)
    return w, topi.to(torch.int32), stats


def aux_loss(stats) -> torch.Tensor:
    """GShard load-balance loss: E * mean_e(frac_tokens_e * mean_prob_e)."""
    top1_count, prob_sum, n = stats
    E = top1_count.shape[0]
    return E * torch.mean((top1_count / n) * (prob_sum / n))


def _shared_out(p, x, act):
    if "shared" not in p:
        return 0.0
    s = p["shared"]
    return (layers.activation_fn(act)(x @ s["gate"])
            * (x @ s["up"])) @ s["down"]


# ---------------------------------------------------------------------------
# The single-device MoE FFN
# ---------------------------------------------------------------------------

def _routed(p, x, ids, wx, cfg: ModelConfig):
    """Steps 2-5 over the rows ``x`` (n, d): ``ids`` (n, k) each token's
    experts in ascending id, ``wx`` (n, k) their weights in ``x.dtype``.
    Returns (the combined expert outputs (n, d), the dropped count)."""
    n, d = x.shape
    k, E = ids.shape[1], cfg.num_experts
    flat_e = ids.reshape(-1)
    cap = int(torch.bincount(flat_e, minlength=E).max())        # host sync
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    (b_tok,), slot, dropped = routing.fixed_capacity_bucket(
        flat_e, E, cap, [tok])
    xe = x[b_tok]                                                # (E, cap, d)
    act = layers.activation_fn(cfg.activation)
    h = act(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    del xe
    ye = torch.bmm(h, p["down"])                                 # (E, cap, d)
    del h
    y = routing.gather_from_buckets(slot, ye).reshape(n, k, d)
    del ye
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + y[:, j] * wx[:, j:j + 1]
    return out, dropped


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig):
    """x (N, d) -> (out (N, d), {"moe_aux", "moe_dropped"}): the routed
    form of the reference's expert scan (module docstring), routed over
    all N rows and dispatched ``CHUNK_ROWS`` at a time: one host sync per
    chunk reads its largest expert load, the buckets' capacity."""
    N, d = x.shape
    w, topi, stats = router_topk(x, p["router"], cfg.experts_per_token)
    aux = aux_loss(stats)
    # each token's choices in ascending expert id: the reference's order
    ids, order = torch.sort(topi.long(), dim=-1)
    wx = w.gather(1, order).to(x.dtype)
    out = torch.empty_like(x)
    dropped = torch.zeros((), dtype=torch.int32, device=x.device)
    for a in range(0, N, CHUNK_ROWS):
        b = min(a + CHUNK_ROWS, N)
        out[a:b], drop = _routed(p, x[a:b], ids[a:b], wx[a:b], cfg)
        dropped += drop
    out = out + _shared_out(p, x, cfg.activation)
    return out, {"moe_aux": aux, "moe_dropped": dropped}


# ---------------------------------------------------------------------------
# Expert parallelism: the dispatch shared by the stacked ranks and a rank
# ---------------------------------------------------------------------------
#
# Each helper takes the assignments of R ranks at once, stacked on a
# leading axis: R = E over the simulated ranks, R = 1 for one rank's own.

class _FanOut(torch.autograd.Function):
    """``n`` aliases of ``x``, one for each of its uses (a rank's tokens'
    three, or a replicated weight's E ranks); the backward adds the uses'
    cotangents in f32 in the aliases' order and rounds once to
    ``x.dtype``, whatever order autograd delivers them in."""

    @staticmethod
    def forward(fctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(fctx, *gs):
        acc = gs[0].float()
        for g in gs[1:]:
            acc = acc + g.float()
        return acc.to(gs[0].dtype), None


def _token_uses(x: torch.Tensor, shared: bool):
    """(router's, dispatch's, shared experts' or None) aliases of a rank's
    tokens ``x`` (:class:`_FanOut`)."""
    uses = _FanOut.apply(x, 3 if shared else 2)
    return uses if shared else (*uses, None)


def _ep_sizes(cfg: ModelConfig, E: int, N: int):
    """(experts a rank, cap1, cap2) of E ranks of N tokens each; raises
    ``ValueError`` when E does not divide the experts, where the
    reference's ``shard_map`` fails."""
    n_exp, k = cfg.num_experts, cfg.experts_per_token
    if n_exp % E:
        raise ValueError(f"{n_exp} experts do not divide over {E} ranks")
    el = n_exp // E
    cf = cfg.moe_capacity_factor
    return (el, max(1, math.ceil(N * k / E * cf)),
            max(1, math.ceil(N * k / el * cf)))


def _bucket_by_owner(flat_e: torch.Tensor, N: int, k: int, E: int, el: int,
                     cap1: int):
    """Level 1: ``flat_e`` (R, N k) expert ids -> ((token (R E, cap1)
    into the R ranks' stacked tokens, local expert id (R E, cap1), empty
    slots the discard id ``el``), slot, dropped), one bucket set of E
    owners per rank, stable positions in input order."""
    R, dev = flat_e.shape[0], flat_e.device
    tok = torch.arange(N, device=dev).repeat_interleave(k)      # (N k,)
    ranks = torch.arange(R, device=dev)[:, None]
    dest1 = (ranks * E + flat_e // el).reshape(-1)
    return routing.fixed_capacity_bucket(
        dest1, R * E, cap1,
        [(ranks * N + tok).reshape(-1), (flat_e % el).reshape(-1)],
        fills=[0, el])


def _expert_ffn(p, recv_x: torch.Tensor, recv_el: torch.Tensor, el: int,
                cap2: int, cfg: ModelConfig):
    """Level 2 and the experts: ``recv_x`` (R, M, d) the rows each rank
    received, ``recv_el`` (R, M) their local expert ids (``el``: empty),
    ``p`` the R ranks' ``R el`` experts in order.  Returns (the expert
    outputs unbucketed, (R M, d); the live rows dropped past ``cap2``).
    Each rank's experts run in GEMMs of their own, at the shapes a rank
    gives them: one batched GEMM over all R el experts may round
    otherwise on a card."""
    R, d = recv_x.shape[0], recv_x.shape[-1]
    flat_el = recv_el.reshape(R, -1)
    ranks = torch.arange(R, device=recv_x.device)[:, None]
    dest2 = (ranks * (el + 1) + flat_el).reshape(-1)
    (e_in,), slot2, _ = routing.fixed_capacity_bucket(
        dest2, R * (el + 1), cap2, [recv_x.reshape(-1, d)])
    # a live row past cap2 is dropped (slot one past all ranks' buckets)
    drop2 = ((flat_el.reshape(-1) < el)
             & (slot2 == R * (el + 1) * cap2)).sum(dtype=torch.int32)
    e_in = e_in.reshape(R, el + 1, cap2, d)
    act = layers.activation_fn(cfg.activation)
    empty = e_in.new_zeros((1, cap2, d))          # the discard bucket's
    e_out = []
    for r in range(R):
        w = {k: p[k][r * el:(r + 1) * el] for k in ("gate", "up", "down")}
        x = e_in[r, :el]
        h = act(torch.bmm(x, w["gate"])) * torch.bmm(x, w["up"])
        e_out += [torch.bmm(h, w["down"]), empty]
        del h
    del e_in
    return routing.gather_from_buckets(slot2, torch.cat(e_out)), drop2


def _combine(contrib: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """contrib (n, k, d), w (n, k) f32 -> (n, d) in ``dtype``: each
    token's k contributions added in f32 in assignment order."""
    cw = w.reshape(contrib.shape[0], -1, 1)
    acc = contrib[:, 0].float() * cw[:, 0]
    for j in range(1, contrib.shape[1]):
        acc = acc + contrib[:, j].float() * cw[:, j]
    return acc.to(dtype)


def moe_ffn_ep(p, x: torch.Tensor, cfg: ModelConfig):
    """Expert-parallel MoE over E simulated ranks (module docstring).

    ``x`` (E, N, d): rank r's N tokens at ``x[r]``; ``p`` the layer's
    whole parameters (``gate``/``up``/``down`` (E_x, ...), rank r's
    slice owned by it; ``router`` and ``shared`` replicated).  Returns
    (out (E, N, d), {"moe_aux", "moe_dropped"}).  Raises ``ValueError``
    when E does not divide the experts, where the reference's
    ``shard_map`` fails."""
    if x.dim() != 3:
        raise ValueError(f"moe_ffn_ep takes (ranks, N, d) tokens, got "
                         f"shape {tuple(x.shape)}")
    E, N, d = x.shape
    k = cfg.experts_per_token
    el, cap1, cap2 = _ep_sizes(cfg, E, N)

    # each rank routes its own tokens (a GEMM of its N rows, as a rank
    # computes it); the load statistics are the sums of the ranks' sums,
    # in rank order (the reference's psum)
    uses = [_token_uses(x[r], "shared" in p) for r in range(E)]
    # the router and the shared experts serve every rank, each on its own
    # tokens: their gradient is the ranks' added in f32 in rank order and
    # rounded once, as ranks as processes add theirs (train/step.py)
    router = _FanOut.apply(p["router"], E)
    shared = [dict(zip(p["shared"], ws)) for ws in zip(*(
        _FanOut.apply(v, E) for v in p["shared"].values()))] \
        if "shared" in p else None
    routed = [router_topk(uses[r][0], router[r], k) for r in range(E)]
    w = torch.cat([r[0] for r in routed])
    topi = torch.cat([r[1] for r in routed])
    aux = aux_loss(tuple(torch.stack(s).sum(0)
                         for s in zip(*(r[2] for r in routed))))
    (b_tok, b_el), slot1, drop1 = _bucket_by_owner(
        topi.reshape(E, N * k).long(), N, k, E, el, cap1)
    xf = torch.stack([u[1] for u in uses]).reshape(E * N, d)
    send_x = xf[b_tok.reshape(-1)].reshape(E, E, cap1, d)
    recv_x = comm.all_to_all(send_x)                     # (E_dst, E_src, ...)
    recv_el = comm.all_to_all(b_el.reshape(E, E, cap1))
    back, drop2 = _expert_ffn(p, recv_x, recv_el, el, cap2, cfg)

    # inverse: all-to-all back, unbucket level 1, combine
    ret = comm.all_to_all(back.reshape(E, E, cap1, d))
    contrib = routing.gather_from_buckets(
        slot1, ret.reshape(E * E, cap1, d)).reshape(E * N, k, d)
    out = _combine(contrib, w, x.dtype)
    if "shared" in p:           # a rank's rows a GEMM, as above
        out = out + torch.cat([_shared_out({"shared": shared[r]},
                                           uses[r][2], cfg.activation)
                               for r in range(E)])
    dropped = drop1.to(torch.int32) + drop2
    return out.reshape(E, N, d), {"moe_aux": aux, "moe_dropped": dropped}


def moe_ffn_ep_rank(p, x: torch.Tensor, cfg: ModelConfig, ctx):
    """The expert-parallel MoE for this rank of a ``ProcessContext``:
    the reference's ``moe_ffn_ep`` body, step for step.  ``x`` (N, d)
    this rank's tokens; ``p`` the layer's parameters with this rank's
    ``el = E_x / E`` experts (``gate``/``up``/``down`` (el, ...), experts
    ``[r el, (r + 1) el)``; ``router`` and ``shared`` whole).  Routes the
    tokens, all-reduces the load statistics (the reference's psum),
    buckets the assignments by owner, all-to-alls the rows and their
    local expert ids, runs its experts over what it received, all-to-alls
    the outputs back, combines, adds the shared experts and all-reduces
    the drops.  Returns (out (N, d), {"moe_aux", "moe_dropped"}), the
    same aux on every rank.  Every rank calls it at the same point with
    the same N."""
    if x.dim() != 2:
        raise ValueError(f"moe_ffn_ep_rank takes one rank's (N, d) tokens, "
                         f"got shape {tuple(x.shape)}")
    N, d = x.shape
    E, k, n_exp = ctx.world, cfg.experts_per_token, cfg.num_experts
    el, cap1, cap2 = _ep_sizes(cfg, E, N)
    if p["gate"].shape[0] != el:
        raise ValueError(
            f"this rank's MoE parameters hold {p['gate'].shape[0]} experts, "
            f"not its {el}: cut them with "
            f"utils.convert.lm_params_for_rank(params, cfg, ctx)")
    x_router, x_send, x_shared = _token_uses(x, "shared" in p)
    w, topi, (top1, prob_sum, n) = router_topk(x_router, p["router"], k)
    stats = comm.all_reduce(torch.cat([top1, prob_sum, n[None]]), ctx=ctx)
    aux = aux_loss((stats[:n_exp], stats[n_exp:2 * n_exp], stats[-1]))
    (b_tok, b_el), slot1, drop1 = _bucket_by_owner(
        topi.reshape(1, N * k).long(), N, k, E, el, cap1)
    recv_x = comm.all_to_all(x_send[b_tok.reshape(-1)].reshape(E, cap1, d),
                             ctx=ctx)                    # (E_src, cap1, d)
    recv_el = comm.all_to_all(b_el.reshape(E, cap1), ctx=ctx)
    back, drop2 = _expert_ffn(p, recv_x[None], recv_el[None], el, cap2, cfg)
    ret = comm.all_to_all(back.reshape(E, cap1, d), ctx=ctx)
    contrib = routing.gather_from_buckets(slot1, ret).reshape(N, k, d)
    out = _combine(contrib, w, x.dtype) + _shared_out(p, x_shared,
                                                      cfg.activation)
    dropped = comm.all_reduce(
        (drop1.to(torch.int32) + drop2).reshape(1), ctx=ctx)[0]
    return out, {"moe_aux": aux, "moe_dropped": dropped}
