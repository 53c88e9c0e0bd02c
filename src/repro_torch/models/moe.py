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
Level 1 buckets each rank's assignments by owner rank at ``cap1 =
ceil(N k / E * cf)`` (empty slots tagged with the discard expert
``E_x/E``), and one all-to-all moves the hidden vectors and their local
expert ids; level 2 buckets each rank's received rows by local expert at
``cap2 = ceil(N k / (E_x/E) * cf)`` with the discard bucket, the expert
GEMMs run over all ranks' buckets at once (rank r's local expert j is
expert r E_x/E + j: the buckets are in expert order), and the inverse
all-to-all and the f32 weighted combine return each assignment to its
token.  Assignments over a capacity are dropped (they contribute zero),
and ``moe_dropped`` is their count summed over ranks.  The combine adds a
token's k contributions in assignment order, as the reference's
``segment_sum`` does, in a loop over k: no atomics, so the card's result
does not vary from run to run.
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
                    dtype=torch.float32, device=None):
    """Stacked (n_layers, ...) MoE block params, the reference's layout:
    ``router`` (n, d, E) in float32 whatever ``dtype`` (drawn in ``dtype``
    first, as the reference rounds it), ``gate``/``up`` (n, E, d, f),
    ``down`` (n, E, f, d) and ``shared.{gate, up, down}`` at
    f * num_shared_experts."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def stack(shape, fan_in):
        # one layer's f32 temporary at most: (E, d, f), 0.74 GB at moonshot
        return layers.stacked_init(gen, n_layers, shape, fan_in,
                                   dtype=dtype, device=device)

    p = {"router": stack((d, E), d).float(),
         "gate": stack((E, d, f), d),
         "up": stack((E, d, f), d),
         "down": stack((E, f, d), f)}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"gate": stack((d, fs), d), "up": stack((d, fs), d),
                       "down": stack((fs, d), fs)}
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
# Expert parallelism over the simulated ranks
# ---------------------------------------------------------------------------

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
    k, n_exp = cfg.experts_per_token, cfg.num_experts
    if n_exp % E:
        raise ValueError(f"{n_exp} experts do not divide over {E} ranks")
    el = n_exp // E
    dev = x.device
    xf = x.reshape(E * N, d)

    # every rank's tokens routed at once: the load statistics as sums over
    # all of them, the reference's psum of each rank's sums
    w, topi, stats = router_topk(xf, p["router"], k)
    aux = aux_loss(stats)
    flat_e = topi.reshape(E, N * k).long()
    flat_w = w.reshape(E * N * k)
    tok = torch.arange(N, device=dev).repeat_interleave(k)     # (N k,)
    ranks = torch.arange(E, device=dev)[:, None]

    # level 1: bucket each rank's assignments by owner rank, one bucket
    # set per rank (bucket r * E + owner); stable positions in input order
    cap1 = max(1, math.ceil(N * k / E * cfg.moe_capacity_factor))
    dest1 = (ranks * E + flat_e // el).reshape(-1)
    (b_tok, b_el), slot1, drop1 = routing.fixed_capacity_bucket(
        dest1, E * E, cap1,
        [(ranks * N + tok).reshape(-1), (flat_e % el).reshape(-1)],
        fills=[0, el])
    send_x = xf[b_tok.reshape(-1)].reshape(E, E, cap1, d)
    recv_x = comm.all_to_all(send_x)                     # (E_dst, E_src, ...)
    recv_el = comm.all_to_all(b_el.reshape(E, E, cap1))

    # level 2: each rank's received rows by local expert, discard bucket el
    cap2 = max(1, math.ceil(N * k / el * cfg.moe_capacity_factor))
    flat_el = recv_el.reshape(E, E * cap1)
    dest2 = (ranks * (el + 1) + flat_el).reshape(-1)
    (e_in,), slot2, _ = routing.fixed_capacity_bucket(
        dest2, E * (el + 1), cap2, [recv_x.reshape(-1, d)])
    # a live row past cap2 is dropped (slot one past all ranks' buckets)
    drop2 = ((flat_el.reshape(-1) < el)
             & (slot2 == E * (el + 1) * cap2)).sum(dtype=torch.int32)
    e_in = e_in.reshape(E, el + 1, cap2, d)[:, :el].reshape(n_exp, cap2, d)
    act = layers.activation_fn(cfg.activation)
    h = act(torch.bmm(e_in, p["gate"])) * torch.bmm(e_in, p["up"])
    del e_in
    e_out = torch.bmm(h, p["down"]).reshape(E, el, cap2, d)
    del h
    e_out = torch.cat([e_out, e_out.new_zeros((E, 1, cap2, d))], dim=1)

    # inverse: unbucket level 2, all-to-all back, unbucket level 1, combine
    back = routing.gather_from_buckets(slot2, e_out.reshape(
        E * (el + 1), cap2, d))                          # (E * E cap1, d)
    ret = comm.all_to_all(back.reshape(E, E, cap1, d))
    contrib = routing.gather_from_buckets(
        slot1, ret.reshape(E * E, cap1, d)).reshape(E * N, k, d)
    cw = flat_w.reshape(E * N, k, 1)
    acc = contrib[:, 0].float() * cw[:, 0]
    for j in range(1, k):
        acc = acc + contrib[:, j].float() * cw[:, j]
    out = acc.to(x.dtype) + _shared_out(p, xf, cfg.activation)
    dropped = drop1.to(torch.int32) + drop2
    return out.reshape(E, N, d), {"moe_aux": aux, "moe_dropped": dropped}
