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
tokens).  ``moe_ffn_ep`` (expert parallelism over a mesh axis) waits for
the LM with a ``ParallelContext``.
"""
from __future__ import annotations

import torch

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


def moe_ffn_ep(p, x, cfg: ModelConfig, axis):
    raise NotImplementedError(
        "moe_ffn_ep (expert parallelism over a mesh axis) waits for the LM "
        "with a ParallelContext (ROADMAP Queue 1 item 13.6)")
