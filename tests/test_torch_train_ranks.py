"""Training with each rank of the model axis a process, on the CPU.

The same seeded inputs go through three paths: the reference (this file
run as a script in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``, on ``Mesh(devices.reshape(1, 4), ("data",
"model"))``), the port's simulated ranks (``make_context(4)``, in this
process), and the port's ranks as processes: ``run_ranks`` spawns 4 gloo
processes on the CPU once per module, and every rank case runs inside
them.  The JAX subprocess runs beside the ranks; both read the
parameters the port draws.  Both port sides run on one CPU thread a
process, so that their reductions take the same order.

What is held, and how closely:

  (a) each differentiable rank collective's input gradient
      (``all_reduce`` on both backends, ``all_gather`` tiled and stacked,
      the bulk ``all_to_all``, ``reduce_scatter`` bulk and emulated,
      ``comm.split`` along an axis and whole): bitwise the simulated
      collective's and ``jax.vjp``'s of the reference's collective in a
      ``shard_map`` -- each moves or adds cotangents, at most E of them,
      and the test's values are small integers, exact in f32;
  (b) the DLRM's gradients (``bce_loss(ctx=ProcessContext).backward()``)
      for row/allgather (bulk and onesided), row/a2a bulk, column and
      table: each rank's shard gradient is its rows (columns, tables) of
      the reference's ``jax.grad`` of ``bce_loss(ctx=)``, and its MLP
      gradients the reference's, within ``rtol=1e-5, atol=1e-6`` (two
      frameworks' f32 arithmetic: the tolerance of the local lookup's
      parity tests).  Against the simulated ranks: bitwise where every
      collective moves values or adds in rank order (onesided, column,
      table); the bulk sums take gloo's order, so their pooled vectors are
      held to ``2 (E - 1) 2**-24 sum_s |partial_s|`` (two f32 orders of E
      terms) and the gradients, which carry that rounding through the
      MLPs, to the
      reference's tolerance.  Then 3 steps of the flow (row-wise Adagrad
      on each rank's shard, SGD on the MLPs): the losses bitwise the
      simulated ranks' for the exact strategies, within ``1e-6``
      relative for the bulk ones and for column (its Adagrad mean adds
      the ranks' row sums of squares in gloo's order);
  (c) one LM train step under processes for every arch of
      ``test_torch_lm_parallel.py::test_train_step_matches_reference``,
      against the simulated ranks: the dense, hybrid, ssm, audio and vlm
      families' metrics, gradients and updated parameters bitwise, but
      for the gradient norm (:data:`NORM_RTOL`: its sharded vocabulary
      table's sum of squares is added per rank, then over the ranks)
      and the updates it scales (:data:`UPDATE_RTOL`); the MoE families'
      loss within :data:`AUX_RTOL` (``moe_aux`` from the load statistics
      summed in gloo's order), ``moe_dropped`` equal, the gradients of
      the routers and shared experts (summed over the ranks in gloo's
      order) within :data:`GRAD_RTOL` relative L2 and every other
      gradient bitwise (``models/moe.py`` adds a token's cotangents in one
      order on both sides), the updated parameters within
      :data:`GRAD_RTOL`; in bf16, for the MoE archs, every gradient
      bitwise but the routers' (within :data:`GRAD_RTOL`) and the shared
      experts' (f32 sums of the same bf16 partials in two orders, each
      rounded once: equal or adjacent bf16 values); against the
      reference (granite, moonshot, deepseek),
      the metrics within ``1e-5`` relative, every gradient within
      ``1e-4`` and every updated parameter within ``1e-5`` relative L2
      (``tests/test_torch_lm_parallel.py``'s bounds);
  (d) ``Trainer(ctx=ProcessContext)``: a rank's state drawn share by
      share (``init_train_state`` with the context) bitwise the cut of
      the whole state, for every arch and with int8 moments, and a tied
      head's parameters too; 3 steps against 2 steps, a
      restart and 1 more, bitwise; a checkpoint written by the ranks
      restores under ``make_context(4)`` to the ranks' state, and one
      written under ``make_context(4)`` restores on the ranks to its cut;
      rank 0 alone reports the metrics;
  (e) the refusals that remain: the one-sided all-to-all pipeline under
      grad (the DLRM on ranks and on simulated ranks), the one-sided rank
      all-to-all, reduce-scatter and ring permute; the bulk rank ring
      permute and row fetch and a tied head's train step go through
      under grad (their gradients: ``tests/test_torch_launch_ranks.py``).
"""
import contextlib
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import store
from repro_torch.configs import dlrm as dlrm_cfg
from repro_torch.configs.base import TrainConfig
from repro_torch.core import comm, parallel
from repro_torch.core import embedding_bag as teb
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import make_context
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import lm as tlm
from repro_torch.optim import rowwise_adagrad_init, rowwise_adagrad_update
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import (lm_params_for_rank,
                                       lm_train_state_for_rank,
                                       rank_sharded, token_slice_leaf)
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
E = 4
ARCHS = ["granite-8b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
         "hymba-1.5b", "rwkv6-1.6b", "whisper-base", "internvl2-2b"]
REF_ARCHS = ARCHS[:3]
MOE = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
LB, LS = 2, 16                    # the LM batch
DB = 16                           # the DLRM batch (E divides it: a2a)
FLOW_STEPS, FLOW_LR = 3, 0.05
TRAINER_ARCH = "moonshot-v1-16b-a3b"
STRATEGIES = {
    "row_allgather_bulk": dict(sharding="row"),
    "row_allgather_onesided": dict(sharding="row", rw_backend="onesided"),
    "row_a2a_bulk": dict(sharding="row", rw_impl="a2a"),
    "column": dict(sharding="column"),
    "table": dict(sharding="table"),
}
# the strategies whose collectives move values or add in rank order
EXACT = ("row_allgather_onesided", "column", "table")
BULK_SUMS = ("row_allgather_bulk", "row_a2a_bulk")
LOCAL = dict(rtol=1e-5, atol=1e-6)
FLOW_RTOL = 1e-6
METRIC, GRAD, UPDATE = 1e-5, 1e-4, 1e-5
AUX_RTOL = 1e-5                   # tests/test_torch_lm_ranks.py's
NORM_RTOL = 1e-6
UPDATE_RTOL = 1e-6
GRAD_RTOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32")


def _tc(**kw):
    return TrainConfig(**{"warmup_steps": 1, "remat": True, **kw})


def _dlrm_cfg(name):
    return dataclasses.replace(dlrm_cfg.smoke(), **STRATEGIES[name])


# ---------------------------------------------------------------------------
# Inputs, from seeds, as numpy
# ---------------------------------------------------------------------------

COLLECTIVES = {
    # name -> (per-rank input shape, cotangent shape, per rank or whole)
    "all_reduce_bulk": ((3, 5), (3, 5), "whole"),
    "all_reduce_onesided": ((3, 5), (3, 5), "whole"),
    "all_gather_tiled": ((2, 5), (2 * E, 5), "whole"),
    "all_gather_stacked": ((2, 5), (2, E, 5), "whole"),
    "all_to_all": ((E, 3), (E, 3), "rank"),
    "reduce_scatter": ((E, 2, 3), (2, 3), "rank"),
    "reduce_scatter_emulated": ((E, 2, 3), (2, 3), "rank"),
    "split_axis": ((2, 2 * E, 3), (2, 2, 3), "rank"),
    "split_whole": ((2, 3), (2, 3), "rank"),
}


def _inputs() -> dict:
    x = {}
    rng = np.random.default_rng(2030)
    for name, (shape, cot, kind) in COLLECTIVES.items():
        lead = () if name.startswith("split") else (E,)
        # small integers: every sum of at most E of them is exact in f32
        x[f"coll/{name}/x"] = rng.integers(-8, 8, lead + shape).astype(
            np.float32)
        x[f"coll/{name}/g"] = rng.integers(
            -8, 8, ((E,) if kind == "rank" else ()) + cot).astype(np.float32)
    cfg = dlrm_cfg.smoke()
    params = tdlrm.init_params(torch.Generator().manual_seed(7), cfg,
                               device="cpu")
    for path, leaf in flatten_with_paths(params):
        x[f"dlrm/params/{path}"] = leaf.numpy()
    T, L = cfg.num_sparse_features, cfg.pooling
    x["dlrm/dense"] = rng.standard_normal(
        (DB, cfg.num_dense_features)).astype(np.float32)
    x["dlrm/idx"] = rng.integers(0, cfg.rows_per_table,
                                 (T, DB, L)).astype(np.int32)
    x["dlrm/lens"] = rng.integers(0, L + 1, (T, DB)).astype(np.int32)
    x["dlrm/labels"] = (rng.random(DB) < 0.3).astype(np.float32)
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        state = tstep.init_train_state(torch.Generator().manual_seed(40 + i),
                                       cfg, _tc(), tp_size=E, device="cpu")
        for path, leaf in flatten_with_paths(state["params"]):
            x[f"lm/{arch}/params/{path}"] = leaf.numpy()
        for k, v in next(lm_batches(cfg, LB, LS, seed=i)).items():
            x[f"lm/{arch}/batch/{k}"] = v
    return x


def _tree(x: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix/...`` keys of ``x``, as CPU
    tensors (lists for the DLRM's MLP layers)."""
    tree: dict = {}
    for key, v in x.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.as_tensor(np.array(v))

    def lists(t):
        if isinstance(t, dict):
            if t and all(k.isdigit() for k in t):
                return [lists(t[str(i)]) for i in range(len(t))]
            return {k: lists(v) for k, v in t.items()}
        return t
    return lists(tree)


def _dlrm_inputs(x):
    batch = JaggedBatch(torch.as_tensor(x["dlrm/idx"]),
                        torch.as_tensor(x["dlrm/lens"]))
    return (torch.as_tensor(x["dlrm/dense"]), batch,
            torch.as_tensor(x["dlrm/labels"]))


def _lm_state(x, arch):
    params = _tree(x, f"lm/{arch}/params")
    return {"params": params, "opt": tstep.adamw_init(params, _tc())}


def _lm_batch(x, arch):
    return {k: v for k, v in _tree(x, f"lm/{arch}/batch").items()}


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.configs import dlrm as jdlrm_cfg
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core import comm as jcomm
    from repro.core.jagged import JaggedBatch as JJagged
    from repro.core.parallel import make_context as jmake_context
    from repro.models import dlrm as jdlrm
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep
    from repro.utils.compat import shard_map

    assert len(jax.devices()) == E, jax.devices()
    x = dict(np.load(inputs))
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, E),
                             ("data", "model"))
    ctx = jmake_context(mesh)
    out = {}

    def put(prefix, tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, v in leaves:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{prefix}/{key}"] = np.asarray(v)

    def jtree(prefix):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                      _tree(x, prefix))

    # (a) each collective's vjp in a shard_map over the model axis
    def smap(fn, ins, outs):
        return shard_map(fn, mesh=mesh, in_specs=ins, out_specs=outs,
                         check_vma=False)

    M = P("model")
    fns = {
        "all_reduce_bulk": smap(lambda v: jcomm.all_reduce(v[0], "model"),
                                (M,), P()),
        "all_reduce_onesided": smap(
            lambda v: jcomm.all_reduce(v[0], "model"), (M,), P()),
        "all_gather_tiled": smap(lambda v: jcomm.all_gather(
            v[0], "model", axis=0, tiled=True), (M,), P()),
        "all_gather_stacked": smap(lambda v: jcomm.all_gather(
            v[0], "model", axis=1), (M,), P()),
        "all_to_all": smap(lambda v: jcomm.all_to_all(v[0], "model")[None],
                           (M,), M),
        "reduce_scatter": smap(lambda v: jcomm.reduce_scatter(
            v[0], "model")[None], (M,), M),
        "reduce_scatter_emulated": smap(lambda v: jcomm.reduce_scatter(
            v[0], "model")[None], (M,), M),
        "split_axis": smap(lambda v: v[None], (P(None, "model"),), M),
        "split_whole": smap(lambda v: v[None], (P(),), M),
    }
    for name, fn in fns.items():
        _, vjp = jax.vjp(fn, jnp.asarray(x[f"coll/{name}/x"]))
        out[f"coll/{name}"] = np.asarray(vjp(jnp.asarray(
            x[f"coll/{name}/g"]))[0])

    # (b) jax.grad of the DLRM's bce_loss(ctx=) per strategy
    params = jtree("dlrm/params")
    batch = JJagged(jnp.asarray(x["dlrm/idx"]), jnp.asarray(x["dlrm/lens"]))
    dense, labels = jnp.asarray(x["dlrm/dense"]), jnp.asarray(
        x["dlrm/labels"])
    for name, fields in STRATEGIES.items():
        cfg = dataclasses.replace(jdlrm_cfg.smoke(), **fields)
        grads = jax.jit(jax.grad(lambda p, c=cfg: jdlrm.bce_loss(
            p, dense, batch, labels, c, ctx)))(params)
        put(f"dlrm/{name}", grads)

    # (c) one train step of lm_loss and adamw_update under the context
    tc = JTrainConfig(warmup_steps=1, remat=True)
    for arch in REF_ARCHS:
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                  dtype="float32")
        lp = jtree(f"lm/{arch}/params")
        lb = {k: jnp.asarray(v) for k, v in _tree(
            x, f"lm/{arch}/batch").items()}
        (_, metrics), grads = jax.jit(lambda p, b: jax.value_and_grad(
            jstep.lm_loss, has_aux=True)(p, b, cfg, ctx, tc))(lp, lb)
        new_p, _, om = jax.jit(
            lambda g, o, p: jadamw.adamw_update(g, o, p, tc))(
                grads, jadamw.adamw_init(lp, tc), lp)
        for k, v in dict(metrics, **om).items():
            out[f"lm/{arch}/metric/{k}"] = np.asarray(v, np.float64)
        put(f"lm/{arch}/grad", grads)
        put(f"lm/{arch}/params", new_p)
    np.savez(outputs, **out)


# ---------------------------------------------------------------------------
# Both port sides
# ---------------------------------------------------------------------------

def _collective(name, x, ctx):
    """(the output, under grad) of collective ``name`` on ``x``: a rank's
    value under a ProcessContext, the stacked ranks' (the whole value for
    the splits) under a ParallelContext."""
    ranks = isinstance(ctx, parallel.ProcessContext)
    c = None if not ranks else ctx
    if name.startswith("all_reduce"):
        return comm.all_reduce(x, backend=name.split("_")[-1], ctx=c)
    if name == "all_gather_tiled":
        return comm.all_gather(x, axis=0, tiled=True, ctx=c)
    if name == "all_gather_stacked":
        return comm.all_gather(x, axis=1, ctx=c)
    if name == "all_to_all":
        return comm.all_to_all(x, ctx=c)
    if name.startswith("reduce_scatter"):
        return comm.reduce_scatter(x, emulate_with_a2a=name.endswith(
            "emulated"), ctx=c)
    axis = 1 if name == "split_axis" else None
    if ranks:
        return comm.split(x, axis=axis, ctx=ctx)
    if axis is None:                              # every rank: all of x
        return x[None].expand((E,) + tuple(x.shape))
    b, s, d = x.shape
    return x.reshape(b, E, s // E, d).transpose(0, 1)


def _coll_grad(name, x, ctx, rank=None):
    """The input gradient of collective ``name`` under the loss <g, out>:
    on a rank, its own input's; simulated, the stacked ranks'."""
    xin = torch.as_tensor(x[f"coll/{name}/x"]).clone()
    g = torch.as_tensor(x[f"coll/{name}/g"])
    if rank is not None and not name.startswith("split"):
        xin = xin[rank].clone()
    if rank is not None and COLLECTIVES[name][2] == "rank":
        g = g[rank]
    xin.requires_grad_(True)
    with torch.enable_grad():
        (_collective(name, xin, ctx) * g).sum().backward()
    return xin.grad


def _dlrm_grads(x, name, ctx, rank_ctx=None):
    """(loss, pooled, the tables' or the shard's gradient, the MLP
    leaves' gradients) of ``bce_loss`` on the module's batch."""
    cfg = _dlrm_cfg(name)
    params = _tree(x, "dlrm/params")
    mlp = [layer[k].requires_grad_(True) for part in ("bottom", "top")
           for layer in params[part] for k in ("b", "w")]
    if rank_ctx is not None:
        shard = teb.shard_for_rank(params["tables"], cfg.embedding_config(),
                                   rank_ctx)
        params["tables"], tab = shard, shard.local.requires_grad_()
    else:
        tab = params["tables"].requires_grad_(True)
    dense, batch, labels = _dlrm_inputs(x)
    with torch.enable_grad():
        loss = tdlrm.bce_loss(params, dense, batch, labels, cfg, ctx)
        grads = torch.autograd.grad(loss, [tab] + mlp)
    with torch.no_grad():
        pooled = tdlrm._pooled_sharded(params["tables"], batch,
                                       cfg.embedding_config(), ctx)
    return loss.detach(), pooled, grads[0], list(grads[1:])


def _dlrm_flow(x, name, ctx, rank_ctx=None):
    """FLOW_STEPS steps of the DLRM flow: row-wise Adagrad on the tables
    (a rank's shard), SGD on the MLPs; the losses, and the tables (the
    rank's shard) after the steps."""
    cfg = _dlrm_cfg(name)
    params = _tree(x, "dlrm/params")
    tables = params["tables"]
    if rank_ctx is not None:
        tables = teb.shard_for_rank(tables, cfg.embedding_config(),
                                    rank_ctx)
    accum = rowwise_adagrad_init(tables)
    dense, batch, labels = _dlrm_inputs(x)
    losses = []
    for _ in range(FLOW_STEPS):
        leaf = getattr(tables, "local", tables).detach().requires_grad_()
        params["tables"] = (dataclasses.replace(tables, local=leaf)
                            if rank_ctx is not None else leaf)
        mlp = [layer[k].detach().requires_grad_() for part in
               ("bottom", "top") for layer in params[part]
               for k in ("b", "w")]
        for i, (part, j, k) in enumerate(
                (p, j, k) for p in ("bottom", "top")
                for j in range(len(params[p])) for k in ("b", "w")):
            params[part][j][k] = mlp[i]
        with torch.enable_grad():
            loss = tdlrm.bce_loss(params, dense, batch, labels, cfg, ctx)
            grads = torch.autograd.grad(loss, [leaf] + mlp)
        losses.append(loss.detach())
        tables, accum = rowwise_adagrad_update(
            dataclasses.replace(tables, local=leaf.detach())
            if rank_ctx is not None else leaf.detach(), accum, grads[0],
            lr=FLOW_LR)
        with torch.no_grad():
            for i, (part, j, k) in enumerate(
                    (p, j, k) for p in ("bottom", "top")
                    for j in range(len(params[p])) for k in ("b", "w")):
                params[part][j][k] = mlp[i].detach() - FLOW_LR * grads[
                    1 + i]
    return losses, getattr(tables, "local", tables)


def _bound_mass(x, name, ctx):
    """sum_s |partial_s| of each pooled element of a bulk row-wise sum,
    this rank's (the measure of the bound on its rounding)."""
    cfg = _dlrm_cfg(name)
    ecfg = cfg.embedding_config()
    params = _tree(x, "dlrm/params")
    rs = teb.shard_for_rank(params["tables"], ecfg, ctx)
    _, batch, _ = _dlrm_inputs(x)
    with torch.no_grad():
        mass = teb.row_partials(rs, batch, ecfg).abs()
        if ecfg.rw_impl == "allgather":
            return comm.all_reduce(mass, ctx=ctx)
        mass = comm.reduce_scatter(mass, ctx=ctx)
        return comm.all_gather(mass.reshape(-1, ecfg.num_tables, ecfg.dim),
                               axis=0, tiled=True, ctx=ctx)


def _lm_step(x, arch, ctx, rank_ctx=None):
    """One train step: the metrics, the gradients (a rank's shares) and
    the updated parameters (a rank's shares), by path."""
    cfg = _cfg(arch)
    state = _lm_state(x, arch)
    if rank_ctx is not None:
        state = lm_train_state_for_rank(state, cfg, rank_ctx)
    step = tstep.make_train_step(cfg, _tc(), ctx)
    state, metrics = step(state, _lm_batch(x, arch))
    return ({k: v.clone() for k, v in metrics.items()},
            dict(flatten_with_paths(step.grads)),
            dict(flatten_with_paths(tstep.rank_tensors(state["params"]))))


def _lm_step_bf16(arch, ctx, rank_ctx=None):
    """The gradients (a rank's shares) of one train step of ``arch``'s
    smoke config in bf16, its state and batch drawn in the process."""
    cfg = tconfigs.get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    state = tstep.init_train_state(torch.Generator().manual_seed(60), cfg,
                                   _tc(), tp_size=E, device="cpu")
    if rank_ctx is not None:
        state = lm_train_state_for_rank(state, cfg, rank_ctx)
    step = tstep.make_train_step(cfg, _tc(), ctx)
    step(state, {k: torch.as_tensor(v) for k, v in next(
        lm_batches(cfg, LB, LS, seed=9)).items()})
    return dict(flatten_with_paths(step.grads))


def _init_mismatches(ctx) -> dict:
    """Per case, the paths where a rank's state drawn share by share
    differs from the cut of the whole state from the same seed (or
    whose types differ)."""
    cases = {arch: (_cfg(arch), _tc()) for arch in ARCHS}
    cases["moonshot-int8"] = (_cfg("moonshot-v1-16b-a3b"),
                              _tc(optimizer_state_dtype="int8"))
    out = {}
    for name, (cfg, tc) in cases.items():
        mine = tstep.init_train_state(torch.Generator().manual_seed(3), cfg,
                                      tc, device="cpu", ctx=ctx)
        cut = lm_train_state_for_rank(tstep.init_train_state(
            torch.Generator().manual_seed(3), cfg, tc, tp_size=E,
            device="cpu"), cfg, ctx)
        assert type(mine["params"]["embed"]) is type(cut["params"]["embed"])
        a, b = _state_paths(mine), _state_paths(cut)
        out[name] = sorted(set(a) ^ set(b)) + [
            p for p in a if p in b and not torch.equal(a[p], b[p])]
    tied = dataclasses.replace(_cfg("granite-8b"), tie_embeddings=True)
    a = dict(flatten_with_paths(tstep.rank_tensors(tlm.init_params(
        torch.Generator().manual_seed(4), tied, device="cpu", ctx=ctx))))
    b = dict(flatten_with_paths(tstep.rank_tensors(lm_params_for_rank(
        tlm.init_params(torch.Generator().manual_seed(4), tied, tp_size=E,
                        device="cpu"), tied, ctx))))
    out["granite-tied"] = sorted(set(a) ^ set(b)) + [
        p for p in a if p in b and not torch.equal(a[p], b[p])]
    return out


def _trainer_run(cfg, ckpt, steps, start, ctx, reports=None):
    t = Trainer(cfg, _tc(checkpoint_every=100),
                lm_batches(cfg, LB, LS, seed=1, start_step=start),
                ckpt_dir=ckpt, ctx=ctx, device="cpu")
    assert t.start_step == start, (t.start_step, start)
    if steps is None:                   # restored, not run
        return t, t.state
    state = t.run(steps, on_metrics=None if reports is None else
                  lambda s, m: reports.append(s))
    return t, state


def _state_paths(state) -> dict:
    return dict(flatten_with_paths({
        "params": tstep.rank_tensors(state["params"]),
        "opt": state["opt"]}))


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:      # noqa: BLE001 -- the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _rank_refusals(x, ctx):
    needs = torch.zeros((E, 3), requires_grad=True)
    shard = torch.zeros((8, 3), requires_grad=True)
    addr = torch.zeros(2, dtype=torch.int64)

    def dlrm_onesided():
        cfg = dataclasses.replace(dlrm_cfg.smoke(), rw_impl="a2a",
                                  rw_backend="onesided")
        params = _tree(x, "dlrm/params")
        params["tables"] = teb.shard_for_rank(
            params["tables"], cfg.embedding_config(), ctx)
        params["tables"].local.requires_grad_()
        dense, batch, labels = _dlrm_inputs(x)
        with torch.enable_grad():
            tdlrm.bce_loss(params, dense, batch, labels, cfg,
                           ctx).backward()

    with torch.enable_grad():
        out = {
            "dlrm_a2a_onesided": _error(dlrm_onesided),
            "all_to_all_onesided": _error(lambda: comm.all_to_all(
                needs, backend="onesided", ctx=ctx)),
            "reduce_scatter_onesided": _error(lambda: comm.reduce_scatter(
                needs[:, :, None], backend="onesided", ctx=ctx)),
            "permute_ring_bulk": _error(lambda: comm.permute_ring(
                needs, ctx=ctx)),
            "permute_ring_onesided": _error(lambda: comm.permute_ring(
                needs, backend="onesided", ctx=ctx)),
            "fetch_rows_bulk": _error(lambda: comm.fetch_rows(
                shard, addr, addr, ctx=ctx)),
            "tied_head": _error(lambda: tstep.make_train_step(
                dataclasses.replace(_cfg("granite-8b"),
                                    tie_embeddings=True), _tc(), ctx)),
        }
    with torch.no_grad():               # no grad: the same calls go through
        out["no_grad"] = [tuple(comm.all_to_all(
            needs, backend="onesided", ctx=ctx).shape), tuple(
            comm.permute_ring(needs, ctx=ctx).shape)]
    return out


def _rank_cases(ctx, x, tmp):
    """Every case on this rank; rank 0 returns every rank's results."""
    torch.set_num_threads(1)
    r = ctx.rank
    out = {"coll": {name: _coll_grad(name, x, ctx, rank=r)
                    for name in COLLECTIVES}}
    out["dlrm"] = {name: _dlrm_grads(x, name, ctx, rank_ctx=ctx)
                   for name in STRATEGIES}
    out["mass"] = {name: _bound_mass(x, name, ctx) for name in BULK_SUMS}
    out["flow"] = {name: _dlrm_flow(x, name, ctx, rank_ctx=ctx)
                   for name in STRATEGIES}
    out["lm"] = {arch: _lm_step(x, arch, ctx, rank_ctx=ctx)
                 for arch in ARCHS}
    out["lm_bf16"] = {arch: _lm_step_bf16(arch, ctx, rank_ctx=ctx)
                      for arch in MOE}
    out["init"] = _init_mismatches(ctx)
    # (d) the Trainer: 3 steps; 2, a restart and 1; a restore of the
    # simulated ranks' checkpoint; rank 0 alone reports
    cfg = _cfg(TRAINER_ARCH)
    reports: list = []
    _, whole = _trainer_run(cfg, None, 3, 0, ctx, reports)
    _trainer_run(cfg, f"{tmp}/ranks", 2, 0, ctx)
    _, resumed = _trainer_run(cfg, f"{tmp}/ranks", 1, 2, ctx)
    _, from_sim = _trainer_run(cfg, f"{tmp}/simulated", None, 2, ctx)
    out["trainer"] = {"whole": _state_paths(whole),
                      "resumed": _state_paths(resumed),
                      "from_sim": _state_paths(from_sim),
                      "reports": reports}
    out["refusals"] = _rank_refusals(x, ctx)
    gathered = [None] * ctx.world
    torch.distributed.all_gather_object(gathered, out, group=ctx.group)
    return gathered


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, every rank's results): the JAX
    subprocess and the 4 rank processes run side by side; a checkpoint
    of the simulated ranks' Trainer is written first, for the ranks to
    restore."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    with _one_thread():
        _trainer_run(_cfg(TRAINER_ARCH), str(tmp / "simulated"), 2, 0,
                     make_context(E))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={E}"}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = parallel.run_ranks(_rank_cases, E, backend="gloo",
                                   device="cpu", args=(x, str(tmp)),
                                   timeout_s=300)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return x, dict(np.load(tmp / "outputs.npz")), ranks, tmp


@pytest.fixture(scope="module")
def simulated(runs):
    """The simulated ranks' results: the collectives, the DLRM's
    gradients and flows, the LM train steps."""
    x = runs[0]
    ctx = make_context(E)
    with _one_thread():
        return {
            "coll": {name: _coll_grad(name, x, ctx) for name in COLLECTIVES},
            "dlrm": {name: _dlrm_grads(x, name, ctx) for name in STRATEGIES},
            "flow": {name: _dlrm_flow(x, name, ctx) for name in STRATEGIES},
            "lm": {arch: _lm_step(x, arch, ctx) for arch in ARCHS},
            "lm_bf16": {arch: _lm_step_bf16(arch, ctx) for arch in MOE},
        }


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


def _share(whole: torch.Tensor, name: str, rank: int) -> torch.Tensor:
    """Rank ``rank``'s shard of the (T, R, D) tables under strategy
    ``name``."""
    sharding = STRATEGIES[name]["sharding"]
    axis = {"row": 1, "column": 2, "table": 0}[sharding]
    n = whole.shape[axis] // E
    return whole.narrow(axis, rank * n, n)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (n if n else 1.0))


def _mine(want: torch.Tensor, got: torch.Tensor, rank: int) -> torch.Tensor:
    """``want``'s share that a rank holds as ``got``: the same tensor, or
    its rows along the shard axis."""
    if want.shape == got.shape:
        return want
    n = got.shape[1]
    return want.narrow(1, rank * n, n)


# ---------------------------------------------------------------------------
# (a) the differentiable rank collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_gradient_matches_simulated_and_reference(
        runs, simulated, name):
    _, want, ranks, _ = runs
    sim = simulated["coll"][name]
    ref = torch.as_tensor(want[f"coll/{name}"])
    assert torch.equal(sim, ref), name
    for r, out in enumerate(ranks):
        got = out["coll"][name]
        # the splits' input is the whole value, every rank's gradient the
        # whole gradient; the others' a rank's own
        wanted = sim if name.startswith("split") else sim[r]
        assert _same_bits(got, wanted), (name, r)


# ---------------------------------------------------------------------------
# (b) the DLRM under processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STRATEGIES))
def test_dlrm_gradients_match_reference(runs, name):
    """Each rank's shard gradient is its part of the reference's jax.grad
    of bce_loss(ctx=); its MLP gradients the reference's."""
    _, want, ranks, _ = runs
    tables = torch.as_tensor(want[f"dlrm/{name}/tables"])
    mlp = [torch.as_tensor(want[f"dlrm/{name}/{part}/{j}/{k}"])
           for part in ("bottom", "top") for j in range(
               len(dlrm_cfg.smoke().bottom_mlp if part == "bottom"
                   else dlrm_cfg.smoke().top_mlp)) for k in ("b", "w")]
    assert float(tables.abs().max()) > 0
    for r, out in enumerate(ranks):
        _, _, g_tab, g_mlp = out["dlrm"][name]
        np.testing.assert_allclose(g_tab.numpy(),
                                   _share(tables, name, r).numpy(), **LOCAL,
                                   err_msg=f"rank {r}")
        for got, w in zip(g_mlp, mlp):
            np.testing.assert_allclose(got.numpy(), w.numpy(), **LOCAL,
                                       err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_dlrm_gradients_match_simulated(runs, simulated, name):
    """Bitwise the simulated ranks' where the collectives move values or
    add in rank order; for the bulk sums the pooled vectors within
    2 (E - 1) 2**-24 sum_s |partial_s| and the gradients within the
    reference's tolerance."""
    _, _, ranks, _ = runs
    loss, pooled, g_tab, g_mlp = simulated["dlrm"][name]
    for r, out in enumerate(ranks):
        rl, rp, rt, rm = out["dlrm"][name]
        mine = _share(g_tab, name, r)
        if name in EXACT:
            assert _same_bits(rl, loss) and _same_bits(rp, pooled), r
            assert _same_bits(rt, mine.contiguous()), r
            assert all(_same_bits(a, b) for a, b in zip(rm, g_mlp)), r
            continue
        bound = 2 * (E - 1) * 2.0 ** -24 * out["mass"][name]
        assert bool(((rp - pooled).abs() <= bound).all()), r
        np.testing.assert_allclose(rt.numpy(), mine.numpy(), **LOCAL)
        for a, b in zip(rm, g_mlp):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **LOCAL)


def test_bulk_sums_differ_in_order_only(runs, simulated):
    """The bound of the bulk strategies is not idle: the ranks' pooled
    vectors differ from the simulated ones somewhere, and stay under it."""
    _, _, ranks, _ = runs
    diff = [float((ranks[0]["dlrm"][n][1] - simulated["dlrm"][n][1])
                  .abs().max()) for n in BULK_SUMS]
    assert max(diff) > 0, diff


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_dlrm_flow_losses_match_simulated(runs, simulated, name):
    """FLOW_STEPS steps of the flow: every rank's losses bitwise rank
    0's; against the simulated ranks bitwise for row/allgather/onesided
    and table, within FLOW_RTOL for the bulk sums and column; the shards
    after the steps each rank's part of the simulated tables (the same
    bounds on the rows: LOCAL)."""
    _, _, ranks, _ = runs
    losses, tables = simulated["flow"][name]
    assert float(losses[-1]) < float(losses[0])
    for r, out in enumerate(ranks):
        rl, rt = out["flow"][name]
        assert all(_same_bits(a, b) for a, b in zip(rl, ranks[0]["flow"]
                                                    [name][0])), r
        mine = _share(tables, name, r).contiguous()
        if name in ("row_allgather_onesided", "table"):
            assert all(_same_bits(a, b) for a, b in zip(rl, losses)), r
            assert _same_bits(rt, mine), r
        else:
            np.testing.assert_allclose([float(v) for v in rl],
                                       [float(v) for v in losses],
                                       rtol=FLOW_RTOL, atol=0)
            np.testing.assert_allclose(rt.numpy(), mine.numpy(), **LOCAL)


# ---------------------------------------------------------------------------
# (c) the LM train step under processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_simulated(runs, simulated, arch):
    _, _, ranks, _ = runs
    cfg = _cfg(arch)
    metrics, grads, params = simulated["lm"][arch]
    for r, out in enumerate(ranks):
        rm, rg, rp = out["lm"][arch]
        assert set(rm) == set(metrics)
        # every rank holds the same metrics
        assert all(_same_bits(rm[k], ranks[0]["lm"][arch][0][k])
                   for k in rm), r
        tols = {"grad_norm": NORM_RTOL}
        if arch in MOE:
            tols.update(moe_aux=AUX_RTOL, loss=AUX_RTOL)
        for k in rm:
            got, want = float(rm[k]), float(metrics[k])
            tol = tols.get(k, 0.0)
            assert abs(got - want) <= tol * abs(want), (r, k, got, want)
        assert set(rg) == set(grads) and set(rp) == set(params)
        for path, g in rg.items():
            want = _mine(grads[path], g, r)
            if arch in MOE and token_slice_leaf(path):
                assert _rel(g.numpy(), want.numpy()) < GRAD_RTOL, (r, path)
            else:
                assert _same_bits(g, want.contiguous()), (r, path)
        for path, p in rp.items():
            want = _mine(params[path], p, r)
            rel = UPDATE_RTOL if arch not in MOE else GRAD_RTOL
            assert _rel(p.numpy(), want.numpy()) < rel, (r, path)
        shared = [p for p in rp if rank_sharded(p, cfg)]
        assert "embed" in shared
        if arch in MOE:
            assert float(rm["moe_dropped"]) == float(metrics["moe_dropped"])
            assert any(p.endswith("moe/gate") for p in shared)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_lm_train_step_matches_reference(runs, arch):
    _, want, ranks, _ = runs
    prefix = f"lm/{arch}/metric/"
    metrics = {k[len(prefix):]: float(v) for k, v in want.items()
               if k.startswith(prefix)}
    grads = dict(flatten_with_paths(_tree(want, f"lm/{arch}/grad")))
    params = dict(flatten_with_paths(_tree(want, f"lm/{arch}/params")))
    for r, out in enumerate(ranks):
        rm, rg, rp = out["lm"][arch]
        assert set(rm) == set(metrics)
        for k, w in metrics.items():
            assert abs(float(rm[k]) - w) <= METRIC * max(abs(w), 1e-30), (
                r, k, float(rm[k]), w)
        for kind, got_tree, want_tree, bound in (
                ("grad", rg, grads, GRAD), ("params", rp, params, UPDATE)):
            assert set(got_tree) == set(want_tree)
            for path, w in want_tree.items():
                g = got_tree[path]
                err = _rel(g.numpy(), _mine(w, g, r).numpy())
                assert err < bound, (r, kind, path, err)


def _bf16_steps_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest number of bf16 values between an element of ``got``
    and ``want`` (both bf16): the distance of their orderings of the
    16-bit patterns."""
    def order(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((order(got) - order(want)).abs().max())


@pytest.mark.parametrize("arch", MOE)
def test_moe_bf16_gradients_match_simulated(runs, simulated, arch):
    """One bf16 train step of the MoE archs under processes against the
    simulated ranks: a token's cotangents from the router, the dispatch
    and the shared experts add in one order on both sides, so every
    gradient is bitwise but those the ranks sum -- the f32 routers'
    within GRAD_RTOL, and the bf16 shared experts', f32 sums of the same
    bf16 partials in two orders each rounded once, equal or adjacent
    bf16 values."""
    _, _, ranks, _ = runs
    want_all = simulated["lm_bf16"][arch]
    for r, out in enumerate(ranks):
        got_all = out["lm_bf16"][arch]
        assert set(got_all) == set(want_all)
        for path, g in got_all.items():
            want = _mine(want_all[path], g, r).contiguous()
            if not token_slice_leaf(path):
                assert _same_bits(g, want), (r, path)
            elif g.dtype == torch.float32:
                assert _rel(g.numpy(), want.numpy()) < GRAD_RTOL, (r, path)
            else:
                assert _bf16_steps_apart(g, want) <= 1, (r, path)


@pytest.mark.parametrize("case", ARCHS + ["moonshot-int8", "granite-tied"])
def test_rank_init_is_the_cut_of_the_whole_state(runs, case):
    """A rank's state drawn share by share (the table's rows and each
    layer's experts drawn whole and cut at once) is bitwise the whole
    state's cut from the same seed; a tied head's parameters too."""
    _, _, ranks, _ = runs
    for r, out in enumerate(ranks):
        assert out["init"][case] == [], (r, out["init"][case])


def test_moe_drops_and_router_sums_are_exercised(runs):
    """The MoE smoke configs drop assignments under expert parallelism,
    and each rank's router gradient before the sum is its own share: the
    summed gradient is not what one rank computed alone."""
    _, _, ranks, _ = runs
    assert any(float(ranks[0]["lm"][a][0]["moe_dropped"]) > 0 for a in MOE)


# ---------------------------------------------------------------------------
# (d) the Trainer under processes
# ---------------------------------------------------------------------------

def test_trainer_resumes_bitwise(runs):
    """3 steps against 2 steps, a restart from the ranks' checkpoint and
    1 more: every rank's state bit for bit."""
    _, _, ranks, _ = runs
    for r, out in enumerate(ranks):
        a, b = out["trainer"]["whole"], out["trainer"]["resumed"]
        assert list(a) == list(b)
        assert all(torch.equal(a[p], b[p]) for p in a), r


def test_trainer_reports_on_rank_zero_only(runs):
    _, _, ranks, _ = runs
    assert ranks[0]["trainer"]["reports"] == [1, 2, 3]
    assert all(out["trainer"]["reports"] == [] for out in ranks[1:])


def test_ranks_checkpoint_restores_under_simulated_ranks(runs):
    """The ranks' checkpoint (step 3 of the resumed run) is the whole
    state: restored under make_context(4), each rank's share of it is
    that rank's state bitwise."""
    _, _, ranks, tmp = runs
    cfg = _cfg(TRAINER_ARCH)
    with _one_thread():
        t = Trainer(cfg, _tc(), iter(()), ckpt_dir=str(tmp / "ranks"),
                    ctx=make_context(E), device="cpu")
    assert t.start_step == 3
    whole = _state_paths(t.state)
    for r, out in enumerate(ranks):
        got = out["trainer"]["resumed"]
        assert set(got) == set(whole)
        for path, v in got.items():
            want = whole[path]
            if rank_sharded(path, cfg):
                n = v.shape[1]
                want = want.narrow(1, r * n, n)
            assert torch.equal(v, want), (r, path)


def test_simulated_checkpoint_restores_on_ranks(runs):
    """The simulated ranks' checkpoint (step 2) restored on each rank is
    its cut of that state, bitwise."""
    _, _, ranks, tmp = runs
    cfg = _cfg(TRAINER_ARCH)
    template = tstep.init_train_state(torch.Generator(), cfg, _tc(),
                                      tp_size=E, device="cpu")
    whole = _state_paths(store.restore(template, str(tmp / "simulated"), 2))
    for r, out in enumerate(ranks):
        got = out["trainer"]["from_sim"]
        for path, v in got.items():
            want = whole[path]
            if rank_sharded(path, cfg):
                n = v.shape[1]
                want = want.narrow(1, r * n, n)
            assert torch.equal(v, want), (r, path)


def test_lm_train_state_for_rank_cuts_the_int8_moments_exactly():
    """Off the process group: a rank's int8 moments decode to its rows of
    the whole moments' decoding, bitwise; replicated moments are the
    given tensors."""
    from repro_torch.optim.quant import dequantize_blockwise

    cfg = _cfg("moonshot-v1-16b-a3b")
    tc = _tc(optimizer_state_dtype="int8")
    state = tstep.init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                                   tp_size=E, device="cpu")
    g = torch.Generator().manual_seed(1)
    for mom in ("m", "v"):
        for _, q in flatten_with_paths(state["opt"][mom]):
            if q.dtype == torch.int8:
                q.copy_(torch.randint(0, 127, q.shape, generator=g))
            else:
                q.copy_(torch.rand(q.shape, generator=g))
    ctx = parallel.ProcessContext(group=None, rank=2, world=E,
                                  device=torch.device("cpu"))
    mine = lm_train_state_for_rank(state, cfg, ctx)
    for mom in ("m", "v"):
        whole = state["opt"][mom]
        for key in ("embed",):
            a = dequantize_blockwise(mine["opt"][mom][key])
            b = dequantize_blockwise(whole[key])
            n = a.shape[1]
            assert torch.equal(a, b[:, 2 * n:3 * n])
        cut = mine["opt"][mom]["moe_blocks"]["moe"]["up"]
        assert torch.equal(dequantize_blockwise(cut), dequantize_blockwise(
            whole["moe_blocks"]["moe"]["up"])[:, 2 * 2:3 * 2])
        assert mine["opt"][mom]["head"].q is whole["head"].q
    assert isinstance(mine["params"]["embed"], teb.RankShard)


# ---------------------------------------------------------------------------
# (e) the refusals that remain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what, match", [
    ("dlrm_a2a_onesided", "RuntimeError: reduce_scatter: the value needs a "
                          "gradient, and the one-sided route has no "
                          "derivative"),
    ("all_to_all_onesided", "RuntimeError: all_to_all: the value needs a "
                            "gradient, and the one-sided route"),
    ("reduce_scatter_onesided", "RuntimeError: reduce_scatter: the value "
                                "needs a gradient, and the one-sided"),
    # the bulk ring permute and row fetch carry the gradient now
    ("permute_ring_bulk", "^no error$"),
    ("permute_ring_onesided", "RuntimeError: permute_ring: the value needs "
                              "a gradient, and the one-sided route has no "
                              "derivative"),
    ("fetch_rows_bulk", "^no error$"),
    # a tied head trains over processes now
    ("tied_head", "^no error$"),
])
def test_rank_refusals_under_grad(runs, what, match):
    _, _, ranks, _ = runs
    for out in ranks:
        msg = out["refusals"][what]
        assert re.search(match, msg), msg


def test_rank_refused_calls_go_through_without_grad(runs):
    _, _, ranks, _ = runs
    for out in ranks:
        assert out["refusals"]["no_grad"] == [(E, 3), (E, 3)]


@pytest.mark.parametrize("op", ["all_to_all", "reduce_scatter",
                                "permute_ring", "fetch_rows"])
def test_simulated_onesided_refuses_under_grad(op):
    """The simulated one-sided routes refuse a value that needs a
    gradient, on the CPU as on a card; the bulk routes carry it."""
    x = torch.ones((E, E, 3), requires_grad=True)
    shards = torch.ones((E, 5, 3), requires_grad=True)
    addr = torch.zeros(2, dtype=torch.int64)
    call = {"all_to_all": lambda b: comm.all_to_all(x, backend=b),
            "reduce_scatter": lambda b: comm.reduce_scatter(x, backend=b),
            "permute_ring": lambda b: comm.permute_ring(x, backend=b),
            "fetch_rows": lambda b: comm.fetch_rows(shards, addr, addr,
                                                    backend=b)}[op]
    with pytest.raises(RuntimeError, match=f"{op}: the value needs a "
                                           f"gradient, and the one-sided "
                                           f"route has no derivative"):
        call("onesided")
    call("bulk").sum().backward()
    with torch.no_grad():
        assert not call("onesided").requires_grad


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
