"""A data axis with each rank a process, on the CPU: a ``(2, 2)`` mesh.

``run_ranks(..., dp_size=2)`` spawns 4 gloo processes on the CPU once per
module: 2 data groups of 2 model-axis ranks, global rank ``d * 2 + m``
rank m of data group d, as the reference's ``("data", "model")`` mesh.
The same seeded inputs go through three paths: the reference on
``Mesh(devices.reshape(2, 2), ("data", "model"))`` (this file run as a
script in a subprocess with ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` and ``JAX_PLATFORMS=cpu``,
beside the ranks), the port's simulated ranks (``make_context(2,
dp_size=2)``, in this process) and the ranks.  Both port sides run on
one CPU thread a process, so that their reductions take one order.

What is held, and how closely:

  * the context: each rank's place (``dp_rank``, ``rank``, ``world``) is
    its device's place in the reference's mesh, the groups' ranks are the
    mesh's rows and columns, and a world ``tp_size`` does not divide
    raises ``ValueError``;
  * the DLRM forward and engine flushes, for row/allgather, row/a2a (each
    bulk and one-sided), column and table: against the reference (bulk;
    Pallas interpret mode cannot run the one-sided kernels on a 2-D mesh)
    at ``PCTR_TOL``, and bitwise the simulated ranks' -- each data
    group's rows pool as the simulation's group does, the model axis's
    sums have two terms (an f32 sum of two terms is one rounding in any
    order), and the MLPs' rows do not depend on the rows beside them;
  * DLRM training, two steps of the flow (row-wise Adagrad on each
    rank's shard, SGD on the MLPs, the gradients summed over the data
    axis by ``dlrm.sum_over_data``): every loss within ``FLOW_RTOL`` of
    the simulated ranks' (their MLP gradients sum the batch's rows in one
    product, the ranks' in two and an all-reduce), and both data groups'
    shards and MLP leaves bitwise equal after each step;
  * granite-8b and moonshot-v1-16b-a3b at smoke width: the forward's,
    prefill's and each decode step's hidden states within ``HIDDEN`` of
    the reference's ``(2, 2)`` run; the forward and prefill bitwise the
    simulated ranks', decode within ``HIDDEN`` (a data group's one-sample
    decode takes other CPU kernels than the simulation's two samples);
    ``generate``'s and ``ContinuousBatcher``'s greedy tokens equal the
    simulated ranks'; one train step's loss within ``LOSS_RTOL`` of the
    simulated step's (the cross-entropy's numerator adds two groups'
    partial sums; ``AUX_RTOL`` for moonshot, the bound
    ``tests/test_torch_lm_ranks.py`` holds its load statistics to) and
    its gradient norm within ``NORM_RTOL``, the metrics
    within ``METRIC`` of the reference's step; the MoE's ``aux`` the
    first data group's;
  * ``Trainer``: the checkpoint written by global rank 0 alone restores
    on every rank to its state, bitwise; only global rank 0 reports;
  * the refusals that stay: the remote tier under a data axis, the
    tiered cache beside a model-axis context; a tied head's train step
    goes through (its step: ``tests/test_torch_launch_ranks.py``).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as tconfigs
from repro_torch.cache.tiers import RemoteStore
from repro_torch.configs import dlrm as dlrm_cfg
from repro_torch.configs.base import TrainConfig
from repro_torch.core import embedding_bag as teb
from repro_torch.core import parallel
from repro_torch.core.cache_config import CacheConfig
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import make_context
from repro_torch.data.synthetic import lm_batches
from repro_torch.models import decode as tdec
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import lm as tlm
from repro_torch.optim import rowwise_adagrad_init, rowwise_adagrad_update
from repro_torch.serving.engine import (ContinuousBatcher, CTRRequest,
                                        Request, generate, make_dlrm_engine)
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import (lm_params_for_rank,
                                       lm_train_state_for_rank)
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
DP, TP = 2, 2
WORLD = DP * TP
# the DLRM: a batch DP divides, the engine's 6 requests in batches of 8
DB, ENGINE_REQS, ENGINE_BATCH = 16, 6, 8
FLOW_STEPS, FLOW_LR = 2, 0.05
STRATEGIES = {
    "row_allgather_bulk": dict(sharding="row"),
    "row_allgather_onesided": dict(sharding="row", rw_backend="onesided"),
    "row_a2a_bulk": dict(sharding="row", rw_impl="a2a"),
    "row_a2a_onesided": dict(sharding="row", rw_impl="a2a",
                             rw_backend="onesided"),
    "column": dict(sharding="column"),
    "table": dict(sharding="table"),
}
# the one-sided a2a pipeline has no derivative: it serves, it does not train
TRAINED = [n for n in STRATEGIES if n != "row_a2a_onesided"]
# the bulk route each strategy is held to the reference on
REFERENCE = {n: n.replace("onesided", "bulk") for n in STRATEGIES}
ARCHS = ("granite-8b", "moonshot-v1-16b-a3b")
MOE = "moonshot-v1-16b-a3b"
LB, LS, MAX_LEN, DECODE_STEPS = 2, 16, 32, 3
PROMPTS, SLOTS, NEW = (6, 10, 13), 2, 6
TRAINER_STEPS = 2
PCTR_TOL = dict(rtol=1e-4, atol=1e-5)
HIDDEN = dict(rtol=1e-5, atol=1e-5)
FLOW_RTOL = 1e-6
LOSS_RTOL = 1e-6
AUX_RTOL = 1e-5
NORM_RTOL = 1e-6
METRIC = 1e-5


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32")


def _dlrm_cfg(name):
    return dataclasses.replace(dlrm_cfg.smoke(), **STRATEGIES[name])


def _tc(**kw):
    return TrainConfig(**{"warmup_steps": 1, "remat": True, **kw})


# ---------------------------------------------------------------------------
# Inputs, from seeds, as numpy
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    x = {}
    rng = np.random.default_rng(2031)
    cfg = dlrm_cfg.smoke()
    params = tdlrm.init_params(torch.Generator().manual_seed(8), cfg,
                               device="cpu")
    for path, leaf in flatten_with_paths(params):
        x[f"dlrm/params/{path}"] = leaf.numpy()
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    x["dlrm/dense"] = rng.standard_normal((DB, F)).astype(np.float32)
    x["dlrm/idx"] = rng.integers(0, cfg.rows_per_table,
                                 (T, DB, L)).astype(np.int32)
    x["dlrm/lens"] = rng.integers(0, L + 1, (T, DB)).astype(np.int32)
    x["dlrm/labels"] = (rng.random(DB) < 0.3).astype(np.float32)
    x["req/dense"] = rng.standard_normal((ENGINE_REQS, F)).astype(np.float32)
    x["req/idx"] = rng.integers(0, cfg.rows_per_table,
                                (ENGINE_REQS, T, L)).astype(np.int32)
    x["req/lens"] = rng.integers(0, L + 1, (ENGINE_REQS, T)).astype(np.int32)
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        state = tstep.init_train_state(torch.Generator().manual_seed(70 + i),
                                       cfg, _tc(), tp_size=TP, device="cpu")
        for path, leaf in flatten_with_paths(state["params"]):
            x[f"lm/{arch}/params/{path}"] = leaf.numpy()
        x[f"lm/{arch}/tokens"] = rng.integers(0, cfg.vocab_size,
                                              (LB, LS)).astype(np.int32)
        x[f"lm/{arch}/steps"] = rng.integers(
            0, cfg.vocab_size, (DECODE_STEPS, LB)).astype(np.int32)
        for j, n in enumerate(PROMPTS):
            x[f"lm/{arch}/prompt{j}"] = rng.integers(
                2, cfg.vocab_size, n).astype(np.int32)
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


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.configs import dlrm as jdlrm_cfg
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core.jagged import JaggedBatch as JJagged
    from repro.core.parallel import make_context as jmake_context
    from repro.models import decode as jdec
    from repro.models import dlrm as jdlrm
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.serving.engine import CTRRequest as JRequest
    from repro.serving.engine import DLRMEngine as JEngine
    from repro.train import step as jstep

    assert len(jax.devices()) == WORLD, jax.devices()
    x = dict(np.load(inputs))
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(DP, TP),
                             ("data", "model"))
    ctx = jmake_context(mesh)
    out = {"mesh": np.array([[d.id for d in row] for row in mesh.devices]),
           "dp_for": np.array([len(ctx.dp_for(DB) or ()),
                               len(ctx.dp_for(3) or ()), ctx.dp_size,
                               ctx.tp_size])}

    def jtree(prefix):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                      _tree(x, prefix))

    params = jtree("dlrm/params")
    batch = JJagged(jnp.asarray(x["dlrm/idx"]), jnp.asarray(x["dlrm/lens"]))
    for name in sorted(set(REFERENCE.values())):
        cfg = dataclasses.replace(jdlrm_cfg.smoke(), **STRATEGIES[name])
        out[f"dlrm/{name}/forward"] = np.asarray(jdlrm.forward(
            params, jnp.asarray(x["dlrm/dense"]), batch, cfg, ctx))
        eng = JEngine(params, cfg, ENGINE_BATCH, ctx)
        for i in range(ENGINE_REQS):
            eng.submit(JRequest(rid=i, dense=x["req/dense"][i],
                                indices=x["req/idx"][i],
                                lengths=x["req/lens"][i]))
        scores = eng.run_to_completion()
        out[f"dlrm/{name}/engine"] = np.array(
            [scores[i] for i in range(ENGINE_REQS)])

    tc = JTrainConfig(warmup_steps=1, remat=True)
    for arch in ARCHS:
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                  dtype="float32")
        lp = jtree(f"lm/{arch}/params")
        tokens = jnp.asarray(x[f"lm/{arch}/tokens"])
        h, aux = jax.jit(lambda p, t: jlm.forward(p, t, cfg, ctx))(lp, tokens)
        out[f"lm/{arch}/forward"] = np.asarray(h)
        if "moe_aux" in aux:
            out[f"lm/{arch}/moe_aux"] = np.asarray(aux["moe_aux"])
        cache, h = jax.jit(lambda p, t: jdec.prefill(
            p, t, cfg, ctx, max_len=MAX_LEN))(lp, tokens)
        out[f"lm/{arch}/prefill"] = np.asarray(h)
        step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, cfg, ctx))
        for i in range(DECODE_STEPS):
            cache, h = step(lp, cache, jnp.asarray(x[f"lm/{arch}/steps"][i]))
            out[f"lm/{arch}/step{i}"] = np.asarray(h)
        lb = {k: jnp.asarray(v.numpy()) for k, v in
              _tree(x, f"lm/{arch}/batch").items()}
        (_, metrics), grads = jax.jit(lambda p, b: jax.value_and_grad(
            jstep.lm_loss, has_aux=True)(p, b, cfg, ctx, tc))(lp, lb)
        _, _, om = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, tc))(
            grads, jadamw.adamw_init(lp, tc), lp)
        for k, v in dict(metrics, **om).items():
            out[f"lm/{arch}/metric/{k}"] = np.asarray(v, np.float64)
    np.savez(outputs, **out)


# ---------------------------------------------------------------------------
# Both port sides
# ---------------------------------------------------------------------------

def _mlp_paths(params):
    return [(p, j, k) for p in ("bottom", "top")
            for j in range(len(params[p])) for k in ("b", "w")]


def _dlrm_serve(x, name, ctx):
    """(the forward's logits, the engine's scores in request order)."""
    cfg = _dlrm_cfg(name)
    params = _tree(x, "dlrm/params")
    dense, batch, _ = _dlrm_inputs(x)
    with torch.no_grad():
        logits = tdlrm.forward(params, dense, batch, cfg, ctx)
    eng = make_dlrm_engine(_tree(x, "dlrm/params"), cfg, ENGINE_BATCH, ctx,
                           device="cpu")
    for i in range(ENGINE_REQS):
        eng.submit(CTRRequest(rid=i, dense=x["req/dense"][i],
                              indices=x["req/idx"][i],
                              lengths=x["req/lens"][i]))
    scores = eng.run_to_completion()
    return logits, torch.tensor([scores[i] for i in range(ENGINE_REQS)])


def _dlrm_flow(x, name, ctx):
    """FLOW_STEPS steps of the flow: row-wise Adagrad on the tables (a
    rank's shard), SGD on the MLPs, the gradients summed over the data
    axis; the losses, and the tables and MLP leaves after each step."""
    cfg = _dlrm_cfg(name)
    params = _tree(x, "dlrm/params")
    tables = params["tables"]
    ranks = isinstance(ctx, parallel.ProcessContext)
    if ranks:
        tables = teb.shard_for_rank(tables, cfg.embedding_config(), ctx)
    accum = rowwise_adagrad_init(tables)
    dense, batch, labels = _dlrm_inputs(x)
    paths = _mlp_paths(params)
    losses, states = [], []
    for _ in range(FLOW_STEPS):
        leaf = getattr(tables, "local", tables).detach().requires_grad_()
        params["tables"] = (dataclasses.replace(tables, local=leaf)
                            if ranks else leaf)
        mlp = [params[p][j][k].detach().requires_grad_()
               for p, j, k in paths]
        for i, (p, j, k) in enumerate(paths):
            params[p][j][k] = mlp[i]
        with torch.enable_grad():
            loss = tdlrm.bce_loss(params, dense, batch, labels, cfg, ctx)
            grads = torch.autograd.grad(loss, [leaf] + mlp)
        grads = tdlrm.sum_over_data(grads, DB, ctx)
        losses.append(loss.detach())
        tables, accum = rowwise_adagrad_update(
            dataclasses.replace(tables, local=leaf.detach()) if ranks
            else leaf.detach(), accum, grads[0], lr=FLOW_LR)
        with torch.no_grad():
            for i, (p, j, k) in enumerate(paths):
                params[p][j][k] = mlp[i].detach() - FLOW_LR * grads[1 + i]
        states.append([getattr(tables, "local", tables).clone()]
                      + [params[p][j][k].clone() for p, j, k in paths])
    return losses, states


def _lm_params(x, arch, ctx):
    whole = _tree(x, f"lm/{arch}/params")
    if isinstance(ctx, parallel.ProcessContext):
        return lm_params_for_rank(whole, _cfg(arch), ctx)
    return whole


def _lm_serve(x, arch, ctx):
    """The forward's hidden states and aux, prefill's and each decode
    step's hidden states, generate's tokens, the batcher's tokens."""
    cfg = _cfg(arch)
    params = _lm_params(x, arch, ctx)
    tokens = torch.as_tensor(x[f"lm/{arch}/tokens"])
    out = {}
    with torch.no_grad():
        out["forward"], out["aux"] = tlm.forward(params, tokens, cfg, ctx)
        cache, out["prefill"] = tdec.prefill(params, tokens, cfg, ctx,
                                             max_len=MAX_LEN)
        for i in range(DECODE_STEPS):
            cache, out[f"step{i}"] = tdec.decode_step(
                params, cache, torch.as_tensor(x[f"lm/{arch}/steps"][i]),
                cfg, ctx)
        out["slots"] = int(cache["length"].shape[0])
        out["generate"] = generate(params, cfg, tokens, MAX_LEN - LS, ctx,
                                   device="cpu")
        eng = ContinuousBatcher(params, cfg, SLOTS, MAX_LEN, ctx, eos_id=-1,
                                device="cpu")
        for j in range(len(PROMPTS)):
            eng.submit(Request(j, x[f"lm/{arch}/prompt{j}"], NEW))
        done = eng.run_to_completion()
        out["batcher"] = {j: done[j].generated for j in range(len(PROMPTS))}
    return out


def _lm_step(x, arch, ctx):
    """One train step's metrics, and the parameters after it (a rank's
    shares), by path."""
    cfg = _cfg(arch)
    params = _tree(x, f"lm/{arch}/params")
    state = {"params": params, "opt": tstep.adamw_init(params, _tc())}
    if isinstance(ctx, parallel.ProcessContext):
        state = lm_train_state_for_rank(state, cfg, ctx)
    step = tstep.make_train_step(cfg, _tc(), ctx)
    state, metrics = step(state, _tree(x, f"lm/{arch}/batch"))
    return ({k: v.clone() for k, v in metrics.items()},
            dict(flatten_with_paths(tstep.rank_tensors(state["params"]))))


def _group_aux(x, ctx):
    """The MoE's aux of this rank's data group's samples alone, over its
    model axis."""
    cfg = _cfg(MOE)
    rows = ctx.data_rows(LB)
    with torch.no_grad():
        _, aux = tlm.forward(_lm_params(x, MOE, ctx),
                             torch.as_tensor(x[f"lm/{MOE}/tokens"])[rows],
                             cfg, ctx.model_axis())
    return aux


def _trainer(x, ctx, tmp):
    """TRAINER_STEPS steps with a final checkpoint, then a restore of it:
    both states, by path, and the steps reported."""
    cfg = _cfg(MOE)
    reports: list = []
    run = Trainer(cfg, _tc(), lm_batches(cfg, LB, LS, seed=1),
                  ckpt_dir=tmp, ctx=ctx, device="cpu")
    state = run.run(TRAINER_STEPS, on_metrics=lambda s, m: reports.append(s))
    back = Trainer(cfg, _tc(), iter(()), ckpt_dir=tmp, ctx=ctx, device="cpu")

    def paths(s):
        return dict(flatten_with_paths({
            "params": tstep.rank_tensors(s["params"]), "opt": s["opt"]}))
    return {"run": paths(state), "restored": paths(back.state),
            "start": back.start_step, "reports": reports}


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:      # noqa: BLE001 -- the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _context(ctx) -> dict:
    """This rank's place and its groups, and the contexts that raise."""
    return {
        "global": dist.get_rank(),
        "place": (ctx.dp_rank, ctx.rank, ctx.world, ctx.dp_size,
                  ctx.tp_size, ctx.global_rank),
        "queries": (ctx.dp_axes, ctx.dp_for(DB), ctx.dp_for(3),
                    ctx.dp_groups(DB), ctx.dp_groups(3), ctx.data_rows(DB),
                    ctx.tp_for(4)),
        "model_group": dist.get_process_group_ranks(ctx.group),
        "data_group": dist.get_process_group_ranks(ctx.data_group),
        "model_axis": (ctx.model_axis().dp_size,
                       ctx.model_axis().group is ctx.group,
                       parallel.same_model_axis(ctx, ctx.model_axis())),
        "tp_3": _error(lambda: parallel.make_process_context(3)),
        "dp_3": _error(lambda: parallel.make_process_context(2, dp_size=3)),
    }


def _refusals(x, ctx) -> dict:
    cfg = dataclasses.replace(dlrm_cfg.smoke(), cache=CacheConfig(rows=8))
    tables = _tree(x, "dlrm/params")["tables"]
    return {
        "remote": _error(lambda: RemoteStore(tables, ctx=ctx)),
        "cache": _error(lambda: make_dlrm_engine(
            _tree(x, "dlrm/params"), cfg, 4, ctx, device="cpu")),
        "tied": _error(lambda: tstep.make_train_step(
            dataclasses.replace(_cfg("granite-8b"), tie_embeddings=True),
            _tc(), ctx)),
    }


def _rank_cases(ctx, x, tmp):
    """Every case on this rank; global rank 0 returns every rank's
    results, in global rank order."""
    torch.set_num_threads(1)
    out = {"context": _context(ctx)}
    out["dlrm"] = {n: _dlrm_serve(x, n, ctx) for n in STRATEGIES}
    out["flow"] = {n: _dlrm_flow(x, n, ctx) for n in TRAINED}
    out["lm"] = {a: _lm_serve(x, a, ctx) for a in ARCHS}
    out["step"] = {a: _lm_step(x, a, ctx) for a in ARCHS}
    out["group_aux"] = _group_aux(x, ctx)
    out["trainer"] = _trainer(x, ctx, tmp)
    out["refusals"] = _refusals(x, ctx)
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, out)
    return gathered


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, every rank's results): the JAX
    subprocess and the 4 rank processes run side by side."""
    tmp = tmp_path_factory.mktemp("dp_ranks")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = parallel.run_ranks(_rank_cases, WORLD, backend="gloo",
                                   device="cpu", dp_size=DP,
                                   args=(x, str(tmp / "ckpt")),
                                   timeout_s=300)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return x, dict(np.load(tmp / "outputs.npz")), ranks


@pytest.fixture(scope="module")
def simulated(runs):
    """The simulated ranks' results on make_context(TP, dp_size=DP)."""
    x = runs[0]
    ctx = make_context(TP, dp_size=DP)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"dlrm": {n_: _dlrm_serve(x, n_, ctx) for n_ in STRATEGIES},
                "flow": {n_: _dlrm_flow(x, n_, ctx) for n_ in TRAINED},
                "lm": {a: _lm_serve(x, a, ctx) for a in ARCHS},
                "step": {a: _lm_step(x, a, ctx) for a in ARCHS}}
    finally:
        torch.set_num_threads(n)


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

def test_ranks_take_the_reference_mesh_layout(runs):
    """Global rank g is the device at [d, m] of the reference's
    ("data", "model") mesh: data group d, model rank m; the model-axis
    group is the mesh's row, the data-axis group its column."""
    _, want, ranks = runs
    mesh = want["mesh"]
    for g, out in enumerate(ranks):
        c = out["context"]
        assert c["global"] == g
        (d,), (m,) = np.nonzero(mesh == g)
        assert c["place"] == (d, m, TP, DP, TP, g)
        assert c["model_group"] == mesh[d].tolist()
        assert c["data_group"] == mesh[:, m].tolist()
        assert c["model_axis"] == (1, True, True)


def test_context_queries_match_the_reference(runs):
    _, want, ranks = runs
    for g, out in enumerate(ranks):
        axes, dp_b, dp_3, groups_b, groups_3, rows, tp_4 = \
            out["context"]["queries"]
        assert [len(dp_b or ()), len(dp_3 or ()), DP, TP] == \
            want["dp_for"].tolist()
        assert (axes, groups_b, groups_3, tp_4) == (("data",), DP, 1,
                                                    "model")
        d = g // TP
        assert rows == slice(d * DB // DP, (d + 1) * DB // DP)


@pytest.mark.parametrize("what, match", [
    ("tp_3", r"ValueError: tp_size 3 != the group's 4 ranks, nor divides"),
    ("dp_3", r"ValueError: tp_size 2 x dp_size 3 != the group's 4 ranks"),
])
def test_a_mesh_that_does_not_fit_the_world_raises(runs, what, match):
    for out in runs[2]:
        assert re.search(match, out["context"][what]), out["context"][what]


# ---------------------------------------------------------------------------
# the DLRM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STRATEGIES))
def test_dlrm_forward_and_engine_match_reference(runs, name):
    _, want, ranks = runs
    ref = REFERENCE[name]
    for out in ranks:
        logits, scores = out["dlrm"][name]
        np.testing.assert_allclose(logits.numpy(),
                                   want[f"dlrm/{ref}/forward"], **PCTR_TOL)
        np.testing.assert_allclose(scores.numpy(),
                                   want[f"dlrm/{ref}/engine"], **PCTR_TOL)


@pytest.mark.parametrize("name", list(STRATEGIES))
def test_dlrm_forward_and_engine_bitwise_simulated(runs, simulated, name):
    """Every rank returns the whole batch's logits and the whole flush,
    bitwise the simulated (2, 2) ranks'."""
    _, _, ranks = runs
    logits, scores = simulated["dlrm"][name]
    assert logits.shape == (DB,)
    for g, out in enumerate(ranks):
        got_l, got_s = out["dlrm"][name]
        assert _same_bits(got_l, logits), g
        assert torch.equal(got_s, scores), g


@pytest.mark.parametrize("name", TRAINED)
def test_dlrm_training_matches_simulated(runs, simulated, name):
    """Two steps: the losses within FLOW_RTOL of the simulated ranks' and
    the same on every rank; after each step both data groups hold
    bitwise the same shard and MLP leaves."""
    _, _, ranks = runs
    losses, _ = simulated["flow"][name]
    assert float(losses[1]) < float(losses[0])
    for g, out in enumerate(ranks):
        got, states = out["flow"][name]
        np.testing.assert_allclose([float(v) for v in got],
                                   [float(v) for v in losses],
                                   rtol=FLOW_RTOL, atol=0)
        assert all(_same_bits(a, b) for a, b in
                   zip(got, ranks[0]["flow"][name][0])), g
        other = ranks[(g + TP) % WORLD]["flow"][name][1]
        for step, (mine, theirs) in enumerate(zip(states, other)):
            assert all(_same_bits(a, b) for a, b in zip(mine, theirs)), (
                g, step)


def test_dlrm_data_groups_score_other_rows(runs):
    """The data groups' halves of the gathered logits differ, so the
    gather's order and the gradients' sum over the data axis are seen."""
    _, _, ranks = runs
    logits = ranks[0]["dlrm"]["row_allgather_bulk"][0]
    half = DB // DP
    assert not torch.equal(logits[:half], logits[half:])


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_hidden_states_match_reference(runs, arch):
    _, want, ranks = runs
    for g, out in enumerate(ranks):
        rec = out["lm"][arch]
        for key in ["forward", "prefill"] + [f"step{i}" for i in
                                             range(DECODE_STEPS)]:
            np.testing.assert_allclose(rec[key].numpy(),
                                       want[f"lm/{arch}/{key}"], **HIDDEN,
                                       err_msg=f"rank {g} {key}")
        if arch == MOE:
            np.testing.assert_allclose(float(rec["aux"]["moe_aux"]),
                                       want[f"lm/{arch}/moe_aux"],
                                       rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_serving_matches_simulated(runs, simulated, arch):
    """The forward and prefill bitwise, decode within HIDDEN, generate's
    and the batcher's greedy tokens equal, the MoE's aux within AUX_RTOL
    and its drops equal; a rank's decode cache holds one data group's
    slots."""
    _, _, ranks = runs
    want = simulated["lm"][arch]
    for g, out in enumerate(ranks):
        rec = out["lm"][arch]
        assert _same_bits(rec["forward"], want["forward"]), g
        assert _same_bits(rec["prefill"], want["prefill"]), g
        for i in range(DECODE_STEPS):
            np.testing.assert_allclose(rec[f"step{i}"].numpy(),
                                       want[f"step{i}"].numpy(), **HIDDEN)
        assert torch.equal(rec["generate"], want["generate"]), g
        assert rec["batcher"] == want["batcher"], g
        assert all(len(t) == NEW for t in rec["batcher"].values())
        assert (rec["slots"], want["slots"]) == (LB // DP, LB)
        if arch == MOE:
            np.testing.assert_allclose(float(rec["aux"]["moe_aux"]),
                                       float(want["aux"]["moe_aux"]),
                                       rtol=AUX_RTOL)
            assert int(rec["aux"]["moe_dropped"]) == \
                int(want["aux"]["moe_dropped"])


def test_moe_aux_is_the_first_data_groups(runs):
    """Every rank's aux is data group 0's own: moe_aux within one f32
    rounding of it (the mean plus the detached difference), moe_dropped
    equal; group 1's own aux differs, so the choice is seen."""
    _, _, ranks = runs
    first = ranks[0]["group_aux"]
    other = ranks[TP]["group_aux"]
    assert (float(first["moe_aux"]), int(first["moe_dropped"])) != (
        float(other["moe_aux"]), int(other["moe_dropped"]))
    for out in ranks:
        aux = out["lm"][MOE]["aux"]
        np.testing.assert_allclose(float(aux["moe_aux"]),
                                   float(first["moe_aux"]), rtol=1e-6)
        assert int(aux["moe_dropped"]) == int(first["moe_dropped"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_simulated_and_reference(runs, simulated,
                                                       arch):
    """One step: the loss within LOSS_RTOL (AUX_RTOL for the MoE) and the
    gradient norm within NORM_RTOL of the simulated (2, 2) step's, every
    metric within METRIC of the reference's, the same on every rank; both
    data groups' parameters bitwise equal after it."""
    _, want, ranks = runs
    metrics, _ = simulated["step"][arch]
    prefix = f"lm/{arch}/metric/"
    ref = {k[len(prefix):]: float(v) for k, v in want.items()
           if k.startswith(prefix)}
    loss_tol = AUX_RTOL if arch == MOE else LOSS_RTOL
    for g, out in enumerate(ranks):
        got, params = out["step"][arch]
        assert set(got) == set(metrics) == set(ref)
        assert all(_same_bits(got[k], ranks[0]["step"][arch][0][k])
                   for k in got), g
        for k, tol in (("loss", loss_tol), ("ce", loss_tol),
                       ("grad_norm", NORM_RTOL)):
            assert abs(float(got[k]) - float(metrics[k])) <= tol * abs(
                float(metrics[k])), (g, k, float(got[k]), float(metrics[k]))
        for k, w in ref.items():
            assert abs(float(got[k]) - w) <= METRIC * max(abs(w), 1e-30), (
                g, k, float(got[k]), w)
        theirs = ranks[(g + TP) % WORLD]["step"][arch][1]
        assert all(torch.equal(params[p], theirs[p]) for p in params), g


def test_trainer_checkpoint_restores_on_every_rank(runs):
    """The checkpoint global rank 0 wrote restores, on every rank of both
    data groups, to that rank's state after the run, bitwise; global
    rank 0 alone reported."""
    _, _, ranks = runs
    for g, out in enumerate(ranks):
        t = out["trainer"]
        assert t["start"] == TRAINER_STEPS
        assert list(t["run"]) == list(t["restored"])
        assert all(torch.equal(t["run"][p], t["restored"][p])
                   for p in t["run"]), g
        assert t["reports"] == (list(range(1, TRAINER_STEPS + 1)) if g == 0
                                else [])
        theirs = ranks[(g + TP) % WORLD]["trainer"]["run"]
        assert all(torch.equal(t["run"][p], theirs[p]) for p in theirs), g


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what, match", [
    ("remote", "NotImplementedError: RemoteStore: a ProcessContext with a "
               "data axis"),
    ("cache", "NotImplementedError: .*ParallelContext is not supported"),
    # a tied head trains under a data axis now: nothing refuses
    ("tied", "^no error$"),
])
def test_refusals_under_a_data_axis(runs, what, match):
    for out in runs[2]:
        msg = out["refusals"][what]
        assert re.search(match, msg), msg


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
