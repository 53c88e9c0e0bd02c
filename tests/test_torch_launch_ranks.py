"""The launchers over a mesh of processes, on the CPU at smoke width.

``launch/serve.py`` and ``launch/train.py`` run the reference's
multi-device path -- the debug mesh ``(data = N / 2, model = 2)`` of
``repro.launch.mesh.make_debug_mesh`` -- with each rank a process
(``--ranks N``; gloo on the CPU).  Held here:

  * ``serve.main(--ranks 4)``: the greedy tokens of the simulated ``(2,
    2)`` batcher (``make_context(2, dp_size=2)``) on the whole parameters
    drawn from the same seed; the report printed once, by global rank 0,
    with four ranks' peak memory; a ``--max-len`` the model axis does
    not divide fails the run with the batcher's ``ValueError``;
  * the rank function ``serve.serve`` on the reference's
    ``lm.init_params(jax.random.key(0), cfg, tp_size=2)`` (f32, converted
    with ``utils/convert``): every admission's and decode step's hidden
    states within ``HIDDEN`` of the reference's launcher path
    (``src/repro/launch/serve.py:42-66``: ``ContinuousBatcher(ctx=)`` on
    ``Mesh(devices.reshape(2, 2), ("data", "model"))``, this file run as
    a script in a subprocess with four forced CPU devices);
  * serving's ``lm.init_params(ctx=)`` bitwise ``lm_params_for_rank`` of
    the whole draw, for granite and moonshot;
  * ``train.main(--ranks 4)``: only global rank 0 logs and writes the
    metrics and the checkpoints; its first loss within ``LOSS_RTOL`` of
    the simulated ``Trainer``'s and its second within
    ``LATER_LOSS_RTOL`` (bf16); the same command run again resumes from
    the checkpoint of step 2 and runs 2 more steps from batch 0, as the
    reference's launcher does, and its checkpoints are bitwise those of
    the launcher's rank function whose ``Trainer`` goes on in memory on
    the same batches, in whose state both data groups agree bitwise;
  * a tied head (``tie_embeddings``) in one f32 train step on ``(1, 4)``
    and ``(2, 2)``: the loss within ``LOSS_RTOL`` of the simulated step's
    and within ``REF_RTOL`` of the reference's step on the same
    parameters, the gradient norm within ``NORM_RTOL`` of the simulated
    step's and within ``REF_RTOL`` of the reference's; after the update
    every rank's ``head`` is the table its model axis holds;
  * the bulk rank ``comm.permute_ring`` and ``comm.fetch_rows`` under
    grad on 4 ranks: the gradients of ``jax.vjp`` of the reference's
    ``comm.permute_ring`` (bitwise: a permute moves values) and
    ``comm.fetch_rows`` (within ``FETCH_GRAD``: a row asked for more than
    once adds its cotangents in another order) on a 1-D mesh;
  * an odd ``--ranks`` raises ``ValueError`` in either launcher;
  * deepseek-v3 (MLA, an MoE layer beside a dense one, the MTP head) at
    smoke width, f32: the serve rank function's hidden states within
    ``HIDDEN`` of the reference's launcher path (at ``DS_DROPLESS``: the
    reference's admission prefills on one device, the port's under the
    context), and the train rank
    function's two steps under the launcher's placement within
    ``REF_RTOL`` of the reference's launcher path
    (``src/repro/launch/train.py:63-74``: ``Trainer(state_shardings=)``
    from ``state_spec_tree`` on the debug mesh) from the same initial
    state and batches; ``train.main(--ranks 4)`` runs deepseek and
    reports its placement.
"""
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.core import comm
from repro_torch.core import parallel
from repro_torch.core.parallel import make_context
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw_init
from repro_torch.serving.engine import ContinuousBatcher
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import (lm_params_for_rank,
                                       lm_params_from_numpy,
                                       lm_train_state_for_rank)
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
WORLD, DP, TP = 4, 2, 2
ARCH = "granite-8b"
ARCHS = ("granite-8b", "moonshot-v1-16b-a3b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the serve runs: 4 requests of 12 tokens, 4 new each, 4 slots of 16
SERVE = ["--requests", "4", "--slots", "4", "--prompt-len", "12",
         "--max-new", "4"]
MAX_LEN = 16
# the train runs: batches of 4 x 16 (each data group its 2 samples)
TRAIN = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
         "--seq", "16"]
LB, LS = 4, 16
E = 4                       # the comm cases' ranks, a 1-D mesh
ROWS, D, M = 6, 8, 5        # the row fetch: a rank's rows, width, asks
SHIFTS = (1, 3)
DS = "deepseek-v3-671b"
# the deepseek train legs: 2 steps of 4 x 16 tokens
DS_TRAIN = ["--arch", DS, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--steps", "2"]
# the deepseek serve legs' capacity factor, at which the expert-parallel
# MoE drops nothing (a rank's local expert may take every token of every
# rank: num_experts / experts_per_token = 8 / 2): the reference's admission
# prefills on one device, whose MoE drops nothing, and the port's under
# the context (ROADMAP "Differences on purpose"), so they agree where no
# capacity binds
DS_DROPLESS = 4.0

# hidden states against the reference (f32; tests/test_torch_dp_ranks.py)
HIDDEN = dict(rtol=1e-5, atol=1e-5)
# a train step's loss and gradient norm against the simulated ranks' (f32
# and the launcher's first bf16 step: the same sums in another order)
LOSS_RTOL = 1e-6
NORM_RTOL = 1e-6
# the launcher's second step in bf16: the first step's bf16 gradients
# round otherwise where a data group takes half the batch, and AdamW's
# first step moves a parameter by ~lr whatever the gradient's size, so a
# parameter whose gradient nears 0 may move the other way.  Read on
# granite's smoke config (tools/later_loss_fault.py): 1.205e-4 sound;
# 5.38e-4 with blocks/ffn/down left out of the data axis's gradient sum,
# 1.94e-3 with every block leaf left out (a single norm weight or the
# table left out reads as sound: the data groups' states, held bitwise
# equal below, catch those)
LATER_LOSS_RTOL = 3e-4
# the tied step's loss and norm against the reference's jax step on the
# same f32 parameters (tests/test_torch_dp_ranks.py's METRIC)
REF_RTOL = 1e-5
# the row fetch's gradient: a row asked for k times adds k cotangents,
# in index_add_'s order here and XLA's scatter-add's there
FETCH_GRAD = dict(rtol=1e-6, atol=1e-6)


def _cfg(arch=ARCH, **kw):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32", **kw)


def _tied():
    return _cfg(tie_embeddings=True)


def _tc():
    return TrainConfig(warmup_steps=1, remat=True)


def _serve_args(*extra):
    return tserve.parser().parse_args(["--arch", ARCH, "--smoke", "--device",
                                       "cpu", *SERVE, *extra])


def _ds_serve_args():
    return tserve.parser().parse_args(["--arch", DS, "--smoke", "--device",
                                       "cpu", *SERVE])


def _ds_train_args():
    return tlaunch.parser().parse_args(DS_TRAIN)


# ---------------------------------------------------------------------------
# Inputs, from seeds, as numpy (the reference's parameters drawn here)
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    import jax

    from repro import configs as jconfigs
    from repro.models import lm as jlm

    x = {}
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                               dtype="float32")
    for key, cfg, tp in (("serve", jcfg, TP),
                         ("tied", dataclasses.replace(
                             jcfg, tie_embeddings=True), E)):
        params = jlm.init_params(jax.random.key(0 if key == "serve" else 1),
                                 cfg, tp_size=tp)
        for path, leaf in flatten_with_paths(jax.tree_util.tree_map(
                lambda a: torch.as_tensor(np.array(a)), params)):
            x[f"{key}/params/{path}"] = leaf.numpy()
    for k, v in next(lm_batches(_tied(), LB, LS, seed=3)).items():
        x[f"tied/batch/{k}"] = v
    # deepseek: the reference's serving parameters (f32, tp 2); the train
    # launcher's initial state as the port draws it (the whole of what
    # each rank draws its pieces of, from the TrainConfig's seed) and its
    # batches
    params = jlm.init_params(jax.random.key(2), dataclasses.replace(
        jconfigs.get_smoke_config(DS), dtype="float32"), tp_size=TP)
    for path, leaf in flatten_with_paths(jax.tree_util.tree_map(
            lambda a: torch.as_tensor(np.array(a)), params)):
        x[f"ds_serve/params/{path}"] = leaf.numpy()
    args = _ds_train_args()
    tc = tlaunch.train_config(args)
    state = tstep.init_train_state(torch.Generator().manual_seed(tc.seed),
                                   _cfg(DS), tc, tp_size=TP, device="cpu")
    for path, leaf in flatten_with_paths(state["params"]):
        x[f"ds_train/params/{path}"] = leaf.numpy()
    batches = lm_batches(_cfg(DS), args.batch, args.seq, seed=tc.seed)
    for s in range(args.steps):
        for k, v in next(batches).items():
            x[f"ds_train/batch/{s}/{k}"] = v
    rng = np.random.default_rng(2032)
    x["ring"] = rng.standard_normal((E, 3, D)).astype(np.float32)
    x["ring/cot"] = rng.standard_normal((E, 3, D)).astype(np.float32)
    x["fetch/shards"] = rng.standard_normal((E, ROWS, D)).astype(np.float32)
    x["fetch/addr"] = rng.integers(0, ROWS, (E, M)).astype(np.int32)
    x["fetch/owner"] = rng.integers(0, E, (E, M)).astype(np.int32)
    x["fetch/cot"] = rng.standard_normal((E, M, D)).astype(np.float32)
    return x


def _tree(x: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in x.items():
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = np.array(v)
    return tree


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core import comm as jcomm
    from repro.core.parallel import make_context as jmake_context
    from repro.optim import adamw as jadamw
    from repro.serving.engine import ContinuousBatcher as JBatcher
    from repro.serving.engine import Request as JRequest
    from repro.train import step as jstep
    from repro.utils.compat import shard_map

    assert len(jax.devices()) == WORLD, jax.devices()
    x = dict(np.load(inputs))
    devices = np.array(jax.devices())
    out = {}

    def jtree(prefix):
        return jax.tree_util.tree_map(jnp.asarray, _tree(x, prefix))

    # the launcher's path, src/repro/launch/serve.py:42-66, at eos -1
    cfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                              dtype="float32")
    ctx = jmake_context(jax.sharding.Mesh(devices.reshape(DP, TP),
                                          ("data", "model")))
    args = _serve_args()
    eng = JBatcher(jtree("serve/params"), cfg, num_slots=args.slots,
                   max_len=MAX_LEN, ctx=ctx, eos_id=-1)
    real, counts = eng._head, {"prefill": 0, "decode": 0}

    def head(h):
        kind = "prefill" if h.shape[0] == 1 else "decode"
        out[f"serve/{kind}/{counts[kind]}"] = np.asarray(h)
        counts[kind] += 1
        return real(h)
    eng._head = head
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(JRequest(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=args.max_new))
    done = eng.run_to_completion()
    for rid, r in done.items():
        out[f"serve/tokens/{rid}"] = np.array(r.generated)

    # the tied head's step, on (2, 2) and (1, 4)
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    tc = JTrainConfig(warmup_steps=1, remat=True)
    lp = jtree("tied/params")
    lb = jtree("tied/batch")
    for name, shape in MESHES.items():
        mctx = jmake_context(jax.sharding.Mesh(devices.reshape(shape),
                                               ("data", "model")))
        (_, metrics), grads = jax.jit(lambda p, b: jax.value_and_grad(
            jstep.lm_loss, has_aux=True)(p, b, tied, mctx, tc))(lp, lb)
        _, _, om = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, tc))(
            grads, jadamw.adamw_init(lp, tc), lp)
        for k, v in dict(metrics, **om).items():
            out[f"tied/{name}/{k}"] = np.asarray(v, np.float64)

    # jax.vjp of the bulk ring permute and row fetch on a 1-D mesh
    mesh = jax.sharding.Mesh(devices, ("model",))

    def per_rank(fn):
        return shard_map(lambda *a: fn(*(v[0] for v in a))[None], mesh=mesh,
                         in_specs=P("model"), out_specs=P("model"),
                         check_vma=False)

    for s in SHIFTS:
        y, vjp = jax.vjp(per_rank(lambda v, s=s: jcomm.permute_ring(
            v, "model", shift=s)), jnp.asarray(x["ring"]))
        out[f"ring/{s}"] = np.asarray(y)
        out[f"ring/{s}/grad"] = np.asarray(vjp(jnp.asarray(x["ring/cot"]))[0])
    addr, owner = jnp.asarray(x["fetch/addr"]), jnp.asarray(x["fetch/owner"])
    fetch = shard_map(
        lambda sh, a, o: jcomm.fetch_rows(sh[0], a[0], o[0], "model")[None],
        mesh=mesh, in_specs=(P("model"),) * 3, out_specs=P("model"),
        check_vma=False)
    y, vjp = jax.vjp(lambda sh: fetch(sh, addr, owner),
                     jnp.asarray(x["fetch/shards"]))
    out["fetch"] = np.asarray(y)
    out["fetch/grad"] = np.asarray(vjp(jnp.asarray(x["fetch/cot"]))[0])

    # deepseek through the reference's serve launcher path, as granite,
    # at the capacity where the expert-parallel decode drops nothing
    ds = dataclasses.replace(jconfigs.get_smoke_config(DS), dtype="float32",
                             moe_capacity_factor=DS_DROPLESS)
    args = _ds_serve_args()
    eng = JBatcher(jtree("ds_serve/params"), ds, num_slots=args.slots,
                   max_len=MAX_LEN, ctx=ctx, eos_id=-1)
    real, counts = eng._head, {"prefill": 0, "decode": 0}

    def ds_head(h):
        kind = "prefill" if h.shape[0] == 1 else "decode"
        out[f"ds_serve/{kind}/{counts[kind]}"] = np.asarray(h)
        counts[kind] += 1
        return real(h)
    eng._head = ds_head
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        eng.submit(JRequest(rid=rid, prompt=rng.integers(
            0, ds.vocab_size, args.prompt_len).astype(np.int32),
            max_new=args.max_new))
    for rid, r in eng.run_to_completion().items():
        out[f"ds_serve/tokens/{rid}"] = np.array(r.generated)

    # deepseek through the reference's train launcher path
    # (src/repro/launch/train.py:63-74) on the debug mesh, from the port's
    # initial state: the launcher's TrainConfig, the state placed by
    # state_spec_tree
    from repro.launch import specs as JS
    from repro.train.loop import Trainer as JTrainer

    ds = dataclasses.replace(ds, moe_capacity_factor=_cfg(
        DS).moe_capacity_factor)
    targs = _ds_train_args()
    jtc = JTrainConfig(learning_rate=targs.lr, total_steps=targs.steps,
                       warmup_steps=max(1, targs.steps // 10),
                       grad_accum=targs.grad_accum,
                       optimizer_state_dtype=targs.opt_state_dtype,
                       checkpoint_every=targs.ckpt_every)
    _, st_specs = JS.state_spec_tree(ds, jtc, ctx)
    shardings = jax.tree.map(ctx.sharding, st_specs)
    template = jstep.init_train_state(jax.random.key(0), ds, jtc, tp_size=TP)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(x, "ds_train/params"))
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(template["params"])
    batches = [_tree(x, f"ds_train/batch/{s}") for s in range(targs.steps)]
    tr = JTrainer(ds, jtc, iter(batches), ctx=ctx,
                  state_shardings=shardings)
    tr.state = jax.device_put({"params": params, "opt": template["opt"]},
                              shardings)
    tr.run(targs.steps)
    for i, (_, m) in enumerate(tr.metrics_log):
        for k in ("loss", "grad_norm"):
            out[f"ds_train/{i}/{k}"] = np.float64(m[k])
    np.savez(outputs, **out)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _record_heads(log: list):
    """Patch this process's ContinuousBatcher so that each head call
    records (kind, index, hidden): an admission's 1 row, indexed by the
    admissions before it (its request, FIFO), a decode step's rows by the
    steps before it."""
    real = ContinuousBatcher._head

    def head(self, hidden):
        kind = "prefill" if hidden.shape[0] == 1 else "decode"
        log.append((kind, len(self.timings[kind]), hidden.clone()))
        return real(self, hidden)
    ContinuousBatcher._head = head


def _tied_step(x, ctx):
    """One f32 train step of the tied granite config from the converted
    reference parameters: its metrics, and this rank's rows and head
    after it (the simulated ranks: the head is the table)."""
    cfg = _tied()
    whole = lm_params_from_numpy(_tree(x, "tied/params"), device="cpu")
    state = {"params": whole, "opt": adamw_init(whole, _tc())}
    if isinstance(ctx, parallel.ProcessContext):
        state = lm_train_state_for_rank(state, cfg, ctx)
    batch = {k: torch.as_tensor(v) for k, v in _tree(x, "tied/batch").items()}
    state, metrics = tstep.make_train_step(cfg, _tc(), ctx)(state, batch)
    p = state["params"]
    if "head" in p:
        rows, head = p["embed"].local[0], p["head"]
    else:
        rows = p["embed"][0]
        head = rows.T
    return ({k: float(v) for k, v in metrics.items()}, rows.clone(),
            head.clone())


def _init_mismatches(ctx) -> dict:
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = tconfigs.get_smoke_config(arch)
        mine = tlm.init_params(torch.Generator().manual_seed(40 + i), cfg,
                               ctx=ctx)
        cut = lm_params_for_rank(tlm.init_params(
            torch.Generator().manual_seed(40 + i), cfg, tp_size=ctx.world,
            device="cpu"), cfg, ctx)
        a = dict(flatten_with_paths(tstep.rank_tensors(mine)))
        b = dict(flatten_with_paths(tstep.rank_tensors(cut)))
        out[arch] = sorted(set(a) ^ set(b)) + [
            p for p in a if p in b and not (
                a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]))]
    return out


def _ds_cases(ctx, x, heads) -> dict:
    """deepseek through both launchers' rank functions on this rank: the
    serve rank function on its cut of the reference's parameters (the
    head calls it records), and the train rank function's 2 steps, whose
    state the launcher draws and places (its metrics, the specs it
    placed by against state_spec_tree's, and whether it holds less than
    the whole state)."""
    cfg = _cfg(DS, moe_capacity_factor=DS_DROPLESS)
    n = len(heads)
    mine = lm_params_for_rank(lm_params_from_numpy(
        _tree(x, "ds_serve/params"), device="cpu"), cfg, ctx)
    served = tserve.serve(ctx, cfg, _ds_serve_args(), params=mine)
    out = {"heads": heads[n:], "tokens": served["tokens"]}
    del heads[n:]
    cfg = _cfg(DS)
    args = _ds_train_args()
    tr = tlaunch.train(ctx, cfg, args)
    want = tspecs.Placement.of(tspecs.state_spec_tree(
        cfg, tr.tc, ctx)[1], cfg, ctx).state
    meta = tstep.init_train_state(None, cfg, tr.tc, tp_size=TP,
                                  device="meta")
    sizes = [sum(t.numel() * t.element_size() for _, t in
                 flatten_with_paths({"params": tstep.rank_tensors(
                     s["params"], cfg), "opt": s["opt"]}))
             for s in (tr.state, meta)]
    out.update(metrics=[m for _, m in tr.metrics_log],
               placed=tr.specs == want, held=sizes[0], whole=sizes[1])
    return out


def _mesh_cases(ctx, x):
    """The (2, 2) mesh's cases on this rank; global rank 0 returns every
    rank's, in global rank order."""
    torch.set_num_threads(1)
    heads: list = []
    _record_heads(heads)
    mine = lm_params_for_rank(lm_params_from_numpy(
        _tree(x, "serve/params"), device="cpu"), _cfg(), ctx)
    served = tserve.serve(ctx, _cfg(), _serve_args(), params=mine)
    out = {"heads": heads, "tokens": served["tokens"],
           "init": _init_mismatches(ctx), "tied": _tied_step(x, ctx)}
    out["ds"] = _ds_cases(ctx, x, heads)
    return tmesh.gather_world(out)


def _line_cases(ctx, x):
    """The (1, 4) mesh's cases on this rank: the tied step, and the bulk
    ring permute and row fetch under grad; rank 0 returns every rank's."""
    torch.set_num_threads(1)
    r = ctx.rank
    out = {"tied": _tied_step(x, ctx)}
    for s in SHIFTS:
        v = torch.as_tensor(x["ring"][r]).requires_grad_()
        with torch.enable_grad():
            y = comm.permute_ring(v, shift=s, ctx=ctx)
            (y * torch.as_tensor(x["ring/cot"][r])).sum().backward()
        out[f"ring/{s}"] = (y.detach(), v.grad)
    shard = torch.as_tensor(x["fetch/shards"][r]).requires_grad_()
    with torch.enable_grad():
        y = comm.fetch_rows(shard, torch.as_tensor(x["fetch/addr"][r]),
                            torch.as_tensor(x["fetch/owner"][r]), ctx=ctx)
        (y * torch.as_tensor(x["fetch/cot"][r])).sum().backward()
    out["fetch"] = (y.detach(), shard.grad)
    return tmesh.gather_world(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the (2, 2) ranks' results, the
    (1, 4) ranks' results): the JAX subprocess beside the ranks."""
    tmp = tmp_path_factory.mktemp("launch_ranks")
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
        square = parallel.run_ranks(_mesh_cases, WORLD, backend="gloo",
                                    device="cpu", dp_size=DP, args=(x,),
                                    timeout_s=300)
        line = parallel.run_ranks(_line_cases, E, backend="gloo",
                                  device="cpu", args=(x,), timeout_s=300)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return x, dict(np.load(tmp / "outputs.npz")), square, line


@pytest.fixture(scope="module")
def simulated(runs):
    """The tied step on the simulated ranks of each mesh."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {name: _tied_step(runs[0], make_context(tp, dp_size=dp))
                for name, (dp, tp) in MESHES.items()}
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _printed_tokens(text: str) -> dict:
    return {int(m.group(1)): json.loads(m.group(2))
            for m in re.finditer(r"^  req (\d+): (\[.*\])$", text, re.M)}


def test_serve_main_over_ranks_matches_the_simulated_batcher(capfd):
    """serve.main(--ranks 4) on the CPU: a (2, 2) mesh of gloo processes
    whose tokens are the simulated (2, 2) batcher's on the whole
    parameters drawn from the same seed; global rank 0 alone reports."""
    assert tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--ranks", str(WORLD), *SERVE]) == 0
    text = capfd.readouterr().out
    assert text.count("served 4 requests, 16 tokens") == 1, text
    assert "granite-smoke on 4 ranks (cpu, gloo) as (data, model) = " \
           "(2, 2)" in text
    peaks = re.search(r"peak host RSS memory per rank: \[(.*)\] GB", text)
    assert len(peaks.group(1).split(",")) == WORLD
    cfg = tconfigs.get_smoke_config(ARCH)
    args = _serve_args()
    params = tlm.init_params(torch.Generator().manual_seed(args.seed), cfg,
                             tp_size=TP, device="cpu")
    eng = ContinuousBatcher(params, cfg, args.slots, tserve.max_len(args),
                            make_context(TP, dp_size=DP), eos_id=-1,
                            device="cpu")
    for req in tserve.requests(cfg, args):
        eng.submit(req)
    want = {rid: r.generated for rid, r in eng.run_to_completion().items()}
    assert _printed_tokens(text) == want


def test_serve_main_refuses_a_max_len_the_model_axis_does_not_divide():
    with pytest.raises(RuntimeError, match="ValueError: a cache of 17 "
                                           "positions does not divide over "
                                           "2 ranks"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--ranks", str(WORLD), *SERVE, "--max-len", "17"])


def test_serve_rank_path_matches_the_reference_launcher(runs):
    """Every head call's hidden states on every rank within HIDDEN of the
    reference's launcher path at the same call; a rank computes the
    admissions of its data group's slots and every decode step whole."""
    _, want, square, _ = runs
    n_prefill = sum(k.startswith("serve/prefill/") for k in want)
    n_decode = sum(k.startswith("serve/decode/") for k in want)
    for g, out in enumerate(square):
        d = g // TP
        kinds = [(k, i) for k, i, _ in out["heads"]]
        assert [i for k, i in kinds if k == "decode"] == list(range(n_decode))
        mine = [i for k, i in kinds if k == "prefill"]
        assert mine and set(mine) < set(range(n_prefill)), (g, mine)
        for kind, i, h in out["heads"]:
            np.testing.assert_allclose(
                h.numpy(), want[f"serve/{kind}/{i}"], **HIDDEN,
                err_msg=f"global rank {g} (data group {d}) {kind} {i}")
        assert out["tokens"] == square[0]["tokens"], g
    admitted = sorted(i for out in square[::TP] for k, i, _ in out["heads"]
                      if k == "prefill")
    assert admitted == list(range(n_prefill))
    assert {rid: list(t) for rid, t in square[0]["tokens"].items()} == {
        int(k.split("/")[-1]): want[k].tolist()
        for k in want if k.startswith("serve/tokens/")}


def test_deepseek_serve_rank_path_matches_the_reference_launcher(runs):
    """deepseek (MLA, its MoE layer expert-parallel over the model axis,
    at DS_DROPLESS) through the serve rank function: every head call's
    hidden states on every rank within HIDDEN of the reference's launcher
    path at the same call, every admission computed by one data group,
    the tokens the reference's."""
    _, want, square, _ = runs
    n_prefill = sum(k.startswith("ds_serve/prefill/") for k in want)
    n_decode = sum(k.startswith("ds_serve/decode/") for k in want)
    assert n_prefill == 4 and n_decode > 0
    for g, out in enumerate(square):
        ds = out["ds"]
        kinds = [(k, i) for k, i, _ in ds["heads"]]
        assert [i for k, i in kinds if k == "decode"] == list(range(n_decode))
        for kind, i, h in ds["heads"]:
            np.testing.assert_allclose(
                h.numpy(), want[f"ds_serve/{kind}/{i}"], **HIDDEN,
                err_msg=f"global rank {g} {kind} {i}")
        assert ds["tokens"] == square[0]["ds"]["tokens"], g
    admitted = sorted(i for out in square[::TP] for k, i, _ in
                      out["ds"]["heads"] if k == "prefill")
    assert admitted == list(range(n_prefill))
    assert {rid: list(t) for rid, t in square[0]["ds"]["tokens"].items()} \
        == {int(k.split("/")[-1]): want[k].tolist()
            for k in want if k.startswith("ds_serve/tokens/")}


def test_deepseek_train_rank_path_matches_the_reference_launcher(runs):
    """deepseek through the train rank function on the (2, 2) mesh: the
    state placed by state_spec_tree's specs, each rank holding less than
    the whole state; two steps' losses and gradient norms (the MTP head's
    cross-entropy and the MoE aux loss in them) within REF_RTOL of the
    reference's launcher path from the same state and batches, the same
    on every rank."""
    _, want, square, _ = runs
    steps = _ds_train_args().steps
    for g, out in enumerate(square):
        ds = out["ds"]
        assert ds["placed"], g
        assert 0 < ds["held"] < ds["whole"], (g, ds["held"], ds["whole"])
        assert len(ds["metrics"]) == steps
        for i, m in enumerate(ds["metrics"]):
            assert "mtp_ce" in m and "moe_aux" in m, sorted(m)
            for k in ("loss", "grad_norm"):
                ref = float(want[f"ds_train/{i}/{k}"])
                assert abs(m[k] - ref) <= REF_RTOL * abs(ref), (g, i, k,
                                                                m[k], ref)
        assert [(m["loss"], m["grad_norm"]) for m in ds["metrics"]] == [
            (m["loss"], m["grad_norm"]) for m in square[0]["ds"]["metrics"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_init_params_is_the_cut_of_the_whole_draw(runs, arch):
    """lm.init_params(ctx=) on a rank of the (2, 2) mesh is bitwise
    lm_params_for_rank of the whole draw from the same seed."""
    for g, out in enumerate(runs[2]):
        assert out["init"][arch] == [], (g, out["init"][arch])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _simulated_losses(steps: int) -> list:
    args = tlaunch.parser().parse_args(TRAIN + ["--steps", str(steps)])
    cfg = tconfigs.get_smoke_config(ARCH)
    tc = tlaunch.train_config(args)
    t = Trainer(cfg, tc, lm_batches(cfg, LB, LS, seed=tc.seed),
                ctx=make_context(TP, dp_size=DP), device="cpu")
    t.run(steps)
    return [m["loss"] for _, m in t.metrics_log]


def _train_on_in_memory(ctx, ckpt_dir):
    """The launcher's rank function for 2 steps with a checkpoint each
    step into ``ckpt_dir``; then its Trainer goes on, never stopped, for
    2 more steps on the seeded batches from batch 0 (the batches a
    resumed launcher takes), writing those steps' checkpoints too.
    Every rank's state then, as a digest of each leaf's bytes."""
    args = tlaunch.parser().parse_args(TRAIN + ["--steps", "2",
                                                "--ckpt-every", "1",
                                                "--ckpt-dir", ckpt_dir])
    cfg = tconfigs.get_smoke_config(ARCH)
    tr = tlaunch.train(ctx, cfg, args)
    tr.data = lm_batches(cfg, LB, LS, seed=tr.tc.seed)
    tr.run(2)
    state = {"params": tstep.rank_tensors(tr.state["params"], cfg),
             "opt": tr.state["opt"]}
    return tmesh.gather_world({
        path: hashlib.sha256(t.detach().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes()).hexdigest()
        for path, t in flatten_with_paths(state)})


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train.main(--ranks 4) for 2 steps with a checkpoint each step, its
    output; then the same command run again, which resumes from step 2
    and runs 2 more; and the launcher's rank function whose Trainer goes
    on in memory instead (:func:`_train_on_in_memory`)."""
    tmp = tmp_path_factory.mktemp("launch_train")
    run = TRAIN + ["--ranks", str(WORLD), "--steps", "2", "--ckpt-every",
                   "1", "--ckpt-dir", str(tmp / "ckpt")]
    out = {"metrics": tmp / "metrics.json", "ckpt": tmp / "ckpt",
           "in_memory": tmp / "in_memory"}
    text = _captured(lambda: tlaunch.main(run + ["--metrics-out",
                                                 str(out["metrics"])]))
    out["steps"] = sorted(os.listdir(tmp / "ckpt"))
    out["resumed"] = _captured(lambda: tlaunch.main(run))
    out["resumed_steps"] = sorted(os.listdir(tmp / "ckpt"))
    out["digests"] = parallel.run_ranks(
        _train_on_in_memory, WORLD, backend="gloo", device="cpu",
        dp_size=DP, args=(str(out["in_memory"]),), timeout_s=300)
    return text, out


def _captured(fn) -> str:
    """What ``fn`` and the processes it starts write to stdout."""
    import tempfile

    with tempfile.TemporaryFile("w+") as f:
        saved = os.dup(1)
        sys.stdout.flush()
        os.dup2(f.fileno(), 1)
        try:
            fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return f.read()


def test_train_main_over_ranks(trained):
    """train.main(--ranks 4): global rank 0 alone logs, writes the metrics
    and the checkpoints; the losses are the simulated (2, 2) Trainer's."""
    text, out = trained
    lines = text.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["1", "2"], lines
    assert sum(ln.startswith("done: 2 steps") for ln in lines) == 1, lines
    assert out["steps"] == ["step_00000001", "step_00000002"]
    got = [m["loss"] for _, m in json.loads(out["metrics"].read_text())]
    want = _simulated_losses(2)
    assert abs(got[0] - want[0]) <= LOSS_RTOL * abs(want[0]), (got, want)
    assert abs(got[1] - want[1]) <= LATER_LOSS_RTOL * abs(want[1]), (got,
                                                                      want)


def test_train_main_over_ranks_resumes_bitwise(trained):
    """The same command run again resumes from the checkpoint of step 2
    and, as the reference's launcher, runs 2 more steps from batch 0: its
    checkpoints of steps 3 and 4 are bitwise those of a Trainer that
    went on in memory over the same batches."""
    _, out = trained
    lines = out["resumed"].splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["3", "4"], lines
    assert sum(ln.startswith("done: 4 steps") for ln in lines) == 1, lines
    assert out["resumed_steps"] == [f"step_{s:08d}" for s in (2, 3, 4)]
    for step in (3, 4):
        a, b = (d / f"step_{step:08d}" for d in (out["ckpt"],
                                                 out["in_memory"]))
        assert (a / "manifest.json").read_text() == \
            (b / "manifest.json").read_text()
        fa, fb = (np.load(d / "shard_p0.npz") for d in (a, b))
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].tobytes() == fb[k].tobytes(), (step, k)


def test_train_over_ranks_data_groups_hold_one_state(trained):
    """After 4 steps under the launcher's placement
    (``launch/specs.state_spec_tree``): a leaf the data axis does not cut
    is bitwise the same in every data group's model rank m (each leaf's
    gradient was summed over the data axis: a leaf left out of the sum
    diverges here, where the losses may not show it:
    tools/later_loss_fault.py); the pieces of a leaf it cuts assemble
    into one state: each rank's piece is bitwise its cut of the whole
    leaf in the checkpoint its Trainer wrote after the last step."""
    _, out = trained
    digests = out["digests"]
    args = tlaunch.parser().parse_args(TRAIN)
    specs = tspecs.Placement.of(tspecs.state_spec_tree(
        tconfigs.get_smoke_config(ARCH), tlaunch.train_config(args),
        make_context(TP, dp_size=DP))[1], tconfigs.get_smoke_config(ARCH),
        None).state
    step = out["in_memory"] / "step_00000004"
    paths = json.loads((step / "manifest.json").read_text())["paths"]
    whole = np.load(step / "shard_p0.npz")
    leaf = {p: whole[f"leaf_{i}"] for i, p in enumerate(paths)}
    assert len(digests) == WORLD and sorted(digests[0]) == sorted(paths)
    cut = 0
    for g, d in enumerate(digests):
        dp_rank, m = divmod(g, TP)
        rank = parallel.ProcessContext(group=None, rank=m, world=TP,
                                       device=torch.device("cpu"),
                                       dp_size=DP, dp_rank=dp_rank)
        for path, h in d.items():
            if ("data",) not in specs[path]:
                assert h == digests[m][path], (g, path)
                continue
            cut += 1
            a = leaf[path]
            piece = np.ascontiguousarray(a[parallel.cut_index(
                specs[path], a.shape, rank)])
            assert hashlib.sha256(piece.tobytes()).hexdigest() == h, (
                g, path)
    assert cut


def test_train_main_over_ranks_runs_and_places_deepseek():
    """train.main(--arch deepseek-v3-671b --smoke --ranks 4 --device cpu):
    two steps on the (2, 2) mesh of gloo processes, global rank 0 alone
    logging them and the state's placement (the reference's specs: the
    leaves cut over each axis, its bytes against the whole state's)."""
    text = _captured(lambda: tlaunch.main(DS_TRAIN + ["--ranks",
                                                      str(WORLD)]))
    lines = text.splitlines()
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["1", "2"], lines
    placed = [ln for ln in lines if ln.startswith("placed:")]
    assert len(placed) == 1, lines
    m = re.match(r"placed: (\d+) of (\d+) state leaves cut \((\d+) over "
                 r"the model axis, (\d+) over the data axis\); global rank "
                 r"0 holds (\d+) of (\d+) B", placed[0])
    assert m, placed[0]
    cut, n, model, data, held, whole = map(int, m.groups())
    assert 0 < model <= cut <= n and 0 < held < whole, placed[0]
    assert sum(ln.startswith("done: 2 steps") for ln in lines) == 1, lines


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tied_head_trains_over_processes(runs, simulated, mesh):
    """A tied head's f32 train step on every rank: the loss and the
    gradient norm the simulated ranks' and the reference's; after the
    update each rank's head is the table its model axis holds."""
    _, want, square, line = runs
    ranks = square if mesh == "2x2" else line
    tp = MESHES[mesh][1]
    sim = simulated[mesh][0]
    for g, out in enumerate(ranks):
        metrics, rows, head = out["tied"]
        for k, tol in (("loss", LOSS_RTOL), ("grad_norm", NORM_RTOL)):
            assert abs(metrics[k] - sim[k]) <= tol * abs(sim[k]), (
                g, k, metrics[k], sim[k])
            ref = float(want[f"tied/{mesh}/{k}"])
            assert abs(metrics[k] - ref) <= REF_RTOL * abs(ref), (
                g, k, metrics[k], ref)
        group = ranks[g - g % tp:g - g % tp + tp]
        table = torch.cat([o["tied"][1] for o in group])
        assert torch.equal(head, table.T), g


# ---------------------------------------------------------------------------
# the bulk rank ring permute and row fetch under grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", SHIFTS)
def test_rank_permute_ring_gradient_is_the_reference_vjp(runs, shift):
    _, want, _, line = runs
    for r, out in enumerate(line):
        y, grad = out[f"ring/{shift}"]
        assert np.array_equal(y.numpy(), want[f"ring/{shift}"][r]), r
        assert np.array_equal(grad.numpy(), want[f"ring/{shift}/grad"][r]), r


def test_rank_fetch_rows_gradient_is_the_reference_vjp(runs):
    x, want, _, line = runs
    assert len(set(map(tuple, x["fetch/addr"].tolist()))) > 1
    for r, out in enumerate(line):
        y, grad = out["fetch"]
        assert np.array_equal(y.numpy(), want["fetch"][r]), r
        np.testing.assert_allclose(grad.numpy(), want["fetch/grad"][r],
                                   **FETCH_GRAD, err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# the rank count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_odd_ranks_raise(launcher):
    main = tserve.main if launcher == "serve" else tlaunch.main
    argv = (["--arch", ARCH, "--smoke", "--device", "cpu"] if
            launcher == "serve" else list(TRAIN))
    with pytest.raises(ValueError, match="3 ranks do not form the debug "
                                         "mesh"):
        main(argv + ["--ranks", "3"])


def test_rank_count_defaults_to_the_reference_device_count():
    """--ranks when given; else the cards without a named device (at
    least 1), 1 with one."""
    assert tmesh.rank_count(None, "cpu") == 1
    assert tmesh.rank_count(None, "cuda:0") == 1
    assert tmesh.rank_count(None, None) == max(torch.cuda.device_count(), 1)
    assert tmesh.rank_count(4, "cpu") == 4
    with pytest.raises(ValueError, match="--ranks must be >= 1"):
        tmesh.rank_count(0, "cpu")


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
