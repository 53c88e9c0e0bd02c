"""The reference's training state placement over processes, on the CPU.

``launch/specs.py`` ports ``repro.launch.specs``' state rules; a rank of
a ``(dp, tp)`` mesh of processes then holds only its piece of each train
state leaf (parameters, gradients, both moments), gathers a layer's
weights whole only while the layer runs, and writes and restores the
whole state's checkpoint.  Held here, for granite and moonshot widened
past the rules' 1024 thresholds (``d_model`` and the dense FFN 1024, so
that every rule cuts a leaf; one dense layer, and moonshot's MoE layer),
in f32, on the meshes ``(2, 2)`` and ``(1, 4)``, with ``fsdp`` on and
off:

  * every leaf's spec the reference's ``state_spec_tree``
    (``Mesh(devices.reshape(mesh), ("data", "model"))``), for f32 and
    int8 moments, where an axis of one device counts as no cut;
  * each rank's pieces of a state in the reference's layout
    (``utils/convert.lm_train_state_for_rank`` with the specs) bitwise
    that device's ``addressable_shards`` after ``jax.device_put(state,
    shardings)``;
  * two train steps under the placement on four gloo processes (one
    spawn; the ``(1, 4)`` mesh is the same processes as one model axis,
    where ``fsdp`` False places as True -- no data axis -- and one run,
    the port's and the reference's, serves both):
    losses and gradient norms within ``REF_RTOL`` of the reference's
    ``Trainer(state_shardings=)`` from the same state and batches (this
    file run as a script in a subprocess with four forced CPU devices);
  * the same steps' state, each rank's pieces, bitwise the cut of the
    port's unplaced run's (``state_shardings`` None: only the vocabulary
    and the experts cut), f32 and int8 moments; losses bitwise, norms
    within ``NORM_RTOL`` (their sums run in another order); the pieces
    two ranks hold alike bitwise equal;
  * each rank's parameter, gradient and moment bytes the specs'
    arithmetic;
  * a checkpoint written under the placement restores bitwise unplaced,
    and on one device; one written unplaced, or on one device, restores
    bitwise under the placement;
  * a spec the port cannot honour raises, naming the leaf.

The steps run with the clip threshold above every gradient norm: the
clip factor is then 1 exactly, so the update is elementwise and the
placed state can be held bitwise to the unplaced one (with a clip, the
norms' last bits would reach every weight).
"""
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShardingConfig, TrainConfig
from repro_torch.core.parallel import (ProcessContext, cut_index,
                                       cut_shape, make_context,
                                       make_process_context, run_ranks)
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as S
from repro_torch.models import lm as tlm
from repro_torch.optim.quant import QuantizedTensor, quantize_blockwise
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import (lm_train_state_for_rank,
                                       train_state_from_numpy)
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-8b", "moonshot-v1-16b-a3b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
FSDPS = (True, False)
OPTS = ("float32", "int8")
WORLD = 4
STEPS = 2
LB, LS = 4, 16
# above every gradient norm of these runs (they read 5-40): the clip
# factor is 1 exactly
GRAD_CLIP = 1e6
# the port's placed steps against the reference's (f32; tests/
# test_torch_launch_ranks.py's REF_RTOL)
REF_RTOL = 1e-5
# the placed norm against the unplaced one: each cut leaf's squares sum
# piece by piece
NORM_RTOL = 1e-6
# the placed state against the unplaced run's where a sum runs over more
# than two ranks in another order: an MoE layer's shared experts, summed
# over the model axis of 4 by a reduce-scatter placed and an all-reduce
# unplaced, whose last bits then reach every leaf at the second step (a
# leaf's largest difference against its largest magnitude; read 1e-6 on
# moonshot's (1, 4)); the losses likewise
STATE_RTOL = 1e-5

CASES = [(a, m, f, o) for a in ARCHS for m in MESHES for f in FSDPS
         for o in OPTS]
# the trained cases: f32 on both meshes, int8 moments on (2, 2)
TRAINED = [(a, m, f, o) for a, m, f, o in CASES
           if o == "float32" or m == "2x2"]


def _cfg(arch):
    base = tconfigs.get_smoke_config(arch)
    return dataclasses.replace(base, d_model=1024, d_ff=1024,
                               dtype="float32",
                               num_layers=2 if base.is_moe else 1)


def _tc(opt):
    return TrainConfig(warmup_steps=1, remat=True, grad_clip=GRAD_CLIP,
                       optimizer_state_dtype=opt)


def _sim(mesh, fsdp):
    dp, tp = MESHES[mesh]
    return make_context(tp, dp, ShardingConfig(fsdp=fsdp))


def _specs(arch, mesh, fsdp, opt):
    """The port's state spec tree of a case."""
    return S.state_spec_tree(_cfg(arch), _tc(opt), _sim(mesh, fsdp))[1]


def _digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous()
    h = hashlib.sha256(repr(tuple(t.shape)).encode())
    h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _state_tensors(state, cfg) -> dict:
    return dict(flatten_with_paths({
        "params": tstep.rank_tensors(state["params"], cfg),
        "opt": state["opt"]}))


# ---------------------------------------------------------------------------
# Inputs, from seeds, as numpy: a whole state in the reference's layout
# ---------------------------------------------------------------------------

def _inputs() -> dict:
    """Per arch and moment dtype the whole train state (drawn with the
    port at ``tp_size`` 4: the padded vocabulary of both meshes), its
    moments random (int8: quantized, v's non-negative), its step 3; and
    the STEPS batches per arch."""
    x = {}
    rng = np.random.default_rng(2034)
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        for opt in OPTS:
            state = tstep.init_train_state(
                torch.Generator().manual_seed(90 + i), cfg, _tc(opt),
                tp_size=WORLD, device="cpu")
            for path, p in flatten_with_paths(state["params"]):
                x[f"{arch}/{opt}/params/{path}"] = p.numpy()
                for k in ("m", "v"):
                    r = rng.standard_normal(tuple(p.shape)).astype(
                        np.float32) * 1e-3
                    if k == "v":
                        r = r * r
                    if opt == "int8":
                        qt = quantize_blockwise(torch.from_numpy(r),
                                                "sym" if k == "m" else "log")
                        x[f"{arch}/{opt}/opt/{k}/{path}/0"] = qt.q.numpy()
                        x[f"{arch}/{opt}/opt/{k}/{path}/1"] = \
                            qt.scale.numpy()
                    else:
                        x[f"{arch}/{opt}/opt/{k}/{path}"] = r
            x[f"{arch}/{opt}/opt/step"] = np.array(3, np.int32)
        batches = lm_batches(cfg, LB, LS, seed=i)
        for s in range(STEPS):
            for k, v in next(batches).items():
                x[f"{arch}/batch/{s}/{k}"] = v
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


def _state(x: dict, arch: str, opt: str) -> dict:
    """The whole state of ``_inputs`` as the port's tensors on the CPU."""
    raw = _tree(x, f"{arch}/{opt}")
    if opt == "int8":
        def quant(tree, params, mode):
            if isinstance(params, dict):
                return {k: quant(tree[k], params[k], mode) for k in params}
            return QuantizedTensor(tree["0"], tree["1"], params.shape, mode)
        for k, mode in (("m", "sym"), ("v", "log")):
            raw["opt"][k] = quant(raw["opt"][k], raw["params"], mode)
    return train_state_from_numpy(raw, device="cpu")


def _batches(x: dict, arch: str) -> list:
    return [{k: x[f"{arch}/batch/{s}/{k}"] for k in ("tokens", "labels")}
            for s in range(STEPS)]


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro.configs.base import ShardingConfig as JShardingConfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core.parallel import make_context as jmake_context
    from repro.launch import specs as JS
    from repro.train import step as jstep
    from repro.train.loop import Trainer as JTrainer

    assert len(jax.devices()) == WORLD, jax.devices()
    x = dict(np.load(inputs))
    devices = np.array(jax.devices())
    out = {"specs": {}, "shards": {}, "metrics": {}}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def is_spec(s):
        return isinstance(s, P)

    for arch in ARCHS:
        base = jconfigs.get_smoke_config(arch)
        jcfg = dataclasses.replace(base, d_model=1024, d_ff=1024,
                                   dtype="float32",
                                   num_layers=2 if base.is_moe else 1)
        for opt in OPTS:
            jtc = JTrainConfig(warmup_steps=1, remat=True,
                               grad_clip=GRAD_CLIP,
                               optimizer_state_dtype=opt)
            template = jax.eval_shape(lambda: jstep.init_train_state(
                jax.random.key(0), jcfg, jtc, tp_size=WORLD))
            leaves, tdef = jax.tree_util.tree_flatten_with_path(template)
            # host arrays: each device_put copies them (the Trainer's
            # step donates its state)
            state = jax.tree_util.tree_unflatten(tdef, [
                x[f"{arch}/{opt}/{key(p)}"] for p, _ in leaves])
            for mesh, shape in MESHES.items():
                grid = devices.reshape(shape)
                where = {grid[d, m].id: (d, m) for d in range(shape[0])
                         for m in range(shape[1])}
                for fsdp in FSDPS:
                    case = f"{arch}/{mesh}/{fsdp}/{opt}"
                    jctx = jmake_context(
                        jax.sharding.Mesh(grid, ("data", "model")),
                        sharding=JShardingConfig(fsdp=fsdp))
                    _, specs = JS.state_spec_tree(jcfg, jtc, jctx)
                    flat = jax.tree_util.tree_flatten_with_path(
                        specs, is_leaf=is_spec)[0]
                    out["specs"][case] = {
                        key(p): [None if e is None else
                                 e if isinstance(e, str) else list(e)
                                 for e in s] for p, s in flat}
                    sh = jax.tree.map(jctx.sharding, specs, is_leaf=is_spec)
                    placed = jax.device_put(state, sh)
                    for p, leaf in jax.tree_util.tree_flatten_with_path(
                            placed)[0]:
                        for shard in leaf.addressable_shards:
                            d, m = where[shard.device.id]
                            a = np.asarray(shard.data)
                            h = hashlib.sha256(repr(a.shape).encode())
                            h.update(a.tobytes())
                            out["shards"][f"{case}/{d}/{m}/{key(p)}"] = \
                                h.hexdigest()
                    if opt != "float32":
                        continue
                    if not fsdp and shape[0] == 1:
                        # no data axis: the placement is fsdp's
                        out["metrics"][case] = out["metrics"][
                            f"{arch}/{mesh}/True/{opt}"]
                        continue
                    tr = JTrainer(jcfg, jtc, iter(_batches(x, arch)),
                                  ctx=jctx, state_shardings=sh)
                    tr.state = jax.device_put(state, sh)
                    tr.run(STEPS)
                    out["metrics"][case] = [[m["loss"], m["grad_norm"]]
                                            for _, m in tr.metrics_log]
    with open(outputs, "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _fresh(state):
    """A copy of a state whose leaves share no memory with it."""
    def copy(v):
        if isinstance(v, dict):
            return {k: copy(u) for k, u in v.items()}
        if isinstance(v, QuantizedTensor):
            return dataclasses.replace(v, q=v.q.clone(),
                                       scale=v.scale.clone())
        return v.clone()
    return copy(state)


def _train(ctx, arch, opt, specs, whole, batches, ckpt_dir=None):
    """``STEPS`` steps of a ``Trainer`` under ``specs`` (None: unplaced)
    from this rank's cut of ``whole``: the trainer."""
    cfg, tc = _cfg(arch), _tc(opt)
    tr = Trainer(cfg, tc, iter(batches), ctx=ctx, state_shardings=specs)
    tr.state = lm_train_state_for_rank(_fresh(whole), cfg, ctx, specs)
    tr.run(STEPS)
    tr.ckpt_dir = ckpt_dir
    return tr


def _against_unplaced(placed, unplaced, specs, cfg, ctx) -> dict:
    """Per leaf of this rank's placed state: (bitwise, max |diff|) against
    its piece of the unplaced run's state (which holds every leaf but
    the vocabulary and the experts whole)."""
    flat = S.Placement.of(specs, cfg, ctx).state
    cut = S.rank_cut_tree(specs, cfg)
    rank = S.Placement.of(cut, cfg, ctx).state
    out = {}
    for path, t in placed.items():
        u = unplaced[path]
        more = tuple(None if r is not None else e
                     for e, r in zip(flat[path], rank[path]))
        u = u[cut_index(more, tuple(u.shape), ctx, what=path)]
        same = t.shape == u.shape
        out[path] = (same and torch.equal(t, u),
                     float((t.double() - u.double()).abs().max())
                     if same and t.numel() else float("inf"),
                     float(u.double().abs().max()) if u.numel() else 0.0)
    return out


def _bytes(tr, specs) -> dict:
    """This rank's parameter, gradient and moment bytes as held, and as
    the specs' arithmetic gives them (the gradient at its moments'
    layout)."""
    cfg, ctx = tr.cfg, tr.ranks
    whole = _state_tensors(tstep.init_train_state(
        None, cfg, tr.tc, tp_size=ctx.world, device="meta"), cfg)
    flat = S.flatten_specs(specs)
    moments = S.moment_specs(specs["opt"]["m"])
    held = _state_tensors(tr.state, cfg)
    grads = dict(flatten_with_paths(tr.step_fn.grads))

    def nbytes(spec, t):
        return math.prod(cut_shape(spec, tuple(t.shape), ctx)) * \
            t.element_size()

    want = dict.fromkeys(("params", "grads", "opt"), 0)
    have = dict(want)
    for path, t in whole.items():
        part = "params" if path.startswith("params/") else "opt"
        want[part] += nbytes(flat[path], t)
        have[part] += held[path].numel() * held[path].element_size()
        if part == "params":
            p = path[len("params/"):]
            want["grads"] += nbytes(S.grad_spec(moments[p]), t)
            have["grads"] += grads[p].numel() * grads[p].element_size()
    return {"held": have, "spec": want}


def _rank_cases(ctx22, tmp):
    """Every case on this rank; global rank 0 returns every rank's."""
    torch.set_num_threads(1)
    x = dict(np.load(os.path.join(tmp, "inputs.npz")))
    ctx14 = make_process_context(WORLD, 1, device="cpu")
    ctxs = {"2x2": ctx22, "1x4": ctx14}
    out = {"metrics": {}, "vs_unplaced": {}, "digests": {}, "bytes": {},
           "place": (ctx22.dp_rank, ctx22.rank, ctx14.rank)}
    keep = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        for mesh, ctx in ctxs.items():
            for opt in OPTS:
                if (arch, mesh, True, opt) not in TRAINED:
                    continue
                whole = _state(x, arch, opt)
                batches = _batches(x, arch)
                tr = _train(ctx, arch, opt, None, whole, batches)
                unplaced = _state_tensors(tr.state, cfg)
                out["metrics"][(arch, mesh, None, opt)] = [
                    (m["loss"], m["grad_norm"]) for _, m in tr.metrics_log]
                if (arch, mesh, opt) == (ARCHS[0], "2x2", "float32"):
                    keep["unplaced"] = tr
                for fsdp in FSDPS:
                    case = (arch, mesh, fsdp, opt)
                    specs = _specs(*case)
                    if not fsdp and MESHES[mesh][0] == 1:
                        # no data axis: fsdp False places as True
                        assert specs == _specs(arch, mesh, True, opt)
                        for k in ("metrics", "vs_unplaced", "digests",
                                  "bytes"):
                            out[k][case] = out[k][(arch, mesh, True, opt)]
                        continue
                    tp = _train(ctx, arch, opt, specs, whole, batches)
                    placed = _state_tensors(tp.state, cfg)
                    out["metrics"][case] = [(m["loss"], m["grad_norm"])
                                            for _, m in tp.metrics_log]
                    out["vs_unplaced"][case] = _against_unplaced(
                        placed, unplaced, specs, cfg, ctx)
                    out["digests"][case] = {p: _digest(t)
                                            for p, t in placed.items()}
                    out["bytes"][case] = _bytes(tp, specs)
                    if (arch, mesh, fsdp, opt) == (ARCHS[0], "2x2", True,
                                                   "float32"):
                        keep["placed"] = tp
                    else:
                        del tp
                del tr
    out["ckpt"] = _checkpoints(ctx22, keep, tmp)
    return tmesh.gather_world(out)


def _checkpoints(ctx, keep, tmp) -> dict:
    """granite's f32 runs on (2, 2) through checkpoints: the placed run's
    written and restored by an unplaced Trainer, the unplaced run's by a
    placed one, the one-device checkpoint by a placed one; each restored
    state's digests, and those of the cut of the checkpoint's whole state
    (read on one device)."""
    arch, opt = ARCHS[0], "float32"
    cfg, tc = _cfg(arch), _tc(opt)
    specs = _specs(arch, "2x2", True, opt)
    out = {}
    for name, tr in (("placed", keep["placed"]), ("unplaced",
                                                  keep["unplaced"])):
        tr.ckpt_dir = os.path.join(tmp, f"ckpt_{name}")
        tr._checkpoint(STEPS, asynchronous=False)
    for src, dst in (("placed", None), ("unplaced", specs),
                     ("one", specs)):
        path = os.path.join(tmp, f"ckpt_{src}")
        back = Trainer(cfg, tc, iter(()), ckpt_dir=path, ctx=ctx,
                       state_shardings=dst)
        whole = Trainer(cfg, tc, iter(()), ckpt_dir=path, device="cpu",
                        dtype=torch.float32).state
        cut = lm_train_state_for_rank(whole, cfg, ctx, dst)
        out[src] = {"restored": {p: _digest(t) for p, t in
                                 _state_tensors(back.state, cfg).items()},
                    "cut": {p: _digest(t) for p, t in
                            _state_tensors(cut, cfg).items()},
                    "step": back.start_step}
    out["placed_again"] = {p: _digest(t) for p, t in _state_tensors(
        Trainer(cfg, tc, iter(()), ckpt_dir=os.path.join(
            tmp, "ckpt_placed"), ctx=ctx, state_shardings=specs).state,
        cfg).items()}
    out["placed_run"] = {p: _digest(t) for p, t in _state_tensors(
        keep["placed"].state, cfg).items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, every rank's results, tmp): the
    JAX subprocess beside the one spawn of the ranks."""
    tmp = tmp_path_factory.mktemp("placement")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    # the one-device checkpoint: granite's whole f32 state
    one = Trainer(_cfg(ARCHS[0]), _tc("float32"), iter(()),
                  ckpt_dir=str(tmp / "ckpt_one"), device="cpu")
    one.state = _state(x, ARCHS[0], "float32")
    one._checkpoint(STEPS, asynchronous=False)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(_rank_cases, WORLD, backend="gloo", device="cpu",
                          dp_size=2, args=(str(tmp),), timeout_s=600)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "outputs.json") as f:
        want = json.load(f)
    return x, want, ranks, tmp


# ---------------------------------------------------------------------------
# the specs and the pieces
# ---------------------------------------------------------------------------

def _norm_entry(e, mesh):
    """A spec entry's axis, an axis of one device as None (the reference's
    ``PartitionSpec`` writes a data axis alone as ``"data"``)."""
    dp, tp = MESHES[mesh]
    if e is None:
        return None
    if e == "model":
        return None if tp == 1 else "model"
    assert e in ("data", ["data"], ("data",)), e
    return None if dp == 1 else "data"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_specs_are_the_references(runs, case):
    arch, mesh, fsdp, opt = case
    want = runs[1]["specs"][f"{arch}/{mesh}/{fsdp}/{opt}"]
    got = S.flatten_specs(_specs(*case))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert [_norm_entry(e, mesh) for e in spec] == [
            _norm_entry(e, mesh) for e in want[path]], path
    # every rule cuts: a data cut of a dense weight with fsdp, a model cut
    assert any("model" in s for s in got.values())
    assert any(("data",) in s for p, s in got.items()
               if "blocks/ffn" in p) == (fsdp and MESHES[mesh][0] > 1)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_rank_pieces_are_the_reference_shards(runs, case):
    """lm_train_state_for_rank of the state in the reference's layout,
    under the case's specs, on each (data group, model rank): bitwise
    that device's shards after jax.device_put."""
    x, want = runs[0], runs[1]["shards"]
    arch, mesh, fsdp, opt = case
    cfg = _cfg(arch)
    dp, tp = MESHES[mesh]
    specs = _specs(*case)
    whole = _state(x, arch, opt)
    sizes = {p: t.numel() for p, t in _state_tensors(whole, cfg).items()}
    cut_any = False
    for d in range(dp):
        for m in range(tp):
            ctx = ProcessContext(group=None, rank=m, world=tp,
                                 device=torch.device("cpu"), dp_size=dp,
                                 dp_rank=d)
            mine = _state_tensors(lm_train_state_for_rank(
                whole, cfg, ctx, specs), cfg)
            prefix = f"{arch}/{mesh}/{fsdp}/{opt}/{d}/{m}/"
            assert sorted(mine) == sorted(k[len(prefix):] for k in want
                                          if k.startswith(prefix))
            for path, t in mine.items():
                assert _digest(t) == want[prefix + path], (d, m, path)
                cut_any |= t.numel() < sizes[path]
    assert cut_any


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [c for c in TRAINED if c[3] == "float32"],
                         ids=lambda c: "-".join(map(str, c)))
def test_training_matches_the_reference(runs, case):
    arch, mesh, fsdp, opt = case
    want = runs[1]["metrics"][f"{arch}/{mesh}/{fsdp}/{opt}"]
    for g, out in enumerate(runs[2]):
        got = out["metrics"][case]
        assert len(got) == len(want) == STEPS
        for s, ((loss, norm), (wl, wn)) in enumerate(zip(got, want)):
            assert abs(loss - wl) <= REF_RTOL * abs(wl), (g, s, loss, wl)
            assert abs(norm - wn) <= REF_RTOL * abs(wn), (g, s, norm, wn)
        assert got == runs[2][0]["metrics"][case], g


def _bitwise_case(arch, mesh) -> bool:
    """Whether every sum of a case runs over at most two ranks: all but
    an MoE layer's shared experts on the model axis of 4."""
    return not (_cfg(arch).is_moe and MESHES[mesh][1] > 2)


@pytest.mark.parametrize("case", TRAINED, ids=lambda c: "-".join(map(str, c)))
def test_placed_state_is_the_unplaced_runs(runs, case):
    """Every rank's pieces after the steps bitwise its cut of the unplaced
    run's state, and the losses bitwise, where every sum runs over at most
    two ranks (else within STATE_RTOL); the norms within NORM_RTOL; the
    first loss bitwise."""
    arch, mesh, fsdp, opt = case
    exact = _bitwise_case(arch, mesh)
    for g, out in enumerate(runs[2]):
        diffs = out["vs_unplaced"][case]
        bad = {p: v for p, v in diffs.items() if not v[0]} if exact else {
            p: v for p, v in diffs.items()
            if not (v[0] or v[1] <= STATE_RTOL * v[2])}
        assert not bad, (g, bad)
        got, base = out["metrics"][case], out["metrics"][(arch, mesh, None,
                                                          opt)]
        assert got[0][0] == base[0][0], g
        for (loss, n), (b_loss, b) in zip(got, base):
            assert loss == b_loss if exact else \
                abs(loss - b_loss) <= STATE_RTOL * abs(b_loss), g
            assert abs(n - b) <= NORM_RTOL * abs(b), (g, n, b)


@pytest.mark.parametrize("case", TRAINED, ids=lambda c: "-".join(map(str, c)))
def test_ranks_holding_a_piece_alike_agree(runs, case):
    """Two ranks whose pieces of a leaf are the same piece (the spec does
    not cut it over the axis they differ on) hold it bitwise alike."""
    arch, mesh, fsdp, opt = case
    dp, tp = MESHES[mesh]
    specs = S.flatten_specs(_specs(*case))
    ranks = runs[2]
    for path, spec in specs.items():
        axes = {e if isinstance(e, str) else "data" for e in spec if e}
        pieces = {}
        for g in range(WORLD):
            d, m = divmod(g, tp)
            key = (d if "data" in axes else 0, m if "model" in axes else 0)
            pieces.setdefault(key, set()).add(
                ranks[g]["digests"][case][path])
        assert all(len(v) == 1 for v in pieces.values()), (path, pieces)


@pytest.mark.parametrize("case", TRAINED, ids=lambda c: "-".join(map(str, c)))
def test_rank_bytes_are_the_specs(runs, case):
    """Each rank's parameter, gradient and moment bytes are exactly what
    the specs give its pieces; under fsdp on (2, 2) fewer than the
    unplaced run's."""
    for g, out in enumerate(runs[2]):
        b = out["bytes"][case]
        assert b["held"] == b["spec"], (g, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", ["placed", "unplaced", "one"])
def test_checkpoint_restores_across_placements(runs, src):
    """A checkpoint written under the placement restores unplaced, one
    written unplaced or on one device restores under the placement: each
    rank's restored pieces bitwise its cut of the checkpoint's whole
    state, read on one device."""
    for g, out in enumerate(runs[2]):
        rec = out["ckpt"][src]
        assert rec["step"] == STEPS
        assert rec["restored"] == rec["cut"], g


def test_placed_checkpoint_round_trip_and_one_state(runs):
    """The placed run's checkpoint restored under the placement is its
    state bitwise, and the placed and unplaced runs wrote the same whole
    state: the same bytes in both checkpoints."""
    tmp = runs[3]
    for g, out in enumerate(runs[2]):
        assert out["ckpt"]["placed_again"] == out["ckpt"]["placed_run"], g
    a, b = (np.load(tmp / f"ckpt_{n}" / f"step_{STEPS:08d}" /
                    "shard_p0.npz") for n in ("placed", "unplaced"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# what the port cannot honour
# ---------------------------------------------------------------------------

def test_a_spec_the_port_cannot_honour_raises_naming_the_leaf():
    cfg = dataclasses.replace(_cfg(ARCHS[0]), num_layers=2)
    ctx = ProcessContext(group=None, rank=0, world=2,
                         device=torch.device("cpu"), dp_size=2, dp_rank=0)
    specs = S.param_spec_tree(tlm.init_params(None, cfg, tp_size=2,
                                              device="meta"), cfg, ctx)
    specs["blocks"]["ffn"]["up"] = ("data", None, "model")
    with pytest.raises(ValueError, match="blocks/ffn/up: a spec cutting "
                                         "the layer axis"):
        tlm.init_params(torch.Generator().manual_seed(0), cfg, ctx=ctx,
                        specs=specs)
    specs["blocks"]["ffn"]["up"] = (None, ("data",), "model", None)
    with pytest.raises(ValueError, match="blocks/ffn/up: a spec of 4 "
                                         "entries"):
        tlm.init_params(torch.Generator().manual_seed(0), cfg, ctx=ctx,
                        specs=specs)
    bad = dataclasses.replace(ctx, world=3)
    with pytest.raises(ValueError, match=r"^blocks/\S+: the model axis's "
                                         r"3 ranks do not divide"):
        tstep.init_train_state(torch.Generator().manual_seed(0), cfg,
                               _tc("float32"), ctx=bad,
                               specs={"params": S.param_spec_tree(
                                   tlm.init_params(None, cfg, tp_size=2,
                                                   device="meta"), cfg,
                                   make_context(1))})


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
