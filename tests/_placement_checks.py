"""The reference's training state placement over processes, for any set
of LM families: the machinery of ``tests/test_torch_placement.py`` with
the families as an argument, read by ``tests/test_torch_placement_mla.py``
(deepseek-v3 and hymba) and ``tests/test_torch_placement_families.py``
(rwkv6, whisper and internvl2).

Each family's smoke config is widened past the rules' 1024 thresholds
(``d_model`` and the dense FFN 1024, so that every rule cuts a leaf; one
layer, two for an MoE family, whose first is dense), in f32, and held on
the meshes ``(2, 2)`` and ``(1, 4)``, with ``fsdp`` on and off:

  * every leaf's spec the reference's ``state_spec_tree``, for f32 and
    int8 moments (:func:`check_specs`);
  * each rank's pieces of a state in the reference's layout bitwise that
    device's ``addressable_shards`` after ``jax.device_put``
    (:func:`check_pieces`);
  * two placed steps on four gloo processes (one spawn) against the
    reference's ``Trainer(state_shardings=)`` (this file run as a script
    in a subprocess with four forced CPU devices), within ``REF_RTOL``
    (:func:`check_reference_steps`);
  * the placed state bitwise the cut of the port's unplaced run's, or
    within ``STATE_RTOL`` where an MoE layer's shared experts sum over a
    model axis of 4 (:func:`bitwise_case` says which), and the pieces two
    ranks hold alike bitwise equal (:func:`check_vs_unplaced`,
    :func:`check_alike`);
  * each rank's parameter, gradient and moment bytes the specs'
    arithmetic (:func:`check_bytes`);
  * for one family (``ckpt_arch``), a checkpoint written placed restores
    bitwise unplaced and on one device, and the other way round
    (:func:`check_checkpoint`, :func:`check_checkpoint_files`).

Every batch carries every key ``lm_batches`` gives (``frames`` for the
audio family, ``patches`` for the vlm family).  The steps run with the
clip threshold above every gradient norm, so the update is elementwise
and the placed state can be held bitwise to the unplaced one.
"""
import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShardingConfig, TrainConfig
from repro_torch.core import comm as tcomm
from repro_torch.core.parallel import (ProcessContext, cut_index,
                                       cut_shape, make_context,
                                       make_process_context, run_ranks)
from repro_torch.data.synthetic import lm_batches
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as S
from repro_torch.optim.quant import QuantizedTensor, quantize_blockwise
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import (lm_train_state_for_rank,
                                       train_state_from_numpy)
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
FSDPS = (True, False)
OPTS = ("float32", "int8")
WORLD = 4
STEPS = 2
LB, LS = 4, 16
# above every gradient norm of these runs: the clip factor is 1 exactly
GRAD_CLIP = 1e6
# the port's placed steps against the reference's (f32; tests/
# test_torch_placement.py's)
REF_RTOL = 1e-5
# the placed norm against the unplaced one: each cut leaf's squares sum
# piece by piece
NORM_RTOL = 1e-6
# the placed state against the unplaced run's where a sum runs over more
# than two ranks in another order: an MoE layer's shared experts, summed
# over the model axis of 4 by a reduce-scatter placed and an all-reduce
# unplaced (tests/test_torch_placement.py's)
STATE_RTOL = 1e-5


def cases(archs) -> list:
    return [(a, m, f, o) for a in archs for m in MESHES for f in FSDPS
            for o in OPTS]


def trained(archs) -> list:
    """The trained cases: f32 on both meshes, int8 moments on (2, 2)."""
    return [(a, m, f, o) for a, m, f, o in cases(archs)
            if o == "float32" or m == "2x2"]


def case_id(case) -> str:
    return "-".join(map(str, case))


def widen(base):
    """A smoke config (either package's) past the rules' thresholds: one
    layer, two for an MoE family (its smoke ``first_k_dense`` 1: a dense
    and an MoE layer)."""
    return dataclasses.replace(base, d_model=1024, d_ff=1024,
                               dtype="float32",
                               num_layers=2 if base.is_moe else 1)


def _cfg(arch):
    return widen(tconfigs.get_smoke_config(arch))


def _tc(opt):
    return TrainConfig(warmup_steps=1, remat=True, grad_clip=GRAD_CLIP,
                       optimizer_state_dtype=opt)


def _sim(mesh, fsdp):
    dp, tp = MESHES[mesh]
    return make_context(tp, dp, ShardingConfig(fsdp=fsdp))


def specs_of(arch, mesh, fsdp, opt):
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

def _inputs(archs) -> dict:
    """Per arch and moment dtype the whole train state (drawn with the
    port at ``tp_size`` 4: the padded vocabulary of both meshes), its
    moments random (int8: quantized, v's non-negative), its step 3; and
    the STEPS batches per arch, every key ``lm_batches`` gives."""
    x = {}
    rng = np.random.default_rng(2034)
    for i, arch in enumerate(archs):
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


def batches_of(x: dict, arch: str) -> list:
    """The STEPS batches of an arch, each with every key it was drawn
    with (``frames``, ``patches``)."""
    out = []
    for s in range(STEPS):
        prefix = f"{arch}/batch/{s}/"
        out.append({k[len(prefix):]: v for k, v in x.items()
                    if k.startswith(prefix)})
    return out


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path, archs) -> None:
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

    for arch in archs:
        jcfg = widen(jconfigs.get_smoke_config(arch))
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
                    tr = JTrainer(jcfg, jtc, iter(batches_of(x, arch)),
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


def _train(ctx, arch, opt, specs, whole, batches):
    """``STEPS`` steps of a ``Trainer`` under ``specs`` (None: unplaced)
    from this rank's cut of ``whole``: the trainer."""
    cfg, tc = _cfg(arch), _tc(opt)
    tr = Trainer(cfg, tc, iter(batches), ctx=ctx, state_shardings=specs)
    tr.state = lm_train_state_for_rank(_fresh(whole), cfg, ctx, specs)
    tr.run(STEPS)
    return tr


def _against_unplaced(placed, unplaced, specs, cfg, ctx) -> dict:
    """Per leaf of this rank's placed state: (bitwise, max |diff|, max
    |unplaced|) against its piece of the unplaced run's state (which
    holds every leaf but the vocabulary and the experts whole)."""
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


# the placed backward's bucket while its reduce-scatters are recorded: a
# layer's pieces at these widths then fill several
SMALL_BUCKET = 1 << 12


def _bucket_sums(tr, sizes) -> dict:
    """Each reduce-scatter of the placed backward ``sizes`` recorded
    (the elements a rank keeps), beside the per-layer sizes of ``tr``'s
    gradient pieces."""
    return {"sums": sorted(set(sizes)),
            "pieces": sorted({t.numel() // (t.shape[0] if re.search(
                r"blocks?/", p) else 1)
                for p, t in flatten_with_paths(tr.step_fn.grads)})}


def rank_cases(ctx22, tmp, archs, ckpt_arch):
    """Every trained case of ``archs`` on this rank, and ``ckpt_arch``'s
    checkpoints (None: none); global rank 0 returns every rank's."""
    torch.set_num_threads(1)
    x = dict(np.load(os.path.join(tmp, "inputs.npz")))
    ctx14 = make_process_context(WORLD, 1, device="cpu")
    ctxs = {"2x2": ctx22, "1x4": ctx14}
    done = trained(archs)
    out = {"metrics": {}, "vs_unplaced": {}, "digests": {}, "bytes": {},
           "sums": {}, "place": (ctx22.dp_rank, ctx22.rank, ctx14.rank)}
    keep = {}
    for arch in archs:
        cfg = _cfg(arch)
        for mesh, ctx in ctxs.items():
            for opt in OPTS:
                if (arch, mesh, True, opt) not in done:
                    continue
                whole = _state(x, arch, opt)
                batches = batches_of(x, arch)
                tr = _train(ctx, arch, opt, None, whole, batches)
                unplaced = _state_tensors(tr.state, cfg)
                out["metrics"][(arch, mesh, None, opt)] = [
                    (m["loss"], m["grad_norm"]) for _, m in tr.metrics_log]
                ckpt = (arch, mesh, opt) == (ckpt_arch, "2x2", "float32")
                if ckpt:
                    keep["unplaced"] = tr
                for fsdp in FSDPS:
                    case = (arch, mesh, fsdp, opt)
                    specs = specs_of(*case)
                    if not fsdp and MESHES[mesh][0] == 1:
                        # no data axis: fsdp False places as True
                        assert specs == specs_of(arch, mesh, True, opt)
                        for k in ("metrics", "vs_unplaced", "digests",
                                  "bytes"):
                            out[k][case] = out[k][(arch, mesh, True, opt)]
                        continue
                    sizes, real = [], tcomm._oa.reduce_scatter_into
                    bucket = tcomm.GATHER_BUCKET_ELEMS
                    rec = (mesh, fsdp, opt) == ("2x2", True, "float32")

                    def record(out_, x_, group_):
                        sizes.append(out_.numel())
                        real(out_, x_, group_)
                    if rec:
                        tcomm._oa.reduce_scatter_into = record
                        tcomm.GATHER_BUCKET_ELEMS = SMALL_BUCKET
                    try:
                        tp = _train(ctx, arch, opt, specs, whole, batches)
                    finally:
                        tcomm._oa.reduce_scatter_into = real
                        tcomm.GATHER_BUCKET_ELEMS = bucket
                    if rec:
                        out["sums"][arch] = _bucket_sums(tp, sizes)
                    placed = _state_tensors(tp.state, cfg)
                    out["metrics"][case] = [(m["loss"], m["grad_norm"])
                                            for _, m in tp.metrics_log]
                    out["vs_unplaced"][case] = _against_unplaced(
                        placed, unplaced, specs, cfg, ctx)
                    out["digests"][case] = {p: _digest(t)
                                            for p, t in placed.items()}
                    out["bytes"][case] = _bytes(tp, specs)
                    if ckpt and fsdp:
                        keep["placed"] = tp
                    else:
                        del tp
                del tr
    if ckpt_arch is not None:
        out["ckpt"] = _checkpoints(ctx22, keep, tmp, ckpt_arch)
    return tmesh.gather_world(out)


def _checkpoints(ctx, keep, tmp, arch) -> dict:
    """``arch``'s f32 runs on (2, 2) through checkpoints: the placed run's
    written and restored by an unplaced Trainer, the unplaced run's by a
    placed one, the one-device checkpoint by a placed one; each restored
    state's digests, and those of the cut of the checkpoint's whole state
    (read on one device)."""
    opt = "float32"
    cfg, tc = _cfg(arch), _tc(opt)
    specs = specs_of(arch, "2x2", True, opt)
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


def run(tmp: Path, archs, ckpt_arch=None):
    """(inputs, the reference's outputs, every rank's results, tmp): the
    JAX subprocess beside the one spawn of the ranks."""
    x = _inputs(archs)
    np.savez(tmp / "inputs.npz", **x)
    if ckpt_arch is not None:
        # the one-device checkpoint: the arch's whole f32 state
        one = Trainer(_cfg(ckpt_arch), _tc("float32"), iter(()),
                      ckpt_dir=str(tmp / "ckpt_one"), device="cpu")
        one.state = _state(x, ckpt_arch, "float32")
        one._checkpoint(STEPS, asynchronous=False)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.json"), *archs], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(rank_cases, WORLD, backend="gloo", device="cpu",
                          dp_size=2, args=(str(tmp), tuple(archs),
                                           ckpt_arch), timeout_s=600)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "outputs.json") as f:
        want = json.load(f)
    return x, want, ranks, tmp


# ---------------------------------------------------------------------------
# The checks, one a test of each file
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


def check_specs(runs, case, data_cut_leaf):
    """Every leaf's spec the reference's; a model cut, and a data cut of
    the family's ``data_cut_leaf`` (a path's part) exactly with fsdp on a
    data axis."""
    arch, mesh, fsdp, opt = case
    want = runs[1]["specs"][f"{arch}/{mesh}/{fsdp}/{opt}"]
    got = S.flatten_specs(specs_of(*case))
    assert sorted(got) == sorted(want)
    for path, spec in got.items():
        assert [_norm_entry(e, mesh) for e in spec] == [
            _norm_entry(e, mesh) for e in want[path]], path
    assert any("model" in s for s in got.values())
    assert any(data_cut_leaf in p for p in got), data_cut_leaf
    assert any(("data",) in s for p, s in got.items()
               if data_cut_leaf in p) == (fsdp and MESHES[mesh][0] > 1)


def check_pieces(runs, case):
    """lm_train_state_for_rank of the state in the reference's layout,
    under the case's specs, on each (data group, model rank): bitwise
    that device's shards after jax.device_put."""
    x, want = runs[0], runs[1]["shards"]
    arch, mesh, fsdp, opt = case
    cfg = _cfg(arch)
    dp, tp = MESHES[mesh]
    specs = specs_of(*case)
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


def check_reference_steps(runs, case):
    arch, mesh, fsdp, opt = case
    want = runs[1]["metrics"][f"{arch}/{mesh}/{fsdp}/{opt}"]
    for g, out in enumerate(runs[2]):
        got = out["metrics"][case]
        assert len(got) == len(want) == STEPS
        for s, ((loss, norm), (wl, wn)) in enumerate(zip(got, want)):
            assert abs(loss - wl) <= REF_RTOL * abs(wl), (g, s, loss, wl)
            assert abs(norm - wn) <= REF_RTOL * abs(wn), (g, s, norm, wn)
        assert got == runs[2][0]["metrics"][case], g


def bitwise_case(arch, mesh) -> bool:
    """Whether every sum of a case runs over at most two ranks: all but
    an MoE layer's shared experts on the model axis of 4 (held within
    STATE_RTOL)."""
    return not (_cfg(arch).is_moe and MESHES[mesh][1] > 2)


def check_vs_unplaced(runs, case):
    """Every rank's pieces after the steps bitwise its cut of the unplaced
    run's state, and the losses bitwise, where :func:`bitwise_case` (else
    within STATE_RTOL); the norms within NORM_RTOL; the first loss
    bitwise."""
    arch, mesh, fsdp, opt = case
    exact = bitwise_case(arch, mesh)
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


def check_alike(runs, case):
    """Two ranks whose pieces of a leaf are the same piece (the spec does
    not cut it over the axis they differ on) hold it bitwise alike."""
    arch, mesh, fsdp, opt = case
    dp, tp = MESHES[mesh]
    specs = S.flatten_specs(specs_of(*case))
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


def check_bucket_sums(runs, arch):
    """The placed backward sums a layer's pieces in buckets of at most
    ``comm.GATHER_BUCKET_ELEMS`` elements, a larger piece alone
    (``core/comm._PlacedGather``): with the bucket at SMALL_BUCKET every
    reduce-scatter of the placed steps on (2, 2) keeps one gradient
    piece's elements or at most SMALL_BUCKET, so a layer's pieces never
    stand in f32 all at once."""
    for g, out in enumerate(runs[2]):
        rec = out["sums"][arch]
        assert rec["sums"], g
        assert all(k in rec["pieces"] or k <= SMALL_BUCKET
                   for k in rec["sums"]), (g, rec)


def check_bytes(runs, case):
    for g, out in enumerate(runs[2]):
        b = out["bytes"][case]
        assert b["held"] == b["spec"], (g, b)
        assert sum(b["held"].values()) > 0, g


def check_checkpoint(runs, src):
    """Each rank's pieces restored from the ``src`` checkpoint (placed,
    unplaced or one device) bitwise its cut of that checkpoint's whole
    state, read on one device."""
    for g, out in enumerate(runs[2]):
        rec = out["ckpt"][src]
        assert rec["step"] == STEPS
        assert rec["restored"] == rec["cut"], g


def check_checkpoint_files(runs):
    """The placed run's checkpoint restored placed is its state bitwise,
    and the placed and unplaced runs wrote the same bytes."""
    tmp = runs[3]
    for g, out in enumerate(runs[2]):
        assert out["ckpt"]["placed_again"] == out["ckpt"]["placed_run"], g
    a, b = (np.load(tmp / f"ckpt_{n}" / f"step_{STEPS:08d}" /
                    "shard_p0.npz") for n in ("placed", "unplaced"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].tobytes() == b[k].tobytes(), k


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]), sys.argv[3:])
