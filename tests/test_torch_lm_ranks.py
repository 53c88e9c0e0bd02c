"""LM serving with each rank of the model axis a process, on the CPU.

The same seeded inputs go through three paths: the reference's ctx path
on a ``(1, 4)`` mesh (this file run as a script in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and
``JAX_PLATFORMS=cpu``, prefill and decode only), the port's simulated
ranks (``make_context(4)``, in this process), and the port's per-rank
path: ``run_ranks`` spawns 4 gloo processes on the CPU once per module,
each rank cuts the parameters to its share
(``utils/convert.lm_params_for_rank``) and every case runs inside them.
The JAX subprocess runs beside the ranks: both read the parameters the
port draws, every smoke config at f32 with the vocabulary padded for 4
ranks.

Tolerances:

  * against the reference (granite-8b, moonshot-v1-16b-a3b and
    deepseek-v3-671b: the vocabulary's row-wise bag, expert parallelism,
    MLA's latent cache): prefill's and each decode step's hidden states
    within ``1e-5`` (``HIDDEN``, the same f32 arithmetic in other orders
    through 2 layers, as ``tests/test_torch_lm_parallel.py``);
  * against the simulated ranks, every arch: bitwise the hidden states of
    prefill, every decode step and ``lm.forward`` -- every collective on
    the way moves values or gathers them in rank order (the embedding's
    all-reduce adds one row to zeros, the decode triples are gathered and
    combined as the simulation stacks them, the all-to-alls move rows);
    ``moe_aux`` within ``1e-5`` relative (the load statistics summed per
    rank, then over the ranks in gloo's order), ``moe_dropped`` exactly;
  * every rank's hidden states and tokens bitwise rank 0's; the
    batcher's tokens equal ``generate``'s and the simulated batcher's.

Also held: a rank's shares (its rows of the vocabulary, 1/4 of the
experts in memory of its own, ``max_len / 4`` positions of every
positional cache entry and the states whole), its collective events,
and the refusals: a ``max_len`` 4 does not divide, a one-sided rank
collective of a tensor that needs a gradient (``comm.all_to_all``,
``dlrm.forward`` through the a2a/onesided pipeline); ``lm.forward``
under grad and a tied head's train step and ``Trainer`` under a
``ProcessContext`` go through (training over processes:
``tests/test_torch_train_ranks.py``).
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

from repro_torch import configs as tconfigs
from repro_torch.configs import dlrm as dlrm_cfg
from repro_torch.configs.base import ShardingConfig, TrainConfig
from repro_torch.core import comm, parallel
from repro_torch.core.embedding_bag import RankShard
from repro_torch.core.jagged import JaggedBatch
from repro_torch.core.parallel import ProcessContext, make_context
from repro_torch.models import decode as tdec
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import ContinuousBatcher, Request, generate
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import lm_params_for_rank
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
E = 4
ARCHS = ["granite-8b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
         "hymba-1.5b", "rwkv6-1.6b", "whisper-base", "internvl2-2b"]
REF_ARCHS = ARCHS[:3]
MOE = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
BATCHER_ARCHS = ("granite-8b", "moonshot-v1-16b-a3b")
B, S, MAX_LEN, DECODE_STEPS = 2, 16, 32, 4
PROMPTS, SLOTS, NEW = (6, 10, 13), 2, 6
HIDDEN = dict(rtol=1e-5, atol=1e-5)
AUX_RTOL = 1e-5


def _cfg(arch):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32")


def _inputs() -> dict:
    """Every arch's tokens, decode tokens, extras, batcher prompts and
    parameters (the port's draw, at 4 ranks' padded vocabulary), as
    numpy, from seeds."""
    x = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        rng = np.random.default_rng(300 + i)
        x[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)) \
            .astype(np.int32)
        x[f"{arch}/steps"] = rng.integers(
            0, cfg.vocab_size, (DECODE_STEPS, B)).astype(np.int32)
        if cfg.family == "audio":
            x[f"{arch}/frames"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            x[f"{arch}/patches"] = rng.standard_normal(
                (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
        for j, n in enumerate(PROMPTS):
            x[f"{arch}/prompt{j}"] = rng.integers(
                2, cfg.vocab_size, n).astype(np.int32)
        params = tlm.init_params(torch.Generator().manual_seed(i), cfg,
                                 tp_size=E, device="cpu")
        for path, leaf in flatten_with_paths(params):
            x[f"{arch}/params/{path}"] = leaf.numpy()
    return x


def _params(x, arch) -> dict:
    """The nested parameter tree of ``arch`` as CPU tensors."""
    prefix = f"{arch}/params/"
    tree: dict = {}
    for key, v in x.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.as_tensor(v)
    return tree


def _t(x, key):
    return torch.as_tensor(x[key])


def _extras(x, arch, keys=("frames", "patches")) -> dict:
    return {k: _t(x, f"{arch}/{k}") for k in keys if f"{arch}/{k}" in x}


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.configs.base import ShardingConfig as JSharding
    from repro.core.parallel import make_context as jmake_context
    from repro.models import decode as jdec

    assert len(jax.devices()) == E, jax.devices()
    x = dict(np.load(inputs))
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, E),
                             ("data", "model"))
    ctx = jmake_context(mesh, JSharding())
    out = {}
    for arch in REF_ARCHS:
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                  dtype="float32")
        params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                        _params(x, arch))
        cache, h = jax.jit(lambda p, t: jdec.prefill(
            p, t, cfg, ctx, max_len=MAX_LEN))(
                params, jnp.asarray(x[f"{arch}/tokens"]))
        out[f"{arch}/prefill"] = np.asarray(h)
        step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, cfg, ctx))
        for i in range(DECODE_STEPS):
            cache, h = step(params, cache, jnp.asarray(x[f"{arch}/steps"][i]))
            out[f"{arch}/step{i}"] = np.asarray(h)
    np.savez(outputs, **out)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _events(events):
    return [f"{e.op}:{e.bytes_in}:{e.axis_size}:{e.backend}" for e in events]


def _serve(ctx, x, arch, cfg, params):
    """prefill + decode hidden states, the forward and its aux, and one
    decode step's collective events, under ``ctx``."""
    out = {}
    tokens = _t(x, f"{arch}/tokens")
    cache, h = tdec.prefill(params, tokens, cfg, ctx, max_len=MAX_LEN,
                            **_extras(x, arch, ("frames",)))
    out["prefill"] = h
    for i in range(DECODE_STEPS):
        with comm.instrument() as events:
            cache, h = tdec.decode_step(params, cache,
                                        _t(x, f"{arch}/steps")[i], cfg, ctx)
        out[f"step{i}"] = h
        out[f"events{i}"] = _events(events)
    out["cache"] = {name: {k: tuple(v.shape) for k, v in st.items()}
                    for name, st in tdec.kv_stacks(cache).items()}
    out["forward"], out["aux"] = tlm.forward(params, tokens, cfg, ctx,
                                             **_extras(x, arch))
    return out


def _batch(x, arch, cfg, params, ctx):
    """The prompts through ContinuousBatcher(ctx) and through
    generate(ctx) one by one: {rid: tokens} of each."""
    eng = ContinuousBatcher(params, cfg, SLOTS, MAX_LEN, ctx, eos_id=-1,
                            device="cpu")
    prompts = [x[f"{arch}/prompt{j}"] for j in range(len(PROMPTS))]
    for j, p in enumerate(prompts):
        eng.submit(Request(j, p, NEW))
    done = eng.run_to_completion()
    return ({j: done[j].generated for j in range(len(prompts))},
            {j: generate(params, cfg, p[None], NEW, ctx,
                         device="cpu")[0].tolist()
             for j, p in enumerate(prompts)
             if (len(p) + NEW) % E == 0})


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:      # noqa: BLE001 -- the message is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _refusals(ctx, x, params):
    """Each refusal a rank must raise, by its message."""
    cfg = _cfg("granite-8b")
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    tokens = _t(x, "granite-8b/tokens")
    whole = _params(x, "granite-8b")
    tc = TrainConfig(warmup_steps=1)
    dcfg = dataclasses.replace(dlrm_cfg.smoke(), rw_impl="a2a",
                               rw_backend="onesided")
    dp = tdlrm.init_params(torch.Generator().manual_seed(0), dcfg,
                           device="cpu")
    dp["tables"].requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    batch = JaggedBatch(
        torch.randint(0, dcfg.rows_per_table, (dcfg.num_sparse_features, 8,
                                               dcfg.pooling), generator=g),
        torch.full((dcfg.num_sparse_features, 8), dcfg.pooling))
    dense = torch.randn(8, dcfg.num_dense_features, generator=g)
    needs_grad = torch.zeros((E, 3), requires_grad=True)

    def lm_under_grad():
        p = lm_params_for_rank(whole, cfg, ctx)
        p["embed"].local.requires_grad_(True)
        with torch.enable_grad():
            tlm.forward(p, tokens, cfg, ctx)

    def dlrm_under_grad():
        with torch.enable_grad():
            tdlrm.forward(dp, dense, batch, dcfg, ctx)

    out = {
        "batcher_max_len": _error(lambda: ContinuousBatcher(
            params, cfg, SLOTS, 30, ctx, device="cpu")),
        "generate_max_len": _error(lambda: generate(
            params, cfg, x["granite-8b/tokens"], 2, ctx, device="cpu")),
        "init_cache": _error(lambda: tdec.init_cache(cfg, 1, 30, ctx=ctx,
                                                     device="cpu")),
        "other_device": _error(lambda: ContinuousBatcher(
            params, cfg, SLOTS, MAX_LEN, ctx, device="meta")),
        "whole_params": _error(lambda: tlm.forward(whole, tokens, cfg, ctx)),
        "train_step": _error(lambda: tstep.make_train_step(tied, tc, ctx)),
        "trainer": _error(lambda: Trainer(tied, tc, iter(()), ctx=ctx,
                                          device="cpu")),
        "all_to_all_grad": _error(lambda: comm.all_to_all(
            needs_grad, backend="onesided", ctx=ctx)),
        "dlrm_grad": _error(dlrm_under_grad),
        "lm_grad": _error(lm_under_grad),
    }
    # no grad: the same tensor goes through
    with torch.no_grad():
        out["all_to_all_no_grad"] = comm.all_to_all(needs_grad, ctx=ctx)
    return out


def _rank_cases(ctx, x):
    """Every case on this rank; rank 0 returns every rank's results."""
    out = {"queries": (ctx.dp_axes, ctx.dp_for(8), ctx.tp_for(8),
                       ctx.tp_for(6), ctx.dp_groups(8),
                       ctx.config.decode_kv_seq_sharded)}
    with torch.no_grad():
        for arch in ARCHS:
            cfg = _cfg(arch)
            whole = _params(x, arch)
            params = lm_params_for_rank(whole, cfg, ctx)
            rec = _serve(ctx, x, arch, cfg, params)
            rec["embed"] = params["embed"].local.clone()
            if cfg.is_moe:
                mine, full = (params["moe_blocks"]["moe"],
                              whole["moe_blocks"]["moe"])
                rec["experts"] = {k: mine[k].clone() for k in
                                  ("gate", "up", "down")}
                rec["own_storage"] = all(
                    mine[k].untyped_storage().data_ptr()
                    != full[k].untyped_storage().data_ptr()
                    for k in ("gate", "up", "down"))
                rec["shared_whole"] = torch.equal(
                    mine["router"], full["router"]) and all(
                    torch.equal(mine["shared"][k], full["shared"][k])
                    for k in mine["shared"])
            if arch in BATCHER_ARCHS:
                rec["batcher"], rec["generate"] = _batch(x, arch, cfg,
                                                         params, ctx)
            del whole
            out[arch] = rec
    out["refusals"] = _refusals(ctx, x, lm_params_for_rank(
        _params(x, "granite-8b"), _cfg("granite-8b"), ctx))
    c = parallel.make_process_context(2, dp_size=2, device="cpu")
    out["dp_context"] = (c.dp_size, c.dp_rank, c.rank, c.world, c.dp_axes,
                         c.dp_for(B), c.dp_groups(B), c.data_rows(B))
    gathered = [None] * ctx.world
    torch.distributed.all_gather_object(gathered, out, group=ctx.group)
    return gathered


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, every rank's results): the JAX
    subprocess and the 4 rank processes run side by side."""
    tmp = tmp_path_factory.mktemp("lm_ranks")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={E}"}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ranks = parallel.run_ranks(_rank_cases, E, backend="gloo",
                                   device="cpu", args=(x,), timeout_s=300)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return x, dict(np.load(tmp / "outputs.npz")), ranks


@pytest.fixture(scope="module")
def simulated(runs):
    """The simulated ranks' results, arch by arch."""
    x, _, _ = runs
    out = {}
    with torch.no_grad():
        for arch in ARCHS:
            cfg, params = _cfg(arch), _params(x, arch)
            rec = _serve(make_context(E), x, arch, cfg, params)
            if arch in BATCHER_ARCHS:
                rec["batcher"], _ = _batch(x, arch, cfg, params,
                                           make_context(E))
            out[arch] = rec
    return out


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32), b.view(torch.int32))


KEYS = ["prefill"] + [f"step{i}" for i in range(DECODE_STEPS)]


# ---------------------------------------------------------------------------
# against the reference and the simulated ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCHS)
def test_rank_prefill_and_decode_match_reference(runs, arch):
    _, want, ranks = runs
    for r, out in enumerate(ranks):
        for key in KEYS:
            np.testing.assert_allclose(out[arch][key].numpy(),
                                       want[f"{arch}/{key}"], **HIDDEN,
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_prefill_and_decode_bitwise_simulated(runs, simulated, arch):
    _, _, ranks = runs
    for r, out in enumerate(ranks):
        for key in KEYS:
            assert _same_bits(out[arch][key], simulated[arch][key]), (r, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_forward_bitwise_simulated(runs, simulated, arch):
    """lm.forward under the ProcessContext: the hidden states bitwise the
    simulated ranks'; moe_aux within 1e-5 relative, moe_dropped equal,
    the same on every rank."""
    _, _, ranks = runs
    want, want_aux = simulated[arch]["forward"], simulated[arch]["aux"]
    for r, out in enumerate(ranks):
        got, aux = out[arch]["forward"], out[arch]["aux"]
        assert _same_bits(got, want), r
        assert set(aux) == set(want_aux)
        if arch in MOE:
            np.testing.assert_allclose(float(aux["moe_aux"]),
                                       float(want_aux["moe_aux"]),
                                       rtol=AUX_RTOL)
            assert int(aux["moe_dropped"]) == int(want_aux["moe_dropped"])
            assert torch.equal(aux["moe_aux"], ranks[0][arch]["aux"]
                               ["moe_aux"])


def test_moe_drops_are_exercised(simulated):
    """The smoke MoE configs drop assignments under expert parallelism,
    so the drops' all-reduce carries non-zero counts."""
    assert any(int(simulated[a]["aux"]["moe_dropped"]) > 0 for a in MOE)


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_rank_cache_holds_its_positions(runs, arch):
    """max_len / 4 positions of every positional entry, states whole."""
    x, _, ranks = runs
    cfg = _cfg(arch)
    whole = tdec.init_cache(cfg, B, MAX_LEN, device="cpu")
    for out in ranks:
        got = out[arch]["cache"]
        assert set(got) == set(tdec.kv_stacks(whole))
        for name, st in tdec.kv_stacks(whole).items():
            for key, t in st.items():
                want = tuple(t.shape)
                if key not in tdec.STATE_KEYS:
                    want = want[:2] + (MAX_LEN // E,) + want[3:]
                assert got[name][key] == want, (name, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_holds_its_vocabulary_rows(runs, arch):
    x, _, ranks = runs
    table = _params(x, arch)["embed"]
    rows = table.shape[1] // E
    for r, out in enumerate(ranks):
        assert torch.equal(out[arch]["embed"],
                           table[:, r * rows:(r + 1) * rows])


@pytest.mark.parametrize("arch", MOE)
def test_rank_holds_its_experts(runs, arch):
    """1/4 of every MoE stack's experts, in memory of its own; the
    router and the shared experts whole."""
    x, _, ranks = runs
    cfg = _cfg(arch)
    full = _params(x, arch)["moe_blocks"]["moe"]
    el = cfg.num_experts // E
    for r, out in enumerate(ranks):
        rec = out[arch]
        for k, t in rec["experts"].items():
            assert t.shape[1] == el
            assert torch.equal(t, full[k][:, r * el:(r + 1) * el]), k
        assert rec["own_storage"] and rec["shared_whole"]


def test_lm_params_for_rank_keeps_the_rest_as_given():
    """Off the process group: every leaf but the table and the expert
    stacks is the given tensor itself; the table is a RankShard."""
    cfg = _cfg("moonshot-v1-16b-a3b")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             tp_size=E, device="cpu")
    ctx = ProcessContext(group=None, rank=1, world=E,
                         device=torch.device("cpu"))
    got = lm_params_for_rank(params, cfg, ctx)
    assert isinstance(got["embed"], RankShard)
    assert got["embed"].local.shape[1] == params["embed"].shape[1] // E
    mine, full = dict(flatten_with_paths(got)), dict(flatten_with_paths(
        {k: v for k, v in params.items() if k != "embed"}))
    for path, t in full.items():
        if path.split("/")[-1] in ("gate", "up", "down") and "/moe/" in \
                f"/{path}" and "shared" not in path:
            assert mine[path].shape[1] == cfg.num_experts // E, path
        else:
            assert mine[path] is t, path
    with pytest.raises(ValueError, match="experts do not divide over 3"):
        lm_params_for_rank(params, cfg, dataclasses.replace(ctx, world=3))


# ---------------------------------------------------------------------------
# serving and the ranks' agreement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", BATCHER_ARCHS)
def test_rank_batcher_matches_generate_and_simulated(runs, simulated, arch):
    """Every rank's batcher finishes with rank 0's tokens, which are
    generate(ctx)'s on each prompt alone (where the ranks divide its
    cache) and the simulated batcher's."""
    _, _, ranks = runs
    got = ranks[0][arch]["batcher"]
    assert all(out[arch]["batcher"] == got for out in ranks)
    assert got == simulated[arch]["batcher"]
    gen = ranks[0][arch]["generate"]
    assert gen and all(got[j] == toks for j, toks in gen.items())
    assert all(len(t) == NEW for t in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_rank_zeros_states(runs, arch):
    _, _, ranks = runs
    for out in ranks[1:]:
        for key in KEYS + ["forward"]:
            assert _same_bits(out[arch][key], ranks[0][arch][key]), key


def test_rank_decode_events(runs, simulated):
    """granite's decode step on a rank records the simulated step's
    events (the embedding's all-reduce of one rank's partial) and one
    all-gather of the (o, m, l) triples a layer, which the simulation
    stacks without a collective; moonshot's all-to-alls are the
    simulated ones, three a MoE layer."""
    _, _, ranks = runs
    cfg = _cfg("granite-8b")
    triple = B * cfg.num_heads * (cfg.head_dim + 2) * 4
    for out in ranks:
        for i in range(DECODE_STEPS):
            got = out["granite-8b"][f"events{i}"]
            want = simulated["granite-8b"][f"events{i}"]
            assert got == want + [f"all_gather:{triple}:{E}:bulk"] * \
                cfg.num_layers
            a2a = [e for e in out["moonshot-v1-16b-a3b"][f"events{i}"]
                   if e.startswith("all_to_all")]
            assert a2a == [e for e in simulated["moonshot-v1-16b-a3b"]
                           [f"events{i}"] if e.startswith("all_to_all")]
            assert len(a2a) == 3 * (_cfg("moonshot-v1-16b-a3b").num_layers
                                    - _cfg("moonshot-v1-16b-a3b")
                                    .first_k_dense)


def test_process_context_queries(runs):
    """ParallelContext's queries with no data axis: no dp axes, no dp
    group to split over, the model axis where 4 divides."""
    _, _, ranks = runs
    for out in ranks:
        assert out["queries"] == ((), None, "model", None, 1, True)
    sharding = ShardingConfig(decode_kv_seq_sharded=False)
    ctx = ProcessContext(group=None, rank=0, world=E,
                         device=torch.device("cpu"), config=sharding)
    assert ctx.config is sharding and ctx.tp_size == E and ctx.dp_size == 1


def test_two_by_two_context_queries(runs):
    """make_process_context(2, dp_size=2) in the world of 4: model rank
    g % 2 of data group g // 2, the batch of B split over the data
    axis."""
    _, _, ranks = runs
    for g, out in enumerate(ranks):
        d, m = divmod(g, 2)
        assert out["dp_context"] == (2, d, m, 2, ("data",), ("data",), 2,
                                     slice(d * B // 2, (d + 1) * B // 2)), g


# ---------------------------------------------------------------------------
# refusals: no silent fallback, no silent gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what, match", [
    ("batcher_max_len", "ValueError: a cache of 30 positions does not "
                        "divide over 4 ranks"),
    ("generate_max_len", "ValueError: a cache of 18 positions does not "
                         "divide over 4 ranks"),
    ("init_cache", "ValueError: a cache of 30 positions"),
    ("other_device", "ValueError: device meta is not the rank's cpu"),
    ("whole_params", "ValueError: under a ProcessContext params\\['embed'\\] "
                     "must be this rank's RankShard"),
    # a tied head trains over processes now: nothing refuses
    ("train_step", "^no error$"),
    ("trainer", "^no error$"),
    ("all_to_all_grad", "RuntimeError: all_to_all: the value needs a "
                        "gradient, and the one-sided route has no "
                        "derivative"),
    ("dlrm_grad", "RuntimeError: reduce_scatter: the value needs a "
                  "gradient, and the one-sided route has no derivative"),
    # the LM's rank collectives carry the gradient now: nothing refuses
    ("lm_grad", "^no error$"),
])
def test_rank_refusals(runs, what, match):
    _, _, ranks = runs
    for out in ranks:
        msg = out["refusals"][what]
        assert re.search(match, msg), msg


def test_rank_collective_without_grad_goes_through(runs):
    _, _, ranks = runs
    for out in ranks:
        got = out["refusals"]["all_to_all_no_grad"]
        assert got.shape == (E, 3) and not got.requires_grad


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
