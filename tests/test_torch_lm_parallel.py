"""The LM under a ParallelContext against the JAX reference's ctx path, on
the CPU.

The reference shards the vocabulary, the experts and the decode cache's
sequence over a jax mesh, one device per rank, so its side runs ONCE per
module in a subprocess with ``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` and ``JAX_PLATFORMS=cpu`` set
before JAX is imported: this file run as a script, reading the numpy
inputs from one ``.npz`` and writing the reference's outputs (its
parameters and train states among them) to another.  Its meshes are
built as ``jax.sharding.Mesh(devices.reshape(shape), ("data",
"model"))``: ``jax.make_mesh`` gives Explicit axes under the installed
jax, on which the reference's ``with_sharding_constraint`` raises.  The
port simulates the same ranks in one process (``make_context``).

Every case runs a smoke config at f32 (``dtype`` replaced), from the
reference's parameters (``init_params`` / ``init_train_state`` at
``key(0)`` and the mesh's ``tp_size``), on a ``(1, 4)`` mesh, and granite
and moonshot also on ``(2, 2)``.  The port's ctx path is held against
the reference's ctx path, not against ``ctx=None``: under expert
parallelism capacity drops assignments, another function.

Tolerances:
  * ``lm.forward``'s hidden states, prefill's and each decode step's
    hidden states: ``1e-5`` (the same f32 arithmetic in other orders
    through 2 layers); ``moe_aux`` ``1e-5``; ``moe_dropped`` exactly;
  * one train step: the metrics within ``1e-5`` relative, every gradient
    leaf within relative L2 ``1e-4``, the parameters after the update
    within relative L2 ``1e-5`` -- except rwkv6's update, ``1e-4``
    (``tests/test_torch_lm_train.py``: its f32 gradient resolves no
    finer in the reference itself);
  * the port's own invariants bitwise: the ctx forward of the families
    without MoE against its ``ctx=None`` forward (one lookup of weight 1
    plus zero partials is the row), remat against none under a context,
    the batcher's tokens against ``generate``'s, a resumed ``Trainer``.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.synthetic import lm_batches as j_lm_batches
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShardingConfig, TrainConfig
from repro_torch.core.parallel import make_context
from repro_torch.data import lm_batches
from repro_torch.models import decode as tdec
from repro_torch.models import lm as tlm
from repro_torch.serving.engine import ContinuousBatcher, Request, generate
from repro_torch.train import step as tstep
from repro_torch.train.loop import Trainer
from repro_torch.utils.convert import train_state_from_numpy
from repro_torch.utils.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
DEVICES = 4
ARCHS = ["granite-8b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
         "hymba-1.5b", "rwkv6-1.6b", "whisper-base", "internvl2-2b"]
MOE = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
B, S, MAX_LEN, DECODE_STEPS = 2, 16, 32, 4
HIDDEN = dict(rtol=1e-5, atol=1e-5)
METRIC, GRAD, UPDATE, UPDATE_RWKV = 1e-5, 1e-4, 1e-5, 1e-4

# name -> (arch, mesh shape, ModelConfig fields, ShardingConfig fields)
FORWARD = {**{a: (a, (1, 4), {}, {}) for a in ARCHS},
           "granite-8b@2x2": ("granite-8b", (2, 2), {}, {}),
           "moonshot-v1-16b-a3b@2x2": ("moonshot-v1-16b-a3b", (2, 2), {},
                                       {}),
           "granite-8b/a2a": ("granite-8b", (1, 4),
                              dict(vocab_rw_impl="a2a"), {}),
           "granite-8b/replicated": ("granite-8b", (1, 4),
                                     dict(vocab_sharding="replicated"), {})}
DECODE = {**{a: (a, (1, 4), {}, {}) for a in ARCHS},
          "granite-8b@2x2": FORWARD["granite-8b@2x2"],
          "moonshot-v1-16b-a3b@2x2": FORWARD["moonshot-v1-16b-a3b@2x2"],
          "granite-8b/local-decode": ("granite-8b", (1, 4), {},
                                      dict(decode_kv_seq_sharded=False))}
TRAIN = {**{a: (a, (1, 4), {}, {}) for a in ARCHS},
         "granite-8b@2x2": FORWARD["granite-8b@2x2"],
         "moonshot-v1-16b-a3b@2x2": FORWARD["moonshot-v1-16b-a3b@2x2"]}


def _tc(**kw):
    return {"warmup_steps": 1, "remat": True, **kw}


def _states():
    """The (arch, tp) pairs whose reference train state the port reads."""
    return sorted({(a, m[1]) for a, m, _, _ in
                   list(FORWARD.values()) + list(DECODE.values())
                   + list(TRAIN.values())})


def _extra(cfg, seed):
    """The family's extra inputs as numpy: frames (audio), patches (vlm)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)}
    return {}


def _inputs() -> dict:
    """Every numpy input of both sides, from seeds: each arch's tokens,
    decode tokens and extras, and its train batch (the reference's
    ``lm_batches(seed=0)``, whose port is bitwise it)."""
    x = {}
    for i, arch in enumerate(ARCHS):
        cfg = tconfigs.get_smoke_config(arch)
        rng = np.random.default_rng(100 + i)
        x[f"{arch}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)) \
            .astype(np.int32)
        x[f"{arch}/steps"] = rng.integers(
            0, cfg.vocab_size, (DECODE_STEPS, B)).astype(np.int32)
        for k, v in _extra(cfg, 200 + i).items():
            x[f"{arch}/{k}"] = v
        for k, v in next(j_lm_batches(cfg, B, S, seed=0)).items():
            x[f"{arch}/batch/{k}"] = v
    return x


def _arch_inputs(x, arch, prefix=""):
    return {k[len(f"{arch}/{prefix}"):]: v for k, v in x.items()
            if k.startswith(f"{arch}/{prefix}") and "/" not in
            k[len(f"{arch}/{prefix}"):]}


def _unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix/a/b`` keys of ``flat``."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# The reference, in a subprocess with four forced CPU devices
# ---------------------------------------------------------------------------

def _jax_reference(inputs: Path, outputs: Path) -> None:
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.configs.base import ShardingConfig as JSharding
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.core.parallel import make_context as jmake_context
    from repro.models import decode as jdec
    from repro.models import lm as jlm
    from repro.optim import adamw as jadamw
    from repro.train import step as jstep

    assert len(jax.devices()) == DEVICES, jax.devices()
    x = dict(np.load(inputs))
    out = {}

    def put(prefix, tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        for path, v in leaves:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{prefix}/{key}"] = np.asarray(v)

    def ctx_of(shape, sharding):
        mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(shape),
                                 ("data", "model"))
        return jmake_context(mesh, JSharding(**sharding))

    def cfg_of(arch, fields):
        return dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   dtype="float32", **fields)

    states = {}
    for arch, tp in _states():
        state = jstep.init_train_state(
            jax.random.key(0), cfg_of(arch, {}), JTrainConfig(**_tc()),
            tp_size=tp, dtype=jnp.float32)
        states[arch, tp] = state
        put(f"state/{arch}/{tp}", state)

    for name, (arch, shape, fields, sharding) in FORWARD.items():
        cfg, ctx = cfg_of(arch, fields), ctx_of(shape, sharding)
        params = states[arch, shape[1]]["params"]
        kw = {k: jnp.asarray(v) for k, v in _arch_inputs(x, arch).items()
              if k in ("frames", "patches")}
        h, aux = jax.jit(lambda p, t: jlm.forward(p, t, cfg, ctx, **kw))(
            params, jnp.asarray(x[f"{arch}/tokens"]))
        out[f"forward/{name}/hidden"] = np.asarray(h)
        for k in ("moe_aux", "moe_dropped"):
            if k in aux:
                out[f"forward/{name}/{k}"] = np.asarray(aux[k])

    for name, (arch, shape, fields, sharding) in DECODE.items():
        cfg, ctx = cfg_of(arch, fields), ctx_of(shape, sharding)
        params = states[arch, shape[1]]["params"]
        kw = {"frames": jnp.asarray(x[f"{arch}/frames"])} \
            if cfg.family == "audio" else {}
        cache, h = jax.jit(lambda p, t: jdec.prefill(
            p, t, cfg, ctx, max_len=MAX_LEN, **kw))(
                params, jnp.asarray(x[f"{arch}/tokens"]))
        out[f"decode/{name}/prefill"] = np.asarray(h)
        step = jax.jit(lambda p, c, t: jdec.decode_step(p, c, t, cfg, ctx))
        for i in range(DECODE_STEPS):
            cache, h = step(params, cache, jnp.asarray(x[f"{arch}/steps"][i]))
            out[f"decode/{name}/step{i}"] = np.asarray(h)

    for name, (arch, shape, fields, sharding) in TRAIN.items():
        cfg, ctx = cfg_of(arch, fields), ctx_of(shape, sharding)
        tc = JTrainConfig(**_tc())
        state = states[arch, shape[1]]
        batch = {k: jnp.asarray(v)
                 for k, v in _arch_inputs(x, arch, "batch/").items()}
        (_, metrics), grads = jax.jit(lambda p, b: jax.value_and_grad(
            jstep.lm_loss, has_aux=True)(p, b, cfg, ctx, tc))(
                state["params"], batch)
        new_p, _, om = jax.jit(
            lambda g, o, p: jadamw.adamw_update(g, o, p, tc))(
                grads, state["opt"], state["params"])
        for k, v in dict(metrics, **om).items():
            out[f"train/{name}/metric/{k}"] = np.asarray(v, np.float64)
        put(f"train/{name}/grad", grads)
        put(f"train/{name}/params", new_p)
    np.savez(outputs, **out)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(inputs, the JAX reference's outputs), computed once per module."""
    tmp = tmp_path_factory.mktemp("lm_parallel_ref")
    x = _inputs()
    np.savez(tmp / "inputs.npz", **x)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={DEVICES}"}
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "outputs.npz")], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return x, dict(np.load(tmp / "outputs.npz"))


# ---------------------------------------------------------------------------
# The port's side
# ---------------------------------------------------------------------------

def _cfg(arch, fields=None):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32", **(fields or {}))


def _ctx(shape, sharding=None):
    return make_context(shape[1], shape[0], ShardingConfig(**(sharding or {})))


def _state(out, arch, tp):
    return train_state_from_numpy(_unflatten(out, f"state/{arch}/{tp}"),
                                  device="cpu")


def _kw(x, arch, keys=("frames", "patches")):
    return {k: torch.as_tensor(v) for k, v in _arch_inputs(x, arch).items()
            if k in keys}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (n if n else 1.0))


@pytest.mark.parametrize("name", list(FORWARD))
def test_forward_matches_reference(ref, name):
    x, out = ref
    arch, shape, fields, sharding = FORWARD[name]
    cfg = _cfg(arch, fields)
    params = _state(out, arch, shape[1])["params"]
    h, aux = tlm.forward(params, torch.as_tensor(x[f"{arch}/tokens"]), cfg,
                         _ctx(shape, sharding), **_kw(x, arch))
    np.testing.assert_allclose(h.numpy(), out[f"forward/{name}/hidden"],
                               **HIDDEN)
    if cfg.is_moe:
        np.testing.assert_allclose(float(aux["moe_aux"]),
                                   out[f"forward/{name}/moe_aux"],
                                   rtol=1e-5)
        assert int(aux["moe_dropped"]) == int(
            out[f"forward/{name}/moe_dropped"])


@pytest.mark.parametrize("name", list(DECODE))
def test_prefill_and_decode_match_reference(ref, name):
    x, out = ref
    arch, shape, fields, sharding = DECODE[name]
    cfg, ctx = _cfg(arch, fields), _ctx(shape, sharding)
    params = _state(out, arch, shape[1])["params"]
    cache, h = tdec.prefill(params, torch.as_tensor(x[f"{arch}/tokens"]),
                            cfg, ctx, max_len=MAX_LEN,
                            **_kw(x, arch, ("frames",)))
    np.testing.assert_allclose(h.numpy(), out[f"decode/{name}/prefill"],
                               **HIDDEN)
    for i in range(DECODE_STEPS):
        cache, h = tdec.decode_step(
            params, cache, torch.as_tensor(x[f"{arch}/steps"][i]), cfg, ctx)
        np.testing.assert_allclose(h.numpy(), out[f"decode/{name}/step{i}"],
                                   **HIDDEN)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_matches_reference(ref, name):
    x, out = ref
    arch, shape, fields, sharding = TRAIN[name]
    cfg = _cfg(arch, fields)
    step = tstep.make_train_step(cfg, TrainConfig(**_tc()),
                                 _ctx(shape, sharding))
    state = _state(out, arch, shape[1])
    batch = {k: torch.as_tensor(v)
             for k, v in _arch_inputs(x, arch, "batch/").items()}
    state, metrics = step(state, batch)
    prefix = f"train/{name}/metric/"
    want = {k[len(prefix):]: float(v) for k, v in out.items()
            if k.startswith(prefix)}
    assert set(metrics) == set(want)
    for k, w in want.items():
        assert abs(float(metrics[k]) - w) <= METRIC * max(abs(w), 1e-30), (
            k, float(metrics[k]), w)
    for kind, tree, bound in (
            ("grad", step.grads, GRAD),
            ("params", state["params"],
             UPDATE_RWKV if arch == "rwkv6-1.6b" else UPDATE)):
        got = dict(flatten_with_paths(tree))
        jw = _unflatten(out, f"train/{name}/{kind}")
        for path, w in flatten_with_paths(jw):
            err = _rel(got[path].detach().numpy(), w)
            assert err < bound, (kind, path, err)


# ---------------------------------------------------------------------------
# The port's own invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE])
def test_ctx_forward_is_bitwise_local(ref, arch):
    """Without MoE a context changes nothing but the embedding's route,
    which is exact: bitwise the ctx=None forward, on both meshes."""
    x, out = ref
    cfg = _cfg(arch)
    params = _state(out, arch, 4)["params"]
    tokens = torch.as_tensor(x[f"{arch}/tokens"])
    want, _ = tlm.forward(params, tokens, cfg, None, **_kw(x, arch))
    for shape in ((1, 4), (2, 2)):
        got, _ = tlm.forward(params, tokens, cfg, _ctx(shape), **_kw(x, arch))
        assert torch.equal(got, want), shape


def test_ctx_refusals():
    """What the reference's shard_map cannot split raises ValueError: a
    cache of positions that do not divide over the ranks, a vocabulary
    table whose rows do not, experts that do not."""
    cfg = _cfg("granite-8b")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    tokens = torch.zeros((B, S), dtype=torch.int64)
    cache, _ = tdec.prefill(params, tokens, cfg, _ctx((1, 4)), max_len=30)
    with pytest.raises(ValueError, match="30 positions"):
        tdec.decode_step(params, cache, tokens[:, 0], cfg, _ctx((1, 4)))
    with pytest.raises(ValueError, match="30 positions"):
        ContinuousBatcher(params, cfg, 2, 30, _ctx((1, 4)), device="cpu")
    odd = dataclasses.replace(cfg, vocab_size=250)
    p_odd = tlm.init_params(torch.Generator().manual_seed(0), odd,
                            device="cpu")
    assert p_odd["embed"].shape[1] == 250
    with pytest.raises(ValueError, match="divisible by 4"):
        tlm.forward(p_odd, tokens, odd, _ctx((1, 4)))
    assert tlm.padded_vocab(odd, 4) == 252
    moe = _cfg("moonshot-v1-16b-a3b", dict(vocab_size=255))
    p_moe = tlm.init_params(torch.Generator().manual_seed(0), moe,
                            device="cpu")
    with pytest.raises(ValueError, match="8 experts do not divide over 3"):
        tlm.forward(p_moe, tokens, moe, make_context(3))
    with pytest.raises(ValueError, match="rw_impl must be one of"):
        tlm.forward(params, tokens, dataclasses.replace(
            cfg, vocab_rw_impl="ring"), _ctx((1, 4)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_mirror_the_cache(arch):
    """cache_specs names an axis (or None) for every axis of every cache
    entry: the slots over the data axis when it divides them, positional
    rows' sequence over the model axis unless decode is local."""
    cfg = _cfg(arch)
    cache = tdec.init_cache(cfg, 4, MAX_LEN, device="cpu")
    for ctx, dp, seq in ((_ctx((2, 2)), "data", "model"),
                         (_ctx((1, 4), dict(decode_kv_seq_sharded=False)),
                          None, None)):
        specs = tdec.cache_specs(cfg, ctx, 4)
        assert set(specs) == set(cache)
        assert specs["length"] == (dp,)
        for name, st in tdec.kv_stacks(cache).items():
            assert set(specs[name]) == set(st)
            for key, t in st.items():
                spec = specs[name][key]
                assert len(spec) == t.dim() and spec[1] == dp, (key, spec)
                if key not in tdec.STATE_KEYS:
                    assert spec[2] == seq, (key, spec)


def test_remat_under_ctx_is_bitwise(ref):
    """moonshot under a context: remat's gradients and loss bitwise none
    (torch.utils.checkpoint recomputes the expert-parallel blocks)."""
    x, out = ref
    arch = "moonshot-v1-16b-a3b"
    cfg = _cfg(arch)
    batch = {k: torch.as_tensor(v)
             for k, v in _arch_inputs(x, arch, "batch/").items()}
    got = []
    for remat in (False, True):
        step = tstep.make_train_step(cfg, TrainConfig(**_tc(remat=remat)),
                                     _ctx((1, 4)))
        state, metrics = step(_state(out, arch, 4), batch)
        got.append((metrics, dict(flatten_with_paths(step.grads))))
    (m0, g0), (m1, g1) = got
    assert float(m0["moe_dropped"]) > 0
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[p], g1[p]) for p in g0)


@pytest.mark.parametrize("arch", ["granite-8b", "moonshot-v1-16b-a3b"])
def test_batcher_under_ctx_matches_generate(ref, arch):
    """Three requests through ContinuousBatcher(ctx=) give the tokens of
    generate(ctx) on each prompt alone."""
    x, out = ref
    cfg, ctx = _cfg(arch), _ctx((1, 4))
    params = _state(out, arch, 4)["params"]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 10, 14)]
    eng = ContinuousBatcher(params, cfg, 2, MAX_LEN, ctx, eos_id=-1,
                            device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 6))
    done = eng.run_to_completion()
    for i, p in enumerate(prompts):
        want = generate(params, cfg, p[None], 6, ctx, device="cpu")
        assert done[i].generated == want[0].tolist(), i


def test_trainer_under_ctx_resumes_bitwise(tmp_path):
    """A Trainer(ctx=) run of 3 steps against 2 steps, a restart from the
    checkpoint, and 1 more: the same state bit for bit."""
    cfg = _cfg("moonshot-v1-16b-a3b")
    tc = TrainConfig(**_tc(checkpoint_every=100))
    ctx = _ctx((1, 4))

    def run(ckpt_dir, steps, start=0):
        t = Trainer(cfg, tc, lm_batches(cfg, B, S, seed=1,
                                        start_step=start),
                    ckpt_dir=ckpt_dir, ctx=ctx, device="cpu")
        assert t.start_step == start
        return t.run(steps)

    whole = run(None, 3)
    run(str(tmp_path), 2)
    resumed = run(str(tmp_path), 1, start=2)
    a = dict(flatten_with_paths(whole))
    b = dict(flatten_with_paths(resumed))
    assert list(a) == list(b)
    assert all(torch.equal(a[p], b[p]) for p in a)


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]), Path(sys.argv[2]))
