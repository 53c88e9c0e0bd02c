"""The port's five examples (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the CPU.

The reference's four examples that run in seconds (quickstart,
dlrm_inference, dlrm_sharding_plan, serve_batched) run once, as scripts,
in a subprocess with four forced CPU devices (this file run as a script),
which also computes the reference's values on the same numpy inputs: the
quickstart tables from a numpy seed, the reference's own DLRM and LM
parameters (``jax.random.key(0)``, as its examples draw them) converted
with ``utils/convert``.  Beside it the port's examples run through their
``main``: quickstart and dlrm_inference at ``--ranks 4`` (one spawn of 4
gloo processes each), serve_batched on the converted parameters, and
lm_train for 3 steps.  Held here:

  * quickstart: the pooled output within ``POOL_TOL`` of the reference's
    ``pooled_lookup_local`` on the same tables, and of the one-rank path,
    which spawns no process;
  * dlrm_inference: the oracle's logits and the tiered engine's scores
    within ``SCORE_TOL`` of the reference's forward, the cache's hits and
    misses equal to the reference's; each strategy on 4 ranks within
    ``STRATEGY_TOL`` of the oracle, its traffic equal to the dict the
    reference's example prints for it;
  * dlrm_sharding_plan: on ``TPU_V5E``'s constants (a port ``Hardware``)
    and the reference's 8 GB budget, 64 shards and every placement and
    per-shard byte count equal to the reference's plan; on the H100
    model, 16 shards of 40 GB;
  * serve_batched: the LM's greedy tokens equal to the reference
    batcher's on the converted f32 smoke parameters up to a near-tie
    (top-2 logits within ``NEAR_TIE``), the DLRM scores within
    ``SCORE_TOL`` of the reference's serialized engine, and the SLO
    monitor's windows those the reference's example prints;
  * lm_train: ``make_100m()`` equal to the reference's, and ``main`` at 3
    steps runs and writes its checkpoint;
  * without a card each example that runs on one raises unless told
    ``--device cpu``.
"""
import ast
import contextlib
import dataclasses
import io
import os
import re
import runpy
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import perf_model as tpm
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.utils.convert import lm_params_from_numpy, params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
if str(EXAMPLES) not in sys.path:
    sys.path.insert(0, str(EXAMPLES))

import dlrm_inference_torch as di  # noqa: E402
import dlrm_sharding_plan_torch as dsp  # noqa: E402
import lm_train_torch as ltr  # noqa: E402
import quickstart_torch as qs  # noqa: E402
import serve_batched_torch as sb  # noqa: E402

WORLD = 4
REF_EXAMPLES = ("quickstart", "dlrm_inference", "dlrm_sharding_plan",
                "serve_batched")
POOL_TOL = 1e-5           # pooled vectors, absolute
SCORE_TOL = 1e-5          # logits and pCTR scores, absolute
STRATEGY_TOL = 1e-4       # a strategy's logits against the oracle
NEAR_TIE = 1e-4           # top-2 logit gap under which greedy may differ
LM_TRAIN = ["--steps", "3", "--batch", "2", "--seq", "32", "--device",
            "cpu"]


def qs_tables() -> np.ndarray:
    """The quickstart's (8, 65536, 128) f32 tables, ~ N(0, 1/128), from a
    numpy seed: the same in both processes."""
    rng = np.random.default_rng(7)
    t = rng.standard_normal((8, 1 << 16, 128), dtype=np.float32)
    return t * np.float32(128 ** -0.5)


def _flat(tree, prefix: str) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _tree(x: dict, prefix: str):
    """The nested tree saved under ``prefix`` by :func:`_flat` (lists
    where every key is an index)."""
    root: dict = {}
    for key, v in x.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)


def _ref_dlrm_base():
    """The reference dlrm_inference example's config."""
    from repro.configs import dlrm as jdlrm_cfg
    return dataclasses.replace(
        jdlrm_cfg.smoke(), num_sparse_features=8, rows_per_table=4096,
        embedding_dim=64, pooling=16, bottom_mlp=(128, 64))


def _ref_serve_dlrm_base():
    """The reference serve_batched example's DLRM config."""
    from repro.cache import CacheConfig
    from repro.configs import dlrm as jdlrm_cfg
    return dataclasses.replace(
        jdlrm_cfg.smoke(), kernel_mode="reference",
        cache=CacheConfig(rows=32, policy="lru"))


def _inputs() -> dict:
    """The reference's parameters, drawn as its examples draw them, as
    numpy: dlrm_inference's DLRM, serve_batched's LM in f32 and its
    DLRM."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import dlrm as jdlrm
    from repro.models import lm as jlm

    key = jax.random.key(0)
    x = {}
    x.update(_flat(jdlrm.init_params(key, _ref_dlrm_base()), "di"))
    cfg = jconfigs.get_smoke_config("granite-8b")
    x.update(_flat(jlm.init_params(key, cfg, dtype=jnp.float32), "sb/lm"))
    x.update(_flat(jdlrm.init_params(key, _ref_serve_dlrm_base()),
                   "sb/dlrm"))
    return x


def _ctr_requests(rng, cfg, CTRRequest) -> list:
    """The examples' 24 Zipf(1.2) requests, drawn from ``rng``."""
    T, L, F = cfg.num_sparse_features, cfg.pooling, cfg.num_dense_features
    reqs = []
    for rid in range(24):
        ranks = rng.zipf(1.2, size=(T, L))
        reqs.append(CTRRequest(
            rid=rid, dense=rng.standard_normal(F).astype(np.float32),
            indices=np.minimum(ranks - 1,
                               cfg.rows_per_table - 1).astype(np.int32),
            lengths=rng.integers(1, L + 1, T).astype(np.int32)))
    return reqs


def _jax_reference(outdir: Path) -> None:
    """The reference's side, with 4 forced CPU devices: the inputs
    (:func:`_inputs`, written first, for the port's side to read while
    this goes on), its four quick examples run as scripts (their output
    kept), then its values on the inputs."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.core import embedding_bag as jeb
    from repro.core.jagged import JaggedBatch, random_jagged_batch
    from repro.models import dlrm as jdlrm
    from repro.serving.engine import (ContinuousBatcher, CTRRequest, Request,
                                      make_dlrm_engine)

    x = _inputs()
    np.savez(outdir / "inputs.part.npz", **x)
    os.replace(outdir / "inputs.part.npz", outdir / "inputs.npz")
    for name in REF_EXAMPLES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
        (outdir / f"{name}.txt").write_text(buf.getvalue())

    jtree = lambda p: jax.tree_util.tree_map(jnp.asarray, _tree(x, p))  # noqa
    out = {}
    cfg = jeb.EmbeddingBagConfig(num_tables=8, rows_per_table=1 << 16,
                                 dim=128, sharding="row", rw_impl="a2a",
                                 capacity_factor=4.0)
    batch = random_jagged_batch(np.random.default_rng(0), 8, 64, 16, 1 << 16)
    out["qs/local"] = np.asarray(jeb.pooled_lookup_local(
        jnp.asarray(qs_tables()), batch, cfg))

    base, params = _ref_dlrm_base(), jtree("di")
    rng = np.random.default_rng(0)
    dense = jnp.asarray(rng.standard_normal((di.B, base.num_dense_features)),
                        jnp.float32)
    batch = random_jagged_batch(rng, base.num_sparse_features, di.B,
                                base.pooling, base.rows_per_table)
    out["di/ref"] = np.asarray(jdlrm.forward(params, dense, batch, base))
    want = []
    for r in _ctr_requests(rng, base, CTRRequest):
        one = JaggedBatch(jnp.asarray(r.indices[:, None, :]),
                          jnp.asarray(r.lengths[:, None]))
        want.append(float(jax.nn.sigmoid(jdlrm.forward(
            params, jnp.asarray(r.dense[None]), one, base))[0]))
    out["di/tiered"] = np.asarray(want)

    cfg = jconfigs.get_smoke_config("granite-8b")
    eng = ContinuousBatcher(jtree("sb/lm"), cfg, num_slots=4, max_len=64,
                            eos_id=-1)
    for req in _lm_requests(cfg, Request):
        eng.submit(req)
    for rid, r in eng.run_to_completion().items():
        out[f"sb/tokens/{rid}"] = np.asarray(r.generated, np.int64)
    base = _ref_serve_dlrm_base()
    serial = make_dlrm_engine(jtree("sb/dlrm"), base, batch_size=8)
    for r in _ctr_requests(np.random.default_rng(0), base, CTRRequest):
        serial.submit(r)
    scores = serial.run_to_completion()
    out["sb/dlrm"] = np.asarray([scores[rid] for rid in range(24)])
    np.savez(outdir / "outputs.npz", **out)


def _lm_requests(cfg, Request) -> list:
    """serve_batched's 10 requests of 4-11 tokens."""
    rng = np.random.default_rng(0)
    return [Request(rid=rid,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        rng.integers(4, 12)).astype(np.int32),
                    max_new=int(rng.integers(4, 10)))
            for rid in range(10)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs (texts by example, values) and the port's
    examples' results, the JAX subprocess running beside the port's."""
    tmp = tmp_path_factory.mktemp("examples")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    try:
        tables = torch.from_numpy(qs_tables())
        port["qs"] = qs.main(["--device", "cpu", "--ranks", str(WORLD)],
                             tables=tables)
        trainer = ltr.main(LM_TRAIN)
        port["lt"] = dict(metrics=[m for _, m in trainer.metrics_log],
                          ckpt=sorted(os.listdir(trainer.ckpt_dir)))
        shutil.rmtree(trainer.ckpt_dir, ignore_errors=True)
        del trainer
        while not (tmp / "inputs.npz").exists():
            assert proc.poll() is None, proc.communicate()[1][-4000:]
            time.sleep(0.2)
        x = dict(np.load(tmp / "inputs.npz"))
        port["di"] = di.main(["--device", "cpu", "--ranks", str(WORLD)],
                             params=params_from_numpy(_tree(x, "di"),
                                                      device="cpu"))
        lm_params = lm_params_from_numpy(_tree(x, "sb/lm"), device="cpu")
        port["sb"] = sb.main(["--device", "cpu"], lm_params=lm_params,
                             dlrm_params=params_from_numpy(
                                 _tree(x, "sb/dlrm"), device="cpu"))
        port["sb_lm_params"] = lm_params
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    texts = {name: (tmp / f"{name}.txt").read_text() for name in REF_EXAMPLES}
    return x, dict(np.load(tmp / "outputs.npz")), texts, port, tables


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_ranks_match_the_reference_oracle(runs):
    _, ref, texts, port, _ = runs
    got = port["qs"]["pooled"].numpy()
    assert got.shape == ref["qs/local"].shape == (64, 8, 128)
    np.testing.assert_allclose(got, ref["qs/local"], rtol=0, atol=POOL_TOL)
    assert port["qs"]["err"] < 1e-4
    err = float(re.search(r"local oracle\| = (\S+)",
                          texts["quickstart"]).group(1))
    assert "mesh: 4 devices" in texts["quickstart"] and err < 1e-4


def test_quickstart_one_rank_spawns_no_process(runs, monkeypatch):
    """``--ranks 1`` runs the pipeline over one shard in this process:
    the same pooled output as the four ranks'."""
    *_, port, tables = runs

    def refuse(*a, **kw):
        raise AssertionError("one rank must not spawn")
    monkeypatch.setattr(qs, "run_model_mesh", refuse)
    one = qs.main(["--device", "cpu", "--ranks", "1"], tables=tables)
    np.testing.assert_allclose(one["pooled"].numpy(),
                               port["qs"]["pooled"].numpy(), rtol=0,
                               atol=POOL_TOL)
    assert one["err"] == 0.0


# ---------------------------------------------------------------------------
# dlrm_inference
# ---------------------------------------------------------------------------

def _ref_strategies(text: str) -> dict:
    """label -> the traffic dict the reference's example prints."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"(\w+)\s*(/\w+)?\s+err=\S+\s+traffic=(\{.*?\})", line)
        if m:
            out[m.group(1) + (m.group(2) or "")] = ast.literal_eval(
                m.group(3))
    return out


def test_dlrm_config_is_the_reference_examples():
    ref = dataclasses.asdict(_ref_dlrm_base())
    got = dataclasses.asdict(di.base_config())
    assert {k: ref[k] for k in got if k in ref and k != "cache"} == \
        {k: got[k] for k in got if k in ref and k != "cache"}


def test_dlrm_oracle_and_tiered_scores_match_the_reference(runs):
    _, ref, texts, port, _ = runs
    np.testing.assert_allclose(port["di"]["ref"].numpy(), ref["di/ref"],
                               rtol=0, atol=SCORE_TOL)
    tiered = port["di"]["tiered"]
    got = np.asarray([tiered["scores"][rid] for rid in range(24)])
    np.testing.assert_allclose(got, ref["di/tiered"], rtol=0, atol=SCORE_TOL)
    assert tiered["err"] < SCORE_TOL
    m = re.search(r"hits=(\d+), misses=(\d+)", texts["dlrm_inference"])
    stats = tiered["stats"]
    assert (stats.hits, stats.misses) == (int(m.group(1)), int(m.group(2)))


@pytest.mark.parametrize("label", ["row/allgather", "row/a2a", "column",
                                   "table"])
def test_strategy_on_four_ranks_matches_the_oracle_and_traffic(runs, label):
    _, ref, texts, port, _ = runs
    rows = {r["label"]: r for r in port["di"]["strategies"]}
    row = rows[label]
    np.testing.assert_allclose(row["logits"].numpy(), ref["di/ref"], rtol=0,
                               atol=STRATEGY_TOL)
    assert row["err"] < STRATEGY_TOL
    assert row["traffic"] == _ref_strategies(texts["dlrm_inference"])[label]


# ---------------------------------------------------------------------------
# dlrm_sharding_plan
# ---------------------------------------------------------------------------

def _port_hw(ref_hw) -> tpm.Hardware:
    """A port ``Hardware`` holding the reference platform's constants."""
    fields = {f.name: getattr(ref_hw, f.name)
              for f in dataclasses.fields(tpm.Hardware)}
    for name in ("bulk", "onesided"):
        fields[name] = tpm.Transport(**dataclasses.asdict(fields[name]))
    return tpm.Hardware(**fields)


@pytest.mark.parametrize("batch", dsp.BATCHES)
def test_plan_on_v5e_constants_is_the_reference_plan(batch):
    from repro.core.perf_model import TPU_V5E
    from repro.core.sharding_plan import plan

    ref_ex = runpy.run_path(str(EXAMPLES / "dlrm_sharding_plan.py"))
    budget = 8e9                    # the reference example's
    got = dsp.plans(hw=_port_hw(TPU_V5E), budget=budget)
    assert got["shards"] == 64 and got["budget"] == budget
    tables = ref_ex["criteo_like_tables"]()
    assert [dataclasses.astuple(t) for t in tables] == \
        [dataclasses.astuple(t) for t in got["tables"]]
    want = plan(tables, num_shards=64, batch_per_shard=batch,
                hbm_budget_bytes=budget, hw=TPU_V5E)
    p = got["plans"][batch]
    assert p.per_shard_bytes == want.per_shard_bytes
    assert [(x.table.name, x.strategy, x.shard, x.est_time_s, x.index)
            for x in p.placements] == \
        [(x.table.name, x.strategy, x.shard, x.est_time_s, x.index)
         for x in want.placements]


def test_plan_on_the_h100_model(capsys):
    out = dsp.main([])
    assert out["shards"] == 16 and out["budget"] == 40e9
    for p in out["plans"].values():
        assert max(p.per_shard_bytes) <= 1.25 * out["budget"]
        assert all(x.strategy == "row" for x in p.placements
                   if x.table.bytes > out["budget"])
    text = capsys.readouterr().out
    assert "h100-dgx-nvlink model" in text and text.rstrip().endswith(".")


# ---------------------------------------------------------------------------
# serve_batched
# ---------------------------------------------------------------------------

def _tie_gap(params, cfg, prompt, tokens) -> float:
    """The top-2 gap of the port's f32 logits for the token after
    ``prompt + tokens``."""
    seq = torch.as_tensor(np.concatenate([prompt, tokens]).astype(np.int64))
    with torch.no_grad():
        h, _ = tlm.forward(params, seq[None], cfg)
        logits = tlm.lm_logits(params, h[:, -1], cfg)[0, :cfg.vocab_size]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def test_serve_batched_lm_tokens_match_the_reference(runs):
    from repro_torch import configs as tconfigs

    _, ref, _, port, _ = runs
    cfg = tconfigs.get_smoke_config("granite-8b")
    done = port["sb"]["lm"]
    assert sorted(done) == list(range(10))
    compared = 0
    for rid, r in done.items():
        want = ref[f"sb/tokens/{rid}"].tolist()
        got = list(r.generated)
        assert len(got) == len(want)
        for j, (a, b) in enumerate(zip(got, want)):
            if a != b:
                gap = _tie_gap(port["sb_lm_params"], cfg, r.prompt, got[:j])
                assert gap < NEAR_TIE, (rid, j, a, b, gap)
                break
            compared += 1
    assert compared >= 0.9 * sum(len(r.generated) for r in done.values())


def test_serve_batched_dlrm_scores_and_slo_match_the_reference(runs):
    _, ref, texts, port, _ = runs
    scores = port["sb"]["dlrm"]["scores"]
    got = np.asarray([scores[rid] for rid in range(24)])
    np.testing.assert_allclose(got, ref["sb/dlrm"], rtol=0, atol=SCORE_TOL)
    slo = port["sb"]["dlrm"]["slo"]
    m = re.search(r"windows=(\d+) .* by_rule=(\{.*\})",
                  texts["serve_batched"])
    assert slo["windows_evaluated"] == int(m.group(1)) > 0
    assert set(slo["breaches_by_rule"]) <= {"hit_rate"}
    assert set(ast.literal_eval(m.group(2))) <= {"hit_rate"}


# ---------------------------------------------------------------------------
# lm_train
# ---------------------------------------------------------------------------

def test_make_100m_is_the_reference_config():
    ref_ex = runpy.run_path(str(EXAMPLES / "lm_train.py"))
    assert dataclasses.asdict(ltr.make_100m()) == \
        dataclasses.asdict(ref_ex["make_100m"]())


def test_lm_train_main_runs_and_writes_its_checkpoint(runs):
    port = runs[3]
    metrics = port["lt"]["metrics"]
    assert len(metrics) == 3
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    assert port["lt"]["ckpt"] == ["step_00000003"]


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("example", ["quickstart", "dlrm_inference",
                                     "serve_batched", "lm_train"])
def test_examples_need_a_card_unless_told_cpu(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    mod = {"quickstart": qs, "dlrm_inference": di, "serve_batched": sb,
           "lm_train": ltr}[example]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def test_model_mesh_backend_rule():
    """As the debug mesh's: NCCL only with no device named and a card a
    rank; gloo on the CPU and on one card the ranks share."""
    cards = torch.cuda.device_count()
    assert tmesh.backend_for(4, "cpu") == "gloo"
    assert tmesh.backend_for(4, "cuda:0") == "gloo"
    assert tmesh.backend_for(cards + 1, None) == "gloo"


if __name__ == "__main__":
    _jax_reference(Path(sys.argv[1]))
