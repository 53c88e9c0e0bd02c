#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card (an H100).

    python3 chip_smoke.py

Phases:
  1. environment: torch, CUDA, nvcc, triton, the card's name and power
     limit; builds the port's CUDA kernels from this checkout (one nvcc per
     source, all started together, into build/) and prints the build's
     seconds, each flash and TBE kernel's ptxas registers and spills, and
     the HGMMA and UTMALDG instructions in the wgmma flash library's SASS
     (cuobjdump; fails if either is absent);
  2. each kernel wrapper against its plain PyTorch version at the main
     path's shapes: the TBE wrappers at T=26 tables, B=2048, L=32, D=128,
     uniform ids over R=1,000,000 rows, random lengths including 0, -1
     padding, in f32 and bf16, plus D=10 (the scalar path) and D=96, and
     one table (T=1, B=2048) at L in {0, 1, 31, 32, 33, 64} with bags of
     live ids and zero weights; stacked, flat (offsets as an array) and
     one table alone bitwise-equal, and stacked and flat over a copy of
     the same rows; the SHA-256 of those outputs (equal digests from two
     checkouts mean bitwise-equal kernels); under torch.profiler, each
     call of gather_pool, gather_pool_tbe, gather_pool_tbe_flat and
     onesided_ring_permute one device kernel; the row fetch's one-sided
     exchange (the chunk-put kernel) on 4 simulated
     hosts' contributions of 2**18 rows (the padded fetch of every flush
     of phase 6) at D=128 and of 1000 rows at D=10, f32 and bf16, bitwise;
     (2b) the flash-attention wrapper at tests/test_kernels.py's four
     shapes in f32 and bf16, and at granite-8b's layer (1, 16384, 32/8,
     128) causal and (1, 9000, 32/8, 128) under a 4096 window, bf16,
     each case on the route the wrapper chose: bf16 at hd 64/128 on the
     wgmma kernel, f32 and hd 16/32 on the SIMT kernel;
  2c. every attached kernel contract (repro_torch.analysis.fixtures) on
     the card: each fixture's one call under set_sync_debug_mode("error")
     and a dispatch-mode census, its wrapper calls, LAUNCH_COUNTS deltas
     and the profiler's TBE device kernels within the contract's launch
     bounds (one TBE kernel for the fused, flat and device_lookup
     contracts), no collective, no host transfer, no f64, the scatter in
     place;
  3. the uncached engine at full width (CONFIG: 26 x 1,000,000 x 128 fp32
     tables) serving 8192 requests in flushes of 2048: scores against a
     plain score on the card, one TBE launch per flush, and 26
     single-table launches for one flush under fused=False; one flush
     profiled each way: the TBE device time as one launch and as 26;
  4. the cached engine (65,536 slots per table, LFU, host cold tier) on
     the same requests: scores and pooled lookups bitwise-equal to phase 3;
  5. kernel, plain-version and library times: the TBE wrappers at the
     phase-2 shapes, the row fetch's puts at the padded fetch of a
     steady-state flush of phase 4, the flash kernel at granite-8b's layer
     (SDPA the library call; the SIMT kernel timed beside it at the same
     shapes), beside each kernel's bound;
  6. the cached engine over the REMOTE cold tier (the same cache, the
     tables row-split over 4 simulated hosts on the card), once with the
     bulk and once with the one-sided transport, on the same requests:
     scores and pooled lookups bitwise-equal to phase 3, the one-sided run
     one put launch per non-empty fetch and the bulk run none;
  6b. pipelined serving (depth 2: two slot pools, the next micro-batch's
     prefetch on a side CUDA stream) through make_dlrm_engine, on the same
     requests: (a) over the host tier, (b) over the remote tier with the
     one-sided transport, (c) with pools that half of the micro-batches
     overflow (the head-of-line fallback): scores bitwise-equal to phase
     3, one TBE launch per micro-batch (and one put launch per non-empty
     fetch), at least one fallback in (c), the port's check_timeline and
     check_scheduler_source clean; wall time beside phases 4 and 6,
     overlap, stage totals, hit rate, pool bytes, peak device memory;
     (d) one profiled run: the streams of the scatters and of the TBE
     launches, and the side-stream device time under forward kernels;
  6c. the planner -> engine round trip with telemetry, on the same
     requests: sharding_plan.plan over CONFIG's 26 tables (H100_DGX, Zipf
     1.05, host tier, 2048 a shard); (a) plan A (2 shards, 0.5 GB: 8 pools
     of 200,000 slots, 2 of 100,000, 16 "row" tables at phase 4's 65,536)
     on the serialized engine over the host tier: S_t the config's vector,
     the pool's bytes exactly slot_pool_bytes (1,458,470,912), scores and
     pooled lookups bitwise phase 3's, one TBE launch per flush; (b) plan B
     (16 shards, 0.2 GB: all 26 cached) with cache.rows = 0 on the
     pipelined engine over the remote tier, one-sided: two pools of
     2,150,400,000 B, scores bitwise phase 3's, 4 TBE launches, one put
     launch per non-empty fetch from the side stream, check_timeline
     clean; both with a Telemetry: request latency p50/p99, each Chrome
     trace exported to chiprun_out/ and validated, its lanes checked,
     hit_rate_t beside est_hit_rate, and the spans fitted back into the
     perf model (calibrate; constants beside H100_DGX's, stage_time_error);
  7. the distributed embedding bag over 4 simulated ranks on the card
     (table-wise over 2), on phase 3's tables: the chunk kernels'
     all-to-all, reduce-scatter (the pull-sum kernel) and ring permute
     (one launch per call)
     bitwise against their plain versions at the a2a pipeline's shapes, and
     at 1, 2, 3 and 8 ranks, with int32 sums that wrap, -0.0 sources and
     exact cancellations; phase 3's requests
     served by DLRMEngine with a ParallelContext for row/allgather (within
     tolerance of phase 3), row/a2a on both backends (dropped lookups per
     flush, 3 all-to-all launches and 1 reduce-scatter launch per
     one-sided flush) and column / table
     (bitwise phase 3); a no-drop traffic (uniform ids, every length 32)
     where a2a drops nothing and agrees with uncached; flush medians, one
     profiled a2a flush, the kernels' times beside their bounds;
  7t. DLRM training at full width (phase 3's tables freed first; fresh
     tables from a seed): at a small size, the fused, unfused and flat
     ops' gradients (tables and weights) against autograd of the plain
     versions; then the test_dlrm flow on one Zipf batch of 2048 from
     dlrm_batches (-1 past each length), the flow's 20 steps of row-wise
     Adagrad on the tables and SGD on the MLPs at lr 0.05: the forward's pooled
     output bitwise the wrapper's, each forward one gather_pool_tbe launch
     and the backward and update none, d tables within n * 2**-24 *
     sum|c| of a float64 host sum of the same contributions and zero
     elsewhere (also through fused=False: 26 launches), the two-run
     backward difference, untouched rows bitwise unchanged and accum
     zero there, the loss down; stage times (CUDA events), a profiled
     step's TBE kernels and idle share, peak device memory;
  8. LM serving: granite-8b at full width in bf16 (random weights from a
     seed) through ContinuousBatcher (4 slots of 16,416 positions) over 8
     requests, 2 prompts of 16,384 tokens (the flash kernel: 36 launches
     each, all on the wgmma route) and 6 of 256-2,048 (full attention:
     none), 32 new tokens each: launches per step and per route, the
     kernel against its plain version on layer 0's real q/k/v,
     decode-matches-forward at full width, prefill and decode times,
     tokens/s, peak device memory, and a profiled decode step, short
     prefill and 16,384-token prefill;
  9. the card line, one JSON line of the kernels, and last the result line.

Any failed check raises: the script exits non-zero and prints no result
line.  It also fails without a CUDA card, and without the port's sources
beside it.
"""
import dataclasses
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# one cuBLAS workspace layout, so equal GEMMs stay bitwise-equal
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
TBE_SOURCE = "src/repro_torch/csrc/tbe_gather_pool.cu"
A2A_SOURCE = "src/repro_torch/csrc/onesided_a2a.cu"
# the flash wrapper's two kernels: bf16 at hd 64/128 (every call of the
# main path) on the tensor cores; f32 and hd 16/32 on the CUDA cores
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention_wgmma.cu"
FLASH_SIMT_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
SOURCES = {"gather_pool_tbe_flat": TBE_SOURCE, "gather_pool_tbe": TBE_SOURCE,
           "gather_pool": TBE_SOURCE, "onesided_put_rows": A2A_SOURCE,
           "onesided_all_to_all": A2A_SOURCE,
           "onesided_reduce_scatter": A2A_SOURCE,
           "onesided_ring_permute": A2A_SOURCE,
           "flash_attention": FLASH_SOURCE}
REPLACES = {"gather_pool_tbe_flat":
            "src/repro/kernels/embedding_gather.py:150",
            "gather_pool_tbe": "src/repro/kernels/embedding_gather.py:215",
            "gather_pool": "src/repro/kernels/embedding_gather.py:95",
            "onesided_put_rows": "src/repro/kernels/onesided_a2a.py:116",
            "onesided_all_to_all": "src/repro/kernels/onesided_a2a.py:57",
            "onesided_reduce_scatter": "src/repro/kernels/onesided_a2a.py:77",
            "onesided_ring_permute": "src/repro/kernels/onesided_a2a.py:145",
            "flash_attention": "src/repro/kernels/flash_attention.py:103"}
# H100 SXM peaks (NVIDIA data sheet), at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12      # dense tensor cores
# kernel vs plain pooling: two f32 summation orders of <= 32 terms differ by
# at most 32 * 2**-24 * sum|w * x| ~ 2e-6 * sum|w * x|, and sum|w * x| < 2
# here (rows ~ N(0, 1/128), weights in [0, 1)), so 1e-5 holds with margin
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
# pCTR: the pooled vectors' f32 differences carried through the MLPs
PCTR_TOL = dict(rtol=1e-4, atol=1e-5)
# flash kernel vs its plain version: in f32 (the SIMT kernel) two orders of
# the same f32 softmax sums (tests/test_kernels.py's bound for the Pallas
# kernel); in bf16 the wgmma kernel rounds the probabilities to bf16 before
# P.V, as SDPA does, where the plain version keeps them in f32, and both
# round the output to bf16: about one bf16 ulp (2**-8 relative) of the
# output (tests/test_torch_flash.py emulates the rounding on the CPU)
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# SDPA (the library yardstick) against the plain version: its flash
# backend rounds the probabilities to bf16 before P.V, as the wgmma kernel
# does, and sums in its own order: a few bf16 ulps
SDPA_TOL = dict(rtol=3e-2, atol=3e-2)
# decode-matches-forward at full width in bf16: relative L2 of the last
# hidden state (the check of tests/test_models.py, at the working type)
DECODE_REL_L2 = 2e-2

DEV = "cuda"
T, B, L, D, R = 26, 2048, 32, 128, 1_000_000
REQUESTS, BATCH = 8192, 2048
HOSTS = 4                  # simulated hosts of the remote cold tier
PUT_ROWS = 2 ** 18         # the padded rows of each of phase 6's fetches
RANKS = 4                  # simulated ranks of phase 7's model axis
T1_POOLINGS = (0, 1, 31, 32, 33, 64)   # phase 2's one-table lengths
T1_ROWS = 100_000          # rows of phase 2's one-table checks
CAPACITY_FACTOR = 2.0      # the a2a buckets' (DLRMConfig passes none)
SPIN_CYCLES = 2_000_000    # ~1 ms of the card's clock before a timed launch
# flash checks: tests/test_kernels.py's four (B, S, H, KH, hd, causal,
# window); then granite-8b's layer at the long prompt and at a 9000-token
# prompt under a 4096 window (neither a multiple of the 64-row tiles)
FLASH_SHAPES = ((2, 128, 4, 2, 32, True, None), (1, 256, 4, 4, 64, True, 64),
                (2, 96, 2, 1, 16, False, None), (1, 64, 8, 2, 128, True, None))
LONG_PROMPT = 16_384       # over attn_chunk_threshold: the flash kernel runs
SHORT_PROMPTS = (256, 2048)  # the short prompts' lengths: full attention
WINDOWED = (9000, 4096)
LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW = 4, 16_416, 32


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _launches(**nonzero) -> dict:
    """Every kernel's launch count: 0 but for ``nonzero``."""
    return {name: nonzero.get(name, 0) for name in SOURCES}


def compare(name, got, want, tol) -> float:
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, **tol))
    log(f"  {name}: max_abs_err {err:.3e} (allclose rtol={tol['rtol']} "
        f"atol={tol['atol']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} within tolerance")
    return err


# ---------------------------------------------------------------------------
# 1. environment and build
# ---------------------------------------------------------------------------

def phase_environment(build) -> str:
    log("== 1. environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}: importable")
    except ImportError as e:
        log(f"triton: not importable ({e})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch.cuda: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    names = list(build.SOURCES)
    recs = build.build(names)          # one nvcc per source, in parallel
    for name in names:
        build.load(name)
    log(f"build + load of {len(names)} sources: "
        f"{time.perf_counter() - t0:.2f} s")
    for rec in recs.values():
        log(f"  {rec.path.name}: nvcc {rec.seconds:.2f} s")
        for line in rec.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    for name, source in (("tbe_gather_pool", TBE_SOURCE),
                         ("flash_attention_wgmma", FLASH_SOURCE),
                         ("flash_attention", FLASH_SIMT_SOURCE)):
        kernels = _ptxas_kernels(recs[name].log)
        check(bool(kernels) or recs[name].seconds == 0.0,
              f"ptxas reported the kernels of {source}")
        for kernel, regs, stores, loads in kernels:
            log(f"  ptxas {kernel} ({source}): {regs} registers, {stores} "
                f"bytes spill stores, {loads} bytes spill loads")
    sass = _sass(recs["flash_attention_wgmma"].path)
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "UTMALDG")}
    log(f"  {recs['flash_attention_wgmma'].path.name} SASS: "
        f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
    check(all(counts.values()), "the wgmma flash library holds HGMMA and "
                                "UTMALDG instructions")
    return card


def _ptxas_kernels(ptxas_log: str) -> list:
    """(kernel, registers, spill-store bytes, spill-load bytes) of each
    flash and TBE entry function in an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], None, (0, 0)
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for \S*\d(flash_[a-z]+_kernel|"
                      r"tbe_gather_pool_kernel)I(\w*)", line)
        if m:
            dtype = "f32" if m.group(2).startswith("f") else "bf16"
            num = re.search(r"Li(\d+)E", m.group(2)).group(1)
            kind = (f"hd {num}" if m.group(1).startswith("flash")
                    else f"vector, {num} rows a group" if "Lb1E"
                    in m.group(2) else "scalar")
            name = f"{m.group(1)}<{dtype}, {kind}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def _sass(path) -> str:
    """``cuobjdump -sass`` of a built library (cuobjdump on the PATH or
    under CUDA_HOME/bin)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                      "cuobjdump")
    check(os.path.exists(tool), "cuobjdump found (PATH or CUDA_HOME/bin)")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(g, t, b, lp, r, d, dev):
    """Tables ~ N(0, 1/d), lengths in [0, lp], uniform ids, -1 padding,
    weights in [0, 1) zeroed on padding."""
    tables = torch.randn((t, r, d), generator=g, device=dev).mul_(d ** -0.5)
    lens = torch.randint(0, lp + 1, (t, b), generator=g, device=dev,
                         dtype=torch.int32)
    mask = torch.arange(lp, device=dev) < lens[..., None]
    ids = torch.randint(0, r, (t, b, lp), generator=g, device=dev,
                        dtype=torch.int32)
    idx = torch.where(mask, ids, -1).to(torch.int32)
    w = torch.rand((t, b, lp), generator=g, device=dev) * mask
    # ragged per-table row counts in the same flat row space
    rows_t = r - torch.randint(0, r // 2, (t,), generator=g, device=dev)
    off = (torch.cumsum(rows_t, 0) - rows_t).to(torch.int32)
    ids_r = torch.minimum(
        (torch.rand((t, b, lp), generator=g, device=dev)
         * rows_t[:, None, None]).long(), rows_t[:, None, None] - 1)
    idx_r = torch.where(mask, ids_r, -1).to(torch.int32)
    return dict(tables=tables, idx=idx, w=w, mask=mask, off=off, idx_r=idx_r)


def _check_all(eg, x, tag, digest, one=5) -> dict:
    """The three wrappers against their plain versions, and the layouts of
    the same rows bitwise-equal: the stacked tables (table t at row t * R,
    passed as a stride), the flat view with the same offsets passed as an
    array, and one table alone.  Every output goes into ``digest``; returns
    the errors."""
    tables, idx, w = x["tables"], x["idx"], x["w"]
    t_, r_, d_ = tables.shape
    flat = tables.view(t_ * r_, d_)
    errs = {}
    stacked = eg.gather_pool_tbe(tables, idx, w)
    errs["gather_pool_tbe"] = compare(
        f"gather_pool_tbe {tag}", stacked,
        eg.gather_pool_tbe_ref(tables, idx, w), POOL_TOL)
    ragged = eg.gather_pool_tbe_flat(flat, x["off"], x["idx_r"], w)
    errs["gather_pool_tbe_flat"] = compare(
        f"gather_pool_tbe_flat ragged {tag}", ragged,
        eg.gather_pool_tbe_flat_ref(flat, x["off"], x["idx_r"], w), POOL_TOL)
    starts = (torch.arange(t_, device=flat.device) * r_).to(torch.int32)
    check(torch.equal(eg.gather_pool_tbe_flat(flat, starts, idx, w), stacked),
          f"flat with offsets t * R bitwise == stacked {tag}")
    one = min(one, t_ - 1)
    single = eg.gather_pool(tables[one], idx[one], w[one])
    errs["gather_pool"] = compare(
        f"gather_pool table {one} {tag}", single,
        eg.gather_pool_ref(tables[one], idx[one], w[one]), POOL_TOL)
    check(torch.equal(single, stacked[one]),
          f"single-table launch bitwise == fused TBE table {one} {tag}")
    for out in (stacked, ragged, single):
        digest.update(out.cpu().numpy().tobytes())
    return errs


def _one_kernel_per_call(calls, tries=3) -> None:
    """Each call under torch.profiler: the device kernels it ran.  Each
    must be exactly one launch of the named kernel.  The profiler now and
    then records no kernel of a call at all; such a call is profiled
    again, up to ``tries`` times.  A call that shows any other kernel, or
    more than one launch, fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, kernel, fn in calls:
        for attempt in range(1, tries + 1):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            ran = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("Activity Buffer")]
            ok = len(ran) == 1 and ran[0][1] == 1 and kernel in ran[0][0]
            log(f"  {label}: {sum(n for _, n in ran)} device kernel(s) "
                f"{[(k[:60], n) for k, n in ran]} "
                f"{'ok' if ok else 'NOT ONE'}"
                f"{f' (profiled {attempt} times)' if attempt > 1 else ''}")
            if ran:
                break
        check(ok, f"{label} is one {kernel} launch and nothing else")


def _contribs(g, h, m, d, dtype, dev):
    """(H_src, H_dst, M, D) contributions of a row fetch: N(0, 1) rows,
    each (requester, row) owned by one rank, ``0 * row`` (so -0.0 for half
    of them) at the other ranks."""
    rows = torch.randn((h, h, m, d), generator=g, device=dev)
    owner = torch.randint(0, h, (h, m), generator=g, device=dev)
    mine = owner[None] == torch.arange(h, device=dev)[:, None, None]
    return (rows * mine[..., None]).to(dtype)


def _bits(x):
    """The raw bits of a float tensor, so -0.0 and 0.0 differ."""
    return x.view({4: torch.int32, 2: torch.int16}[x.element_size()])


def _check_puts(oa, c, tag) -> float:
    """The row fetch's exchange and fetched rows against their plain versions
    on the same contributions: bitwise; returns the max abs error."""
    exch = oa.onesided_put_rows(c)
    want = oa.onesided_put_rows_ref(c)
    fetched = oa.onesided_fetch_rows(c)
    want_f = oa.onesided_fetch_rows_ref(c)
    torch.cuda.synchronize()
    err = max(float((exch.float() - want.float()).abs().max()),
              float((fetched.float() - want_f.float()).abs().max()))
    ok = torch.equal(_bits(exch), _bits(want)) and \
        torch.equal(_bits(fetched), _bits(want_f))
    log(f"  onesided_put_rows {tag}: exchange and fetched rows "
        f"{'bitwise equal' if ok else 'DIFFER'} (max_abs_err {err:.3e})")
    check(ok, f"onesided_put_rows {tag} bitwise == plain version")
    return err


def phase_kernels(eg, oa) -> dict:
    log("== 2. kernels against their plain versions")
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(0)
    digest = hashlib.sha256()
    x = _inputs(g, T, B, L, R, D, dev)
    log(f"  T={T} B={B} L={L} D={D} R={R}: "
        f"{int(x['mask'].sum())} valid lookups of {T * B * L}")
    errs = _check_all(eg, x, "f32", digest)
    bf = dict(x, tables=x["tables"].to(torch.bfloat16))
    for k, v in _check_all(eg, bf, "bf16", digest).items():
        errs[k] = max(errs[k], v)
    del bf
    for d_small in (10, 96):
        small = _inputs(g, 3, 64, 7, 1000, d_small, dev)
        _check_all(eg, small, f"D={d_small} f32", digest, one=1)
        _check_all(eg, dict(small, tables=small["tables"].to(
            torch.bfloat16)), f"D={d_small} bf16", digest, one=1)
    # one table (the unfused baseline's launch) at the pooling lengths
    # around the kernel's 32-slot windows and 8-row groups, with bags whose
    # ids are live and weights all zero
    for lp in T1_POOLINGS:
        one = _inputs(g, 1, B, lp, T1_ROWS, D, dev)
        one["w"][:, ::5] = 0.0          # live ids, no weight: +0.0, no read
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"T=1 L={lp} {str(dtype)[6:]}"
            y = dict(one, tables=one["tables"].to(dtype))
            _check_all(eg, y, tag, digest, one=0)
            zeros = eg.gather_pool(y["tables"][0], y["idx"][0],
                                   y["w"][0])[::5]
            check(torch.equal(_bits(zeros), torch.zeros_like(_bits(zeros))),
                  f"zero-weight bags pool to +0.0 {tag}")
    x["digest"] = digest.hexdigest()
    log(f"  phase-2 TBE digest (sha256 of every output above, f32 and "
        f"bf16, all three wrappers): {x['digest']}")

    # stacked tables and a compact flat pool holding the same rows (the
    # slot-pool layout): the same kernel pools them bitwise-equal
    tables, idx, w, mask = x["tables"], x["idx"], x["w"], x["mask"]
    rows, counts = [], []
    slots = torch.zeros_like(idx)
    for t in range(T):
        uniq, inv = torch.unique(idx[t][mask[t]].long(), return_inverse=True)
        rows.append(tables[t, uniq])
        counts.append(uniq.numel())
        slots[t][mask[t]] = inv.to(torch.int32)
    pool = torch.cat(rows)
    off_p = torch.tensor([0] + counts[:-1], device=dev).cumsum(0).to(
        torch.int32)
    same = torch.equal(eg.gather_pool_tbe_flat(pool, off_p, slots, w),
                       eg.gather_pool_tbe(tables, idx, w))
    log(f"  stacked vs flat pool of the same {pool.shape[0]} rows: "
        f"{'bitwise equal' if same else 'DIFFER'}")
    check(same, "stacked and flat pool bitwise-equal")
    del pool, rows

    # no device work beside the kernel: each wrapper call is one launch
    ring = torch.randn((RANKS, 1000, D), generator=g, device=dev)
    _one_kernel_per_call((
        ("gather_pool", "tbe_gather_pool_kernel",
         lambda: eg.gather_pool(tables[5], idx[5], w[5])),
        ("gather_pool_tbe", "tbe_gather_pool_kernel",
         lambda: eg.gather_pool_tbe(tables, idx, w)),
        ("gather_pool_tbe_flat", "tbe_gather_pool_kernel",
         lambda: eg.gather_pool_tbe_flat(tables.view(T * R, D), x["off"],
                                         x["idx_r"], w)),
        ("onesided_ring_permute", "put_chunks_kernel",
         lambda: oa.onesided_ring_permute(ring, 1))))

    # the row fetch's puts: 4 simulated hosts, D=128 and D=10, f32 and
    # bf16
    put_err = 0.0
    for m, d in ((PUT_ROWS, D), (1000, 10)):
        for dtype in (torch.float32, torch.bfloat16):
            c = _contribs(g, HOSTS, m, d, dtype, dev)
            put_err = max(put_err, _check_puts(
                oa, c, f"H={HOSTS} M={m} D={d} {str(dtype)[6:]}"))
            del c
    errs["onesided_put_rows"] = put_err
    x["errs"] = errs
    return x


def _qkv(g, b, s, h, kh, hd, dtype):
    """N(0, 1) q (b, s, h, hd), k and v (b, s, kh, hd) of ``dtype``."""
    return tuple(torch.randn((b, s, n, hd), generator=g, device=DEV).to(dtype)
                 for n in (h, kh, kh))


def _flash_route(dtype, hd) -> str:
    """The kernel the wrapper must choose: the tensor-core one for bf16 at
    hd 64 and 128, the SIMT one for the rest."""
    return "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "simt"


def _flash_case(fa, q, k, v, causal, window, tag) -> float:
    """The flash wrapper against its plain version on the same inputs, and
    the one launch it made on the route that dtype and hd choose."""
    want_route = _flash_route(q.dtype, q.shape[-1])
    before = dict(fa.ROUTE_COUNTS)
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ran = {r: n - before[r] for r, n in fa.ROUTE_COUNTS.items()}
    check(ran == {r: int(r == want_route) for r in ran},
          f"flash_attention {tag}: one launch on the {want_route} route "
          f"(got {ran})")
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    check(got.dtype == q.dtype and got.shape == q.shape,
          f"flash_attention {tag}: output of q's dtype and shape")
    return compare(f"flash_attention {tag} [{want_route}]", got.float(),
                   want.float(), FLASH_TOL[q.dtype])


def check_flash(pt) -> float:
    """The flash wrapper against its plain version at the test shapes (f32
    and bf16) and at granite-8b's layer, causal and windowed (bf16), each
    case on its route; returns the largest error."""
    log("== 2b. flash attention against its plain version")
    cfg = pt.LM_CONFIG
    g = torch.Generator(device=DEV).manual_seed(9)
    err = 0.0
    for b, s, h, kh, hd, causal, window in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(g, b, s, h, kh, hd, dtype)
            err = max(err, _flash_case(
                pt.fa, q, k, v, causal, window,
                f"({b}, {s}, {h}/{kh}, {hd}) causal={causal} "
                f"window={window} {str(dtype)[6:]}"))
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for s, window in ((LONG_PROMPT, None), WINDOWED):
        q, k, v = _qkv(g, 1, s, H, KH, hd, torch.bfloat16)
        err = max(err, _flash_case(
            pt.fa, q, k, v, True, window,
            f"granite (1, {s}, {H}/{KH}, {hd}) causal window={window} bf16"))
    return err


# ---------------------------------------------------------------------------
# 2c. kernel contracts on the card
# ---------------------------------------------------------------------------

# the contracts whose fixture must show one TBE kernel in its profile
ONE_TBE_KERNEL = ("kernels.ops.embedding_bag_batched[fused]",
                  "kernels.ops.embedding_bag_batched_flat",
                  "cache.cached_bag.device_lookup")


def phase_contracts(pt) -> dict:
    """Every attached kernel contract against its fixture on the card
    (``repro_torch.analysis.fixtures.run_all``): each fixture's one call
    runs under set_sync_debug_mode("error") and a dispatch-mode census,
    with its kernel-wrapper calls, LAUNCH_COUNTS deltas and the profiler's
    TBE device kernels held to the contract's launch bounds."""
    log("== 2c. kernel contracts on the card (fixtures at the reference's "
        "shapes; sync debug mode 'error'; TBE kernels by the profiler)")
    t0 = time.perf_counter()
    reports = pt.fixtures.run_all(device=DEV, device_kernel=pt.TBE_KERNEL)
    check(len(reports) == len(pt.repo_contracts()),
          "a fixture for every attached contract")
    out = {}
    for r in reports:
        c = r.census
        log(f"  {r.contract.name}: {'ok' if r.ok else 'FAIL'}; wrapper "
            f"calls {c.calls}, launches {c.launches}, TBE device kernels "
            f"{c.device_kernels}, collectives {c.collectives or 'none'}, "
            f"host transfers {c.host_transfers or 'none'}, float dtypes "
            f"{sorted(c.float_dtypes)}")
        for v in r.violations:
            log(f"    - {v}")
        check(r.ok, f"contract {r.contract.name} holds on the card")
        out[r.contract.name] = c.device_kernels
    for name in ONE_TBE_KERNEL:
        check(out[name] == 1, f"{name}: one TBE device kernel per call")
    # injected faults on the card: a .item() (the dispatch census and the
    # sync mode both see it), and a pageable host-to-device copy inside
    # torch.as_tensor, which no dispatch mode sees
    contract = pt.kops.KERNEL_CONTRACTS["tbe_fused"]
    x = torch.randn(64, 16, device=DEV)
    faults = {
        ".item()": lambda v: v * float(v.abs().max().item()),
        "torch.as_tensor(numpy, device=cuda)": lambda v: v + torch.as_tensor(
            np.arange(16, dtype=np.float32), device=v.device),
    }
    for label, fn in faults.items():
        r = pt.audit(fn, (x,), dataclasses.replace(contract, min_launches=0,
                                                   max_launches=0))
        # caught as a host transfer and as nothing else
        caught = bool(r.census.host_transfers) and bool(r.violations) and \
            all(v.startswith("host transfer ") for v in r.violations)
        log(f"  injected {label}: {'caught' if caught else 'NOT CAUGHT'} "
            f"{r.census.host_transfers}; violations {r.violations}")
        check(caught, f"the audit on the card catches an injected {label} "
                      f"as a host transfer")
    log(f"  phase 2c: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 3. / 4. the engine at full width
# ---------------------------------------------------------------------------

def _requests(cfg, CTRRequest, n, seed):
    """Zipf(1.05) ids, lengths in [1, L], -1 padding beyond lengths."""
    from repro_torch.core.jagged import zipf_ranks

    rng = np.random.default_rng(seed)
    t_, l_ = cfg.num_sparse_features, cfg.pooling
    ids = zipf_ranks(rng, 1.05, cfg.rows_per_table,
                     (n, t_, l_)).astype(np.int32)
    lengths = rng.integers(1, l_ + 1, (n, t_)).astype(np.int32)
    ids[np.arange(l_) >= lengths[..., None]] = -1
    dense = rng.standard_normal(
        (n, cfg.num_dense_features)).astype(np.float32)
    return [CTRRequest(rid=i, dense=dense[i], indices=ids[i],
                       lengths=lengths[i]) for i in range(n)]


def _fetched_rows(eng) -> int:
    st = eng.cache_stats()
    return 0 if st is None else st.fetch_host + st.fetch_remote


def _serve(eng, kmods):
    """Flush the whole queue, each flush timed by CUDA events; every
    kernel module's launch counts are set to 0 just before and read just
    after.  Also returns the rows each flush fetched from the cold tier."""
    scores, heads, ms, splits, fetched = {}, [], [], 0, []
    for mod in kmods:
        mod.reset_launch_counts()
    while eng.queue:
        before = _fetched_rows(eng)
        head = eng.queue[: eng.batch_size]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eng.flush()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        fetched.append(_fetched_rows(eng) - before)
        splits += len(out) < len(head)
        heads.append(head)
        scores.update(out)
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    return scores, heads, ms, splits, counts, fetched


def _profile_flush(eng, head, median_ms, label,
                   kernels=("tbe_gather_pool_kernel",), require=True):
    """One more flush of ``head`` under torch.profiler (after the launch
    counts were read): device time by kernel and the device's busy share
    of the median unprofiled flush; checks (``require``) that each of
    ``kernels`` ran.  Returns the idle share in percent and, for each of
    ``kernels``, its device ms and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in head:
        eng.submit(r)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.flush()
    # device-side rows only (kernels, copies); the CPU ops' rows repeat
    # their kernels' time, and the profiler's own buffer requests are not
    # work of the flush
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    ran = {}
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        if require:
            check(bool(mine), f"the profiled {label} flush ran {kernel}")
        ran[kernel] = (sum(e.self_device_time_total for e in mine) / 1e3,
                       sum(e.count for e in mine))
        log(f"  profiled {label} flush: {kernel} {ran[kernel][0]:.4f} ms of "
            f"device time over {ran[kernel][1]} launch(es)")
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"  profiled {label} flush: device busy {busy_ms:.3f} ms = "
        f"{100 * busy_ms / median_ms:.1f}% of the median flush "
        f"({median_ms:.3f} ms); idle {100 - 100 * busy_ms / median_ms:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<3d} "
            f"{e.key[:90]}")
    return 100 - 100 * busy_ms / median_ms, ran


def _padded(eng, head):
    dense, idx, lens = eng._pad_batch(head)
    dev = torch.device(DEV)
    return (torch.as_tensor(dense, device=dev),
            torch.as_tensor(idx, device=dev),
            torch.as_tensor(lens, device=dev))


def phase_uncached(pt, eg, oa) -> dict:
    log("== 3. uncached engine at full width (CONFIG)")
    cfg = pt.CONFIG
    t0 = time.perf_counter()
    params = pt.init_params(torch.Generator(device=DEV).manual_seed(1),
                            cfg, device=DEV)
    torch.cuda.synchronize()
    log(f"  init_params: {cfg.num_sparse_features} x {cfg.rows_per_table} x "
        f"{cfg.embedding_dim} {cfg.dtype} tables "
        f"({cfg.embedding_config().table_bytes / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = _requests(cfg, pt.CTRRequest, REQUESTS, seed=2)
    eng = pt.DLRMEngine(params, cfg, batch_size=BATCH, device=DEV)
    for r in reqs:
        eng.submit(r)
    scores, heads, ms, _, counts, _ = _serve(eng, (eg, oa, pt.fa))
    log(f"  {len(scores)} requests in {len(heads)} flushes; launches "
        f"{counts}; flush ms {[round(m, 3) for m in ms]}, median "
        f"{statistics.median(ms):.3f} ms (CUDA events)")
    vals = np.array(list(scores.values()))
    check(len(scores) == REQUESTS and np.isfinite(vals).all()
          and ((vals > 0) & (vals < 1)).all(), "8192 finite pCTRs in (0, 1)")
    check(counts == _launches(gather_pool_tbe=len(heads)),
          "one fused TBE launch per flush")

    # the plain score on the card: ref.py pooling + the model's own
    # interaction and MLPs
    err = 0.0
    with torch.no_grad():
        for head in heads:
            dense, idx, lens = _padded(eng, head)
            pooled = pt.ref.embedding_bag_batched_ref(
                params["tables"], idx, lens).transpose(0, 1)
            bot = pt.dlrm._mlp_apply(params["bottom"], dense, final_act=True)
            logit = pt.dlrm._mlp_apply(
                params["top"], pt.dlrm.dot_interaction(bot, pooled))[:, 0]
            want = torch.sigmoid(logit)[: len(head)].double().cpu()
            got = torch.tensor([scores[r.rid] for r in head],
                               dtype=torch.float64)
            err = max(err, float((got - want).abs().max()))
            check(bool(torch.allclose(got, want, **PCTR_TOL)),
                  "engine pCTR vs plain score")
    log(f"  engine vs plain score on the card: max_abs_err {err:.3e} "
        f"(rtol={PCTR_TOL['rtol']} atol={PCTR_TOL['atol']}) ok")

    # fused=False: one flush is T single-table launches, same scores
    eng_u = pt.DLRMEngine(params, dataclasses.replace(cfg, fused=False),
                          batch_size=BATCH, device=DEV)
    for r in heads[0]:
        eng_u.submit(r)
    scores_u, _, ms_u, _, counts_u, _ = _serve(eng_u, (eg, oa, pt.fa))
    log(f"  fused=False flush: launches {counts_u}, {ms_u[0]:.3f} ms")
    check(counts_u == _launches(gather_pool=cfg.num_sparse_features),
          "fused=False flush is 26 single-table launches")
    check(all(scores_u[r.rid] == scores[r.rid] for r in heads[0]),
          "fused=False scores bitwise == fused")
    log("  fused=False scores bitwise equal to fused")
    # the paper's fused-against-per-table comparison on the card: the same
    # flush's TBE device time as one launch and as T launches.  The
    # profiler now and then records no kernel at all; a flush whose profile
    # shows none is profiled again, up to 3 times, and any other count
    # fails at once
    tbe = "tbe_gather_pool_kernel"
    for _ in range(3):
        _, fused = _profile_flush(eng, heads[1], statistics.median(ms),
                                  "uncached", require=False)
        _, per_table = _profile_flush(eng_u, heads[1], ms_u[0],
                                      "fused=False", require=False)
        if fused[tbe][1] and per_table[tbe][1]:
            break
    check(fused[tbe][1] == 1 and per_table[tbe][1] == cfg.num_sparse_features,
          "the profiled flushes: 1 fused launch, 26 single-table launches")
    log(f"  TBE device time of one flush: fused {fused[tbe][0]:.4f} ms "
        f"(1 launch), fused=False {per_table[tbe][0]:.4f} ms "
        f"({per_table[tbe][1]} gather_pool launches)")
    return dict(params=params, reqs=reqs, scores=scores, heads=heads,
                flush_ms=ms, unfused_ms=ms_u[0],
                tbe_device_ms=dict(fused=fused[tbe][0],
                                   unfused=per_table[tbe][0]),
                launches={"gather_pool_tbe": counts["gather_pool_tbe"],
                          "gather_pool": counts_u["gather_pool"]})


COUNTERS = ("hits", "misses", "misses_host", "misses_remote", "evictions",
            "fetch_host", "fetch_remote", "bytes_h2d", "bytes_remote")


def _check_pooled(pt, eng, unc, label) -> None:
    """The cached engine's pooled lookups bitwise-equal to the uncached
    ``pooled_lookup_local`` over the full tables, batch by batch."""
    ecfg = pt.CONFIG.embedding_config()
    with torch.no_grad():
        for head in unc["heads"]:
            _, idx, lens = _padded(eng, head)
            slots = eng.cache.prefetch_arrays(idx.cpu().numpy(),
                                              lens.cpu().numpy())
            got = eng.cache.device_lookup(
                eng.cache.pool, torch.as_tensor(slots, device=idx.device),
                lens, None)
            want = pt.eb.pooled_lookup_local(
                unc["params"]["tables"], pt.JaggedBatch(idx, lens), ecfg)
            check(torch.equal(got, want),
                  f"{label} pooled bitwise == uncached")
    log(f"  {label} pooled lookups bitwise equal to uncached "
        f"({len(unc['heads'])} batches)")


def phase_cached(pt, eg, oa, unc) -> dict:
    log("== 4. cached engine at full width (65,536 slots/table, LFU, host "
        "cold tier)")
    cache = pt.CacheConfig(rows=65536, policy="lfu", cold_tier="host")
    cfg = dataclasses.replace(pt.CONFIG, cache=cache)
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH, device=DEV)
    torch.cuda.synchronize()
    log(f"  cache built in {time.perf_counter() - t0:.1f} s: pool "
        f"{eng.cache.pool_bytes / 1e6:.0f} MB on the card, host cold tier "
        f"{eng.cache.cold.tables.numel() * 4 / 1e9:.1f} GB")
    for r in unc["reqs"]:
        eng.submit(r)
    scores, heads, ms, splits, counts, fetched = _serve(eng, (eg, oa, pt.fa))
    st = eng.cache_stats()
    counters = {k: getattr(st, k) for k in COUNTERS}
    log(f"  {len(scores)} requests in {len(heads)} flushes, {splits} "
        f"half-split(s); launches {counts}; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms")
    log(f"  hit rate {st.hit_rate:.4f} ({st.hits} hits, {st.misses} misses),"
        f" {st.evictions} evictions, {st.bytes_h2d / 1e6:.1f} MB h2d; "
        f"prefetch {st.prefetch_s:.3f} s, scatter {st.scatter_s:.3f} s, "
        f"forward {st.forward_s:.3f} s")
    hit_rate = st.hit_rate
    check(counts == _launches(gather_pool_tbe_flat=len(heads)),
          "one fused flat TBE launch per cached flush")
    log(f"  rows fetched from the cold tier per flush: {fetched}")
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          "cached scores bitwise == uncached")
    log("  cached scores bitwise equal to uncached")
    _check_pooled(pt, eng, unc, "cached")
    _profile_flush(eng, unc["heads"][1], statistics.median(ms), "cached")
    return dict(launches=counts["gather_pool_tbe_flat"], flush_ms=ms,
                splits=splits, hit_rate=hit_rate, fetched=fetched,
                counters=counters)


# ---------------------------------------------------------------------------
# 5. times
# ---------------------------------------------------------------------------

def _times(fn, reps, scratch):
    """Per-launch CUDA-event times (ms), L2 evicted before each launch by
    writing a buffer five times its size.  The card spins for about a
    millisecond before each timed region, so that the host has enqueued
    all of ``fn``'s launches before the card reaches them: the time is the
    card's, not the rate at which the host issues launches."""
    evs = []
    for _ in range(reps):
        scratch.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in evs]


def _bound(addr, w, t_, d_, itemsize):
    """Least time: the unique rows this data reads plus ids, weights,
    offsets and output, once each, over HBM; or 2 flops per valid
    element over the fp32 rate; whichever is larger."""
    live = w != 0
    rows = torch.unique(addr[live]).numel()
    n = w.numel()
    nbytes = rows * d_ * itemsize + n * 8 + t_ * 4 + (n // w.shape[-1]) \
        * d_ * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * int(live.sum()) * d_ / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _pow2(m: int) -> int:
    return 1 << (m - 1).bit_length()


def _times_puts(oa, m_pad, scratch) -> dict:
    """The puts of one row fetch (one launch for the 4 simulated hosts) at
    ``m_pad`` padded rows, against the plain exchange and the one PyTorch
    call that computes it; checked bitwise first."""
    g = torch.Generator(device=DEV).manual_seed(5)
    c = _contribs(g, HOSTS, m_pad, D, torch.float32, torch.device(DEV))
    err = _check_puts(oa, c, f"H={HOSTS} M_pad={m_pad} D={D} f32")
    kern = lambda: oa.onesided_put_rows(c)
    plain = lambda: oa.onesided_put_rows_ref(c)
    lib = lambda: c.transpose(0, 1).contiguous()
    check(torch.equal(_bits(lib()), _bits(plain())),
          "onesided_put_rows: library yardstick computes the same exchange")
    p1 = _times(plain, 10, scratch)
    k1 = _times(kern, 10, scratch)
    l1 = _times(lib, 20, scratch)
    k2 = _times(kern, 10, scratch)
    p2 = _times(plain, 10, scratch)
    # each put reads one row and writes it once: 2 * H * (H * M_pad * D)
    # elements; no arithmetic
    bound_ms = 2 * HOSTS * HOSTS * m_pad * D * 4 / HBM_BYTES_PER_S * 1e3
    out = dict(ms=statistics.median(k1 + k2),
               plain_ms=statistics.median(p1 + p2),
               library_ms=statistics.median(l1), bound_ms=bound_ms,
               bound_by="bytes", max_abs_err=err)
    log(f"  onesided_put_rows (H={HOSTS}, M_pad={m_pad}, D={D}, one fetch = "
        f"one launch): kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms (bytes); kernel at "
        f"{100 * bound_ms / out['ms']:.1f}% of the bound")
    return out


def phase_times(eg, oa, x, m_pad) -> dict:
    """The TBE wrappers' times at the phase-2 shapes and the row fetch's
    puts' at ``m_pad`` padded rows."""
    log("== 5. times (f32; median of 20 launches per version, in turns "
        "plain, kernel, library, library, kernel, plain; the card's time, "
        "the host's launches enqueued ahead)")
    F = torch.nn.functional
    tables, idx, w, mask = x["tables"], x["idx"], x["w"], x["mask"]
    flat = tables.view(T * R, D)
    off, idx_r = x["off"], x["idx_r"]
    ar = (torch.arange(T, device=tables.device) * R)[:, None, None]
    g_flat = (off.long()[:, None, None] + torch.where(mask, idx_r, 0)).view(
        T * B, L)
    g_stack = (ar + torch.where(mask, idx, 0)).view(T * B, L)
    one = min(5, T - 1)
    g_one = torch.where(mask[one], idx[one], 0).long()
    cases = {
        "gather_pool_tbe_flat": (
            lambda: eg.gather_pool_tbe_flat(flat, off, idx_r, w),
            lambda: eg.gather_pool_tbe_flat_ref(flat, off, idx_r, w),
            lambda: F.embedding_bag(g_flat, flat, mode="sum",
                                    per_sample_weights=w.view(T * B, L)),
            (g_flat.view(T, B, L), w, T)),
        "gather_pool_tbe": (
            lambda: eg.gather_pool_tbe(tables, idx, w),
            lambda: eg.gather_pool_tbe_ref(tables, idx, w),
            lambda: F.embedding_bag(g_stack, flat, mode="sum",
                                    per_sample_weights=w.view(T * B, L)),
            (g_stack.view(T, B, L), w, T)),
        "gather_pool": (
            lambda: eg.gather_pool(tables[one], idx[one], w[one]),
            lambda: eg.gather_pool_ref(tables[one], idx[one], w[one]),
            lambda: F.embedding_bag(g_one, tables[one], mode="sum",
                                    per_sample_weights=w[one]),
            (g_one[None], w[one][None], 1)),
    }
    scratch = torch.empty(256 * 2 ** 20 // 4, device=tables.device)
    out = {}
    for name, (kern, plain, lib, (addr, ww, t_)) in cases.items():
        want = plain().reshape(-1, D)
        check(bool(torch.allclose(lib().reshape(-1, D), want, **POOL_TOL)),
              f"{name}: library yardstick computes the same function")
        kern()
        p1 = _times(plain, 10, scratch)
        k1 = _times(kern, 10, scratch)
        l1 = _times(lib, 20, scratch)
        k2 = _times(kern, 10, scratch)
        p2 = _times(plain, 10, scratch)
        bound_ms, bound_by = _bound(addr, ww, t_, D, 4)
        out[name] = dict(ms=statistics.median(k1 + k2),
                         plain_ms=statistics.median(p1 + p2),
                         library_ms=statistics.median(l1),
                         bound_ms=bound_ms, bound_by=bound_by)
        log(f"  {name}: kernel {out[name]['ms']:.4f} ms, plain "
            f"{out[name]['plain_ms']:.4f} ms, library "
            f"{out[name]['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); kernel at {100 * bound_ms / out[name]['ms']:.1f}%"
            f" of the bound")
    out["onesided_put_rows"] = _times_puts(oa, m_pad, scratch)
    return out


def _attn_pairs(s, causal, window) -> int:
    """(query, key) pairs that the masks leave at sequence length s."""
    pos = torch.arange(s)
    hi = pos + 1 if causal else torch.full_like(pos, s)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    return int((hi - lo).sum())


def times_flash(pt) -> dict:
    """The flash kernel at granite-8b's layer (1, 16,384, 32/8, 128) bf16
    causal, against its plain version, SDPA (the one PyTorch call that
    computes the same function), the SIMT kernel (the other route, forced
    through ``_launch``, which counts nothing, so that both kernels are
    timed on one card) and the bound: the products QK^T and P.V of the
    live (query, key) pairs over the bf16 tensor-core peak, or q, k, v
    read and o written once over HBM.  The windowed shape is timed too
    (logged; SDPA has no window)."""
    fa, cfg = pt.fa, pt.LM_CONFIG
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=DEV).manual_seed(10)
    scratch = torch.empty(256 * 2 ** 20 // 4, device=DEV)
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {}
    for s, window in ((LONG_PROMPT, None), WINDOWED):
        q, k, v = _qkv(g, 1, s, H, KH, hd, torch.bfloat16)
        kern = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
        simt = lambda: fa._launch(q, k, v, True, window, route="simt")
        plain = lambda: fa.flash_attention_ref(q, k, v, causal=True,
                                               window=window)
        lib = lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), is_causal=True,
                           enable_gqa=True)
        kern()
        compare(f"flash_attention SIMT kernel (1, {s}, {H}/{KH}, {hd}) "
                f"window={window}", simt().float(), plain().float(),
                FLASH_TOL[torch.bfloat16])
        p1 = _times(plain, 1, scratch)
        k1 = _times(kern, 10, scratch)
        s1 = _times(simt, 1, scratch)
        l1 = []
        if window is None:
            check(bool(torch.allclose(lib().transpose(1, 2).float(),
                                      plain().float(), **SDPA_TOL)),
                  "flash_attention: SDPA computes the same function")
            l1 = _times(lib, 10, scratch)
        s2 = _times(simt, 1, scratch)
        k2 = _times(kern, 10, scratch)
        p2 = _times(plain, 1, scratch)
        flops = 4 * _attn_pairs(s, True, window) * H * hd
        t_ops = flops / BF16_FLOPS_PER_S
        t_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) / HBM_BYTES_PER_S
        r = dict(ms=statistics.median(k1 + k2),
                 plain_ms=statistics.median(p1 + p2),
                 library_ms=statistics.median(l1) if l1 else None,
                 bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 simt_ms=statistics.median(s1 + s2))
        lib_txt = (f"SDPA {r['library_ms']:.4f} ms, " if l1 else "")
        log(f"  flash_attention (1, {s}, {H}/{KH}, {hd}) bf16 causal "
            f"window={window} (medians of 20 kernel, 2 SIMT, 2 plain, 10 "
            f"SDPA launches): kernel {r['ms']:.4f} ms, SIMT kernel "
            f"{r['simt_ms']:.3f} ms ({r['simt_ms'] / r['ms']:.1f}x the "
            f"kernel), plain {r['plain_ms']:.3f} ms, {lib_txt}bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.2f}% of the bound, "
            f"{flops / r['ms'] / 1e9:.1f} TFLOP/s")
        if window is None:
            out["flash_attention"] = r
    return out


# ---------------------------------------------------------------------------
# 6. the remote cold tier
# ---------------------------------------------------------------------------

def _serve_remote(pt, eg, oa, unc, cached, backend) -> dict:
    """The phase-4 cache over the remote tier on ``backend``: serve the
    phase-3 requests, check them, profile one flush of fresh requests."""
    cache = pt.CacheConfig(rows=65536, policy="lfu", cold_tier="remote",
                           remote_hosts=HOSTS, remote_backend=backend)
    cfg = dataclasses.replace(pt.CONFIG, cache=cache)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH, device=DEV)
    torch.cuda.synchronize()
    cold = eng.cache.cold
    check(isinstance(cold, pt.RemoteStore) and cold.hosts == HOSTS
          and cold.shards.device.type == "cuda"
          and eng.params["tables"] is None,
          "the engine holds only the slot pool and the shards on the card")
    log(f"  [{backend}] cache built in {time.perf_counter() - t0:.1f} s: "
        f"pool {eng.cache.pool_bytes / 1e6:.0f} MB and {HOSTS} shards of "
        f"{cold.shards.shape[1]} x {cold.shards.shape[2]} rows "
        f"({cold.shards.numel() * 4 / 1e9:.1f} GB) on the card")
    for r in unc["reqs"]:
        eng.submit(r)
    fetches = []
    prev = pt.comm.set_event_sink(fetches.append)
    try:
        scores, heads, ms, splits, counts, fetched = _serve(
            eng, (eg, oa, pt.fa))
    finally:
        pt.comm.set_event_sink(prev)
    st = eng.cache_stats()
    counters = {k: getattr(st, k) for k in COUNTERS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m_pads = [ev.bytes_in // (HOSTS * D * 4) for ev in fetches]
    fetch_ms = [1e3 * (ev.t1 - ev.t0) for ev in fetches]
    log(f"  [{backend}] {len(scores)} requests in {len(heads)} flushes, "
        f"{splits} half-split(s); launches {counts}; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms")
    log(f"  [{backend}] {len(fetches)} fetches: rows {fetched}, padded "
        f"{m_pads}, fetch ms {[round(m, 3) for m in fetch_ms]} (host clock, "
        f"to the payloads on the host); misses host {st.misses_host} / "
        f"remote {st.misses_remote}, {st.bytes_h2d / 1e6:.1f} MB h2d, "
        f"{st.bytes_remote / 1e6:.1f} MB remote; prefetch "
        f"{st.prefetch_s:.3f} s, scatter {st.scatter_s:.3f} s, forward "
        f"{st.forward_s:.3f} s; peak device memory {peak_gb:.1f} GB")
    check(counts["gather_pool_tbe_flat"] == len(heads)
          and counts["gather_pool"] == counts["gather_pool_tbe"] == 0,
          f"[{backend}] one fused flat TBE launch per flush")
    check(len(fetches) == sum(f > 0 for f in fetched) > 0,
          f"[{backend}] one fetch per flush that missed")
    want_puts = len(fetches) if backend == "onesided" else 0
    check(counts["onesided_put_rows"] == want_puts,
          f"[{backend}] {want_puts} put launches (1 per non-empty fetch)")
    # the same admission decisions as the host tier: the same fetches
    check(fetched == cached["fetched"]
          and m_pads == [_pow2(f) for f in fetched if f],
          f"[{backend}] the host tier's fetches, padded to powers of two")
    host = cached["counters"]
    check(all(counters[k] == host[k] for k in
              ("hits", "misses", "evictions"))
          and st.misses_host + st.misses_remote == host["misses"]
          and st.fetch_host + st.fetch_remote == host["fetch_host"],
          f"[{backend}] the host tier's counters, split by owner")
    row_bytes = eng.cache.row_bytes
    check(st.misses_remote > 0
          and st.bytes_remote == st.fetch_remote * row_bytes
          and st.bytes_h2d == st.fetch_host * row_bytes,
          f"[{backend}] remote misses, bytes == fetched rows x row bytes")
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          f"[{backend}] remote-tier scores bitwise == uncached")
    log(f"  [{backend}] scores bitwise equal to uncached")
    _check_pooled(pt, eng, unc, f"[{backend}] remote-tier")
    # a flush of fresh requests, so that the profiled flush fetches
    fresh = _requests(pt.CONFIG, pt.CTRRequest, BATCH, seed=3)
    idle, _ = _profile_flush(
        eng, fresh, statistics.median(ms), f"remote {backend}",
        ("tbe_gather_pool_kernel",) + (
            ("put_chunks_kernel",) if backend == "onesided" else ()))
    return dict(flush_ms=ms, launches=counts["onesided_put_rows"],
                fetches=len(fetches), m_pads=m_pads, fetch_ms=fetch_ms,
                counters=counters, idle=idle, peak_gb=peak_gb)


def phase_remote(pt, eg, oa, unc, cached) -> dict:
    log(f"== 6. cached engine over the remote cold tier (65,536 slots/table,"
        f" LFU, tables row-split over {HOSTS} simulated hosts on the card)")
    out = {}
    for backend in ("bulk", "onesided"):
        out[backend] = _serve_remote(pt, eg, oa, unc, cached, backend)
        torch.cuda.empty_cache()        # the shards of this engine go
    return out


# ---------------------------------------------------------------------------
# 6b. pipelined serving
# ---------------------------------------------------------------------------

def _serve_pipelined(pt, kmods, eng, reqs):
    """``run_to_completion`` of ``reqs`` on a pipelined engine, every
    kernel module's launch counts set to 0 just before and read just
    after.  Wall time on the host clock, up to the last scores on the host
    (the drain's copy waits for the main stream, which waited on the side
    stream's events).  Also returns the remote fetches it made."""
    for r in reqs:
        eng.submit(r)
    fetches = []
    prev = pt.comm.set_event_sink(fetches.append)
    for mod in kmods:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        scores = eng.run_to_completion()
    finally:
        pt.comm.set_event_sink(prev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    return scores, wall_ms, counts, fetches


def _pipelined_engine(pt, unc, label, **cache):
    cfg = dataclasses.replace(pt.CONFIG, cache=pt.CacheConfig(
        policy="lfu", pipeline_depth=2, **cache))
    t0 = time.perf_counter()
    eng = pt.make_dlrm_engine(unc["params"], cfg, BATCH, device=DEV)
    torch.cuda.synchronize()
    ring = eng.cache
    check(isinstance(eng, pt.PipelinedDLRMEngine) and ring.depth == 2
          and isinstance(eng.scheduler.side, torch.cuda.Stream)
          and all(b.cold is ring.buffers[0].cold for b in ring.buffers)
          and all(b.stats is ring.stats for b in ring.buffers),
          f"[{label}] make_dlrm_engine built a depth-2 ring over one cold "
          f"tier, with a side stream")
    log(f"  [{label}] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{ring.depth} pools of {ring.buffers[0].pool_bytes / 1e6:.0f} MB "
        f"({ring.pool_bytes / 1e9:.3f} GB) on the card, one "
        f"{type(ring.buffers[0].cold).__name__} cold tier")
    return eng


def _check_pipelined(pt, eng, unc, scores, label) -> None:
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          f"[{label}] depth-2 scores bitwise == uncached")
    log(f"  [{label}] {len(scores)} scores bitwise equal to phase 3")
    spans = eng.trace.spans
    race = pt.check_timeline(spans, depth=2)
    static = pt.check_scheduler_source()
    log(f"  [{label}] check_timeline over {len(spans)} spans: "
        f"{[str(v) for v in race] or 'clean'}; check_scheduler_source: "
        f"{[str(v) for v in static] or 'clean'}")
    check(not race and not static, f"[{label}] the epoch protocol holds")


def _stage_log(pt, eng, label) -> dict:
    st, tr = eng.cache_stats(), eng.trace
    stages = {s: tr.total(s) for s in pt.STAGES}
    prefetch_ms = [round(1e3 * sum(s.seconds for s in tr.spans
                                   if s.batch == k
                                   and s.stage in ("admit", "fetch")), 3)
                   for k in sorted({s.batch for s in tr.spans})]
    log(f"  [{label}] stage totals (s, host clock): "
        + ", ".join(f"{s} {t:.4f}" for s, t in stages.items())
        + f"; overlap_s {tr.overlap_s():.4f}, overlap_fraction "
        f"{tr.overlap_fraction():.4f}; hit rate {st.hit_rate:.4f} "
        f"({st.misses} misses), {st.fetch_host + st.fetch_remote} rows "
        f"fetched, {st.evictions} evictions, fallbacks "
        f"{eng.scheduler.fallbacks}; admit + fetch ms by batch "
        f"{prefetch_ms}")
    return dict(stages=stages, overlap_s=tr.overlap_s(),
                overlap_fraction=tr.overlap_fraction(),
                hit_rate=st.hit_rate, misses=st.misses,
                fetched=st.fetch_host + st.fetch_remote)


def _stream_overlap(pt_prof) -> dict:
    """Device kernels and copies of a profiled pipelined run, by stream:
    the streams of the scatter's ``index_copy_`` kernels and of the TBE
    launches, and the device time in which a side-stream kernel or copy
    ran while a kernel of the TBE's (main) stream ran."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        pt_prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy")
           and "stream" in e.get("args", {})]
    streams = lambda key: sorted({e["args"]["stream"] for e in dev
                                  if key in e.get("name", "")})
    scatter, tbe = streams("index_copy"), streams("tbe_gather_pool_kernel")
    main = set(tbe)
    fwd = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev
                 if e["args"]["stream"] in main and e["cat"] == "kernel")
    side = [e for e in dev if e["args"]["stream"] not in main]
    both_us, hits = 0.0, 0
    for e in side:
        s0, s1 = e["ts"], e["ts"] + e["dur"]
        inside = sum(max(0.0, min(s1, f1) - max(s0, f0)) for f0, f1 in fwd)
        both_us += inside
        hits += inside > 0
    return dict(scatter_streams=scatter, tbe_streams=tbe,
                side_events=len(side), side_overlapping=hits,
                overlap_ms=both_us / 1e3)


def phase_pipelined(pt, eg, oa, unc, cached, remote) -> dict:
    log("== 6b. pipelined serving (depth 2: two slot pools, prefetch on a "
        "side CUDA stream), phase 3's requests")
    kmods = (eg, oa, pt.fa)
    n_batches = -(-REQUESTS // BATCH)
    out = {}
    # (a) the host cold tier, as phase 4
    eng = _pipelined_engine(pt, unc, "host", rows=65536, cold_tier="host")
    scores, wall, counts, _ = _serve_pipelined(pt, kmods, eng, unc["reqs"])
    serial_ms = sum(cached["flush_ms"])
    log(f"  [host] run_to_completion {wall:.3f} ms (host clock) against "
        f"phase 4's flushes summed {serial_ms:.3f} ms "
        f"({wall / serial_ms:.3f}x); launches {counts}")
    check(counts == _launches(gather_pool_tbe_flat=n_batches),
          "[host] one fused flat TBE launch per micro-batch")
    _check_pipelined(pt, eng, unc, scores, "host")
    out["host"] = dict(wall_ms=wall, serial_ms=serial_ms,
                       pool_bytes=eng.cache.pool_bytes,
                       **_stage_log(pt, eng, "host"))
    log(f"  [host] hit rate {out['host']['hit_rate']:.4f} against phase 4's "
        f"{cached['hit_rate']:.4f} (each pool sees every other batch); "
        f"misses {out['host']['misses']} against "
        f"{cached['counters']['misses']}, rows fetched "
        f"{out['host']['fetched']} against {sum(cached['fetched'])} "
        f"({cached['fetched']} by flush)")
    # (d) one profiled depth-2 run of fresh requests on the same engine
    from torch.profiler import ProfilerActivity, profile

    for r in _requests(pt.CONFIG, pt.CTRRequest, REQUESTS, seed=3):
        eng.submit(r)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_to_completion()
    ov = _stream_overlap(prof)
    log(f"  [profiled] index_copy_ (scatter) kernels on stream(s) "
        f"{ov['scatter_streams']}, TBE launches on stream(s) "
        f"{ov['tbe_streams']}; {ov['side_events']} kernels/copies off the "
        f"TBE's stream, {ov['side_overlapping']} of them ran while a "
        f"kernel of that stream ran ({ov['overlap_ms']:.3f} ms of device "
        f"time)")
    out["profile"] = ov
    del eng, scores
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the remote tier, one-sided, as phase 6
    torch.cuda.reset_peak_memory_stats()
    eng = _pipelined_engine(pt, unc, "remote onesided", rows=65536,
                            cold_tier="remote", remote_hosts=HOSTS,
                            remote_backend="onesided")
    scores, wall, counts, fetches = _serve_pipelined(pt, kmods, eng,
                                                     unc["reqs"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serial_ms = sum(remote["onesided"]["flush_ms"])
    log(f"  [remote onesided] run_to_completion {wall:.3f} ms against "
        f"phase 6's one-sided flushes summed {serial_ms:.3f} ms "
        f"({wall / serial_ms:.3f}x); launches {counts}; {len(fetches)} "
        f"fetches; peak device memory {peak_gb:.1f} GB (phase 6: "
        f"{remote['onesided']['peak_gb']:.1f} GB)")
    check(counts["gather_pool_tbe_flat"] == n_batches
          and counts["onesided_put_rows"] == len(fetches) > 0,
          "[remote onesided] one TBE launch per micro-batch, one put launch "
          "per non-empty fetch")
    _check_pipelined(pt, eng, unc, scores, "remote onesided")
    out["remote"] = dict(wall_ms=wall, serial_ms=serial_ms, peak_gb=peak_gb,
                         puts=counts["onesided_put_rows"],
                         **_stage_log(pt, eng, "remote onesided"))
    del eng, scores
    gc.collect()
    torch.cuda.empty_cache()
    # (c) a pool that half of the micro-batches overflow: the largest
    # per-table working set of each batch, the pool one of the smaller ones
    ws = []
    for head in unc["heads"]:
        idx = np.stack([r.indices for r in head])        # (B, T, L)
        ws.append(max(len(np.unique(idx[:, t][idx[:, t] >= 0]))
                      for t in range(idx.shape[1])))
    slots = sorted(ws)[(len(ws) - 1) // 2]
    eng = _pipelined_engine(pt, unc, "overflow", rows=slots,
                            cold_tier="host")
    scores, wall, counts, _ = _serve_pipelined(pt, kmods, eng, unc["reqs"])
    fallbacks = eng.scheduler.fallbacks
    log(f"  [overflow] {slots} slots a table against the micro-batches' "
        f"largest per-table working sets {ws} (numpy {np.__version__}'s "
        f"draws): {fallbacks} fallback(s), "
        f"{counts['gather_pool_tbe_flat']} TBE launches, run_to_completion "
        f"{wall:.3f} ms")
    check(len(scores) == REQUESTS and not eng.queue and fallbacks >= 1,
          "[overflow] every request scored, at least one fallback")
    _check_pipelined(pt, eng, unc, scores, "overflow")
    out["overflow"] = dict(slots=slots, working_sets=ws, fallbacks=fallbacks,
                           wall_ms=wall,
                           launches=counts["gather_pool_tbe_flat"],
                           **_stage_log(pt, eng, "overflow"))
    del eng, scores
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 6c. the planner -> engine round trip, with telemetry
# ---------------------------------------------------------------------------

PLAN_ZIPF = 1.05             # the traffic skew the planner prices
PLAN_A = dict(num_shards=2, hbm_budget_bytes=0.5e9)   # 10 cached, 16 row
PLAN_B = dict(num_shards=16, hbm_budget_bytes=0.2e9)  # all 26 cached
PLAN_FALLBACK_ROWS = 65_536  # plan A's "row" tables: phase 4's pool


def _plan(pt, **kw):
    """sharding_plan.plan over CONFIG's 26 tables (H100_DGX, Zipf 1.05,
    host tier, flushes of 2048 a shard); returns the plan and its log."""
    cfg = pt.CONFIG
    specs = [pt.sp.TableSpec(f"t{i}", rows=cfg.rows_per_table,
                             dim=cfg.embedding_dim, pooling=cfg.pooling)
             for i in range(cfg.num_sparse_features)]
    t0 = time.perf_counter()
    p = pt.sp.plan(specs, batch_per_shard=BATCH, hw=pt.pm.H100_DGX,
                   zipf_a=PLAN_ZIPF, **kw)
    took = time.perf_counter() - t0
    pools = {}
    for pl in p.placements:
        key = (pl.strategy, pl.cache_rows, round(pl.est_hit_rate, 4))
        pools[key] = pools.get(key, 0) + 1
    return p, (f"planned in {took:.2f} s (host CPU): "
               + ", ".join(f"{n} x {k[0]}" + (f" {k[1]} slots est_hit_rate "
                                              f"{k[2]}" if k[1] else "")
                           for k, n in sorted(pools.items())))


def _hit_gaps(p, stats) -> list:
    """(table, est_hit_rate, measured hit_rate_t) of each cached table."""
    hr = stats.hit_rate_t
    return [(pl.index, pl.est_hit_rate, float(hr[pl.index]))
            for pl in sorted(p.placements, key=lambda q: q.index)
            if pl.strategy == "cached"]


def _log_gaps(label, gaps) -> None:
    err = [m - e for _, e, m in gaps]
    log(f"  [{label}] hit_rate_t against est_hit_rate (logged, not gated): "
        + ", ".join(f"t{t} {m:.4f}/{e:.4f}" for t, e, m in gaps))
    log(f"  [{label}] measured - est: mean {statistics.mean(err):+.4f}, "
        f"min {min(err):+.4f}, max {max(err):+.4f}")


def _telemetry_readout(pt, tel, name, label, lanes) -> dict:
    """Latency quantiles, the Chrome trace (exported to chiprun_out/ and
    validated) and its lanes; each of ``lanes`` must hold spans."""
    h = tel.request_latency(name)
    log(f"  [{label}] request latency (enqueue -> score, host clock): "
        f"{h.count} requests, p50 {1e3 * h.p50:.3f} ms, p99 "
        f"{1e3 * h.p99:.3f} ms, max {1e3 * h.max:.3f} ms")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = tel.export_trace(
        str(out / f"trace_6c_{label.replace(' ', '_')}.json"))
    with open(path) as fh:
        n = pt.obs.validate_chrome_trace(json.load(fh))
    by_lane = {lane: len(tel.tracer.spans(lane=lane))
               for lane in pt.obs.LANES}
    log(f"  [{label}] Chrome trace {os.path.relpath(path, ROOT)}: {n} "
        f"events, valid; spans by lane {by_lane}")
    check(all(by_lane[lane] > 0 for lane in lanes),
          f"[{label}] the {', '.join(lanes)} lanes hold spans")
    return dict(count=h.count, p50=h.p50, p99=h.p99, lanes=by_lane)


def _fit_log(pt, label, res, samples) -> dict:
    """The fitted constants beside H100_DGX's, and stage_time_error for the
    base and the fitted model, on the run's own samples."""
    base, hw = res.base, res.hw
    t_name = "onesided" if res.onesided else "bulk"
    bt, ft = getattr(base, t_name), getattr(hw, t_name)
    err_base = pt.pm.stage_time_error(samples, base, onesided=res.onesided)
    err_fit = res.error(samples)
    log(f"  [{label}] calibrate: {res.n_h2d} h2d and {res.n_remote} "
        f"fetch_remote samples; gather_overhead_s {hw.gather_overhead_s:.6g}"
        f" (H100_DGX {base.gather_overhead_s:.6g}), host_Bps "
        f"{hw.host_Bps:.6g} ({base.host_Bps:.6g}); {t_name} alpha_s "
        f"{ft.alpha_s:.6g} ({bt.alpha_s:.6g}), beta_Bps {ft.beta_Bps:.6g} "
        f"({bt.beta_Bps:.6g})")
    log(f"  [{label}] stage_time_error: H100_DGX "
        f"{ {k: round(v, 4) for k, v in err_base.items()} }, fitted "
        f"{ {k: round(v, 4) for k, v in err_fit.items()} }")
    for name, v in (("gather_overhead_s", hw.gather_overhead_s),
                    ("alpha_s", ft.alpha_s)):
        # a negative intercept is clamped to 0 (the reference's rule)
        check(v >= 0 and np.isfinite(v), f"[{label}] fitted {name} >= 0")
    for name, v in (("host_Bps", hw.host_Bps), ("beta_Bps", ft.beta_Bps)):
        # a zero slope pins the rate to inf (the reference's rule)
        check(v > 0, f"[{label}] fitted {name} > 0 or inf")
    return dict(gather_overhead_s=hw.gather_overhead_s, host_Bps=hw.host_Bps,
                alpha_s=ft.alpha_s, beta_Bps=ft.beta_Bps, n_h2d=res.n_h2d,
                n_remote=res.n_remote, err_base=err_base, err_fit=err_fit)


def phase_planned(pt, eg, oa, unc, cached) -> dict:
    log("== 6c. planner -> engine round trip (sharding_plan.plan at full "
        "width) with telemetry, phase 3's requests")
    t_phase = time.perf_counter()
    kmods = (eg, oa, pt.fa)
    n_batches = -(-REQUESTS // BATCH)
    out = {}
    # (a) plan A on the serialized engine, host tier
    p, msg = _plan(pt, **PLAN_A)
    log(f"  [plan A] {PLAN_A}: {msg}")
    cfg = dataclasses.replace(pt.CONFIG, sharding_plan=p, cache=pt.CacheConfig(
        rows=PLAN_FALLBACK_ROWS, policy="lfu", cold_tier="host"))
    vec = cfg.cache_rows_vector()
    tel = pt.Telemetry()
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH, device=DEV,
                        telemetry=tel)
    torch.cuda.synchronize()
    pool = eng.cache.pool
    want_bytes = (8 * 200_000 + 2 * 100_000 + 16 * PLAN_FALLBACK_ROWS) * D * 4
    log(f"  [plan A] engine built in {time.perf_counter() - t0:.1f} s: S_t "
        f"{eng.cache.mgr.slots_per_table.tolist()}; pool "
        f"{tuple(pool.shape)}, "
        f"{pool.numel() * pool.element_size()} B")
    check(type(eng) is pt.DLRMEngine
          and list(eng.cache.mgr.slots_per_table) == list(vec)
          and eng.params["tables"] is None,
          "[plan A] a serialized engine whose S_t is cfg.cache_rows_vector()")
    check(pool.numel() * pool.element_size() == want_bytes == 1_458_470_912
          == pt.pm.slot_pool_bytes(vec, D) == eng.cache.pool_bytes,
          "[plan A] pool bytes == slot_pool_bytes == 1,458,470,912")
    for r in unc["reqs"]:
        eng.submit(r)
    scores, heads, ms, splits, counts, fetched = _serve(eng, kmods)
    st = eng.cache_stats()
    hit_rate = st.hit_rate
    log(f"  [plan A] {len(scores)} requests in {len(heads)} flushes, "
        f"{splits} half-split(s); launches {counts}; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms "
        f"(phase 4, same run: {statistics.median(cached['flush_ms']):.3f} "
        f"ms); hit rate {st.hit_rate:.4f} (phase 4 {cached['hit_rate']:.4f}),"
        f" rows fetched {fetched}")
    check(counts == _launches(gather_pool_tbe_flat=len(heads)),
          "[plan A] one fused flat TBE launch per flush")
    check(sorted(scores) == sorted(unc["scores"])
          and all(scores[k] == unc["scores"][k] for k in scores),
          "[plan A] scores bitwise == phase 3")
    log("  [plan A] scores bitwise equal to phase 3")
    gaps = _hit_gaps(p, st)
    _log_gaps("plan A", gaps)
    lat = _telemetry_readout(pt, tel, eng.obs_name, "plan A serialized",
                             ("engine", "cache", "request"))
    samples = tel.tracer.stage_samples()
    res = pt.pm.calibrate(samples)
    check(res.n_h2d >= 4, "[plan A] at least 4 h2d samples")
    fit = _fit_log(pt, "plan A", res, samples)
    _check_pooled(pt, eng, unc, "[plan A]")
    out["a"] = dict(flush_ms=ms, launches=counts["gather_pool_tbe_flat"],
                    splits=splits, hit_rate=hit_rate, gaps=gaps,
                    latency=lat, fit=fit, pool_bytes=want_bytes)
    del eng, pool, scores
    gc.collect()
    torch.cuda.empty_cache()

    # (b) plan B (no cache.rows) on the pipelined engine, remote one-sided
    p, msg = _plan(pt, **PLAN_B)
    log(f"  [plan B] {PLAN_B}: {msg}")
    log("  [plan B] priced for the host tier: under 4 one-sided hosts the "
        "planner caches nothing at this width, and the hit-rate prices do "
        "not depend on the tier")
    cfg = dataclasses.replace(pt.CONFIG, sharding_plan=p, cache=pt.CacheConfig(
        rows=0, pipeline_depth=2, cold_tier="remote", remote_hosts=HOSTS,
        remote_backend="onesided"))
    vec = cfg.cache_rows_vector()
    tel = pt.Telemetry()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = pt.make_dlrm_engine(unc["params"], cfg, BATCH, device=DEV,
                              telemetry=tel)
    torch.cuda.synchronize()
    ring = eng.cache
    log(f"  [plan B] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{ring.depth} pools of {ring.buffers[0].pool_bytes} B, S_t "
        f"{sorted(set(vec))} ({sum(vec)} slots a pool)")
    check(isinstance(eng, pt.PipelinedDLRMEngine) and ring.depth == 2
          and cfg.cache.rows == 0
          and all(list(b.mgr.slots_per_table) == list(vec)
                  for b in ring.buffers)
          and all(b.pool_bytes == pt.pm.slot_pool_bytes(vec, D)
                  == 2_150_400_000 for b in ring.buffers),
          "[plan B] make_dlrm_engine built the pipelined engine, both pools "
          "of the plan's S_t (2 x 2,150,400,000 B)")
    for r in unc["reqs"]:
        eng.submit(r)
    # each put launch's stream, read by a wrapper of the chunk-put launcher
    # (it launches nothing itself)
    put_streams, launch = [], oa._launch_all_to_all

    def _recording(x, counter, *args, **kw):
        if counter == "onesided_put_rows":
            put_streams.append(torch.cuda.current_stream(x.device).cuda_stream)
        return launch(x, counter, *args, **kw)

    oa._launch_all_to_all = _recording
    tel.tracer.install_comm_sink()
    for mod in kmods:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        scores = eng.run_to_completion()
    finally:
        tel.tracer.remove_comm_sink()
        oa._launch_all_to_all = launch
    wall = 1e3 * (time.perf_counter() - t0)
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fetches = tel.tracer.spans(lane="comm", name="fetch_rows")
    side = getattr(eng.scheduler.side, "cuda_stream", None)
    log(f"  [plan B] run_to_completion {wall:.3f} ms (host clock); launches "
        f"{counts}; {len(fetches)} fetches, fetch ms "
        f"{[round(1e3 * f.seconds, 3) for f in fetches]}; put launches on "
        f"stream(s) {sorted(set(put_streams))}, the side stream {side}; peak "
        f"device memory {peak_gb:.1f} GB")
    check(counts == _launches(gather_pool_tbe_flat=n_batches,
                              onesided_put_rows=len(fetches))
          and len(fetches) > 0,
          "[plan B] one TBE launch per micro-batch, one put launch per "
          "non-empty fetch")
    check(len(put_streams) == len(fetches)
          and set(put_streams) == {side},
          "[plan B] every put launch issued from the side stream")
    _check_pipelined(pt, eng, unc, scores, "plan B")
    st = eng.cache_stats()
    stages = _stage_log(pt, eng, "plan B")
    gaps = _hit_gaps(p, st)
    _log_gaps("plan B", gaps)
    lat = _telemetry_readout(pt, tel, eng.obs_name, "plan B pipelined",
                             ("request", "pipeline", "comm"))
    samples = tel.tracer.stage_samples()
    res = pt.pm.calibrate(samples, onesided=True)
    check(res.n_remote >= 1, "[plan B] at least 1 fetch_remote sample")
    fit = _fit_log(pt, "plan B", res, samples)
    out["b"] = dict(wall_ms=wall, launches=counts, fetches=len(fetches),
                    hit_rate=st.hit_rate, gaps=gaps, latency=lat, fit=fit,
                    peak_gb=peak_gb, pool_bytes=ring.pool_bytes,
                    stages=stages)
    del eng, ring, scores
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 6c took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 7. the distributed embedding bag
# ---------------------------------------------------------------------------

# (label, DLRMConfig fields, ranks of the model axis); table-wise over 2
# ranks because 26 % 4 != 0
STRATEGIES = (
    ("row/allgather/bulk", dict(sharding="row"), RANKS),
    ("row/a2a/bulk", dict(sharding="row", rw_impl="a2a"), RANKS),
    ("row/a2a/onesided", dict(sharding="row", rw_impl="a2a",
                              rw_backend="onesided"), RANKS),
    ("column", dict(sharding="column"), RANKS),
    ("table", dict(sharding="table"), 2),
)


def _a2a_shapes():
    """The a2a pipeline's per-flush shapes at full width: the phase-1
    bucket capacity C and the phase-3 rows Bl * T."""
    bl = BATCH // RANKS
    n = bl * T * L
    return min(max(1, int(n / RANKS * CAPACITY_FACTOR)), n), bl * T


def _same_bits(got, want) -> bool:
    return got.dtype == want.dtype and got.shape == want.shape \
        and torch.equal(_bits(got), _bits(want))


def _check_chunk(name, got, want, tag) -> float:
    torch.cuda.synchronize()
    err = float((got.double() - want.double()).abs().max())
    ok = _same_bits(got, want)
    log(f"  {name} {tag}: {'bitwise equal' if ok else 'DIFFER'} "
        f"(max_abs_err {err:.3e})")
    check(ok, f"{name} {tag} bitwise == plain version")
    return err


def _check_chunk_kernels(pt, oa) -> dict:
    """The chunk kernels' three wrappers against their plain versions at
    the a2a pipeline's shapes (phase 1 int32, phase 3 f32 and bf16), at
    shapes that are not 16-byte aligned, at 1, 2, 3 and 8 ranks, on int32
    sums that overflow and on f32 sources of -0.0 and exact cancellations,
    bitwise; the bulk routes launch nothing.  Returns each wrapper's
    largest error."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(7)
    cap, rows = _a2a_shapes()
    ids = torch.randint(-T, R * T, (RANKS, RANKS, cap), generator=g,
                        device=dev, dtype=torch.int32)
    part = torch.randn((RANKS, RANKS, rows, D), generator=g, device=dev)
    odd = torch.randn((RANKS, RANKS, 1001), generator=g, device=dev)
    errs = dict.fromkeys(("onesided_all_to_all", "onesided_reduce_scatter",
                          "onesided_ring_permute"), 0.0)
    for tag, x in ((f"phase 1 int32 {tuple(ids.shape)}", ids),
                   (f"phase 3 f32 {tuple(part.shape)}", part),
                   (f"phase 3 bf16 {tuple(part.shape)}",
                    part.to(torch.bfloat16)),
                   ("unaligned bf16 (4, 4, 1001)", odd.to(torch.bfloat16)),
                   ("unaligned int32 (4, 4, 7, 3)", ids[..., :21].reshape(
                       RANKS, RANKS, 7, 3).contiguous())):
        errs["onesided_all_to_all"] = max(
            errs["onesided_all_to_all"], _check_chunk(
                "onesided_all_to_all", oa.onesided_all_to_all(x),
                oa.onesided_all_to_all_ref(x), tag))
    for tag, x in ((f"phase 3 f32 {tuple(part.shape)}", part),
                   (f"phase 3 bf16 {tuple(part.shape)}",
                    part.to(torch.bfloat16)),
                   ("unaligned f32 (4, 4, 1001)", odd)):
        got = oa.onesided_reduce_scatter(x)
        errs["onesided_reduce_scatter"] = max(
            errs["onesided_reduce_scatter"], _check_chunk(
                "onesided_reduce_scatter", got,
                oa.onesided_reduce_scatter_ref(x), tag))
        _check_chunk("onesided_reduce_scatter", got, x.sum(0),
                     tag + " vs the bulk route x.sum(0)")
    # other rank counts at a ragged chunk, every dtype: bitwise at any E,
    # since the pull-sum keeps PyTorch's four partial sums
    for e in (1, 2, 3, 8):
        f = torch.randn((e, e, 1001), generator=g, device=dev)
        i32 = torch.randint(-2**31, 2**31 - 1, (e, e, 1001), generator=g,
                            device=dev, dtype=torch.int32)
        for x in (f, f.to(torch.bfloat16), i32):
            tag = f"E={e} {str(x.dtype)[6:]} {tuple(x.shape)}"
            errs["onesided_all_to_all"] = max(
                errs["onesided_all_to_all"], _check_chunk(
                    "onesided_all_to_all", oa.onesided_all_to_all(x),
                    oa.onesided_all_to_all_ref(x), tag))
            got = oa.onesided_reduce_scatter(x)
            errs["onesided_reduce_scatter"] = max(
                errs["onesided_reduce_scatter"], _check_chunk(
                    "onesided_reduce_scatter", got,
                    oa.onesided_reduce_scatter_ref(x), tag))
            _check_chunk("onesided_reduce_scatter", got,
                         x.sum(0, dtype=x.dtype), tag + " vs x.sum(0)")
    # int32 partials over the whole range at phase 1's shape: the sums wrap
    wrap = torch.randint(-2**31, 2**31 - 1, tuple(ids.shape), generator=g,
                         device=dev, dtype=torch.int32)
    wide = wrap.long().sum(0)
    check(bool((wide != wide.int().long()).any()), "the int32 sums overflow")
    got = oa.onesided_reduce_scatter(wrap)
    _check_chunk("onesided_reduce_scatter", got,
                 oa.onesided_reduce_scatter_ref(wrap),
                 f"int32 {tuple(wrap.shape)} that wraps")
    check(torch.equal(got.long(), (wide + 2**31) % 2**32 - 2**31),
          "the int32 reduce-scatter wraps modulo 2**32")
    # f32 sources: rank 1 cancels rank 0 exactly, ranks 2 and 3 hold -0.0;
    # in the first 64 elements every source is -0.0
    zeros = torch.full((RANKS, RANKS, 4096), -0.0, device=dev)
    zeros[0] = torch.randn((RANKS, 4096), generator=g, device=dev)
    zeros[1] = -zeros[0]
    zeros[..., :64] = -0.0
    got = oa.onesided_reduce_scatter(zeros)
    _check_chunk("onesided_reduce_scatter", got,
                 oa.onesided_reduce_scatter_ref(zeros),
                 "f32 -0.0 and cancellations")
    _check_chunk("onesided_reduce_scatter", got, zeros.sum(0),
                 "f32 -0.0 and cancellations vs x.sum(0)")
    check(_same_bits(got, torch.zeros_like(got)),
          "-0.0 sources and exact cancellations sum to +0.0")
    ring = part[0]
    for tag, x in ((f"f32 {tuple(ring.shape)}", ring),
                   ("unaligned bf16 (4, 1001)", odd[0].to(torch.bfloat16))):
        for shift in (1, 3):
            got = oa.onesided_ring_permute(x, shift)
            errs["onesided_ring_permute"] = max(
                errs["onesided_ring_permute"], _check_chunk(
                    "onesided_ring_permute", got,
                    oa.onesided_ring_permute_ref(x, shift),
                    f"{tag} shift {shift}"))
            _check_chunk("onesided_ring_permute", got,
                         torch.roll(x, shift, 0),
                         f"{tag} shift {shift} vs torch.roll")
    oa.reset_launch_counts()
    pt.comm.all_to_all(ids, backend="bulk")
    pt.comm.reduce_scatter(part, backend="bulk")
    pt.comm.reduce_scatter(part, backend="bulk", emulate_with_a2a=True)
    pt.comm.permute_ring(ring, backend="bulk")
    torch.cuda.synchronize()
    check(set(oa.LAUNCH_COUNTS.values()) == {0},
          "the bulk routes launch no put kernel")
    log("  bulk all_to_all / reduce_scatter / permute_ring: 0 put launches")
    return errs


def _uniform_requests(cfg, CTRRequest, n, seed):
    """The no-drop traffic: uniform ids, every length L."""
    rng = np.random.default_rng(seed)
    t_, l_ = cfg.num_sparse_features, cfg.pooling
    ids = rng.integers(0, cfg.rows_per_table, (n, t_, l_)).astype(np.int32)
    dense = rng.standard_normal(
        (n, cfg.num_dense_features)).astype(np.float32)
    lengths = np.full((n, t_), l_, np.int32)
    return [CTRRequest(rid=i, dense=dense[i], indices=ids[i],
                       lengths=lengths[i]) for i in range(n)]


def _pooled_pairs(pt, eng, unc, heads, ecfg):
    """(sharded, uncached) pooled vectors of each head, batch by batch."""
    with torch.no_grad():
        for head in heads:
            _, idx, lens = _padded(eng, head)
            batch = pt.JaggedBatch(idx, lens)
            yield (pt.eb.pooled_lookup_sharded(eng.params["tables"], batch,
                                               ecfg),
                   pt.eb.pooled_lookup_local(unc["params"]["tables"], batch,
                                             pt.CONFIG.embedding_config()))


def _dropped(pt, eng, heads, ecfg):
    """Dropped lookups per rank of each flush's batch."""
    out = []
    with torch.no_grad():
        for head in heads:
            _, idx, lens = _padded(eng, head)
            _, d = pt.eb.pooled_lookup_rw_a2a_with_stats(
                eng.params["tables"], pt.JaggedBatch(idx, lens), ecfg)
            out.append(d.tolist())
    return out


def _serve_strategy(pt, eg, oa, unc, label, fields, ranks, nodrop) -> dict:
    cfg = dataclasses.replace(pt.CONFIG, **fields)
    ecfg = cfg.embedding_config()
    t0 = time.perf_counter()
    eng = pt.DLRMEngine(unc["params"], cfg, batch_size=BATCH,
                        ctx=pt.make_context(tp_size=ranks), device=DEV)
    torch.cuda.synchronize()
    log(f"  [{label}] {ranks} ranks; tables sharded in "
        f"{time.perf_counter() - t0:.2f} s")
    for r in unc["reqs"]:
        eng.submit(r)
    scores, heads, ms, _, counts, _ = _serve(eng, (eg, oa, pt.fa))
    n = len(heads)
    log(f"  [{label}] {len(scores)} requests in {n} flushes; launches "
        f"{ {k: v for k, v in counts.items() if v} }; flush ms "
        f"{[round(m, 3) for m in ms]}, median {statistics.median(ms):.3f} ms")
    vals = np.array([scores[k] for k in sorted(scores)])
    check(sorted(scores) == sorted(unc["scores"]) and np.isfinite(vals).all()
          and ((vals > 0) & (vals < 1)).all(),
          f"[{label}] 8192 finite pCTRs in (0, 1)")
    want = np.array([unc["scores"][k] for k in sorted(scores)])
    out = dict(flush_ms=ms, counts=counts, scores=scores, heads=heads,
               pctr_err=float(np.abs(vals - want).max()))
    if label == "row/allgather/bulk":
        check(counts == _launches(gather_pool_tbe_flat=ranks * n),
              f"[{label}] one fused flat TBE launch per rank per flush")
        check(bool(np.allclose(vals, want, **PCTR_TOL)),
              f"[{label}] pCTR within tolerance of uncached")
        err = 0.0
        for got, ref in _pooled_pairs(pt, eng, unc, heads, ecfg):
            err = max(err, compare(f"[{label}] pooled vs uncached", got, ref,
                                   POOL_TOL))
        log(f"  [{label}] pCTR vs uncached max_abs_err "
            f"{out['pctr_err']:.3e} (rtol={PCTR_TOL['rtol']} "
            f"atol={PCTR_TOL['atol']}); pooled max_abs_err {err:.3e}")
    elif label.startswith("row/a2a"):
        # one launch per collective call: 3 all-to-alls, 1 reduce-scatter
        puts = dict(onesided_all_to_all=3 * n, onesided_reduce_scatter=n) \
            if label.endswith("onesided") else {}
        check(counts == _launches(**puts),
              f"[{label}] {sum(puts.values()) // n} chunk-kernel launches "
              f"per flush, no TBE launch")
        out["dropped"] = _dropped(pt, eng, heads, ecfg)
        live = [int(lens.sum()) for lens in (
            _padded(eng, h)[2] for h in heads)]
        log(f"  [{label}] dropped lookups per flush (per rank): "
            f"{out['dropped']}; of {live} live lookups")
        # the no-drop traffic: nothing dropped, and uncached's scores
        for r in nodrop["reqs"]:
            eng.submit(r)
        s_nd, h_nd, _, _, c_nd, _ = _serve(eng, (eg, oa, pt.fa))
        d_nd = _dropped(pt, eng, h_nd, ecfg)
        check(all(v == 0 for d in d_nd for v in d),
              f"[{label}] no lookup dropped on the no-drop traffic")
        check(c_nd == _launches(**{k: v // n for k, v in puts.items()}),
              f"[{label}] the no-drop flush's launches")
        got = np.array([s_nd[k] for k in sorted(s_nd)])
        ref = np.array([nodrop["scores"][k] for k in sorted(s_nd)])
        check(bool(np.allclose(got, ref, **PCTR_TOL)),
              f"[{label}] no-drop pCTR within tolerance of uncached")
        err = 0.0
        for g_, w_ in _pooled_pairs(pt, eng, unc, h_nd, ecfg):
            err = max(err, compare(f"[{label}] no-drop pooled vs uncached",
                                   g_, w_, POOL_TOL))
        log(f"  [{label}] no-drop traffic: dropped {d_nd}; pCTR vs "
            f"uncached max_abs_err {float(np.abs(got - ref).max()):.3e}; "
            f"pooled max_abs_err {err:.3e}")
        out["nodrop_err"] = float(np.abs(got - ref).max())
        out["eng"] = eng
    else:
        check(counts == _launches(gather_pool_tbe=ranks * n),
              f"[{label}] one fused TBE launch per rank per flush")
        check(all(scores[k] == unc["scores"][k] for k in scores),
              f"[{label}] scores bitwise == uncached")
        for got, ref in _pooled_pairs(pt, eng, unc, heads, ecfg):
            check(torch.equal(got, ref), f"[{label}] pooled bitwise == "
                                         f"uncached")
        log(f"  [{label}] scores and pooled lookups bitwise equal to "
            f"uncached")
    return out


def _times_chunks(pt, oa) -> dict:
    """The three wrappers at the shapes the a2a pipeline gives them (one
    launch each): the all-to-all at phase 1's int32 buckets, the
    reduce-scatter at phase 3's f32 partials, the ring at a rank's block of
    them; against the plain version, the one PyTorch call that computes the
    same function, and the bytes bound.  The all-to-all alone at phase 3's
    shape is timed too (logged, not in the kernels line)."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(8)
    cap, rows = _a2a_shapes()
    part = torch.randn((RANKS, RANKS, rows, D), generator=g, device=dev)
    ids = torch.randint(0, R * T, (RANKS, RANKS, cap), generator=g,
                        device=dev, dtype=torch.int32)
    ring = part[0]
    scratch = torch.empty(256 * 2 ** 20 // 4, device=dev)
    nbytes = part.numel() * 4
    cases = {
        "onesided_all_to_all": (
            lambda: oa.onesided_all_to_all(ids),
            lambda: oa.onesided_all_to_all_ref(ids),
            lambda: ids.transpose(0, 1).contiguous(),
            2 * ids.numel() * 4, 0),
        "onesided_reduce_scatter": (
            lambda: oa.onesided_reduce_scatter(part),
            lambda: oa.onesided_reduce_scatter_ref(part),
            lambda: part.sum(0),
            nbytes + nbytes // RANKS, part.numel() - part[0].numel()),
        "onesided_ring_permute": (
            lambda: oa.onesided_ring_permute(ring, 1),
            lambda: oa.onesided_ring_permute_ref(ring, 1),
            lambda: torch.roll(ring, 1, 0),
            2 * ring.numel() * 4, 0),
        "phase-3 all-to-all alone (f32)": (
            lambda: oa.onesided_all_to_all(part),
            lambda: oa.onesided_all_to_all_ref(part),
            lambda: part.transpose(0, 1).contiguous(),
            2 * nbytes, 0),
    }
    out = {}
    for name, (kern, plain, lib, moved, flops) in cases.items():
        check(_same_bits(lib(), plain()),
              f"{name}: library yardstick computes the same function")
        kern()
        p1 = _times(plain, 10, scratch)
        k1 = _times(kern, 10, scratch)
        l1 = _times(lib, 20, scratch)
        k2 = _times(kern, 10, scratch)
        p2 = _times(plain, 10, scratch)
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = flops / FP32_FLOPS_PER_S
        out[name] = dict(ms=statistics.median(k1 + k2),
                         plain_ms=statistics.median(p1 + p2),
                         library_ms=statistics.median(l1),
                         bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
        r = out[name]
        log(f"  {name} ({moved / 1e6:.1f} MB moved): kernel {r['ms']:.4f} "
            f"ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound")
    return out


def phase_distributed(pt, eg, oa, unc) -> dict:
    log(f"== 7. the distributed embedding bag ({RANKS} simulated ranks on "
        f"the card, table-wise over 2; phase 3's tables)")
    torch.cuda.reset_peak_memory_stats()
    errs = _check_chunk_kernels(pt, oa)
    # the no-drop traffic's uncached scores
    nd_reqs = _uniform_requests(pt.CONFIG, pt.CTRRequest, BATCH, seed=4)
    eng = pt.DLRMEngine(unc["params"], pt.CONFIG, batch_size=BATCH,
                        device=DEV)
    for r in nd_reqs:
        eng.submit(r)
    nodrop = dict(reqs=nd_reqs, scores=eng.run_to_completion())
    del eng
    out = {}
    for label, fields, ranks in STRATEGIES:
        out[label] = _serve_strategy(pt, eg, oa, unc, label, fields, ranks,
                                     nodrop)
        torch.cuda.empty_cache()            # the column copy goes
    bulk, ones = out["row/a2a/bulk"], out["row/a2a/onesided"]
    check(bulk["dropped"] == ones["dropped"],
          "both backends drop the same lookups")
    same = all(bulk["scores"][k] == ones["scores"][k]
               for k in bulk["scores"])
    err = max(abs(bulk["scores"][k] - ones["scores"][k])
              for k in bulk["scores"])
    log(f"  row/a2a onesided vs bulk scores: "
        f"{'bitwise equal' if same else 'not bitwise'} (max_abs_err "
        f"{err:.3e})")
    check(same or err <= PCTR_TOL["atol"],
          "onesided a2a scores within tolerance of bulk")
    out["a2a_bitwise"] = same
    out["idle"], _ = _profile_flush(
        ones["eng"], unc["heads"][1],
        statistics.median(ones["flush_ms"]), "row/a2a/onesided",
        ("put_chunks_kernel", "sum_chunks_kernel"))
    del bulk["eng"], ones["eng"]
    times = _times_chunks(pt, oa)
    # the ring collective through its comm entry point (no serving path
    # calls it, in the reference either): one put launch for all ranks
    oa.reset_launch_counts()
    x = torch.randn((RANKS, _a2a_shapes()[1], D), device=DEV)
    got = pt.comm.permute_ring(x, shift=1, backend="onesided")
    ring_launches = oa.LAUNCH_COUNTS["onesided_ring_permute"]
    check(ring_launches == 1 and _same_bits(got, torch.roll(x, 1, 0)),
          "comm.permute_ring(backend='onesided'): one launch per call")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  comm.permute_ring(backend='onesided'): {ring_launches} launches;"
        f" peak device memory in this phase {out['peak_gb']:.1f} GB")
    out["errs"], out["times"] = errs, times
    out["launches"] = dict(
        onesided_all_to_all=ones["counts"]["onesided_all_to_all"],
        onesided_reduce_scatter=ones["counts"]["onesided_reduce_scatter"],
        onesided_ring_permute=ring_launches)
    return out


# ---------------------------------------------------------------------------
# 7t. DLRM training at full width
# ---------------------------------------------------------------------------

# the test_dlrm flow's steps on its one batch: at CONFIG's width and lr
# 0.05 the loss first rises (the first row-wise Adagrad step moves each
# touched element by about lr), in the reference as well
# (tests/test_torch_train.py), and falls under its start by step 20
TRAIN_STEPS = 20
TRAIN_LR = 0.05
TRAIN_SEED = 11
# the card's gradient against a float64 sum of the same f32 contributions
# on the host: n terms summed in f32 in any order are within
# n * 2**-24 * sum|c| of the exact sum (each of the n - 1 additions rounds
# once; the host sum's own error is ~1e-16 relative)
SEGSUM_ULP = 2.0 ** -24
# small-size backwards on the card against autograd of the plain versions:
# two f32 orders of a few terms
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp_leaves(params) -> list:
    return [layer[k] for group in ("bottom", "top")
            for layer in params[group] for k in ("w", "b")]


def _all_counts(kmods) -> dict:
    return {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}


def _find_node(root, name):
    """The autograd node named ``name`` in the graph under ``root``."""
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if node.name() == name:
            return node
        todo.extend(n for n, _ in node.next_functions)
    raise RuntimeError(f"no {name} node in the graph")


def _segsum_host(g, flat_ids, live):
    """The float64 segment sum on the host of the live slots' f32
    contributions ``g[t, b]`` (weight 1) into their flat rows: (rows,
    sums, |terms| sums, term counts), rows sorted."""
    t_i, b_i, _ = torch.nonzero(live, as_tuple=True)
    contrib = g[t_i, b_i].double().cpu().numpy()           # (n_live, D)
    ids = flat_ids[live].cpu().numpy()
    order = np.argsort(ids, kind="stable")
    ids, contrib = ids[order], contrib[order]
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    rows = ids[starts]
    sums = np.add.reduceat(contrib, starts, axis=0)
    abs_sums = np.add.reduceat(np.abs(contrib), starts, axis=0)
    counts = np.diff(np.r_[starts, ids.size])
    return rows, sums, abs_sums, counts


def _check_segsum(label, d_flat, host) -> float:
    """The card's gradient rows against the host's float64 sums, each
    element within ``n * 2**-24 * sum|c|``; returns the largest error."""
    rows, sums, abs_sums, counts = host
    got = d_flat[torch.as_tensor(rows, device=d_flat.device)].double(
        ).cpu().numpy()
    err = np.abs(got - sums)
    bound = counts[:, None] * SEGSUM_ULP * abs_sums
    ok = bool((err <= bound).all())
    log(f"  {label}: {rows.size} live rows (up to {int(counts.max())} "
        f"terms a row) against the float64 host sum: max_abs_err "
        f"{err.max():.3e}, largest share of its bound "
        f"{float((err / np.maximum(bound, 1e-300)).max()):.3f} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label} within n * 2**-24 * sum|c| of the float64 sum")
    return float(err.max())


def _small_backwards(pt, eg) -> None:
    """At a small size on the card: the fused, unfused and flat ops'
    gradients (tables and weights) against autograd of the plain
    versions on the same inputs."""
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
    t_, r_, d_, b_, l_ = 4, 1000, D, 64, 8
    tables = torch.randn((t_, r_, d_), generator=g, device=dev)
    lens = torch.randint(0, l_ + 1, (t_, b_), generator=g, device=dev,
                         dtype=torch.int32)
    live = torch.arange(l_, device=dev) < lens[..., None]
    idx = torch.where(live, torch.randint(0, r_, (t_, b_, l_), generator=g,
                                          device=dev, dtype=torch.int32), -1)
    w = torch.rand((t_, b_, l_), generator=g, device=dev)
    flat = tables.view(t_ * r_, d_)
    off = (torch.arange(t_, device=dev) * r_).to(torch.int32)
    cases = {
        "fused": (lambda tb, ww: pt.kops.embedding_bag_batched(
            tb, idx, lens, ww, fused=True), tables),
        "unfused": (lambda tb, ww: pt.kops.embedding_bag_batched(
            tb, idx, lens, ww, fused=False), tables),
        "flat": (lambda tb, ww: pt.kops.embedding_bag_batched_flat(
            tb, off, idx, lens, ww), flat),
    }
    plain = {
        "fused": lambda tb, ww: pt.ref.embedding_bag_batched_ref(
            tb, torch.where(live, idx, 0), lens, ww),
        "unfused": lambda tb, ww: torch.stack([
            pt.ref.embedding_bag_ref(tb[t], torch.where(live[t], idx[t], 0),
                                     lens[t], ww[t]) for t in range(t_)]),
        "flat": lambda tb, ww: pt.ref.embedding_bag_batched_flat_ref(
            tb, off, torch.where(live, idx, 0), lens, ww),
    }
    expect = {"fused": {"gather_pool_tbe": 1}, "unfused": {"gather_pool": t_},
              "flat": {"gather_pool_tbe_flat": 1}}
    for name, (fn, base) in cases.items():
        grads = []
        for f in (fn, plain[name]):
            tb = base.clone().requires_grad_()
            ww = w.clone().requires_grad_()
            eg.reset_launch_counts()
            out = f(tb, ww)
            grads.append(torch.autograd.grad((out ** 2).sum(), (tb, ww)))
            if f is fn:
                launches = {k: v for k, v in eg.LAUNCH_COUNTS.items() if v}
        for what, got, want in zip(("d tables", "d eff_w"), *grads):
            compare(f"{name} backward {what} (T={t_}, R={r_}, B={b_}, "
                    f"L={l_})", got, want, GRAD_TOL)
        log(f"    {name}: launches of the forward and backward {launches}")
        check(launches == expect[name],
              f"{name}: the forward's launches, none in the backward")


class _GradProbe:
    """Step 0's checks, between its backward and its update: the upstream
    gradient of the TBE forward (taken by a prehook on its backward node)
    summed per row in float64 on the host against the card's d tables;
    zero rows; a second backward on the same graph; and the same step's
    gradient through the unfused path (26 single-table launches)."""

    def __init__(self, pt, kmods, params, flat_ids, live, touched, inputs):
        self.pt, self.kmods, self.params = pt, kmods, params
        self.flat_ids, self.live, self.touched = flat_ids, live, touched
        self.inputs = inputs
        self.g, self.out = [], {}

    def attach(self, loss) -> None:
        node = _find_node(loss.grad_fn, "_PooledLookupTBEBackward")
        node.register_prehook(lambda grad_out: self.g.append(grad_out[0]))

    def check(self, loss, leaves, grads) -> None:
        pt, out = self.pt, self.out
        T_, R_, D_ = leaves[0].shape
        d_flat = grads[0].view(T_ * R_, D_)
        host = _segsum_host(self.g[0], self.flat_ids, self.live)
        out["max_abs_err"] = _check_segsum("d tables (fused)", d_flat, host)
        check(not bool(((d_flat != 0).any(-1) & ~self.touched).any()),
              "d tables exactly zero on every untouched row")
        log("  d tables: exactly zero on every untouched row")
        # the same backward again on the same graph: the atomic adds land
        # in another order
        (again,) = torch.autograd.grad(loss, [leaves[0]])
        rows = torch.as_tensor(host[0], device=d_flat.device)
        out["run_diff"] = float((again.view(T_ * R_, D_)[rows]
                                 - d_flat[rows]).abs().max())
        log(f"  two backward runs on identical inputs: max_abs_diff "
            f"{out['run_diff']:.3e} over the live rows "
            f"({'bitwise equal' if out['run_diff'] == 0 else 'not bitwise'})")
        del again
        # the unfused path at full width: T single-table launches forward,
        # none backward, the same gradient within the same bound
        dense, batch, labels, cfg = self.inputs
        for mod in self.kmods:
            mod.reset_launch_counts()
        loss_u = pt.dlrm.bce_loss(self.params, dense, batch, labels,
                                  dataclasses.replace(cfg, fused=False))
        fwd = _all_counts(self.kmods)
        (d_u,) = torch.autograd.grad(loss_u, [leaves[0]])
        check(fwd == _launches(gather_pool=T_)
              and _all_counts(self.kmods) == fwd,
              "fused=False training: T gather_pool launches forward, none "
              "backward")
        out["unfused_launches"] = fwd["gather_pool"]
        out["unfused_err"] = _check_segsum("d tables (fused=False)",
                                           d_u.view(T_ * R_, D_), host)
        del d_u, loss_u


def _train_step(pt, kmods, params, accum, inputs, probe=None):
    """One step of the flow: the loss (``dlrm.bce_loss``), the gradients of
    the tables and every MLP leaf (``torch.autograd.grad``), row-wise
    Adagrad on the tables and SGD on the MLPs.  Returns the loss, the new
    tables, accum and MLP leaves (the caller commits them), the stages'
    CUDA-event times and each stage's own launches (forward, backward,
    update).  ``probe`` runs between the backward and the update, outside
    the timed stages and the counts."""
    leaves = [params["tables"]] + _mlp_leaves(params)
    for p in leaves:
        p.requires_grad_()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for mod in kmods:
        mod.reset_launch_counts()
    ev[0].record()
    loss = pt.dlrm.bce_loss(params, *inputs)
    ev[1].record()
    marks = [_all_counts(kmods)]
    if probe is not None:
        probe.attach(loss)
    grads = torch.autograd.grad(loss, leaves,
                                retain_graph=probe is not None)
    ev[2].record()
    marks.append(_all_counts(kmods))
    if probe is not None:
        probe.check(loss, leaves, grads)
    value = loss.detach()
    del loss
    marks.append(_all_counts(kmods))
    ev[3].record()
    with torch.no_grad():
        new, accum = pt.rowwise_adagrad_update(
            params["tables"].detach(), accum, grads[0], lr=TRAIN_LR)
        mlp = [p.detach() - TRAIN_LR * gg
               for p, gg in zip(leaves[1:], grads[1:])]
    ev[4].record()
    marks.append(_all_counts(kmods))
    counts = [marks[0]] + [{k: b[k] - a[k] for k in a}
                           for a, b in ((marks[0], marks[1]),
                                        (marks[2], marks[3]))]
    del grads
    torch.cuda.synchronize()
    ms = dict(forward=ev[0].elapsed_time(ev[1]),
              backward=ev[1].elapsed_time(ev[2]),
              update=ev[3].elapsed_time(ev[4]))
    return value, new, accum, mlp, ms, counts


def _commit(params, new, mlp) -> None:
    params["tables"] = new
    for layer, (w, b) in zip([layer for group in ("bottom", "top")
                              for layer in params[group]],
                             zip(mlp[0::2], mlp[1::2])):
        layer["w"], layer["b"] = w, b


def _profile_step(pt, kmods, params, accum, inputs, step_ms) -> dict:
    """One more step under torch.profiler, its results dropped: the TBE
    device kernels it ran, the device's busy time and its idle share of
    the median unprofiled step.  A profile with no device event at all is
    taken again, up to 3 times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = _train_step(pt, kmods, params, accum, inputs)
        del out
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("Activity Buffer")]
        if events:
            break
    tbe = sum(e.count for e in events if "tbe_gather_pool_kernel" in e.key)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    idle = 100 - 100 * busy / step_ms
    log(f"  profiled step: {tbe} TBE device kernel(s); device busy "
        f"{busy:.3f} ms of the median step's {step_ms:.3f} ms; idle "
        f"{idle:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    check(tbe == 1, "the profiled step ran one TBE device kernel")
    return dict(tbe_kernels=tbe, busy_ms=busy, idle=idle)


def phase_train(pt, eg, oa) -> dict:
    """The test_dlrm training flow at CONFIG's full width on the card:
    fresh tables from a seed (phase 3's are freed before; no later check
    reads the trained ones), one Zipf(1.05) batch of B=2048 from
    dlrm_batches with -1 past each length, TRAIN_STEPS steps of row-wise
    Adagrad on the tables and SGD on the MLPs at lr 0.05."""
    cfg = pt.CONFIG
    T_, R_, D_, L_ = (cfg.num_sparse_features, cfg.rows_per_table,
                      cfg.embedding_dim, cfg.pooling)
    log(f"== 7t. DLRM training at full width ({T_} x {R_} x {D_} "
        f"{cfg.dtype}, B={BATCH}, {TRAIN_STEPS} steps, lr {TRAIN_LR})")
    kmods = (eg, oa, pt.fa)
    dev = torch.device(DEV)
    t0 = time.perf_counter()
    _small_backwards(pt, eg)
    torch.cuda.empty_cache()
    log(f"  device memory held by earlier phases: "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    params = pt.init_params(torch.Generator(device=dev).manual_seed(
        TRAIN_SEED), cfg, device=dev)
    data = next(pt.dlrm_batches(cfg, BATCH, seed=TRAIN_SEED, zipf_a=1.05,
                                fixed_pooling=False, device=dev))
    lens = data["batch"].lengths
    live = torch.arange(L_, device=dev) < lens[..., None]
    batch = pt.JaggedBatch(torch.where(live, data["batch"].indices, -1)
                           .to(torch.int32), lens)
    inputs = (data["dense"], batch, data["labels"], cfg)
    flat_ids = (torch.where(live, batch.indices, 0).long()
                + torch.arange(T_, device=dev)[:, None, None] * R_)
    touched = torch.zeros(T_ * R_, dtype=torch.bool, device=dev)
    touched[flat_ids[live]] = True
    log(f"  {int(live.sum())} live lookups of {T_ * BATCH * L_}, "
        f"{int(touched.sum())} touched rows of {T_ * R_}")

    # the forward with the tables requiring grad: bitwise the wrapper's
    ecfg = cfg.embedding_config()
    tables = params["tables"].requires_grad_()
    trained = pt.eb.pooled_lookup_local(tables, batch, ecfg)
    with torch.no_grad():
        served = pt.eb.pooled_lookup_local(tables, batch, ecfg)
        wrapper = eg.gather_pool_tbe(
            tables, pt.kops._safe_ids(batch.indices, lens),
            pt.kops._effective_weights(batch.indices, lens, None))
    check(trained.requires_grad and torch.equal(trained.detach(), served)
          and torch.equal(served, wrapper.transpose(0, 1)),
          "the training forward's pooled output bitwise == the wrapper's")
    log("  pooled output with grad, without, and the wrapper's: bitwise "
        "equal")
    del trained, served, wrapper, tables

    accum = pt.rowwise_adagrad_init(params["tables"])
    probe = _GradProbe(pt, kmods, params, flat_ids, live, touched, inputs)
    losses, stages, fwd_launches = [], [], 0
    for step in range(TRAIN_STEPS):
        loss, new, accum, mlp, ms, counts = _train_step(
            pt, kmods, params, accum, inputs,
            probe=probe if step == 0 else None)
        old = params["tables"].detach()
        moved = (new.view(torch.int32) != old.view(torch.int32)).any(-1)
        check(not bool((moved.view(-1) & ~touched).any()),
              f"step {step}: every untouched row bitwise unchanged")
        check(not bool(((accum != 0).view(-1) & ~touched).any()),
              f"step {step}: accum non-zero only on touched rows")
        del moved, old
        _commit(params, new, mlp)
        del new, mlp
        fwd, bwd, upd = counts
        check(fwd == _launches(gather_pool_tbe=1),
              f"step {step}: the forward is one gather_pool_tbe launch")
        check(bwd == upd == _launches(),
              f"step {step}: the backward and the update launch nothing")
        fwd_launches += fwd["gather_pool_tbe"]
        losses.append(float(loss))
        stages.append(ms)
        log(f"  step {step}: loss {losses[-1]:.6f}; forward "
            f"{ms['forward']:.3f} ms, backward {ms['backward']:.3f} ms, "
            f"update {ms['update']:.3f} ms (CUDA events); launches: "
            f"forward 1 gather_pool_tbe, backward +0, update +0")
    with torch.no_grad():
        last = float(pt.dlrm.bce_loss(params, *inputs))
    log(f"  loss before the first step {losses[0]:.6f}, after the last "
        f"{last:.6f}")
    check(np.isfinite(losses + [last]).all() and last < losses[0],
          "the loss after the last step is under the loss before the first")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(sum(s.values()) for s in stages)
    prof = _profile_step(pt, kmods, params, accum, inputs, step_ms)
    med = {k: statistics.median(s[k] for s in stages)
           for k in ("forward", "backward", "update")}
    log(f"  median stage ms over {TRAIN_STEPS} steps: forward "
        f"{med['forward']:.3f}, backward {med['backward']:.3f}, update "
        f"{med['update']:.3f}; peak device memory {peak_gb:.1f} GB; phase "
        f"7t: {time.perf_counter() - t0:.1f} s")
    out = dict(probe.out, losses=losses + [last], stages=stages,
               median=med, peak_gb=peak_gb, prof=prof, launches=fwd_launches)
    del params, accum, probe
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 8. LM serving
# ---------------------------------------------------------------------------

def _lm_requests(pt, cfg) -> list:
    """Two long prompts (the flash kernel) and six of 256-2,048 tokens
    (full attention), uniform ids over the vocabulary."""
    rng = np.random.default_rng(12)
    short = rng.integers(SHORT_PROMPTS[0], SHORT_PROMPTS[1] + 1, 6).tolist()
    lens = [LONG_PROMPT] + short[:3] + [LONG_PROMPT] + short[3:]
    return [pt.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                       .astype(np.int32), max_new=LM_MAX_NEW)
            for i, n in enumerate(lens)]


def phase_lm(pt, kmods) -> dict:
    cfg = pt.LM_CONFIG
    log(f"== 8. LM serving: {cfg.name} at full width ({cfg.num_layers} "
        f"layers, d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads,"
        f" d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), "
        f"ContinuousBatcher({LM_SLOTS} slots x {LM_MAX_LEN} positions)")
    fa, lm, dec = pt.fa, pt.lm, pt.dec
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=DEV).manual_seed(11), cfg,
                            device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  init_params: {n_params / 1e9:.3f} B parameters "
        f"({n_params * 2 / 1e9:.1f} GB bf16) in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = _lm_requests(pt, cfg)

    # layer 0's real q/k/v of the first long prompt: kernel vs plain
    tokens = torch.as_tensor(reqs[0].prompt[None], device=DEV)
    pl = lm.layer(params["blocks"], 0)
    x = lm._norm(lm.embed_tokens(params, tokens, cfg), pl["ln1"], cfg)
    q, k, v = lm._gqa_qkv(pl["attn"], x, torch.arange(
        LONG_PROMPT, device=DEV)[None], cfg)
    err = _flash_case(fa, q, k, v, True, cfg.window,
                      f"layer 0 of a {LONG_PROMPT}-token prompt (real q/k/v)")
    del x, q, k, v

    eng = pt.ContinuousBatcher(params, cfg, num_slots=LM_SLOTS,
                               max_len=LM_MAX_LEN, eos_id=-1, device=DEV)
    for r in reqs:
        eng.submit(r)
    for mod in kmods:
        mod.reset_launch_counts()
    steps = []
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slots):
        n0 = len(eng.timings["prefill"])
        c0 = fa.LAUNCH_COUNTS["flash_attention"]
        eng.step()
        steps.append(([n for n, _ in eng.timings["prefill"][n0:]],
                      fa.LAUNCH_COUNTS["flash_attention"] - c0))
    serve_s = time.perf_counter() - t0
    counts = {k: v for mod in kmods for k, v in mod.LAUNCH_COUNTS.items()}
    thr, nl = cfg.attn_chunk_threshold, cfg.num_layers
    for lens, n in steps:
        want = nl * sum(s > thr for s in lens)
        check(n == want, f"{n} flash launches in a step admitting prompts "
                         f"of {lens} tokens: want {nl} per prompt over "
                         f"{thr}, none per short prefill or decode step")
    n_long = sum(len(r.prompt) > thr for r in reqs)
    check(counts == _launches(flash_attention=nl * n_long),
          f"the LM path launched the flash kernel {nl} x {n_long} times "
          f"and nothing else")
    check(fa.ROUTE_COUNTS == {"wgmma": nl * n_long, "simt": 0},
          f"every flash launch of the LM path on the wgmma route "
          f"({fa.ROUTE_COUNTS})")
    done = eng.done
    check(sorted(done) == [r.rid for r in reqs]
          and all(len(r.generated) == LM_MAX_NEW
                  and 0 <= min(r.generated)
                  and max(r.generated) < cfg.vocab_size
                  for r in done.values()),
          f"{len(reqs)} requests served, {LM_MAX_NEW} ids each, in the "
          f"vocabulary")
    tokens_out = sum(len(r.generated) for r in done.values())
    prefill, decode = eng.timings["prefill"], eng.timings["decode"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {len(done)} requests, {tokens_out} tokens in {len(steps)} steps,"
        f" {serve_s:.3f} s: {tokens_out / serve_s:.2f} tokens/s; flash "
        f"launches {counts['flash_attention']} ({nl} x {n_long} long "
        f"prefills; per step {[n for _, n in steps if n]}; by route "
        f"{fa.ROUTE_COUNTS})")
    for n, sec in prefill:
        log(f"  prefill of {n} tokens: {1e3 * sec:.1f} ms")
    log(f"  decode step ({LM_SLOTS} slots): median "
        f"{1e3 * statistics.median(decode):.3f} ms, min "
        f"{1e3 * min(decode):.3f}, max {1e3 * max(decode):.3f} over "
        f"{len(decode)} steps; peak device memory {peak_gb:.1f} GB")
    # where the time goes: one decode step, one short and one long prefill
    # profiled (the slots' cache as the loop left it; its rows are scratch
    # now)
    kv = {k: v[:, :1] for k, v in eng.cache["blocks"].items()}
    short = torch.as_tensor(reqs[1].prompt[None], device=DEV)
    prof = dict(
        decode=_profile_lm(lambda: dec.decode_step(
            params, eng.cache, eng.tokens, cfg), "decode step",
            statistics.median(decode) * 1e3),
        prefill=_profile_lm(lambda: dec._prefill_into(
            params, short, cfg, kv), f"prefill of {short.shape[1]} tokens",
            prefill[1][1] * 1e3),
        long_prefill=_profile_lm(lambda: dec._prefill_into(
            params, tokens, cfg, kv), f"prefill of {LONG_PROMPT} tokens",
            prefill[0][1] * 1e3))
    del eng, kv
    torch.cuda.empty_cache()

    # decode matches forward at full width: prefill(prompt[:-1]) +
    # decode_step(prompt[-1]) against the forward's last hidden state
    h_full, _ = lm.forward(params, tokens, cfg)
    last = h_full[0, -1].float()
    del h_full
    cache, _ = dec.prefill(params, tokens[:, :-1], cfg, max_len=LONG_PROMPT)
    cache, h_dec = dec.decode_step(params, cache, tokens[:, -1], cfg)
    rel = float((h_dec[0].float() - last).norm() / last.norm())
    check(bool(torch.isfinite(h_dec).all() and torch.isfinite(last).all()),
          "finite hidden states")
    log(f"  decode matches forward ({LONG_PROMPT} tokens): relative L2 "
        f"{rel:.3e} (bound {DECODE_REL_L2})")
    check(rel < DECODE_REL_L2, "decode_step after prefill matches forward")
    del cache, params
    torch.cuda.empty_cache()
    return dict(launches=counts["flash_attention"], err=err, rel=rel,
                prefill=prefill, decode=decode, serve_s=serve_s,
                tokens=tokens_out, peak_gb=peak_gb, prof=prof)


def _profile_lm(fn, label, unprofiled_ms) -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy time by
    kernel, and its busy share of the same work's unprofiled time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    idle = 100 - 100 * busy_ms / unprofiled_ms
    log(f"  profiled {label}: device busy {busy_ms:.3f} ms of "
        f"{unprofiled_ms:.3f} ms unprofiled (host clock); idle {idle:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    return dict(busy_ms=busy_ms, idle=idle)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_gather as eg
    from repro_torch.kernels import onesided_a2a as oa

    class pt:   # the port's entry points, one namespace
        from repro_torch.cache import RemoteStore
        from repro_torch.configs.dlrm import CONFIG
        from repro_torch.core import comm
        from repro_torch.core import embedding_bag as eb
        from repro_torch.core.cache_config import CacheConfig
        from repro_torch.core.jagged import JaggedBatch
        from repro_torch.core.parallel import make_context
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ref
        from repro_torch.models import decode as dec
        from repro_torch.models import dlrm, lm
        from repro_torch.models.dlrm import init_params
        from repro_torch.analysis import (check_scheduler_source,
                                          check_timeline)
        from repro_torch.pipeline import STAGES
        from repro_torch.serving.engine import (ContinuousBatcher,
                                                CTRRequest, DLRMEngine,
                                                PipelinedDLRMEngine, Request,
                                                make_dlrm_engine)
        from repro_torch.configs.granite_8b import CONFIG as LM_CONFIG
        from repro_torch import obs
        from repro_torch.obs import Telemetry
        from repro_torch.core import perf_model as pm
        from repro_torch.core import sharding_plan as sp
        from repro_torch.analysis import audit, fixtures, repo_contracts
        from repro_torch.analysis.contracts import TBE_KERNEL
        from repro_torch.data.synthetic import dlrm_batches
        from repro_torch.kernels import ops as kops
        from repro_torch.optim import (rowwise_adagrad_init,
                                       rowwise_adagrad_update)

    # full fp32 products on the card, as in the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_environment(build)
    x = phase_kernels(eg, oa)
    flash_err = check_flash(pt)
    contracts = phase_contracts(pt)
    unc = phase_uncached(pt, eg, oa)
    cached = phase_cached(pt, eg, oa, unc)
    # the rows of the last flush's fetch, padded: a steady-state flush
    times = phase_times(eg, oa, x, _pow2(cached["fetched"][-1]))
    times.update(times_flash(pt))
    errs, digest = x["errs"], x["digest"]
    del x                       # phase 2's tables: 13.3 GB
    torch.cuda.empty_cache()
    remote = phase_remote(pt, eg, oa, unc, cached)
    piped = phase_pipelined(pt, eg, oa, unc, cached, remote)
    planned = phase_planned(pt, eg, oa, unc, cached)
    dist = phase_distributed(pt, eg, oa, unc)
    del unc["params"]           # phase 3's tables: 13.3 GB
    torch.cuda.empty_cache()
    train = phase_train(pt, eg, oa)
    lm = phase_lm(pt, (eg, oa, pt.fa))

    log("== 9. summary")
    # each main path's launches, read from its own run with the counts
    # at 0 just before it; a kernel's `launches` is their sum over the
    # paths that run it, `launches_by_path` keeps each path's own count
    by_path = {
        "gather_pool_tbe": {
            "3 serving uncached": unc["launches"]["gather_pool_tbe"],
            "7t training": train["launches"]},
        "gather_pool": {
            "3 serving uncached, fused=False":
                unc["launches"]["gather_pool"],
            "7t training, fused=False": train["unfused_launches"]},
        "gather_pool_tbe_flat": {"4 serving cached": cached["launches"]},
        "onesided_put_rows": {
            "6 serving remote": remote["onesided"]["launches"]},
        **{name: {"7 distributed": n} for name, n in dist["launches"].items()},
        "flash_attention": {"8 LM serving": lm["launches"]},
    }
    check(all(n > 0 for paths in by_path.values() for n in paths.values()),
          "every kernel launched on each main path that runs it")
    times.update(dist["times"])
    errs.update(dist["errs"])
    errs["flash_attention"] = max(flash_err, lm["err"])
    kernels = []
    for name in SOURCES:
        t = dict(times[name])
        err = max(errs[name], t.pop("max_abs_err", 0.0))
        kernels.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name],
                            launches=sum(by_path[name].values()),
                            launches_by_path=by_path[name],
                            max_abs_err=err, **t))
    log(f"uncached median flush {statistics.median(unc['flush_ms']):.3f} ms,"
        f" cached median flush {statistics.median(cached['flush_ms']):.3f} "
        f"ms, cached hit rate {cached['hit_rate']:.4f}; fused=False flush "
        f"{unc['unfused_ms']:.3f} ms; TBE device time of a flush "
        f"{unc['tbe_device_ms']['fused']:.4f} ms fused, "
        f"{unc['tbe_device_ms']['unfused']:.4f} ms in "
        f"{unc['launches']['gather_pool']} launches")
    log(f"phase-2 TBE digest {digest}")
    for backend, r in remote.items():
        log(f"remote {backend}: median flush "
            f"{statistics.median(r['flush_ms']):.3f} ms, profiled flush idle "
            f"{r['idle']:.1f}%, {r['fetches']} fetches, median fetch "
            f"{statistics.median(r['fetch_ms']):.3f} ms, put launches "
            f"{r['launches']}, peak device memory {r['peak_gb']:.1f} GB")
    for label, r in (("host", piped["host"]),
                     ("remote onesided", piped["remote"])):
        log(f"pipelined depth 2, {label}: run_to_completion "
            f"{r['wall_ms']:.3f} ms against {r['serial_ms']:.3f} ms of "
            f"serialized flushes, overlap_fraction "
            f"{r['overlap_fraction']:.4f}, hit rate {r['hit_rate']:.4f}")
    log(f"pipelined depth 2: pools {piped['host']['pool_bytes'] / 1e9:.3f} "
        f"GB, remote peak device memory {piped['remote']['peak_gb']:.1f} GB,"
        f" {piped['overflow']['fallbacks']} fallback(s) at "
        f"{piped['overflow']['slots']} slots, profiled scatter streams "
        f"{piped['profile']['scatter_streams']} vs TBE streams "
        f"{piped['profile']['tbe_streams']}, "
        f"{piped['profile']['overlap_ms']:.3f} ms of side work under forward"
        f" kernels")
    pa, pb = planned["a"], planned["b"]
    log(f"planned (6c): A serialized median flush "
        f"{statistics.median(pa['flush_ms']):.3f} ms (phase 4 "
        f"{statistics.median(cached['flush_ms']):.3f}), hit rate "
        f"{pa['hit_rate']:.4f}, latency p50/p99 "
        f"{1e3 * pa['latency']['p50']:.3f}/{1e3 * pa['latency']['p99']:.3f} "
        f"ms; B pipelined run {pb['wall_ms']:.3f} ms, hit rate "
        f"{pb['hit_rate']:.4f}, latency p50/p99 "
        f"{1e3 * pb['latency']['p50']:.3f}/{1e3 * pb['latency']['p99']:.3f} "
        f"ms, {pb['fetches']} fetches, peak {pb['peak_gb']:.1f} GB")
    log(f"planned (6c) fit: A gather_overhead_s "
        f"{pa['fit']['gather_overhead_s']:.6g}, host_Bps "
        f"{pa['fit']['host_Bps']:.6g}; B one-sided alpha_s "
        f"{pb['fit']['alpha_s']:.6g}, beta_Bps {pb['fit']['beta_Bps']:.6g}")
    log("distributed (median flush ms): " + ", ".join(
        f"{label} {statistics.median(dist[label]['flush_ms']):.3f}"
        for label, _, _ in STRATEGIES))
    log(f"distributed: row/a2a dropped per flush {dist['row/a2a/bulk']['dropped']}"
        f", onesided vs bulk {'bitwise' if dist['a2a_bitwise'] else 'within tolerance'}, "
        f"profiled a2a flush idle {dist['idle']:.1f}%, peak device memory "
        f"{dist['peak_gb']:.1f} GB")
    log(f"contracts (2c): all {len(contracts)} hold on the card; TBE device "
        f"kernels per fixture {contracts}")
    med = train["median"]
    log(f"training (7t): losses {[round(v, 6) for v in train['losses']]}, "
        f"median forward {med['forward']:.3f} ms, backward "
        f"{med['backward']:.3f} ms, update {med['update']:.3f} ms, device "
        f"idle {train['prof']['idle']:.1f}% of a step, peak device memory "
        f"{train['peak_gb']:.1f} GB, d tables vs float64 max_abs_err "
        f"{train['max_abs_err']:.3e} (fused=False "
        f"{train['unfused_err']:.3e}), two-run backward difference "
        f"{train['run_diff']:.3e}")
    log(f"LM serving ({pt.LM_CONFIG.name}): {lm['tokens']} tokens in "
        f"{lm['serve_s']:.3f} s ({lm['tokens'] / lm['serve_s']:.2f} tokens/s),"
        f" prefill ms by length "
        f"{[(n, round(1e3 * t, 1)) for n, t in lm['prefill']]}, median "
        f"decode step {1e3 * statistics.median(lm['decode']):.3f} ms, "
        f"flash launches {lm['launches']}, decode vs forward relative L2 "
        f"{lm['rel']:.3e}, peak device memory {lm['peak_gb']:.1f} GB, "
        f"device idle {lm['prof']['decode']['idle']:.1f}% of a decode step, "
        f"{lm['prof']['prefill']['idle']:.1f}% of a short prefill, "
        f"{lm['prof']['long_prefill']['idle']:.1f}% of a "
        f"{LONG_PROMPT}-token prefill")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
