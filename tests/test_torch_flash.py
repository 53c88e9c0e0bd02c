"""The flash-attention wrapper's two routes, on the CPU.

The wgmma kernel (``csrc/flash_attention_wgmma.cu``) runs only on the
card, so its arithmetic is held here through an emulation of its tile
loop: 128-row query and key tiles, the key tiles it skips, scores scaled
in log2 units, masked scores -1e30, the probabilities rounded to bf16
before P.V (as SDPA's flash backend does) with the row sum taken in f32
before the rounding, and ``acc / max(l, 1e-30)`` rounded to bf16.  The
emulation lives in this file: it is not a mode of the package.

Tolerances:
  * the emulation against the port's plain version and the reference's
    ``chunked_attention``: ``chip_smoke.py``'s FLASH_TOL for bf16,
    ``rtol = atol = 1e-2``, which the card's kernel is held to (the
    rounding of P moves the output by about one bf16 ulp);
  * the emulation with P kept in f32 against the plain version: ``2e-5``
    (two orders of the same f32 sums, exp2 for exp).

Also: the route table (dtype and hd alone), the refusal of CPU tensors
on both routes, and the TMA-rule check that the wrapper runs before any
build.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as tflash

FLASH_TOL_BF16 = dict(rtol=1e-2, atol=1e-2)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK = 128          # query and key rows per tile of the wgmma kernel
LOG2E = 1.4426950408889634
# (B, S, H, KH, hd, causal, window): chip_smoke.py's four test shapes, then
# GQA at hd 128 over a few hundred keys (three tiles, the last ragged),
# causal and under a window, and a non-causal window at hd 64
SHAPES = [
    (2, 128, 4, 2, 32, True, None),
    (1, 256, 4, 4, 64, True, 64),
    (2, 96, 2, 1, 16, False, None),
    (1, 64, 8, 2, 128, True, None),
    (1, 300, 8, 2, 128, True, None),
    (1, 300, 8, 2, 128, True, 100),
    (2, 300, 4, 1, 64, False, 150),
]


def _inputs(B, S, H, KH, hd, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed + S + hd)
    return tuple(torch.from_numpy(rng.standard_normal((B, S, n, hd))
                                  .astype(np.float32)).to(dtype)
                 for n in (H, KH, KH))


def _emulate(q, k, v, causal, window, p_dtype=torch.bfloat16):
    """The wgmma kernel's arithmetic on the CPU: q (B, S, H, hd), k and v
    (B, S, KH, hd) -> (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale_log2 = torch.tensor(hd ** -0.5 * LOG2E, dtype=torch.float32)
    n_k = -(-S // BLOCK)
    pad = n_k * BLOCK - S        # TMA fills the rows past S with zeros
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                  for t in (q, k, v))
    kf = kf.repeat_interleave(G, dim=2)
    vf = vf.repeat_interleave(G, dim=2)
    out = torch.empty_like(q)
    for qt in range(n_k):
        q0 = qt * BLOCK
        rows = q0 + torch.arange(BLOCK)
        kt_hi = min(n_k, qt + 1) if causal else n_k
        kt_lo = 0
        if window is not None and q0 - window - (BLOCK - 1) >= 0:
            kt_lo = (q0 - window - (BLOCK - 1)) // BLOCK + 1
        m = torch.full((B, H, BLOCK), -1e30)
        l = torch.zeros((B, H, BLOCK))
        acc = torch.zeros((B, H, BLOCK, hd))
        qt_ = qf[:, q0:q0 + BLOCK]
        for kt in range(kt_lo, kt_hi):
            k0 = kt * BLOCK
            keys = k0 + torch.arange(BLOCK)
            s = torch.einsum("bqhd,bkhd->bhqk", qt_,
                             kf[:, k0:k0 + BLOCK]) * scale_log2
            ok = (keys < S)[None, :].expand(BLOCK, -1)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window is not None:
                ok = ok & (keys[None, :] > rows[:, None] - window)
            s = s.masked_fill(~ok, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(p_dtype).float(),
                vf[:, k0:k0 + BLOCK])
            m = m_new
        o = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
        n = min(BLOCK, S - q0)
        out[:, q0:q0 + n] = o[:, :n].to(q.dtype)
    return out


@pytest.mark.parametrize("B,S,H,KH,hd,causal,window", SHAPES)
def test_bf16_probabilities_stay_within_flash_tol(B, S, H, KH, hd, causal,
                                                  window):
    """P rounded to bf16 before P.V: within FLASH_TOL of the port's plain
    version and of the reference's chunked_attention on the same inputs."""
    q, k, v = _inputs(B, S, H, KH, hd)
    got = _emulate(q, k, v, causal, window).float()
    want = tflash.flash_attention_ref(q, k, v, causal=causal,
                                      window=window).float()
    torch.testing.assert_close(got, want, **FLASH_TOL_BF16)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                  for t in (q, k, v))
    ref = np.asarray(jlayers.chunked_attention(
        jq, jk, jv, causal=causal, window=window), np.float32)
    np.testing.assert_allclose(got.numpy(), ref, **FLASH_TOL_BF16)


@pytest.mark.parametrize("B,S,H,KH,hd,causal,window", SHAPES)
def test_emulated_tile_loop_is_the_plain_function(B, S, H, KH, hd, causal,
                                                  window):
    """With P kept in f32 the emulation (its skipped tiles, -1e30 masks,
    log2-unit scores) is the plain version to f32 rounding: the rounding of
    P is the only approximation of the wgmma kernel."""
    q, k, v = _inputs(B, S, H, KH, hd, dtype=torch.float32)
    got = _emulate(q, k, v, causal, window, p_dtype=torch.float32)
    want = tflash.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_route_follows_dtype_and_head_dim(dtype, hd):
    want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
            else "simt")
    assert tflash.pick_route(dtype, hd) == want


@pytest.mark.parametrize("route", [None, "wgmma", "simt"])
def test_launch_refuses_cpu_tensors_on_every_route(route):
    q = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash._launch(q, q, q, True, None, route=route)


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    q, k, v = _inputs(1, 40, 4, 2, 128)
    tflash.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, causal=True)
    assert tflash.LAUNCH_COUNTS == {"flash_attention": 0}
    assert tflash.ROUTE_COUNTS == {"wgmma": 0, "simt": 0}
    torch.testing.assert_close(got, tflash.flash_attention_ref(q, k, v))


def _bf16(n):
    return torch.zeros(n, dtype=torch.bfloat16)


# (case, the view, what the error says, or None where TMA takes it)
TMA_CASES = [
    ("contiguous", lambda: _bf16(2 * 8 * 2 * 128).view(2, 8, 2, 128), None),
    ("kv-cache slice", lambda: _bf16(2 * 20 * 2 * 128).view(
        2, 20, 2, 128)[:, :8], None),
    ("heads of a wider projection", lambda: _bf16(8 * 6 * 128).view(
        1, 8, 6, 128)[:, :, 2:4], None),
    ("head stride of 260 bytes", lambda: _bf16(4096).as_strided(
        (1, 8, 2, 128), (8 * 512, 512, 130, 1)), "head stride is 260"),
    ("seq stride of 520 bytes", lambda: _bf16(8192).as_strided(
        (2, 8, 2, 128), (4096, 260, 128, 1)), "seq stride is 520"),
    ("base 2 bytes past alignment", lambda: _bf16(4096 + 1)[1:].view(
        1, 8, 4, 128), "16-byte aligned"),
    ("batch stride of 6 bytes", lambda: _bf16(4096).as_strided(
        (1, 8, 2, 128), (3, 256, 128, 1)), "batch stride is 6"),
    ("head dim not contiguous", lambda: _bf16(4096).as_strided(
        (1, 8, 1, 128), (4096, 512, 512, 2)), "contiguous head"),
]


@pytest.mark.parametrize("case,make,error", TMA_CASES,
                         ids=[c[0] for c in TMA_CASES])
def test_tma_rule_check(case, make, error):
    """The check the wrapper runs on q, k and v before any build of the
    wgmma kernel: a view that breaks TMA's rules raises (it does not move
    to the SIMT route)."""
    t = make()
    if error is None:
        tflash.check_tma("k", t)
    else:
        with pytest.raises(ValueError, match=error):
            tflash.check_tma("k", t)


def test_wgmma_source_builds_with_nvcc_or_raises(monkeypatch, tmp_path):
    """The wgmma kernel is one of the sources the build starts together,
    and without nvcc its build raises (no fallback to the SIMT route)."""
    assert "flash_attention_wgmma" in build.SOURCES
    assert build.library_path("flash_attention_wgmma").name.startswith(
        "flash_attention_wgmma-")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["flash_attention_wgmma"])


def test_wgmma_source_states_what_it_replaces_and_what_bounds_it():
    text = (build.CSRC / "flash_attention_wgmma.cu").read_text()
    header = text[:text.index("#include")]
    assert "src/repro/kernels/flash_attention.py" in header
    assert "_flash_kernel" in header
    assert "operations" in header and "6,500 flops per byte" in header
    for part in ("wgmma", "TMA", "setmaxnreg", "mbarrier"):
        assert part in header
    assert "cudaGetDriverEntryPoint" in text      # no -lcuda in the build
    assert not any("-lcuda" in f for f in build.NVCC_FLAGS)


def test_log2_scale_is_the_reference_scale():
    """exp2(s * hd**-0.5 * log2 e) is exp(s * hd**-0.5)."""
    for hd in (64, 128):
        s = 3.7
        assert math.isclose(2 ** (s * hd ** -0.5 * LOG2E),
                            math.exp(s * hd ** -0.5), rel_tol=1e-12)
