"""The wgmma flash kernel against its plain version, on an NVIDIA card.

Every test here is marked ``cuda`` and skips without a card: the kernel
(``csrc/flash_attention_wgmma.cu``) has no CPU mode, and
``tests/test_torch_flash.py`` holds its arithmetic on the CPU.  On a
machine with an H100, from the repository root:

    python -m pytest -q -m cuda tests/test_torch_flash_card.py

The shapes are the edges that ``chip_smoke.py``'s main-path shapes do
not reach: sequences of 1 and 2 tokens, one short of and one past a
128-row tile, windows of 1 and around a tile, non-causal windows, MHA
and GQA, q/k/v as views of one fused projection.  Tolerance:
``chip_smoke.py``'s FLASH_TOL for bf16, ``rtol = atol = 1e-2``.  This file
imports no JAX, so that it runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash

FLASH_TOL_BF16 = dict(rtol=1e-2, atol=1e-2)
MASKS = [(True, None), (False, None), (True, 1), (True, 128), (True, 129),
         (False, 130)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wgmma kernel has no CPU mode")
    return torch.device("cuda")


def _randn(g, shape, device):
    return torch.randn(shape, generator=g, device=device).bfloat16()


def _check(q, k, v, causal, window):
    tflash.reset_launch_counts()
    got = tflash.flash_attention(q, k, v, causal=causal, window=window)
    assert tflash.ROUTE_COUNTS == {"wgmma": 1, "simt": 0}
    want = tflash.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("S", [1, 2, 127, 129, 257, 1000])
def test_wgmma_kernel_matches_plain_version(card, S, hd, causal, window):
    B, H, KH = (3, 4, 4) if hd == 64 else (2, 6, 2)
    g = torch.Generator(device=card).manual_seed(1000 * S + hd)
    q, k, v = (_randn(g, (B, S, n, hd), card) for n in (H, KH, KH))
    _check(q, k, v, causal, window)


@pytest.mark.cuda
def test_wgmma_kernel_reads_fused_projection_views(card):
    """q, k and v as head slices of one (B, S, H + 2 KH, hd) tensor: the
    tensor maps take the strides as they are, without a copy."""
    B, S, H, KH, hd = 2, 700, 8, 2, 128
    g = torch.Generator(device=card).manual_seed(7)
    qkv = _randn(g, (B, S, H + 2 * KH, hd), card)
    _check(qkv[:, :, :H], qkv[:, :, H:H + KH], qkv[:, :, H + KH:], True,
           None)


@pytest.mark.cuda
def test_wgmma_kernel_refuses_a_misaligned_view(card):
    """A bf16 view 2 bytes past 16-byte alignment raises before any
    launch; it does not move to the SIMT route."""
    x = torch.zeros(64 * 2 * 128 + 1, dtype=torch.bfloat16,
                    device=card)[1:].view(1, 64, 2, 128)
    tflash.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tflash.flash_attention(x, x, x, causal=True)
    assert tflash.ROUTE_COUNTS == {"wgmma": 0, "simt": 0}
